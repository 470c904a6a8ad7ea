"""The port's activation hints (``repro_torch.dist.hints``), mirroring
``tests/test_hints.py``: off a mesh, and on a plain tensor, every hint
returns its input itself; inside ``activation_sharding`` a hint
redistributes a DTensor to the guarded spec (on a gloo world of one in
this process), the context is re-entrant and restores, and the guard is
the one the sharding rules use.  The hints sit at the reference's four
call sites (q, k and v in ``gqa``, the FFN hidden, the residual)."""
import inspect

import pytest
import torch

from repro.dist import hints as jhints
from repro_torch.dist import hints


def _tensors():
    g = torch.Generator().manual_seed(0)
    return {
        "act": torch.randn((2, 8, 16), generator=g),          # (B, S, d)
        "heads": torch.randn((2, 8, 4, 4), generator=g),      # (B, S, H, hd)
        "ffn_hidden": torch.randn((2, 8, 32), generator=g),   # (B, S, f)
    }


@pytest.fixture
def mesh():
    """A (1, 1) ("data", "model") mesh on a gloo group of one rank."""
    import torch.distributed as dist

    from repro_torch.dist import make_mesh

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"), device="cpu")
    finally:
        dist.destroy_process_group()


def test_public_names_are_the_references():
    assert hints.__all__ == jhints.__all__


def test_hints_are_identity_off_mesh():
    for name, x in _tensors().items():
        assert getattr(hints, name)(x) is x, f"{name} must return its input itself off-mesh"
    x = torch.ones((2, 3, 8))
    assert not hints.on_mesh(x)
    assert torch.equal(hints.split_heads(x, 2, 4), x.reshape(2, 3, 2, 4))


def test_hints_inside_a_mesh_keep_plain_tensors_and_values(mesh):
    """On a (1, 1) mesh a plain tensor comes back itself; a DTensor comes
    back on the hint's placements with the same values, and its gradient
    goes back through the hint."""
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    with hints.activation_sharding(mesh):
        for name, x in _tensors().items():
            assert getattr(hints, name)(x) is x
            d = distribute_tensor(x, mesh, (Replicate(), Replicate())).requires_grad_()
            y = getattr(hints, name)(d)
            assert isinstance(y, DTensor) and torch.equal(y.full_tensor(), x)
            want = {"act": (Shard(0), Replicate()), "heads": (Shard(0), Shard(2)),
                    "ffn_hidden": (Shard(0), Shard(2))}[name]
            assert tuple(y.placements) == want
            y.sum().backward()
            assert tuple(d.grad.placements) == (Replicate(), Replicate())
            assert torch.equal(d.grad.full_tensor(), torch.ones_like(x))
    for name, x in _tensors().items():  # the context is gone: identities again
        assert getattr(hints, name)(x) is x


def test_activation_sharding_context_is_reentrant_and_restores(mesh):
    x = torch.ones((2, 4, 8))
    assert not hints._ACTIVE
    with hints.activation_sharding(mesh, ("data",)):
        with hints.activation_sharding(mesh) as inner:
            assert len(hints._ACTIVE) == 2 and inner.batch_axes == ("data",)
            assert hints.act(x) is x
        assert len(hints._ACTIVE) == 1
    assert not hints._ACTIVE
    assert hints.act(x) is x


def test_plain_tensors_mix_in_only_inside_the_context(mesh):
    """Inside the context a plain tensor meets a DTensor as a replicated
    one (``implicit_replication``, on for the outermost context only)."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    d = distribute_tensor(torch.ones(4, 8), mesh, (Replicate(), Replicate()))
    plain = torch.arange(8.0)
    with hints.activation_sharding(mesh):
        with hints.activation_sharding(mesh):
            pass
        assert torch.equal((d + plain).full_tensor(), torch.ones(4, 8) + plain)
    with pytest.raises(RuntimeError, match="mixed torch.Tensor and DTensor"):
        d + plain


def test_divisibility_guard_drops_unfit_axes_in_hints():
    """Head count not divisible by the model axis: the hint falls back to a
    batch-only spec (guard shared with the sharding rules)."""
    from repro_torch.dist.sharding import PartitionSpec as P
    from repro_torch.dist.sharding import _divisible

    class FakeMesh:
        shape = {"data": 2, "model": 16}

    spec = _divisible(P("data", None, "model", None), (4, 8, 6, 4), FakeMesh())
    assert spec == ("data", None, None, None)


def test_hints_sit_at_the_references_call_sites():
    from repro_torch.models import attention, lm, moe

    qkv = inspect.getsource(attention.gqa._qkv)
    for t, n in (("q", "H"), ("k", "Hkv"), ("v", "Hkv")):
        assert f"{t} = hints.heads(hints.split_heads({t}, {n}, hd))" in qkv
    assert "hints.ffn_hidden(h)" in inspect.getsource(moe.dense_ffn.forward)
    assert "x = hints.act(x + y)" in inspect.getsource(lm.apply_unit)
