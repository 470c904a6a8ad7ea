"""The port's dry-run (``repro_torch.launch.{specs,dryrun}`` and
``LMModel.init_caches(kv_dtype=)``) against the reference's
(``repro.launch.{specs,dryrun}``), on the CPU.

* ``input_specs``: the reference's keys, shapes and dtype names for every
  config x shape, as meta tensors.
* ``count_params`` and the record's ``params_active``, exact against the
  reference's on ``jax.eval_shape`` params, every config at full width.
* f8 decode caches: the reduced llama decodes 4 greedy steps from fresh
  ``float8_e4m3fn`` caches, as the dry-run's decode cell starts, beside
  the reference from its own f8 caches: the caches bit for bit after every
  step, the logits at the teacher-forcing bar (rtol 2e-2, atol 2e-3), the
  greedy tokens equal.  (Prefill builds caches of the activations' dtype
  in both packages, so it is not this path.)
* The CLI in a subprocess at full width, llama3.2-3b ``decode_32k`` on
  both production meshes (fake process groups of 256 and 512 ranks): exit
  0, records that carry the reference's ``run_cell`` keys, and an argument
  size equal to rank 0's local shard bytes computed here from the specs;
  a world of another size raises.
"""
import json
import math
import os
import resource
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch.dryrun import count_params as jcount_params
from repro.launch.specs import input_specs as jinput_specs
from repro.models.lm import build_model as jbuild
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_arrays
from repro_torch.dist import sharding as tsh
from repro_torch.launch import dryrun
from repro_torch.launch.specs import input_specs
from repro_torch.models.lm import build_model as tbuild

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = jconfigs.list_configs()
REF_RUN_CELL_KEYS = {"arch", "shape", "mesh", "tag", "status", "lower_s", "compile_s",
                     "memory", "cost", "jaxpr_cost", "collectives", "n_devices",
                     "params_total", "params_active", "tokens", "step"}


def test_the_port_has_the_reference_configs():
    assert tconfigs.list_configs() == CONFIGS and len(CONFIGS) == 10


@pytest.mark.parametrize("shape", list(jconfigs.SHAPES))
@pytest.mark.parametrize("arch", CONFIGS)
def test_input_specs_match_the_reference(arch, shape):
    want = jinput_specs(jconfigs.get_config(arch), jconfigs.SHAPES[shape])
    got = input_specs(tconfigs.get_config(arch), tconfigs.SHAPES[shape])
    assert sorted(got) == sorted(want)
    for key, spec in want.items():
        t = got[key]
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(spec.shape), key
        assert str(t.dtype).split(".")[-1] == spec.dtype.name, key


@pytest.mark.parametrize("arch", CONFIGS)
def test_count_params_and_active_match_the_reference(arch):
    """Full width, exact: the total, the non-expert count and the record's
    ``params_active`` (non-expert + expert x top_k / E)."""
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jp = jax.eval_shape(lambda: jbuild(jcfg).init(jax.random.key(0), dtype=jnp.bfloat16))
    with torch.device("meta"):
        tp = tbuild(tcfg)._draw(torch.Generator(), torch.bfloat16)
    want, got = jcount_params(jp), dryrun.count_params(tp)
    assert got == want

    def active(total, nonexpert, cfg):
        frac = (cfg.top_k / cfg.n_experts) if cfg.moe else 0.0
        return nonexpert + (total - nonexpert) * frac

    assert active(*got, tcfg) == active(*want, jcfg)


def test_f8_caches_decode_as_the_reference():
    arch, B, L, steps = "llama3.2-3b", 2, 16, 4
    jcfg, tcfg = jconfigs.get_config(arch).reduced(), tconfigs.get_config(arch).reduced()
    jm, tm = jbuild(jcfg), tbuild(tcfg)
    jp = jm.init(jax.random.key(0))
    tp = lm_params_from_arrays(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    jcaches = jm.init_caches(B, L, kv_dtype=jnp.float8_e4m3fn)
    tcaches = tm.init_caches(B, L, kv_dtype=torch.float8_e4m3fn, device="cpu")
    assert tcaches[0]["sub0"]["k"].dtype == torch.float8_e4m3fn
    tok = np.random.default_rng(0).integers(0, jcfg.vocab, (B, 1)).astype(np.int32)
    jtoks, ttoks = [], []
    jt, tt = tok, tok
    for pos in range(steps):
        jl, jcaches = jm.decode_step(jp, jnp.asarray(jt), jcaches, pos)
        tl, tcaches = tm.decode_step(tp, torch.from_numpy(tt), tcaches, pos)
        for key in ("k", "v"):
            want = np.asarray(jcaches[0]["sub0"][key]).view(np.uint8)
            got = tcaches[0]["sub0"][key].view(torch.uint8).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"step {pos} {key}")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-2, atol=2e-3)
        jt = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        tt = tl.argmax(-1)[:, None].to(torch.int32).numpy()
        jtoks.append(jt)
        ttoks.append(tt)
    np.testing.assert_array_equal(np.concatenate(ttoks, 1), np.concatenate(jtoks, 1))


class _Mesh:
    """Duck-typed mesh for the rules alone (no process group)."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


def _local_bytes(leaf, spec, sizes) -> int:
    """Rank 0's bytes of ``leaf`` under ``spec`` (divisible: the guard saw
    to it)."""
    entries = list(spec) + [None] * (leaf.ndim - len(spec))
    dims = [n // math.prod(sizes[a] for a in
                           (() if e is None else e if isinstance(e, tuple) else (e,)))
            for n, e in zip(leaf.shape, entries)]
    return math.prod(dims) * leaf.element_size()


def _rank0_argument_bytes(arch: str, shape_name: str, sizes: dict) -> int:
    cfg, shape = tconfigs.get_config(arch), tconfigs.SHAPES[shape_name]
    model, mesh = tbuild(cfg), _Mesh(sizes)
    with torch.device("meta"):
        params = model._draw(torch.Generator(), torch.bfloat16)
    caches = model.init_caches(shape.global_batch, shape.seq_len, torch.bfloat16,
                               device="meta")
    batch = input_specs(cfg, shape)
    from repro_torch.train._tree import flatten_with_paths, leaves

    total = sum(_local_bytes(p, tsh._divisible(tsh.param_pspec(path, p, cfg), p.shape, mesh),
                             sizes) for path, p in flatten_with_paths(params))
    for leaf in leaves(caches):
        total += _local_bytes(leaf, tsh._cache_pspec(leaf, mesh, cfg), sizes)
    for leaf in leaves(batch):
        total += _local_bytes(leaf, tsh.batch_pspec(mesh, leaf.shape[0]), sizes)
    return total


def test_cli_runs_a_full_width_decode_cell_on_both_meshes(tmp_path):
    """``python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape
    decode_32k --mesh both``: exit 0 within 60 CPU seconds (about 20 here),
    two ``ok`` records with
    the reference's ``run_cell`` keys, FLOPs, collectives and a peak, and
    rank 0's argument bytes as the specs give them."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    before = resource.getrusage(resource.RUSAGE_CHILDREN)
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                          "llama3.2-3b", "--shape", "decode_32k", "--mesh", "both", "--out",
                          str(tmp_path)], env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    after = resource.getrusage(resource.RUSAGE_CHILDREN)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    assert "[dryrun] done, 0 failures" in run.stdout
    # its CPU seconds, which the suite's other workers do not stretch as
    # they stretch the wall clock
    cpu_s = (after.ru_utime - before.ru_utime) + (after.ru_stime - before.ru_stime)
    assert cpu_s < 60, cpu_s
    for mesh_name, sizes in (("single_pod", {"data": 16, "model": 16}),
                             ("multi_pod", {"pod": 2, "data": 16, "model": 16})):
        rec = json.loads((tmp_path / f"llama3.2-3b__decode_32k__{mesh_name}.json").read_text())
        assert rec["status"] == "ok", rec.get("trace")
        assert REF_RUN_CELL_KEYS <= set(rec)
        assert rec["n_devices"] == math.prod(sizes.values())
        assert rec["step"] == "decode" and rec["tokens"] == 128
        assert rec["jaxpr_cost"]["flops"] > 0 and rec["collectives"]["total"] > 0
        mem = rec["memory"]
        assert mem["argument_size_in_bytes"] == _rank0_argument_bytes(
            "llama3.2-3b", "decode_32k", sizes)
        assert mem["peak_memory_in_bytes"] >= (mem["argument_size_in_bytes"]
                                               + mem["output_size_in_bytes"])
        assert mem["temp_size_in_bytes"] > 0


_WRONG_WORLD = r"""
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch.dryrun import run_cell
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
try:
    run_cell("llama3.2-3b", "decode_32k", "single_pod", "")
except ValueError as e:
    assert "needs a world of 256" in str(e), e
    print("raised")
"""


def test_a_world_of_another_size_raises():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, "-c", _WRONG_WORLD], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0 and "raised" in run.stdout, run.stderr[-3000:]


# The reduced deepseek-v3 and mamba2 train steps (remat on) on a fake (2, 4)
# group, meta tensors: the shape of every storage rank 0 makes
_HEADS = r"""
import json
import sys
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.dist import hints, make_mesh
from repro_torch.dist.sharding import (NamedSharding, PartitionSpec as P, batch_shardings,
                                       device_put, param_shardings)
from repro_torch.launch import analysis
from repro_torch.launch.specs import input_specs
from repro_torch.models.lm import build_model
from repro_torch.train.optimizer import OptConfig, opt_init
from repro_torch.train.trainer import TrainConfig, make_train_step

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
made = []
track = analysis._Trace._track
def tracked(self, t):
    if id(t.untyped_storage()) not in self._seen:
        made.append([list(t.shape), str(sys._getframe(1).f_locals.get("func"))])
    track(self, t)
analysis._Trace._track = tracked
out = {}
for arch in ("deepseek-v3-671b", "mamba2-370m"):
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    with torch.device("meta"):
        params = model._draw(torch.Generator(), torch.float32)
    ps = param_shardings(params, mesh, cfg)
    oc = OptConfig()
    batch = input_specs(cfg, ShapeSpec("x", 64, 8, "train"), dtype=torch.float32)
    args = device_put((params, opt_init(params, oc), batch),
                      (ps, {"mu": ps, "nu": ps, "step": NamedSharding(mesh, P())},
                       batch_shardings(batch, mesh)))
    made.clear()
    with hints.activation_sharding(mesh):
        analysis.memory_trace(make_train_step(model, TrainConfig(opt=oc, remat=True)), *args)
    out[arch] = list(made)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def head_split_shapes():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, "-c", _HEADS], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


def _products(made, rows, width):
    """How many ``mm`` products of (rows, width) rank 0 made."""
    return sum(1 for shape, op in made if shape == [rows, width] and op == "aten.mm.default")


def test_mla_attention_blocks_carry_only_the_ranks_heads(head_split_shapes):
    """deepseek-v3-671b reduced (4 MLA heads, 4 layers) trained at B = 8,
    S = 64 on a fake (2, 4) group: every attention block rank 0 makes,
    (rows, kv heads, 1, q, k), holds its 4 rows and 4 / 4 = 1 head, never
    all 4 (the full-width ``train_4k`` cell's peak was such a block of 128
    heads); q's head product over its 4 x 64 rows is its one head's 16 + 8
    columns, made once a layer: remat's recompute gets it back
    (``common.saving_products``)."""
    H, m, S = 4, 4, 64
    made = head_split_shapes["deepseek-v3-671b"]
    blocks = [shape for shape, _ in made if len(shape) == 5 and shape[3:] == [S, S]]
    assert blocks
    assert {tuple(s[:3]) for s in blocks} == {(8 // 2, H // m, 1)}, blocks
    assert _products(made, 4 * S, 24) == 4 and _products(made, 4 * S, H * 24) == 0


def test_mamba2_mixer_products_carry_only_the_ranks_heads(head_split_shapes):
    """mamba2-370m reduced (8 heads of 16, state 16, one group, 4 layers)
    trained at B = 8, S = 64 on a fake (2, 4) group: rank 0's in_proj
    product over its 4 x 64 rows has its 2 heads' z, x and dt columns and
    the group's B and C (2 x 32 + 2 x 16 + 2 = 98), never all 2 x 128 + 2 x
    16 + 8 = 296, made once a layer (remat's recompute gets it back); the
    scan's (rows, Q, Q, heads) blocks hold 2 heads."""
    rows, Hl, Q = 4 * 64, 2, 16
    made = head_split_shapes["mamba2-370m"]
    widths = {shape[1] for shape, _ in made if len(shape) == 2 and shape[0] == rows}
    assert 98 in widths and 296 not in widths, widths
    assert _products(made, rows, 98) == 4
    scan = [shape for shape, _ in made if len(shape) == 4 and shape[1:3] == [Q, Q]]
    assert scan and {s[3] for s in scan} == {Hl}, scan


# The dry-run's default step (the anchors off, as without ``--hints``) on a
# fake (2, 4) group, meta tensors, every config reduced: the reduced
# llama3.2-3b and deepseek-v3 train steps (remat on), each local ``mm``
# rank 0 makes in the model's code with the weight its line names; the
# reduced mamba2 and deepseek-v3 decode steps (``build_cell``'s, FSDP params,
# a 64-row cache), the shape of every storage rank 0 makes
_ANCHORS_OFF = r"""
import json
import linecache
import re
import sys
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch._subclasses.fake_tensor import FakeTensor
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.dist import hints, make_mesh
from repro_torch.dist.sharding import device_put
from repro_torch.launch import analysis, dryrun

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
dryrun.get_config = lambda arch: get_config(arch).reduced()
made = []
dispatch = analysis._Trace.__torch_dispatch__

def recorded(self, func, types, args=(), kwargs=None):
    out = dispatch(self, func, types, args, kwargs)
    if out is NotImplemented or not isinstance(out, torch.Tensor) or isinstance(out, FakeTensor):
        return out
    weight = None
    if str(func) == "aten.mm.default":
        # the weight named in the model's call that made the product (the
        # call's own span of its line, where one line makes two products)
        f, call = sys._getframe(), ""
        while f is not None and ("repro_torch/models" not in f.f_code.co_filename
                                 or "common.py" in f.f_code.co_filename):
            f = f.f_back
        if f is not None:
            line, end, col, end_col = list(f.f_code.co_positions())[f.f_lasti // 2]
            call = linecache.getline(f.f_code.co_filename, line)
            if end == line and col is not None:
                call = call[col:end_col]
        names = re.findall(r'p\["(\w+)"\]', call)
        weight = names[0] if names else None
    made.append([list(out.shape), str(func), weight])
    return out

analysis._Trace.__torch_dispatch__ = recorded
out = {}
for arch, shape in (("llama3.2-3b", ShapeSpec("x", 64, 8, "train")),
                    ("deepseek-v3-671b", ShapeSpec("x", 64, 8, "train")),
                    ("mamba2-370m", ShapeSpec("x", 64, 8, "decode")),
                    ("deepseek-v3-671b", ShapeSpec("x", 64, 8, "decode"))):
    fn, args, shardings, _ = dryrun.build_cell(arch, shape, mesh, dtype=torch.float32)
    args = device_put(args, shardings)
    made.clear()
    with hints.activation_sharding(mesh, anchor=False):
        analysis.memory_trace(fn, *args)
    out[arch + "|" + shape.step] = list(made)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def anchors_off_shapes():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, "-c", _ANCHORS_OFF], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


def _by_weight(made) -> dict:
    """{weight: the set of (rows, columns) products rank 0 made with it}."""
    out = {}
    for shape, op, weight in made:
        if op == "aten.mm.default" and weight is not None:
            out.setdefault(weight, set()).add(tuple(shape))
    return out


@pytest.mark.parametrize("arch", ["llama3.2-3b", "deepseek-v3-671b"])
def test_column_parallel_products_keep_their_model_split_without_anchors(
        anchors_off_shapes, arch):
    """The dry-run's default train step (no ``--hints``): rank 0's dense FFN
    products over its 4 x 64 rows carry d_ff / 4 = 32 of 128 columns, as
    the reference's GSPMD makes them ((256, 32) in its partitioned HLO),
    never the whole 128 on rows split over "model" too; llama's q product
    carries its 1 head of 4 (16 columns) and k and v their 32 / 4 columns;
    v3's down products w_dq and w_dkv their 32 / 4 columns and w_kr its 8 /
    4 (and its shared expert's gate and up, a dense FFN of 32, 8 columns);
    the FLOPs a rank makes are its share, not every column."""
    products = _by_weight(anchors_off_shapes[arch + "|train"])
    rows = 4 * 64
    ffn = {(rows, 128 // 4)} | ({(rows, 32 // 4)} if arch == "deepseek-v3-671b" else set())
    assert products["w_gate"] == products["w_up"] == ffn, products
    if arch == "llama3.2-3b":
        assert products["wq"] == {(rows, 16)}, products
        assert products["wk"] == products["wv"] == {(rows, 8)}, products
    else:
        assert products["w_dq"] == products["w_dkv"] == {(rows, 8)}, products
        assert products["w_kr"] == {(rows, 2)}, products
    assert not any(s[1] == 128 for v in products.values() for s in v), products


def test_mamba2_decode_carries_only_the_ranks_heads_and_no_whole_in_proj(
        anchors_off_shapes):
    """mamba2-370m reduced (8 heads of 16, in_proj (64, 296), out_proj (128,
    64)) decoding one token of B = 8 on a fake (2, 4) group in the
    dry-run's default step: rank 0 gathers in_proj over "data" only, to its
    (64, 74) block of columns, and out_proj to its (32, 64) rows, never
    either whole; its in_proj product is (4, 74) and its recurrence's
    state (4, 2, 16, 16), its 2 heads, gathered back whole (4, 8, 16, 16)
    for the cache."""
    made = anchors_off_shapes["mamba2-370m|decode"]
    shapes = [tuple(s) for s, _, _ in made]
    assert (64, 74) in shapes and (32, 64) in shapes, sorted(set(shapes))
    assert (64, 296) not in shapes and (128, 64) not in shapes
    assert (4, 74) in shapes and (4, 2, 16, 16) in shapes and (4, 8, 16, 16) in shapes


def test_mla_decode_carries_only_the_ranks_heads(anchors_off_shapes):
    """deepseek-v3 reduced (4 MLA heads, r_kv 32) decoding one token of B =
    8 against a 64-row latent cache on a fake (2, 4) group: every storage
    of rank 0 with a head axis holds its 1 head, the absorbed query (4, 1,
    1, 32) and the scores (4, 1, 1, 64), never all 4, and no block of w_uk
    or w_uv (32, 4, 16) holds every head."""
    made = anchors_off_shapes["deepseek-v3-671b|decode"]
    shapes = {tuple(s) for s, _, _ in made}
    assert (4, 1, 1, 32) in shapes and (4, 1, 1, 64) in shapes, sorted(shapes)
    assert not {(4, 1, 4, 32), (4, 4, 1, 64), (4, 1, 4, 16), (4, 1, 4, 24),
                (32, 4, 16), (16, 4, 16)} & shapes


def test_moe_default_step_sums_expert_blocks_as_the_reference_does():
    """deepseek-moe-16b reduced, the default train step (no hints) on a
    (2, 4) mesh, through ``tools/mesh_collectives.py``: the reference's
    partitioned HLO exchanges no tokens over "model" (its all-to-alls, if
    any, stay within "data") and all-reduces over "model"; the port's rank
    0, its residual whole over "model" at each norm, issues no all-to-all
    (each "model" group routes the same rows) and sums the expert blocks'
    shares by all-reduce."""
    run = subprocess.run([sys.executable, str(ROOT / "tools" / "mesh_collectives.py"),
                          "--arch", "deepseek-moe-16b"],
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    ref, port = (json.loads(line) for line in run.stdout.strip().splitlines()[-2:])
    assert ref["side"] == "reference" and port["side"] == "port"
    by_axes = ref["count_by_axes"]
    assert not any(k.startswith("all-to-all over") and "model" in k for k in by_axes), by_axes
    assert by_axes.get("all-reduce over model", 0) > 0, by_axes
    assert "all-to-all" not in port["count"] and port["count"]["all-reduce"] > 0, port
