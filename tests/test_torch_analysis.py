"""The dry-run's counters (``repro_torch.launch.analysis``) against the
reference's (``repro.launch.analysis``), on the CPU.

``step_cost`` runs a step on unsharded meta tensors and classes its ATen
ops as ``jaxpr_cost`` classes the jaxpr's primitives.  Its product FLOPs
are held to the reference's ``jaxpr_cost(jax.make_jaxpr(fn)(...))`` on
the same shapes: ``chunked_attention`` and the reduced prefill and decode
of every family within 1 %, every family's train step within 2 %.
``ew_flops`` and ``bytes`` are printed beside the reference's and not
held: eager op decompositions differ from the jaxpr's primitives.

The train step's products differ from the reference's by one named term
(ROADMAP.md, queue 3's findings), which the test computes from the shapes
and holds exactly as it is named: the chunked loss's backward recomputes
each chunk's logits (``models/lm.py:_ce_grads``), 2 B S d V, where the
reference's scan keeps them as residuals.  Under remat both run the same
policy (``dots_with_no_batch_dims_saveable``): the products without batch
dims (``aten.mm``) are saved, only the batched ones (``aten.bmm``) are
recomputed.

``collective_bytes`` and the dry-run's sharded runs need a process group,
so they run in one subprocess on ``fake`` groups (one process, no
communication): the reference's collective-parser test on a group of 2,
the reduced llama's train step and decode on a (2, 4) mesh, and
``dryrun_pdx`` on the (16, 16) mesh, held to counts written here.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as jconfigs
from repro.launch.analysis import jaxpr_cost
from repro.launch.specs import input_specs as jinput_specs
from repro.models import lm as jlm
from repro.models.common import chunked_attention as jattention
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch import configs as tconfigs
from repro_torch.launch.analysis import step_cost
from repro_torch.launch.specs import input_specs
from repro_torch.models import lm as tlm
from repro_torch.models.common import chunked_attention
from repro_torch.train import optimizer as topt
from repro_torch.train import trainer as ttrainer

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ["llama3.2-3b", "deepseek-moe-16b", "deepseek-v3-671b", "jamba-v0.1-52b",
            "mamba2-370m", "internvl2-1b", "whisper-small"]
B, S = 2, 64


def _meta_params(model):
    with torch.device("meta"):
        return model._draw(torch.Generator(), torch.float32)


def test_step_cost_counts_attention_flops():
    """``tests/test_dryrun.py::test_jaxpr_cost_counts_attention_flops``:
    the qk and pv products of ``chunked_attention`` within the reference
    test's 0.9-1.6x of 4 B H S^2 D, and within 1 % of the reference's
    ``jaxpr_cost`` on the same shapes."""
    Bq, Sq, H, D = 2, 256, 4, 32
    q = torch.empty((Bq, Sq, H, D), device="meta")
    c = step_cost(lambda q, k, v: chunked_attention(q, k, v, q_chunk=128, kv_chunk=128),
                  q, q, q)
    expect = 2 * 2 * Bq * H * Sq * Sq * D
    assert 0.9 * expect <= c["dot_flops"] <= 1.6 * expect, (c["dot_flops"], expect)
    jq = jax.ShapeDtypeStruct((Bq, Sq, H, D), jnp.float32)
    ref = jaxpr_cost(jax.make_jaxpr(
        lambda q, k, v: jattention(q, k, v, q_chunk=128, kv_chunk=128))(jq, jq, jq))
    assert c["dot_flops"] == pytest.approx(ref["dot_flops"], rel=1e-2)
    assert c["flops"] == c["dot_flops"] + c["ew_flops"]


def _cells(arch: str, step: str):
    """(reference fn, its abstract args, port fn, its meta args) of one
    reduced family's prefill or decode at B = 2, S = 64, f32."""
    jcfg, tcfg = jconfigs.get_config(arch).reduced(), tconfigs.get_config(arch).reduced()
    jm, tm = jlm.build_model(jcfg), tlm.build_model(tcfg)
    jp = jax.eval_shape(lambda: jm.init(jax.random.key(0)))
    tp = _meta_params(tm)
    jb = jinput_specs(jcfg, jconfigs.ShapeSpec("x", S, B, step), dtype=jnp.float32)
    tb = input_specs(tcfg, tconfigs.ShapeSpec("x", S, B, step), dtype=torch.float32)
    if step == "prefill":
        return (lambda p, b: jm.prefill(p, b, S), (jp, jb),
                lambda p, b: tm.prefill(p, b, S), (tp, tb))
    jc = jax.eval_shape(lambda: jm.init_caches(B, S))
    tc = tm.init_caches(B, S, device="meta")
    return (lambda p, c, b: jm.decode_step(p, b["tokens"], c, S - 1), (jp, jc, jb),
            lambda p, c, b: tm.decode_step(p, b["tokens"], c, S - 1), (tp, tc, tb))


@pytest.mark.parametrize("step", ["prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_step_cost_matches_the_reference_jaxpr_cost(arch, step):
    """Every family's reduced prefill and decode: ``dot_flops`` within 1 %
    of the reference's ``jaxpr_cost``."""
    jfn, jargs, tfn, targs = _cells(arch, step)
    ref = jaxpr_cost(jax.make_jaxpr(jfn)(*jargs))
    with torch.no_grad():
        got = step_cost(tfn, *targs)
    print(f"{arch} {step}: ew_flops {got['ew_flops']:.4g} (reference {ref.get('ew_flops', 0):.4g}), "
          f"bytes {got['bytes']:.4g} (reference {ref.get('bytes', 0):.4g})")
    assert got["dot_flops"] > 0
    assert got["dot_flops"] == pytest.approx(ref["dot_flops"], rel=1e-2)


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_cost_matches_the_reference_but_for_the_named_recompute(arch):
    """Every family reduced, AdamW, B = 2, S = 64, remat on: the port's
    products are the reference's plus the loss's recomputed logits
    (2 B S d V over the text positions), within 2 %.  llama also without
    remat, where the same holds, and remat adds only batched products
    (``bmm``): the backward recomputes no projection (``mm``).  whisper
    is held with remat only: the reference's encoder remats either way
    (``_inputs_to_x`` calls ``_encode`` without ``remat``)."""
    jcfg, tcfg = jconfigs.get_config(arch).reduced(), tconfigs.get_config(arch).reduced()
    jm, tm = jlm.build_model(jcfg), tlm.build_model(tcfg)
    jp = jax.eval_shape(lambda: jm.init(jax.random.key(0)))
    tp = _meta_params(tm)
    jb = jinput_specs(jcfg, jconfigs.ShapeSpec("x", S, B, "train"), dtype=jnp.float32)
    tb = input_specs(tcfg, tconfigs.ShapeSpec("x", S, B, "train"), dtype=torch.float32)
    joc, toc = jopt.OptConfig(), topt.OptConfig()
    logits = 2.0 * B * tb["labels"].shape[1] * tcfg.d_model * tcfg.vocab
    ref, got = {}, {}
    for remat in (True, False) if arch == "llama3.2-3b" else (True,):
        step = jtrainer.make_train_step(jm, jtrainer.TrainConfig(opt=joc, remat=remat))
        ref[remat] = jaxpr_cost(jax.make_jaxpr(step)(
            jp, jax.eval_shape(lambda p: jopt.opt_init(p, joc), jp), jb))["dot_flops"]
        got[remat] = step_cost(ttrainer.make_train_step(tm, ttrainer.TrainConfig(
            opt=toc, remat=remat)), tp, topt.opt_init(tp, toc), tb)
        assert got[remat]["dot_flops"] - logits == pytest.approx(ref[remat], rel=2e-2)
        print(f"{arch} train step dot FLOPs (remat {remat}): port {got[remat]['dot_flops']:.6g} "
              f"less the logits {got[remat]['dot_flops'] - logits:.6g}, reference {ref[remat]:.6g}")
    if False in got:
        bmm = {r: got[r]["dot_flops_by_op"]["bmm"] for r in (False, True)}
        assert bmm[True] - bmm[False] == pytest.approx(ref[True] - ref[False], rel=2e-2)
        mm = {r: got[r]["dot_flops"] - bmm[r] for r in (False, True)}
        assert mm[True] == mm[False]


# --------------------------------------------------------------------------
# Collectives on fake process groups, in one subprocess.
# --------------------------------------------------------------------------
_SHARDED = r"""
import dataclasses, json, math, sys
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.dist import hints, make_mesh, all_gather, psum
from repro_torch.dist.sharding import (NamedSharding, PartitionSpec as P, batch_shardings,
                                       cache_shardings, data_axes, device_put,
                                       param_shardings, strip_axes)
from repro_torch.launch.analysis import collective_bytes
from repro_torch.launch.specs import input_specs
from repro_torch.models.lm import build_model
from repro_torch.train._tree import flatten_with_paths, leaves
from repro_torch.train.optimizer import OptConfig, opt_init
from repro_torch.train.trainer import TrainConfig, make_train_step

out = {}
# the reference's parser test: one all-gather of (64,) f32, then seven
# all-reduces of (64,) f32 in a loop, on a group of 2
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
m2 = make_mesh((2,), ("x",), device="cpu")
def parser_case(x):
    all_gather(x, m2, "x")
    for _ in range(7):
        x = psum(x, m2, "x")
out["parser"] = collective_bytes(parser_case, torch.empty((64,), device="meta"))
dist.destroy_process_group()

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
base = get_config("llama3.2-3b").reduced()

def sharded_params(cfg, strip=False):
    model = build_model(cfg)
    with torch.device("meta"):
        params = model._draw(torch.Generator(), torch.float32)
    ps = param_shardings(params, mesh, cfg)
    if strip:
        ps = strip_axes(ps, data_axes(mesh))
    return model, params, ps

for n in (2, 3, 4):
    cfg = dataclasses.replace(base, n_layers=n)
    model, params, ps = sharded_params(cfg)
    oc = OptConfig()
    opt = opt_init(params, oc)
    batch = input_specs(cfg, ShapeSpec("x", 64, 8, "train"), dtype=torch.float32)
    args = device_put((params, opt, batch), (ps, {"mu": ps, "nu": ps, "step": NamedSharding(mesh, P())},
                                             batch_shardings(batch, mesh)))
    with hints.activation_sharding(mesh, anchor=False):
        out[f"train{n}"] = collective_bytes(make_train_step(model, TrainConfig(opt=oc)), *args)

def decode(strip):
    model, params, ps = sharded_params(base, strip)
    caches = model.init_caches(8, 64, device="meta")
    tok = input_specs(base, ShapeSpec("x", 64, 8, "decode"))
    args = device_put((params, caches, tok),
                      (ps, cache_shardings(caches, mesh, base), batch_shardings(tok, mesh)))
    fn = lambda p, c, b: model.decode_step(p, b["tokens"], c, 63)
    with torch.no_grad(), hints.activation_sharding(mesh, anchor=False):
        coll = collective_bytes(fn, *args)
    # what the FSDP layout gathers at least: each data-sharded param whole
    # over "data", still split over "model"
    floor = 0
    for (path, p), s in zip(flatten_with_paths(params), leaves(ps)):
        spec = [e if isinstance(e, tuple) else (e,) for e in s.spec if e is not None]
        if any("data" in e for e in spec):
            split = math.prod(4 for e in spec if "model" in e)
            floor += p.numel() * p.element_size() // split
    return coll, floor

out["decode_fsdp"], out["fsdp_gather_floor"] = decode(False)
out["decode_infer"], _ = decode(True)
dist.destroy_process_group()

# one MoE layer of deepseek-v3-671b at full width, bf16, at decode_32k's
# batch (128 tokens), on the production (16, 16) mesh of 256 ranks
from repro_torch.configs import SHAPES
from repro_torch.launch.analysis import memory_trace
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.moe import moe_ffn
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
mesh = make_production_mesh(device="cpu")
v3 = get_config("deepseek-v3-671b")
with torch.device("meta"):
    layer = moe_ffn.init(torch.Generator(), v3, torch.bfloat16)
x = torch.empty((SHAPES["decode_32k"].global_batch, 1, v3.d_model), dtype=torch.bfloat16,
                device="meta")
for tag, strip in (("fsdp", False), ("stationary", True)):
    ps = param_shardings(layer, mesh, v3)
    if strip:
        ps = strip_axes(ps, data_axes(mesh))
    args = device_put((layer, x), (ps, batch_shardings(x, mesh)))
    with torch.no_grad(), hints.activation_sharding(mesh, data_axes(mesh), anchor=False):
        _, coll, mem = memory_trace(lambda p, x: moe_ffn.forward(p, x, v3), *args)
    out[f"v3_moe_{tag}"] = {"collectives": coll, "memory": mem}
dist.destroy_process_group()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def sharded():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, "-c", _SHARDED], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


def test_collective_bytes_counts_like_the_hlo_parser(sharded):
    """``tests/test_dryrun.py::test_collective_parser_trip_counts`` on a fake
    group of 2: one all-gather of (64,) f32 (its result (128,) f32, 512 B)
    and seven all-reduces of (64,) f32 in a loop (64 x 4 x 7 B, count 7)."""
    got = sharded["parser"]
    assert got["bytes"]["all-gather"] == 128 * 4
    assert got["bytes"]["all-reduce"] == 64 * 4 * 7
    assert got["count"]["all-reduce"] == 7 and got["count"]["all-gather"] == 1
    assert got["total"] == 128 * 4 + 64 * 4 * 7


def test_train_step_gathers_grow_with_depth(sharded):
    """The reduced llama's FSDP x TP train step on a fake (2, 4) group: the
    all-gathers (the FSDP unshard of each unit's params, forward,
    recompute and backward) grow linearly with depth: 2 against 4 layers
    differ by twice what one layer adds."""
    c = {n: sharded[f"train{n}"] for n in (2, 3, 4)}
    for key in ("count", "bytes"):
        one = c[3][key]["all-gather"] - c[2][key]["all-gather"]
        assert one > 0
        assert c[4][key]["all-gather"] - c[2][key]["all-gather"] == 2 * one
    assert c[4]["count"].get("reduce-scatter", 0) > 0  # the FSDP grads


def test_weight_stationary_decode_moves_fewer_gathered_bytes(sharded):
    """``--infer-params`` (params over "model" only) against the FSDP
    layout on the same decode: fewer all-gather bytes, by at least the
    data-sharded params' gathers."""
    fsdp = sharded["decode_fsdp"]["bytes"].get("all-gather", 0)
    infer = sharded["decode_infer"]["bytes"].get("all-gather", 0)
    assert sharded["fsdp_gather_floor"] > 0
    assert fsdp - infer >= sharded["fsdp_gather_floor"], (fsdp, infer)


def test_dryrun_pdx_collectives_match_the_analytic_count(tmp_path):
    """``dryrun_pdx`` on the (16, 16) mesh, all six variants: every record
    ``ok``, and its collectives as counted here.  A block variant merges
    with two all-gathers (dists, ids) of 256 x 128 x 10 4-byte values;
    ``dim`` sums each of its 768 local tiles' (128, 8192) f32 partial
    distances with one psum over "model" and gathers over "data" (16).
    The batched product's FLOPs are 2 Q D N over the padded corpus."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun_pdx", "--mesh",
                          "single_pod", "--out", str(tmp_path)], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-2000:]
    Q, K, n_parts, C, D = 128, 10, 12288, 8192, 1536
    gather = Q * K * 4
    for variant in ["block", "dim", "block_matmul", "block_matmul_bf16",
                    "block_matmul_int8", "block_pruned"]:
        rec = json.loads((tmp_path / f"pdx-search-{variant}__batch128__single_pod.json")
                         .read_text())
        assert rec["status"] == "ok" and rec["n_devices"] == 256, rec
        coll = rec["collectives"]
        if variant == "dim":
            assert coll["count"] == {"all-reduce": 768, "all-gather": 2}
            assert coll["bytes"] == {"all-reduce": 768 * Q * C * 4,
                                     "all-gather": 2 * 16 * gather}
        else:
            assert coll["count"] == {"all-gather": 2}
            assert coll["bytes"] == {"all-gather": 2 * 256 * gather}
        if "matmul" in variant:
            assert rec["jaxpr_cost"]["dot_flops"] == 2.0 * Q * D * C * n_parts
        assert rec["memory"]["peak_memory_in_bytes"] >= rec["memory"]["argument_size_in_bytes"]
        assert math.isclose(rec["params_total"], 100_000_000 * D)


def test_deepseek_v3_moe_layer_holds_only_its_own_experts(sharded):
    """deepseek-v3-671b's MoE layer alone at full width (256 experts of
    3 x 7168 x 2048, bf16) at decode_32k's 128 tokens on the (16, 16) mesh
    of a fake group of 256: rank 0's peak stays below twice its E/m share
    of the routed experts, 2 x 1.41 GB, in the FSDP layout (its block
    gathered over "data" only) and the weight-stationary one (its block
    held whole); gathering every expert whole would take 22.5 GB.  In the
    weight-stationary layout the step gathers less than one expert's
    bytes: no expert weight at all."""
    E, d, f, m = 256, 7168, 2048, 16
    expert = 3 * d * f * 2
    share = E // m * expert
    for tag in ("fsdp", "stationary"):
        rec = sharded[f"v3_moe_{tag}"]
        peak = rec["memory"]["peak_memory_in_bytes"]
        assert share < peak < 2 * share, (tag, peak, share)
        print(f"v3 MoE layer, {tag}: peak {peak:.4g} B, collectives {rec['collectives']}")
    gathered = sharded["v3_moe_stationary"]["collectives"]["bytes"].get("all-gather", 0)
    assert gathered < expert, gathered
