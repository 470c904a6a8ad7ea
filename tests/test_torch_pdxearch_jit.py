"""repro_torch's shape-static masked PDXearch (``pdxearch_jit``, the
``jit-masked`` executor) and ``pdx_partial`` against the reference's, on
the CPU.

Mirrors ``tests/test_pdxearch.py::test_jit_mode_matches_adaptive_mode_exact``
and adds port-against-reference cases on one store: every pruner, metric
and boundary schedule, with and without ``SearchStats``.  Tolerances: ids
equal, except a swap between neighbours whose reference distances lie
within 1e-5 relative of each other (``assert_same_results``); distances
allclose at rtol 1e-4 / atol 1e-3; ``SearchStats`` equal exactly (the
reference counts the values computed in f32, and so does the port).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.distance import pdx_partial as j_pdx_partial
from repro.core.engine import SearchSpec as JSpec
from repro.core.engine import VectorSearchEngine as JEngine
from repro.core.layout import build_flat_store as j_build_flat_store
from repro.core.pdxearch import SearchStats as JStats
from repro.core.pdxearch import pdxearch_jit as j_pdxearch_jit
from repro.core.pruners import make_bond as j_make_bond
from repro.core.pruners import pca_components
from repro.data.synthetic import make_dataset
from repro_torch.convert import engine_from_arrays
from repro_torch.core import VectorSearchEngine as CoreEngine
from repro_torch.core import pdxearch_jit as core_pdxearch_jit
from repro_torch.core.distance import pdx_partial
from repro_torch.core.engine import SearchSpec, VectorSearchEngine
from repro_torch.core.layout import build_flat_store
from repro_torch.core.pdxearch import SearchStats, pdxearch, pdxearch_jit
from repro_torch.core.pruners import make_bond

from test_torch_engine import assert_same_results, ref_arrays

CPU = dict(device="cpu")


def test_jit_mode_matches_adaptive_mode_exact():
    X, Q = make_dataset(1500, 24, "skewed", n_queries=3, seed=9)
    store = build_flat_store(X, capacity=256, **CPU)
    pruner = make_bond(store.dim_means, **CPU)
    jstore = j_build_flat_store(X, capacity=256)
    jpruner = j_make_bond(jstore.dim_means)
    for q in Q:
        a = pdxearch(store, torch.from_numpy(q), 5, pruner)
        b = pdxearch_jit(store, torch.from_numpy(q), 5, pruner)
        np.testing.assert_allclose(
            np.sort(a.dists.numpy()), np.sort(b.dists.numpy()), rtol=1e-4
        )
        assert set(a.ids.tolist()) == set(b.ids.tolist())
        want = j_pdxearch_jit(jstore, jnp.asarray(q), 5, jpruner)
        assert_same_results(np.asarray(want.ids), np.asarray(want.dists),
                            b.ids.numpy(), b.dists.numpy())


@pytest.fixture(scope="module")
def engines():
    """A reference engine per pruner on one flat store with PAD lanes
    (1000 rows at capacity 128), and the port engine carried over."""
    X, Q = make_dataset(1000, 40, "skewed", n_queries=3, seed=13)
    out = {}
    for name in ("linear", "adsampling", "bsa", "bond"):
        je = JEngine.build(X, pruner=name, capacity=128)
        arrays = ref_arrays(je)
        if name == "bsa":
            comps, eig = pca_components(X)
            arrays.update(components=comps, eigval=eig, bsa_m=3.0)
        out[name] = (je, engine_from_arrays(arrays, **CPU), Q)
    return out


CASES = [
    ("linear", "l2", "adaptive"), ("linear", "ip", "adaptive"),
    ("linear", "l1", "fixed"), ("adsampling", "l2", "adaptive"),
    ("adsampling", "l2", "fixed"), ("bsa", "l2", "adaptive"),
    ("bond", "l2", "adaptive"), ("bond", "l1", "fixed"),
]


@pytest.mark.parametrize("pruner,metric,schedule", CASES)
def test_jit_masked_matches_reference(engines, pruner, metric, schedule):
    je, te, Q = engines[pruner]
    spec = dict(k=5, metric=metric, schedule=schedule, delta_d=16,
                executor="jit-masked")
    js, ts = JStats(), SearchStats()
    want = je.search(Q, JSpec(**spec), stats=js)
    got = te.search(Q, SearchSpec(**spec), stats=ts)
    assert got.plan.executor == want.plan.executor == "jit-masked"
    assert_same_results(want.ids, want.dists, got.ids, got.dists)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert 0 < ts.values_computed <= ts.values_total


def test_prefer_static_plans_the_masked_path(engines):
    je, te, Q = engines["adsampling"]
    spec = SearchSpec(k=5, prefer_static=True)
    p = te.plan(Q[0], spec)
    assert p.executor == "jit-masked" == je.plan(Q[0], JSpec(k=5, prefer_static=True)).executor
    assert p.reason.startswith("prefer_static")
    # a batch on a flat store takes the matmul scan, as the reference plans
    assert te.plan(Q, spec).executor == "batch-matmul"
    res = te.search(Q[0], spec)
    assert res.plan.executor == "jit-masked" and res.ids.shape == (5,)


def test_jit_masked_refuses_an_ivf_engine():
    X, Q = make_dataset(600, 16, "clustered", n_queries=2, seed=3)
    eng = VectorSearchEngine.build(X, index="ivf", pruner="linear",
                                   capacity=64, nlist=4, **CPU)
    # the planner keeps prefer_static IVF queries on the routed path
    assert eng.plan(Q[0], SearchSpec(prefer_static=True)).executor == "adaptive"
    with pytest.raises(ValueError, match="no IVF routing"):
        eng.search(Q[0], SearchSpec(executor="jit-masked"))


@pytest.mark.parametrize("metric", ["l2", "ip", "l1"])
def test_pdx_partial_matches_reference(metric):
    rng = np.random.default_rng(4)
    T = rng.standard_normal((24, 130)).astype(np.float32)
    q = rng.standard_normal(24).astype(np.float32)
    acc = rng.standard_normal(130).astype(np.float32)
    for d0, d1 in ((0, 2), (2, 14), (14, 24)):
        want = j_pdx_partial(jnp.asarray(T), jnp.asarray(q), d0, d1,
                             jnp.asarray(acc), metric)
        got = pdx_partial(torch.from_numpy(T), torch.from_numpy(q), d0, d1,
                          torch.from_numpy(acc), metric)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-5)


def test_core_reexports_the_reference_names():
    """``repro_torch.core`` exports what ``repro.core`` exports."""
    import repro.core as jcore
    import repro_torch.core as tcore

    names = [n for n in dir(jcore) if not n.startswith("_")
             and not isinstance(getattr(jcore, n), type(jcore))]
    assert set(names) <= set(tcore.__all__)
    for n in names:
        assert getattr(tcore, n) is not None
    assert CoreEngine is VectorSearchEngine and core_pdxearch_jit is pdxearch_jit
