"""The port's LM serving (``repro_torch.serve.engine.GenerationEngine``) and
retrieval-augmented pipeline (``repro_torch.serve.rag.RagPipeline``)
against the reference's, on the CPU.

Both packages serve the same reduced model: the reference's ``jax.random``
weights carried across with ``convert.lm_params_from_arrays``.  Held:
greedy tokens equal token for token; ``embed`` within 1e-5 + 1e-5 |ref|
(f32, the same sums in another order); the documents' embeddings and the
store's PDX tiles within 1e-4 + 1e-4 |ref| (the rotation multiplies them
once more); retrieved ids, answered tokens and doc ids equal.  Temperature
sampling draws from a ``torch.Generator``, not ``jax.random``: it is held to
determinism per seed, range and shape only.  The reference's three RAG
cases (``tests/test_serve.py``) are mirrored on the port.  On the CPU a
batch of queries plans ``batch-matmul`` and a single one ``adaptive`` in
both packages; on the card the port plans ``fused-batch`` and
``fused-scan`` (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.models.lm import build_model as jbuild
from repro.serve.engine import GenerationEngine as JEngine
from repro.serve.rag import RagPipeline as JRag
from repro.serve.rag import _embed_docs as j_embed_docs
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_arrays
from repro_torch.models.lm import build_model
from repro_torch.obs import metrics
from repro_torch.serve import GenerationEngine, RagPipeline
from repro_torch.serve.rag import _embed_docs

ROOT = Path(__file__).resolve().parents[1]
EMBED_TOL = dict(rtol=1e-5, atol=1e-5)
STORE_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def engines():
    """Per (arch, cache_len): the reference's engine and the port's on the
    CPU holding the same weights."""
    out = {}

    def get(arch="llama3.2-3b", cache_len=64):
        if (arch, cache_len) not in out:
            cfg = jget_config(arch).reduced()
            jm = jbuild(cfg)
            jp = jm.init(jax.random.key(0))
            tcfg = get_config(arch).reduced()
            tp = lm_params_from_arrays(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
            out[arch, cache_len] = (
                cfg, JEngine(model=jm, params=jp, cache_len=cache_len),
                GenerationEngine(model=build_model(tcfg), params=tp, cache_len=cache_len))
        return out[arch, cache_len]
    return get


def tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


# -------------------------------------------------------------- generation
@pytest.mark.parametrize("arch", ["llama3.2-3b", "gemma-2b"])
def test_greedy_generation_equals_the_reference(engines, arch):
    cfg, jeng, teng = engines(arch)
    batch = {"tokens": tokens(0, (3, 8), cfg.vocab)}
    want = jeng.generate(batch, max_new_tokens=5)
    got = teng.generate(batch, max_new_tokens=5)
    assert got.shape == (3, 5) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(teng.generate(batch, max_new_tokens=5), got)


def test_temperature_sampling_is_deterministic_per_seed(engines):
    cfg, _, teng = engines()
    batch = {"tokens": tokens(1, (2, 8), cfg.vocab)}
    a = teng.generate(batch, max_new_tokens=4, temperature=1.0, seed=7)
    b = teng.generate(batch, max_new_tokens=4, temperature=1.0, seed=7)
    c = teng.generate(batch, max_new_tokens=4, temperature=1.0, seed=8)
    assert a.shape == (2, 4)
    assert (a >= 0).all() and (a < cfg.vocab).all()
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_generate_refuses_a_cache_too_small(engines):
    cfg, _, teng = engines()
    with pytest.raises(ValueError, match="cache too small"):
        teng.generate({"tokens": tokens(2, (1, 60), cfg.vocab)}, max_new_tokens=5)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "gemma-2b"])
def test_embed_matches_the_reference(engines, arch):
    cfg, jeng, teng = engines(arch)
    batch = {"tokens": tokens(3, (4, 10), cfg.vocab)}
    got = teng.embed(batch)
    assert got.shape == (4, cfg.d_model) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(jeng.embed(batch)), **EMBED_TOL)


# --------------------------------------------------------------------- RAG
@pytest.mark.parametrize("pruner", ["bond", "adsampling"])
def test_rag_store_retrieve_and_answer_match_the_reference(engines, pruner):
    cfg, jeng, teng = engines(cache_len=96)
    docs = tokens(5, (40, 12), cfg.vocab)
    np.testing.assert_allclose(_embed_docs(teng, docs), j_embed_docs(jeng, docs),
                               **EMBED_TOL)
    jrag = JRag.build(jeng, docs, pruner=pruner, index="flat", retrieve_k=3)
    trag = RagPipeline.build(teng, docs, pruner=pruner, index="flat", retrieve_k=3,
                             device="cpu")
    assert trag.store.device.type == "cpu"
    np.testing.assert_allclose(trag.store.store.data.numpy(),
                               np.asarray(jrag.store.store.data), **STORE_TOL)
    np.testing.assert_array_equal(trag.store.store.ids.numpy(),
                                  np.asarray(jrag.store.store.ids))
    q = {"tokens": tokens(6, (4, 8), cfg.vocab)}
    for batch in (q, {"tokens": q["tokens"][:1]}, {"tokens": docs[[3, 17, 29]]}):
        np.testing.assert_array_equal(trag.retrieve(batch), jrag.retrieve(batch))
    out, ids = trag.answer(q, max_new_tokens=4)
    want_out, want_ids = jrag.answer(q, max_new_tokens=4)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(out, want_out)


def test_rag_pipeline_end_to_end(engines):
    cfg, _, eng = engines(cache_len=96)
    rng = np.random.default_rng(2)
    docs = rng.integers(0, cfg.vocab, (20, 12)).astype(np.int32)
    rag = RagPipeline.build(eng, docs, pruner="bond", index="flat", retrieve_k=2,
                            device="cpu")
    q = {"tokens": rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32)}
    out, doc_ids = rag.answer(q, max_new_tokens=4)
    assert out.shape == (2, 4)
    assert doc_ids.shape == (2, 2)
    assert (doc_ids >= 0).all() and (doc_ids < 20).all()


def test_rag_retrieves_self_document(engines):
    """A query identical to a stored doc must retrieve that doc (exact BOND)."""
    cfg, _, eng = engines(cache_len=96)
    rng = np.random.default_rng(3)
    docs = rng.integers(0, cfg.vocab, (16, 10)).astype(np.int32)
    rag = RagPipeline.build(eng, docs, pruner="bond", index="flat", retrieve_k=1,
                            device="cpu")
    ids = rag.retrieve({"tokens": docs[5:6]})
    assert ids[0, 0] == 5


def test_rag_add_documents_live(engines):
    """Documents added after build are retrievable immediately (write-head),
    with ids that keep indexing doc_tokens, as in the reference."""
    cfg, jeng, eng = engines(cache_len=96)
    rng = np.random.default_rng(4)
    docs = rng.integers(0, cfg.vocab, (12, 10)).astype(np.int32)
    rag = RagPipeline.build(eng, docs, pruner="bond", index="flat", retrieve_k=1,
                            device="cpu")
    extra = rng.integers(0, cfg.vocab, (3, 10)).astype(np.int32)
    new_ids = rag.add_documents(extra)
    assert new_ids.tolist() == [12, 13, 14]
    assert rag.doc_tokens.shape == (15, 10)
    ids = rag.retrieve({"tokens": extra[1:2]})
    assert ids[0, 0] == 13
    out, doc_ids = rag.answer({"tokens": extra[1:2]}, max_new_tokens=2)
    assert doc_ids[0, 0] == 13 and out.shape == (1, 2)
    jrag = JRag.build(jeng, docs, pruner="bond", index="flat", retrieve_k=1)
    assert jrag.add_documents(extra).tolist() == new_ids.tolist()
    want_out, want_ids = jrag.answer({"tokens": extra[1:2]}, max_new_tokens=2)
    np.testing.assert_array_equal(doc_ids, want_ids)
    np.testing.assert_array_equal(out, want_out)
    assert rag.add_documents(np.zeros((0, 10), np.int32)).shape == (0,)


def test_retrievals_are_counted_by_executor(engines):
    from repro.obs import metrics as jmetrics

    cfg, jeng, eng = engines(cache_len=96)
    docs = tokens(7, (24, 10), cfg.vocab)
    rag = RagPipeline.build(eng, docs, pruner="adsampling", device="cpu")
    jrag = JRag.build(jeng, docs, pruner="adsampling")
    reg = metrics.get_registry()
    name = "repro_rag_retrievals_total"
    metrics.set_enabled(True)
    jmetrics.set_enabled(True)
    try:
        for batch in ({"tokens": docs[:5]}, {"tokens": docs[7:8]}):
            executor = jrag.store.plan(jeng.embed(batch)).executor
            j_before = jmetrics.get_registry().get(name, executor=executor)
            before = reg.get(name, executor=executor)
            rag.retrieve(batch)
            jrag.retrieve(batch)
            assert reg.get(name, executor=executor) - before == len(batch["tokens"])
            assert jmetrics.get_registry().get(name, executor=executor) - j_before == len(
                batch["tokens"])
    finally:
        metrics.set_enabled(False)
        jmetrics.set_enabled(False)


def test_rag_store_lives_on_the_lm_device(engines):
    cfg, _, eng = engines(cache_len=96)
    with pytest.raises(ValueError, match="one device"):
        RagPipeline.build(eng, tokens(8, (4, 6), cfg.vocab), device="meta")


def test_serve_cli_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "gemma-2b", "--reduced",
         "--requests", "2", "--max-new", "3", "--rag", "--device", "cpu"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert "RAG answered 2 reqs" in run.stdout
    assert "on cpu: generated (2, 3) tokens" in run.stdout
