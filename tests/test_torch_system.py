"""End-to-end on the port, as ``tests/test_system.py`` runs the reference:
train -> checkpoint -> resume -> serve -> retrieval-augmented answer,
through the public entry points, on the CPU (``device="cpu"``)."""
import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch.train import main as train_main
from repro_torch.launch.train import train_loop
from repro_torch.models.lm import build_model
from repro_torch.serve.engine import GenerationEngine
from repro_torch.serve.rag import RagPipeline
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import OptConfig, opt_init


def test_train_checkpoint_resume_serve_rag(tmp_path):
    ckpt_dir = str(tmp_path / "ck")

    # 1) train a reduced llama a few steps with checkpointing
    out1 = train_loop(
        "llama3.2-3b", reduced=True, steps=12, batch=2, seq=32,
        lr=5e-3, ckpt_dir=ckpt_dir, ckpt_every=6, log_every=100, device="cpu",
    )
    assert np.isfinite(out1["final_loss"])
    assert ckpt.all_steps(ckpt_dir) == [6, 12]

    # 2) resume from the checkpoint and keep training — loss stays finite
    #    and the loop picks up at the saved step
    out2 = train_loop(
        "llama3.2-3b", reduced=True, steps=16, batch=2, seq=32,
        lr=5e-3, ckpt_dir=ckpt_dir, ckpt_every=100, log_every=100, device="cpu",
    )
    assert len(out2["history"]) == 4  # 16 - 12 resumed steps
    assert np.isfinite(out2["final_loss"])

    # 3) serve the trained weights with the paper's retrieval in front
    cfg = get_config("llama3.2-3b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    step, tree = ckpt.restore(
        ckpt_dir, {"params": params, "opt": opt_init(params, OptConfig())}
    )
    assert step == 12 and int(tree["opt"]["step"]) == 12
    assert not torch.equal(tree["params"]["embed"], params["embed"])  # trained
    eng = GenerationEngine(model=model, params=tree["params"], cache_len=96)
    rng = np.random.default_rng(0)
    docs = rng.integers(0, cfg.vocab, (12, 10)).astype(np.int32)
    rag = RagPipeline.build(eng, docs, pruner="bond", device="cpu")
    q = {"tokens": rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32)}
    answer, doc_ids = rag.answer(q, max_new_tokens=4)
    assert answer.shape == (2, 4)
    assert (doc_ids >= 0).all()
    again, again_ids = rag.answer(q, max_new_tokens=4)
    np.testing.assert_array_equal(again, answer)
    np.testing.assert_array_equal(again_ids, doc_ids)


def test_the_train_cli_runs_on_the_cpu(capsys):
    train_main(["--arch", "llama3.2-3b", "--reduced", "--steps", "3", "--batch", "2",
                "--seq", "16", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[train] step 0 loss" in out and "[train] done: final_loss=" in out
