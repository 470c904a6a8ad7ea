#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one CUDA card: vector search,
the served LM with retrieval through it, the LM's training, the other
model families' serving and training, and the LM side's mesh layer.

    python3 chip_smoke.py [--n 1000000] [--dim 960] [--seed 0]

Imports only ``torch``, ``numpy`` and the port (``src/repro_torch``), never
JAX or the JAX package.  Phases, each printing one JSON line:

  1. device — the card's name and power limit, torch/CUDA versions, and
     the build of the CUDA kernels from ``src/repro_torch/kernels/csrc``
     (into the git-ignored ``build/``), with their register counts.
  1b. table4 — the paper's Table 4 on the card: PDX (K4,
     ``ops.pdx_distance_op`` on ``X.T``) against N-ary (K5,
     ``ops.nary_distance_op`` on ``X``) over n = 2^20 standard-normal
     vectors drawn on the card from ``--seed``, at each of the reference's
     dims (``benchmarks/bench_kernels.py:DIMS_FULL``), for l2, ip and l1:
     kernel, plain and library medians with the L2 cache flushed before
     every timed run, the byte bound, parity, and geomean speedups at
     D <= 32, D > 32 and overall, as ``bench_kernels._table4`` reports.
  2. main path — an IVF + ADSampling engine over a clustered collection at
     the shape of the GIST1M dataset (n = 1,000,000, D = 960), capacity
     1024, k = 10; the data is drawn from ``--seed``, the rotation and
     k-means from ``--seed + 1``, so the two share no random draws.  For
     each scan dtype (f32, bf16, int8, int4): 16 single
     queries (``fused-scan``, one K1 launch each) and one batch of 64
     (``fused-batch``, K2), with the launch counters zeroed just before and
     read just after, the executors checked, returned distances checked
     against direct f32 distances of the returned ids, and recall@10
     against a ground truth computed on the card by direct f32
     differences (>= 0.95 for fused-scan, >= 0.99 for fused-batch at
     f32/bf16/int8; recorded at int4, see RECALL_FLOORS).  Then
     ``fused-scan``'s wall per query over WALL_ROUNDS rounds of the 16
     queries per dtype, after the counters were read (phase
     ``fused_scan_wall``).
  3. cascade — the same engine through the multi-resolution cascade, for
     each ladder of LADDERS: 16 single queries (``cascade-scan``: K1 on the
     first stage, K3 on the second) and one batch of 64 (``cascade-batch``:
     K2 once per d-tile per stage), counters zeroed just before each and
     read just after, recall@10 >= 0.99 and returned distances exact for
     both, and equal ids on the queries both answer.  Survivors and bytes
     per stage come from the port's own counters.
  4. kernels vs plain — K1, K2 and K3 at every dtype on the engine's own
     mirror, real queries and threshold (K1 and K3 also at thr = +inf and
     at the 1 % quantile of the lanes' full distances, so that lanes die
     at every d-tile; K3's ids are a real previous stage's survivors);
     K1 at ladder A's projection stage (d_tile = rank, eps0 = 0); K2 per
     d-tile in each ``cascade-batch`` stage, on the arguments that stage
     passed on the counted path (also at +inf and the 1 % quantile) —
     against their plain PyTorch
     versions on the same card tensors, with CUDA-event medians of the
     kernel, the whole op (K2), the plain version and (K2) a library
     matmul, and the least time the card could take (bound).  The K1 and
     K3 rows also carry their launch shape (body bulk or direct, lanes
     per block, blocks, shared memory, look-ahead and the most bytes it
     can add; the path's rows must run the bulk body), a lane-level bound
     (the row's ``bound_ms``) beside the partition-level one, the time at
     thr = 0 (the sweep of d-tile 0 alone) and the host's time in the
     wrapper (``host_ms``: Python, ctypes and the library's host code).
     Every kernel time is the device's: the timed run waits behind a 1 ms
     spin of the card, so the host's enqueue is not counted.
     Before it, a ``torch.profiler`` breakdown of the main path's device
     time by kernel at f32 and int8, and of cascade ladder A (where the
     time goes).
  4b. flat_scan (before 4, while the collection is still on the card) —
     the collection in the engine's rotated space as one flat (960, 1M)
     f32 PDX block: for 16 single queries K4 (full l2 distances, from which
     the exact k = 10 threshold) then K6 (``ops.pdx_prune_scan_op``), with
     survivors, recall@10 of the survivors, lanes and 32-byte sectors
     alive entering each d-tile, K6's time against K4's (the paper's
     pruned-vs-full), its sweep alone (thr = 0), the survivors its sweep
     listed and its bound at the lane and the sector level; K6 on
     query 0 also at +inf and the 1 % quantile against its plain version,
     and against K1 on query 0's START partition; K7
     (``ops.batched_distance_op``) for the batch of 64 at f32 and bf16,
     l2 and ip.
  5b. tiered (after 4, on the same engine, before 6) — tiered serving
     beyond device memory (``SearchSpec.hbm_slots``): 256 queries drawn as
     ``benchmarks/bench_tiered.py`` draws them (zipf a = 3 over a seeded
     permutation of the collection's 64 clusters), 16 batches of 16, k =
     10, nprobe = 8, a pool of P // 4 slots (the store at least 4x the
     pool; the routed demand floor asserted to fit).  Per scan dtype (f32
     and int8 held, int4 recorded): a cold pass and a warm pass with K2's
     counter zeroed before and read after (one launch per (chunk, pass)
     step, asserted batch by batch), held to ids equal to a pool of all P
     slots, recall@10 >= 0.99 against the exact top-10 within each query's
     routed buckets (direct f32 differences on the card), exact returned
     distances, no id outside the routed buckets, a warm hit rate >= 0.8,
     and ``sync_uploads`` giving the same ids and misses; recorded: walls
     per batch, hits, misses, evictions, uploaded slots, bytes sent, the
     upload wait and overlap, the worker's host-quantize seconds, the first
     search's set-up, the pool's bytes; for int8 a ``torch.profiler`` view
     of one cold and one warm batch (host quantize and re-rank seconds
     beside it), and K2 on the pool's shape (S slots, B = 16) against its
     plain version at every dtype.  Then ``tiered_tree``: the two-level
     centroid tree on a copy of the index (super_k = max(8, sqrt(nlist)),
     nprobe_super = 4): routing cost below nlist, bucket overlap with flat
     routing >= 0.9, tiered recall against flat-routed tiered >= 0.9.
  5c. serve (after 5e, on the same frozen engine, before 6) — the serving
     tier (``repro_torch.serve.VectorServer``, ``benchmarks/bench_serve.py``'s
     premise at full scale): 64 blocking single-query ``engine.search``
     calls per dtype (the serial rate); then one server (max_batch 64,
     flush window 2 ms) warmed at f32 and int8 (``warmup``), and per dtype,
     with the launch counters zeroed just before: a closed-loop burst of the
     main path's 64 queries (one bucket-64 batch, ids equal to
     ``engine.search`` of the batch), one single query (a bucket of one,
     ids equal to its blocking search), 16 of the queries below served one
     at a time (buckets of one), and 2,048 queries drawn like the main
     path's (``serve_queries``) in an open loop of lognormal gaps at 3x
     the serial rate; held: every future resolves, recall@10 against the
     card's ground truth >= 0.95 on bucket-1 queries (the 16 and the open
     loop's own, so the fused-scan floor, a mean, is taken over at least
     the main path's 16 queries) and >= 0.99 on the rest, exact distances, no set-up after warmup (``obs.setups``), K1 ==
     the bucket-1 batches and K2 == the larger buckets' launches; recorded:
     QPS, p50/p99, QPS over serial and p99 over p50 (bench_serve's 2x and
     5x gates, not held), batches, fill, queue wait, plan and run time per
     bucket, the caching allocator's new segments after warmup, and the
     device's idle share over one profiled second of a second open loop.
     The served cascade (ladder A): ``warmup(specs=[cascade])`` timed, one
     single query and 256 open-loop queries at 3x its serial rate, held to
     recall@10 >= 0.99, exact distances, no set-up, K1, K2 and K3 launched;
     each scan stage's K2 launches read through ``StageRecorder`` on the
     executor thread and held to its d-tiles per ``cascade-batch`` batch.
     The served tiered path (int8, P // 4 slots, nprobe 8, max_batch 16):
     the tiered phase's 256 zipf queries in an open loop at 3x the rate of
     their blocking single-query searches, held to those searches' ids,
     recall@10 within the routed buckets >= 0.99, no id outside them, no
     set-up after warmup; recorded: each upload's host wait against its
     issue-to-complete window (the overlap ``prepare_execute`` buys),
     beside the same on the blocking path (batches of 16 on a fresh pool).
  5d. routing (after 5b, before 5c) — batched bucket routing on the main
     path's index: ``route_batch`` at B = 1, 16 and 64 for each route
     dtype, every row held bit for bit to ``route`` of that query alone,
     and its ms per batch beside the per-query loop through ``route``.
  5e. sharded (after 5d, before 5c) — the broadcast mesh executors on a
     world of one (NCCL, ``repro_torch.dist.make_mesh``) over the main
     path's engine, through ``search(..., mesh=)``:
     ``batch-block-sharded`` at f32 and int8 on the 64 queries bit for
     bit equal to ``batch-matmul`` and
     ``fused-batch`` (K2 counted from 0 around the int8 run and held to
     ``_tile_scan``'s steps), ``block-sharded`` equal to the masked
     PDXearch, ``dim-sharded`` equal to ``batch-matmul`` as sets, one
     all-gather per batch and two per query, walls recorded.  One card
     allows a world of one only.
  5f. routed (after 5e, in the same NCCL world of one) — the bucket-routed
     executors the main path's IVF engine plans on the ("data",) mesh, no
     executor forced: ``routed_bucket`` at f32 and int8, nprobe 8, on the
     64 queries (one exchange round of 64 slots) and on their first 40
     (spilled into two rounds, 32 + 16), held to recall@10 >= 0.99 against
     the exact top-10 within each query's routed buckets, no id outside
     them, exact returned distances, one all-to-all per round and one
     all-gather, K2 counted from 0 (f32 0, int8 ``_tile_scan``'s steps),
     the spilled int8 rows equal to the same rows of the 64; then
     ``routed_tiered`` on 5b's premise (P // 4 slots, the zipf queries in
     batches of 16) at f32 and int8, each batch bit for bit equal to
     ``tiered-scan`` on the same warm cache, one all-gather and one K2
     launch per step; walls beside ``fused-batch``'s and ``tiered-scan``'s,
     the exchange plan and ``routed_batch_bytes`` recorded.
  6. mutable (after 4, on the same engine) — the store made mutable
     (``from_store``: masters to the host, the frozen mirrors dropped),
     5,000 ids drawn from ``--seed`` deleted, 5,000 rows of
     ``make_dataset`` (same kind, ``--seed + 2``) inserted in batches of
     200, so flushes fill the freed slots bucket by bucket; then, with
     live write-head rows: the upload and mirror rebuilds timed, and with
     the counters zeroed just before and read just after, 16 single
     queries (``fused-scan``, K1) and a batch of 64 (``fused-batch``, K2)
     at f32 and int8 and 16 queries through ladder A (``cascade-scan``,
     K1 then K3), held to recall@10 against the live set's ground truth
     (the floors of 2 and 3), exact returned distances and no deleted id;
     16 inserted rows (8 sealed, 8 in the head) queried as themselves must
     come back at rank 0; the write-head merge timed alone; one int8
     ``tiered-scan`` batch of 16 (a pool of P // 4 slots) held to the
     tiered floors, no deleted id.  Then ``compact()`` and the same again
     (the tiered pool must change generation).  Every K1, K2 and K3 must
     launch.
  6b. serve_churn (after 6's ``compact()``, on that mutable store) — a
     server with a maintenance thread (interval CHURN_MAINT_S, head fill
     threshold 0) under f32 and int8 open-loop traffic while a thread runs
     CHURN_CYCLES cycles of inserting CHURN_ROWS standard-normal rows,
     querying each as itself and deleting them; held: a maintenance swap
     adopted, every inserted row its own rank 0 while live, no deleted id
     returned (nor found by the deleted rows queried as themselves),
     recall@10 against the live set at the fused floors; recorded: clone
     and repack seconds, the first batch after the swap, p99 of the
     queries submitted while the swap was made, swaps adopted, discarded,
     rows replayed, set-ups after warmup (a new tiles_version rebuilds its
     mirrors; not held).
  7. jit_masked — a flat ADSampling engine over the first 65,536 rows:
     4 queries with ``prefer_static=True`` plan ``jit-masked`` and return
     the ``adaptive`` executor's ids; both run plain PyTorch on the card.
  8. lm (after 7; the vector engine has left the card) — the served LM,
     ``repro_torch.serve.GenerationEngine`` over llama3.2-3b at full width
     (28 layers, d_model 3072, GQA 24/8 heads, d_ff 8192, vocab 128,256,
     tied embeddings) at f32, the weights drawn on the card from a
     ``torch.Generator`` seeded with ``--seed``: 8 requests of 16 prompt
     tokens, 16 new tokens, ``cache_len`` as ``launch/serve.py`` computes
     it.  Recorded: params and bytes, prefill ms, decode ms per token
     (median over the steps) beside its byte bound, tokens/s, peak device
     memory, one decode step's and one prefill's device time by kernel and
     idle share (``torch.profiler``), and the same generation with bf16
     weights (tokens/s, share of greedy tokens equal to f32's; not held).  Held: two ``generate`` calls
     give equal tokens; prefill + one decode equals the parallel forward at
     rtol 2e-2 / atol 2e-3 (the reference's teacher-forcing test).  The LM
     is plain PyTorch: the reference computes it in plain JAX, with no
     Pallas kernel.
  9. rag (after 8, on its engine) — ``repro_torch.serve.RagPipeline.build``
     over 4,096 documents of 32 tokens (the LM embeds them in chunks of 32;
     a flat ADSampling store of capacity 256 at D = 3072 on the card), then
     ``answer`` on phase 8's requests (``retrieve_k = 1``).  With the launch
     counters zeroed just before each call and read just after: 64 sampled
     documents as one query batch (``fused-batch``, exactly one K2) and 16
     of them one at a time (``fused-scan``, one K1 each); ``answer``'s
     batch of 8 (one K2).  Held: each document retrieves itself at rank 0,
     recall@10 >= 0.99 (batch) and >= 0.95 (single) against a ground truth
     of direct f32 differences on the card, returned distances exact (1e-3
     relative; within K2's rounding scale 1e-5 (||q||^2 + ||x||^2) where
     the distance is 0), the retrieval counter's ``executor`` label,
     ``add_documents`` of 3 documents returning ids 4096-4098 that each
     retrieve themselves, and K1 and K2 at the store's shape against their
     plain versions.  Recorded: embed and store build seconds, retrieve
     and search ms at B = 64 and B = 1, ``answer``'s wall and tokens/s.
  10. train (after 9, on phase 8's params; phase 9's store released) —
     llama3.2-3b at full width trained by ``repro_torch.train``: AdamW
     (lr 1e-4, no warmup) with remat under the reference's policy (the
     products without batch dims saved, the rest recomputed), 8 steps on
     one ``TokenStream(cfg, 256, 8, seed)`` batch placed on the main
     thread.  Held: the chunked loss equals ``F.cross_entropy`` over the
     full logits of the same hidden states at rtol 1e-5, every loss and
     grad norm finite, the last loss below the first, two ``generate``
     calls on the trained params equal, no kernel of the port launched.
     Recorded: the losses, the step's median, least and most ms
     (forward+backward and optimizer apart), tokens/s, the share of the 67
     TFLOP/s f32 peak at 6 N T FLOP, the optimizer beside its byte bound
     (7 x 4 B a param at 3.35 TB/s), peak memory, the last step's device
     profile, the generated tokens that changed from phase 8's.
     ``train_2l``: the same width at 2 layers, B = 8, S = 256:
     ``accum_steps=4`` against 1 (loss and grads rtol 1e-4; at lr 1e-4
     the params' difference's ``global_norm`` < 1e-3, at the reference
     test's lr 1e-3 recorded), remat on against off (grads allclose,
     under deterministic algorithms, the gap recorded), 3 ``compress_grads`` steps
     holding the error-feedback identity within 1e-4, an Adafactor step
     finite.  ``train_reduced``: ``cfg.reduced()`` overfits one batch in
     20 steps by more than 0.5 (AdamW, ``compress_grads``), and
     ``train_loop`` resumed from its ``ckpt_dir`` at step 3 equals the
     uninterrupted 6 steps bit for bit (a subprocess under
     ``torch.use_deterministic_algorithms(True)``).
  11. families (after 10; llama's params and train state freed) — every
     other registered family served through ``GenerationEngine`` at full
     width, f32, one model on the card at a time, params drawn on the card
     from ``--seed``, phase 8's 8 requests of 16 tokens and 16 new:
     deepseek-moe-16b (28 layers unless the card's free memory forces a
     cut), deepseek-v3 cut to 4 layers (its 3 dense layers and 1 MoE
     layer of 256 experts, MLA), jamba cut to 8 (one period: 1 attention
     and 7 Mamba layers, MoE on every second), internvl2-1b (256 patch
     embeddings before the prompt), mamba2-370m, whisper-small (1,500
     encoder frames); each cut is listed in the line's ``reduced``.  Held:
     two ``generate`` calls equal, every logit finite; internvl2, mamba2
     and whisper: prefill of 15 tokens + one decode equals the parallel
     forward (rtol 2e-2 / atol 2e-3); each MoE layer's output in a decode
     step equals a plain loop over each token's top-k experts (plus the
     shared ones) at MOE_RTOL / MOE_ATOL, with no token dropped; one
     full-width MLA layer of deepseek-v3's draw: prefill + the absorbed
     decode equals ``forward_train``.  Recorded: params and bytes, prefill
     ms, decode ms a token beside two byte bounds (every weight once a
     step, what the capacity dispatch reads; the experts the step routes
     to only), tokens/s, peak memory beside what was allocated before,
     the drops at prefill, a decode step's device profile.  No kernel of
     the port runs here: the reference computes these models in plain
     JAX.
  11b. train_families (after 11, before 12) — the other families trained
     at full width, f32, one model on the card at a time, as phase 10
     trains llama (AdamW at lr 1e-4, remat, 8 steps on one ``TokenStream``
     batch of 8 rows, which also draws the patch embeddings and the
     frames): deepseek-moe-16b (its dense layer and 5 MoE layers),
     deepseek-v3 (2 of its 3 dense MLA layers: one MoE layer alone is
     about 11 B params), mamba2-370m (48 layers, at 1024 positions: four
     SSD chunks, so the carried state's backward runs), internvl2-1b (256
     patch embeddings, then 256 text tokens, the loss over the text),
     whisper-small (12 + 12 layers, 1,500 encoder frames); depth cut only,
     by fixed cuts (``TRAIN_FAMILY_LAYERS``) whose 16 B a param (params,
     grads, two moments) leave the card room for the activations, each
     cut in ``reduced`` with its reason.  Held, per family: the chunked loss
     against the full logits at rtol 1e-5, every loss and grad norm
     finite, the last loss below the first, no kernel of the port
     launched, and remat on against off from fresh params at a 2-layer
     cut (whisper 2 + 2, deepseek-moe-16b its dense layer and one MoE
     layer, deepseek-v3 2 dense layers) at phase ``train_2l``'s bar.
     Recorded: params and the params a token reaches, the step's median,
     least and most ms (forward+backward and optimizer apart), tokens/s,
     the share of the f32 peak at 6 N T, the optimizer beside its byte
     bound, peak memory, a profiled step's top device operations and idle
     share, a MoE's drops at the train capacity.  The done line names
     jamba as not trained: one period of its hybrid stack (the least cut
     that keeps its layout) holds 13.27 B params, 212 GB of training
     state.
  12. mesh_lm (after 11b) — the LM side's mesh layer (``dist.sharding``,
     ``hints``, ``pipeline``, ``restore(shardings=)``) on a (1, 1)
     ("data", "model") mesh in an NCCL world of one of its own, llama3.2-3b
     at full width, f32.  Held: the FSDP x TP train step at 2 layers
     (B = 8, S = 256, AdamW at lr 1e-4, remat) on DTensor params,
     optimizer state and batch, the hints active, against the plain step
     from the same params (losses rtol 1e-5, the params' difference's
     ``global_norm`` < 1e-3, every param and moment on its sharding); at
     full depth (28 layers) the weight-stationary layout serves phase 8's
     requests: prefill + 16 greedy decode steps give the plain path's
     tokens; ``pipeline_apply`` over a ("stage",) mesh of one, one
     full-width unit in train mode over 4 microbatches, equals the unit
     applied to each, with 4 ppermutes and 1 psum; ``restore(shardings=)``
     of the trained 2-layer params equals the saved tensors bit for bit on
     the card.  The expert-parallel MoE (``hints.per_experts``):
     deepseek-moe-16b at full width on the same mesh, its experts split
     over "model"; its 2-layer step (f32) held as llama's, its
     weight-stationary decode at full depth in bf16 (28 layers of f32
     params and their DTensor copies do not fit together) giving the
     plain bf16 decode's tokens, every MoE layer through the
     expert-parallel path.  Recorded: whether the sharded step is bit for
     bit the plain one, both step walls, decode ms a token beside the
     plain path's (llama's also beside phase 8's), a sharded llama decode
     step's device profile.
  13. dryrun (after 12) — the port's dry-run (``launch/{specs,analysis,
     dryrun,dryrun_pdx}.py``).  (a) Its CLIs in subprocesses under the
     card's torch, on a fake process group of 256 ranks (meta tensors,
     nothing on the card): DRYRUN_CELLS (llama3.2-3b at ``decode_32k`` and
     ``train_4k``, deepseek-v3-671b at ``decode_32k``),
     and ``dryrun_pdx`` at ``block_matmul_int8`` and ``dim``, held: every
     record ``ok``, FLOPs and a peak above 0, ``dim``'s psums 768.  (b) The
     estimator against the card: llama3.2-3b at full width in bf16, a
     prefill at B = 8, S = 2048 and a decode at B = 8 against a 4096 cache
     with bf16 and with f8 caches: ``step_cost`` and the live-storage
     estimate of the temporaries (peak less the arguments) on meta tensors,
     then the same step on the card: held, the estimate within 25 % of the
     step's ``max_memory_allocated`` above what the arguments hold (after a
     warm-up call); recorded, the step's ms beside the bound the counted
     FLOPs and bytes give, and the f8 decode's greedy agreement with bf16
     over 16 steps from fresh caches.  (c) The paper's workload, one rank of
     256: ``dryrun_pdx``'s per-rank body (``local_fn``) on its real
     (48, 1536, 8192) shard at f32, bf16 and int8 (2.42, 1.21, 0.60 GB),
     Q = 128, its all-gathers over an NCCL world of one: held, the ids and
     distances equal a direct selection over every tile's distances (one
     stable sort), so the tile loop and the merge change no answer;
     recorded, ms beside the bound (154.6 GFLOP, the shard's bytes).  No
     kernel of the port runs here.
  5. the kernels line: one JSON object per kernel and dtype (K4 and K5 by
     metric over the Table 4 sweep, K4 and K6 on the flat block, K7 by
     dtype and metric, K2 on the tiered pool by dtype); the K1, K2 and K3
     rows on the mutable phase's path also carry ``launches_mutable`` (its
     counts before and after ``compact``), the K2 rows ``launches_tiered``
     (phase 5b's cold and warm passes), ``launches_sharded`` (phase 5e's
     batch-block-sharded runs) and ``launches_routed`` (phase 5f's runs;
     K2 at the spilled exchange's 48 rows is a row of its own), and the
     K1, K2 and K3 rows on
     phase 5c's serving path ``launches_serve``; K1 and K2 at the RAG
     store's shape (phase 9, D = 3072, C = 256) are rows of their own,
     with ``launches_rag``.

Then the card's name and power limit (``nvidia-smi``), and as the last
line ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero before the result lines; without a CUDA card, or without the
repository beside it, it exits non-zero at once.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
DTYPES = ("f32", "bf16", "int8", "int4")
N_SINGLE, N_BATCH, K = 16, 64, 10
# recall@10 floors (fused-scan, fused-batch) per scan dtype.  The reference
# holds its fused executors to exact recall at f32/bf16/int8 only; at int4
# with the default rerank_mult = 4 its own fused paths lose neighbours (the
# port returns the reference's ids there, also at D = 960:
# tests/test_torch_width.py), so int4 is held to exact returned distances
# and its recall is recorded.
RECALL_FLOORS = {"f32": (0.95, 0.99), "bf16": (0.95, 0.99),
                 "int8": (0.95, 0.99), "int4": None}

# H100 SXM published peaks (NVIDIA data sheet, dense, at the full 700 W):
# HBM3 bandwidth; f32 on the SIMT cores, the rate of the scans with no
# product and of the elementwise work beside a product; bf16 on the tensor
# cores, the rate of a product of two bf16 operands (exact in its f32
# accumulator, so the tensor cores compute the same function).  A product
# with an f32 operand is held to the card's fastest f32-accurate route, an
# exact bf16 split on the tensor cores (TF32 would change the function, and
# f32 SIMT is slower): 989/3 where the other operand is exact in bf16 (bf16
# tiles, int8/int4 levels with the scale folded into the queries), three
# passes of the three query planes; 989/6 for f32 x f32, six passes.  These
# are the routes K2 and K7 take, so no share of theirs can pass 100 %.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_SPLIT3_FLOPS = PEAK_BF16_FLOPS / 3
PEAK_SPLIT6_FLOPS = PEAK_BF16_FLOPS / 6

K1_SOURCE = "src/repro_torch/kernels/csrc/pdx_scan.cu"
K1_REPLACES = "src/repro/kernels/pdx_scan.py:236"
K2_SOURCE = "src/repro_torch/kernels/csrc/batched_matmul.cu"
K2_REPLACES = "src/repro/kernels/batched_matmul.py:124"
K3_SOURCE = K1_SOURCE
K3_REPLACES = "src/repro/kernels/pdx_scan.py:366"
K4_SOURCE = K1_SOURCE
K4_REPLACES = "src/repro/kernels/pdx_scan.py:66"
K5_SOURCE = "src/repro_torch/kernels/csrc/nary_scan.cu"
K5_REPLACES = "src/repro/kernels/nary_scan.py:41"
K6_SOURCE = K1_SOURCE
K6_REPLACES = "src/repro/kernels/pdx_scan.py:133"
K7_SOURCE = K2_SOURCE
K7_REPLACES = "src/repro/kernels/batched_matmul.py:49"

# Table 4 (benchmarks/bench_kernels.py:DIMS_FULL and _table4): PDX vs N-ary
TABLE4_N = 1 << 20
TABLE4_DIMS = (8, 16, 32, 64, 128, 192, 256, 384, 512, 768, 1024, 1536)
TABLE4_METRICS = ("l2", "ip", "l1")
L2_CACHE_BYTES = 50 * 2**20  # H100 SXM
SPIN_CYCLES = 2_000_000  # about 1 ms of the card's clock, ahead of a timed run
WALL_ROUNDS = 8  # rounds of the 16 single queries behind each fused-scan wall

# cascade ladders: A is the reference's own benchmark ladder
# (benchmarks/bench_cascade.py), B a full-dimension one
LADDERS = {"A": ("proj32:int8", "int4", "f32"), "B": ("bf16", "int8", "f32")}
CASCADE_RECALL_FLOOR = 0.99

# phase mutable: ids deleted, rows inserted (in batches), inserted rows
# queried as themselves (10,000 and 10,000 until the LM phases came: the
# inserts' fallback repacks are host-bound, about 190 s of the script);
# phase jit_masked: rows of its flat engine, queries
MUT_DELETE, MUT_INSERT, MUT_BATCH, MUT_SELF = 5_000, 5_000, 200, 16
MASKED_ROWS, MASKED_QUERIES = 65_536, 4

# phase tiered (benchmarks/bench_tiered.py's serving premise): queries, batch,
# zipf exponent of the hot clusters, probes; f32 and int8 held to the floors,
# int4 recorded; the two-level tree's descent and its floors
TIERED_QUERIES, TIERED_BATCH, TIERED_ZIPF, TIERED_NPROBE = 256, 16, 3.0, 8
TIERED_DTYPES, TIERED_HELD, TIERED_PROFILE_DTYPE = ("f32", "int8", "int4"), ("f32", "int8"), "int8"
TIERED_RECALL_FLOOR, TIERED_HIT_FLOOR = 0.99, 0.8
TREE_NPROBE_SUPER, TREE_OVERLAP_FLOOR, TREE_RECALL_FLOOR = 4, 0.9, 0.9

# phase serve (benchmarks/bench_serve.py's premise at the main path's scale):
# serial queries, open-loop queries (lognormal gaps at SERVE_RATE_X times
# the serial rate), the cascade's open-loop queries, batch caps, flush
# window, admission queue depth (deep enough that nothing is rejected);
# recall floors of the queries served in a bucket of one (fused-scan) and
# in larger buckets (fused-batch); the profiled window
SERVE_SERIAL, SERVE_OPEN, SERVE_CASCADE_OPEN, SERVE_RATE_X = 64, 2048, 256, 3.0
SERVE_MAX_BATCH, SERVE_TIERED_MAX_BATCH, SERVE_FLUSH_S, SERVE_QUEUE_DEPTH = 64, 16, 0.002, 8192
SERVE_DTYPES, SERVE_RECALL_FLOORS, SERVE_PROFILE_S = ("f32", "int8"), (0.95, 0.99), 1.0
# phase serve_churn (bench_serve's CHURN_ROWS): rows inserted then deleted
# per cycle, cycles, the gap after each, the maintenance interval, and how
# long the traffic may wait for a swap after the churn
CHURN_ROWS, CHURN_CYCLES, CHURN_GAP_S, CHURN_MAINT_S, CHURN_SWAP_WAIT_S = 8, 48, 0.5, 10.0, 180.0
# phase routing: route dtypes, batch sizes, timed repetitions (the fastest
# kept); phase sharded: the per-query executors' queries
ROUTING_DTYPES, ROUTING_BATCHES, ROUTING_REPS = ("f32", "bf16", "int8", "int4"), (1, 16, 64), 3
SHARDED_SINGLE = 4
# phase routed: the spilled batch (40 rows of one rank's demand spill into
# two exchange rounds, 32 + 16) and the recall floor within the routed buckets
ROUTED_SPILL, ROUTED_RECALL_FLOOR = 40, 0.99
# phases lm and rag: the served LM at full width (f32, the reference
# launcher's dtype), its requests, prompt and new tokens (cache_len as
# ``launch/serve.py`` computes it); the RAG store's documents, their length,
# the retrieval batch, the single queries, the documents added live, the
# timed repetitions and the recall floors (fused-scan, fused-batch: the main
# path's); the prefill + decode tolerance of the reference's teacher-forcing
# test (tests/test_models_smoke.py)
LM_ARCH, LM_REQUESTS, LM_PROMPT, LM_NEW = "llama3.2-3b", 8, 16, 16
RAG_DOCS, RAG_DOC_LEN, RAG_BATCH, RAG_SINGLE, RAG_ADD, RAG_REPS = 4096, 32, 64, 16, 3, 5
RAG_RECALL_FLOORS = (0.95, 0.99)
TEACHER_RTOL, TEACHER_ATOL = 2e-2, 2e-3
# phase train: the full-width batch, sequence, steps and learning rate
# (AdamW, no warmup, remat on); the chunked loss's tolerance against the
# full logits; the 2-layer phase's accumulation bars (the reference's,
# tests/test_train.py), compressed steps and error-feedback bar; the
# reduced config's overfit steps and the loss drop they must reach;
# AdamW's bytes a param (read p, g, mu, nu; write p, mu, nu; f32)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 8, 256, 8, 1e-4
CE_RTOL, ACCUM_RTOL, ACCUM_PARAM_BAR, ACCUM_REF_LR = 1e-5, 1e-4, 1e-3, 1e-3
EF_STEPS, EF_BAR = 3, 1e-4
OVERFIT_STEPS, OVERFIT_DROP = 20, 0.5
OPT_BYTES_PER_PARAM = 7 * 4
# phase families: the other model families served at full width (f32, the
# lm phase's requests, prompt and new tokens), deepest first while the card
# is emptiest; the depth cuts that memory forces (deepseek-v3: its 3 dense
# layers and 1 MoE layer; jamba: one period of 8), and the headroom a model
# leaves free beyond its params (a deeper model is cut further to keep it;
# deepseek-moe-16b's phase peaked 0.56 GB above its 65.5 GB of params on
# the card, and 68.8 GB were free after the train phases);
# the teacher-forcing holds (the MoE models' prefill and decode get other
# capacities, so they may drop other tokens: each MoE layer's decode output
# is held to a plain loop over its top-k experts instead, at MOE_RTOL /
# MOE_ATOL: the same f32 products, one token at a time)
FAMILY_ARCHS = ("deepseek-moe-16b", "deepseek-v3-671b", "jamba-v0.1-52b", "internvl2-1b",
                "mamba2-370m", "whisper-small")
FAMILY_LAYERS = {"deepseek-v3-671b": 4, "jamba-v0.1-52b": 8}
FAMILY_HEADROOM_BYTES = 2e9
FAMILY_TEACHER = ("internvl2-1b", "mamba2-370m", "whisper-small")
MOE_RTOL, MOE_ATOL = 1e-4, 1e-5
# phase train_families: the other families trained at full width (f32,
# AdamW at TRAIN_LR, remat, TRAIN_STEPS steps on one batch), one model on
# the card at a time, depth cut (TRAIN_FAMILY_LAYERS, fixed, as
# FAMILY_LAYERS is) so that params, grads and two moments
# (TRAIN_BYTES_PER_PARAM) leave room on the card for the activations, the
# chunked loss and the optimizer's temporaries: deepseek-moe-16b its dense
# layer and 5 MoE layers (3.44 B params, 55 GB); deepseek-v3 2 of its 3
# dense MLA layers (3.02 B params, 48 GB; one of its MoE layers alone is
# about 11 B params, 180 GB of training state); mamba2 trains at 1024 positions,
# four SSD chunks, so the carried state's backward runs; a VLM's TRAIN_SEQ
# text tokens follow its patch embeddings.  jamba is not trained: one
# period of its hybrid stack is the least cut that keeps its layout
TRAIN_FAMILY_ARCHS = ("deepseek-moe-16b", "deepseek-v3-671b", "mamba2-370m", "internvl2-1b",
                      "whisper-small")
TRAIN_FAMILY_LAYERS = {"deepseek-moe-16b": {"n_layers": 6},
                       "deepseek-v3-671b": {"n_layers": 2, "n_dense_layers": 2}}
TRAIN_FAMILY_SEQ = {"mamba2-370m": 1024}
TRAIN_FAMILY_UNTRAINED = "jamba-v0.1-52b"
TRAIN_BYTES_PER_PARAM = 16
# phase 12 (mesh_lm): the expert-parallel MoE at full width; its decode in
# bf16 at full depth, since 28 layers of f32 params (65.6 GB) and their
# DTensor copies do not fit on the card together
MESH_MOE_ARCH, MESH_MOE_DTYPE = "deepseek-moe-16b", "bfloat16"
# phase 12 (mesh_lm): the head-split paths at full width, f32, a 2-layer
# step each: the Mamba2 mixer by blocks of heads, and deepseek-v3's first 2
# (dense) MLA layers, as phase train_families cuts it
MESH_TP_ARCHS = ("mamba2-370m", "deepseek-v3-671b")
MESH_TP_LAYERS = {"mamba2-370m": {"n_layers": 2},
                  "deepseek-v3-671b": TRAIN_FAMILY_LAYERS["deepseek-v3-671b"]}
# phase 13 (dryrun): the CLIs' cells on a fake group of 256 ranks (each
# timed at under about 30 s of meta run on a CPU), the estimator's LM cells
# (batch, sequence or cache length) held to the card's allocator at
# DRYRUN_MEM_RTOL, and the f8 decode's greedy steps
DRYRUN_CELLS = (("llama3.2-3b", "decode_32k"), ("llama3.2-3b", "train_4k"),
                ("deepseek-v3-671b", "decode_32k"))
DRYRUN_PDX = ("block_matmul_int8", "dim")
DRYRUN_PDX_PSUMS = 768
DRYRUN_CLI_TIMEOUT_S = 300
DRYRUN_PREFILL, DRYRUN_DECODE = (8, 2048), (8, 4096)
DRYRUN_MEM_RTOL = 0.25
DRYRUN_GREEDY_STEPS = 16


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_times(torch, fn, reps: int = 10, warmup: int = 2, flush=None) -> tuple[float, float]:
    """Medians of ``reps`` timed runs of ``fn`` after ``warmup`` runs: its
    CUDA-event time on the device and the host's time in the call (ms).
    ``flush`` (a ``Flush``) empties the L2 cache before each timed run,
    outside the events.  The timed run is queued behind a 1 ms spin of the
    card, so the events time the device's work and not the host's enqueue
    of it (a short kernel's wrapper takes 0.05-0.1 ms of Python and ctypes,
    which an idle card would wait for between the events; the work of a
    plain version that takes longer to enqueue than the spin still counts
    its host gaps), and the host's time is that of the enqueue alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times, host = [], []
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(SPIN_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        h0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - h0) * 1e3)
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times), statistics.median(host)


def cuda_ms(torch, fn, reps: int = 10, warmup: int = 2, flush=None) -> float:
    """The device's time of ``fn`` (``cuda_times``), ms."""
    return cuda_times(torch, fn, reps, warmup, flush)[0]


class Flush:
    """Empties the card's 50 MB L2 cache: writes one 128 MB buffer, then
    reads another, so the cache ends holding clean lines of the second (a
    timed kernel then pays no write-back of the first)."""

    def __init__(self, torch, dev, nbytes: int = 128 * 2**20):
        self.torch = torch
        self.dirty = torch.empty(nbytes // 4, dtype=torch.float32, device=dev)
        self.clean = torch.zeros(nbytes // 4, dtype=torch.float32, device=dev)

    def __call__(self):
        self.dirty.fill_(1.0)
        self.torch.sum(self.clean)


def bound_ms(nbytes: float, flops: float, peak_flops: float = PEAK_F32_FLOPS,
             simt_flops: float = 0.0) -> tuple[float, str]:
    """(least ms, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the operations over their peaks: ``flops`` at
    ``peak_flops``, the peak for the operands' type, or ``simt_flops``
    (elementwise work beside a product) at the f32 SIMT peak, whichever
    takes longer, since the two kinds of unit run side by side."""
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    to = max(flops / peak_flops, simt_flops / PEAK_F32_FLOPS) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def product_peak(*f32_operands: bool) -> float:
    """The peak a product is held to: bf16 x bf16 on the tensor cores, the
    three-pass split with one f32 operand, the six-pass split with two."""
    return (PEAK_BF16_FLOPS, PEAK_SPLIT3_FLOPS, PEAK_SPLIT6_FLOPS)[sum(f32_operands)]


def ptxas_summary(logs: dict) -> dict:
    """Max registers and total spill bytes per library from ``-Xptxas -v``;
    for the scan library also each K1/K3 and K6 kernel's registers, spills
    and static shared memory (the dynamic ring is in the
    ``kernel_vs_plain`` lines)."""
    import re

    groups = {"k1_k3_kernels": r"prune_scan_(sweep|tail|multi)_kernel",
              "k6_kernels": r"prune_(sweep|tail)_kernel"}
    out = {}
    for name, log in logs.items():
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
        spills = [int(a) + int(b) for a, b in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
        out[name] = {"kernels": len(regs), "max_registers": max(regs, default=0),
                     "spill_bytes": sum(spills)}
        for entry in re.split(r"Compiling entry function '", log)[1:]:
            fn = entry.split("'", 1)[0]
            m = re.search(r"Used (\d+) registers", entry)
            group = next((g for g, pat in groups.items() if re.search(pat, fn)), None)
            if m is None or group is None:
                continue
            sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", entry)
            sm = re.search(r"(\d+) bytes smem", entry)
            short = re.search(r"(prune_\w+?_kernelI.*?)EEv", fn)
            out[name].setdefault(group, []).append({
                "kernel": short.group(1) if short else fn, "registers": int(m.group(1)),
                "spill_bytes": int(sp.group(1)) + int(sp.group(2)) if sp else 0,
                "static_smem_bytes": int(sm.group(1)) if sm else 0})
    return out


def ground_truth(torch, X, Q, k: int, chunk: int = 1 << 16):
    """Exact top-k ids by direct f32 differences, chunked over rows."""
    ids = []
    for q in Q:
        best_d = best_i = None
        for lo in range(0, X.shape[0], chunk):
            diff = X[lo:lo + chunk] - q[None, :]
            d = torch.sum(diff * diff, dim=1)
            dd, ii = torch.topk(d, min(k, d.shape[0]), largest=False)
            ii = ii + lo
            if best_d is None:
                best_d, best_i = dd, ii
            else:
                ad, ai = torch.cat([best_d, dd]), torch.cat([best_i, ii])
                dd, sel = torch.topk(ad, k, largest=False)
                best_d, best_i = dd, ai[sel]
        ids.append(best_i)
    return torch.stack(ids).cpu().numpy()


def dist_error(torch, X, Q, ids, dists) -> float:
    """Largest |returned - direct f32 distance| / direct over the returned
    ids (in the original space; the pruner's rotation preserves L2)."""
    ids_t = torch.from_numpy(ids.astype(np.int64)).to(X.device)
    vecs = X[ids_t]                                         # (B, k, D)
    diff = vecs - Q[:, None, :]
    true = torch.sum(diff * diff, dim=2)
    got = torch.from_numpy(dists).to(X.device)
    return float(((got - true).abs() / true.clamp(min=1e-6)).max())


def scan_walls(torch, eng, Q, specs: dict) -> dict:
    """``fused-scan``'s wall per query, host clock around ``engine.search``
    (NumPy out, so synchronized), in ``WALL_ROUNDS`` rounds of the 16 single
    queries per scan dtype: the rounds' median, least and most, so that a
    change of the wall can be told from its spread."""
    out = {"phase": "fused_scan_wall", "rounds": WALL_ROUNDS}
    for dt, spec in specs.items():
        rounds = []
        for _ in range(WALL_ROUNDS):
            t0 = time.perf_counter()
            for i in range(N_SINGLE):
                eng.search(Q[i], spec)
            rounds.append((time.perf_counter() - t0) / N_SINGLE * 1e3)
        out[dt] = {"ms_per_query_median": statistics.median(rounds),
                   "ms_per_query_min": min(rounds), "ms_per_query_max": max(rounds)}
    return out


def where_time_goes(torch, eng, Q, spec, prefix: str, **tag) -> dict:
    """Device time by kernel name under ``torch.profiler`` for the path's
    two calls (16 single queries, one batch of 64), beside their host wall
    time: the device busy share and the top kernels."""
    out = {"phase": "where_time_goes", **tag}
    for label, run in (
        (f"{prefix}_scan_16_queries", lambda: [eng.search(Q[i], spec) for i in range(N_SINGLE)]),
        (f"{prefix}_batch_64", lambda: eng.search(Q, spec)),
    ):
        out[label] = device_profile(torch, run)
    return out


def device_profile(torch, run) -> dict:
    """One call of ``run`` under ``torch.profiler``: its host wall, the
    device's busy time summed over its kernels and copies, the idle share
    and the top device events by time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only: a CPU op's device time repeats that of the
    # kernels it launched
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1 - busy / (wall * 1e3)),
            "top": [{"kernel": k[:80], "ms": ms, "calls": c} for k, ms, c in rows[:8]]}


def kernel_times(torch, fn, reps: int = 5) -> dict:
    """Device time a call of ``fn`` spends in each kernel (and memset), by
    name, ms: ``torch.profiler``'s device events over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / 1e3 / reps for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0}


def scan_parity(torch, ref, m, ids, qt, thr, eps0, prefetch: bool = False,
                d_tile: int = 64):
    """K1 (or K3 with ``prefetch``) through its op against the plain
    version on the same card tensors: alive masks may differ only on lanes
    whose keep test came within 1e-4 relative of the bound, no lane with
    ids < 0 is alive, dists allclose where both keep a lane, and (K3)
    ``streamed`` equal on every partition whose masks agree.  -> (summary,
    the plain walk's trace, the kernel's alive mask)."""
    from repro_torch.kernels.ops import (
        pdx_prune_scan_multi_op, pdx_prune_scan_multi_prefetch_op,
    )

    sc = m.scale if m.quantized else None
    off = m.offset if m.quantized else None
    op = pdx_prune_scan_multi_prefetch_op if prefetch else pdx_prune_scan_multi_op
    plain = ref.pdx_prune_scan_multi_dskip_ref if prefetch else ref.pdx_prune_scan_multi_ref
    kern = op(m.data, ids, qt, thr, sc, off, eps0=eps0, d_tile=d_tile,
              packed=m.packed, dim=m.dim)
    *want, walk = plain(m.data, ids, qt, thr, d_tile=d_tile, eps0=eps0, scale=sc,
                        offset=off, packed=m.packed, dim=m.dim, trace=True)
    kd, ka, pd_, pa = kern[0], kern[1], want[0], want[1] != 0
    live = ids >= 0
    both = ka & pa & live
    mism = (ka != pa) & live
    n_mism = int(mism.sum())
    out = {"max_abs_err": float((kd - pd_).abs()[both].max()) if both.any() else 0.0,
           "alive_mismatches": n_mism,
           "mismatch_margin_max": float(walk.margin[mism].max()) if n_mism else 0.0}
    ok = (bool(torch.allclose(kd[both], pd_[both], rtol=1e-4, atol=1e-3))
          and out["mismatch_margin_max"] < 1e-4 and not bool(ka[~live].any()))
    if prefetch:
        agree = ~mism.any(dim=1)
        out["streamed_mismatches"] = int((kern[2] != want[2])[agree].sum())
        ok = ok and out["streamed_mismatches"] == 0
    return {"parity": ok, **out}, walk, ka


def first_vote_blocks(torch, ref, m, ids, qt, thr, eps0, d_tile: int, lanes: int) -> int:
    """Blocks of ``lanes`` lanes of mirror ``m`` with a lane still alive
    after their first d-tile's vote, by the plain walk's test (sums in
    PyTorch's order, so a lane at the bound may fall either way)."""
    d0 = min(d_tile, m.dim)
    rows0 = -(-d0 // 2) if m.packed else d0
    sc = m.scale[:d0] if m.quantized else None
    off = m.offset[:d0] if m.quantized else None
    T32 = ref.dequantize_ref(m.data[:, :rows0], sc, off, dim_axis=1, packed=m.packed, dim=d0)
    diff = T32 - qt[None, :d0, None].to(torch.float32)
    acc = torch.sum(diff * diff, dim=1)
    keep = (ids >= 0) & (acc * ref._ratio(m.dim, d0) <= thr * ref._inflation(eps0, d0))
    P, V = keep.shape
    nb = -(-V // lanes)
    keep = torch.nn.functional.pad(keep, (0, nb * lanes - V)).reshape(P, nb, lanes)
    return int(keep.any(dim=2).sum())


def scan_kernel_row(torch, ref, m, ids, qt, thr, eps0, *, prefetch: bool,
                    launches: int, d_tile: int = 64, tag: str = "",
                    **row_extra) -> dict:
    """K1 (or K3) on mirror ``m`` at ``d_tile``: held to its plain version
    at the path's threshold ``thr`` and, since a path's threshold may kill
    most lanes in the first d-tiles, also at +inf and at the 1 % quantile
    of the live lanes' full distances, where lanes die at every d-tile;
    CUDA-event medians of the kernel (on the operands its wrapper prepares)
    and of the plain version; the bound.  ``tag`` names the row (the mirror
    dtype by default).  The row carries the launch shape (body, lanes per
    block, blocks, shared memory, look-ahead and the most bytes it can add);
    a row on the path (``launches`` > 0) must run the bulk body.  Emits the
    phase line, returns the row."""
    from repro_torch.kernels.ops import _prep_multi
    from repro_torch.kernels.pdx_scan import (
        pdx_prune_scan_multi_cuda, pdx_prune_scan_multi_geometry,
        pdx_prune_scan_multi_prefetch_cuda,
    )
    from repro_torch.obs.meters import tile_widths

    sc = m.scale if m.quantized else None
    off = m.offset if m.quantized else None
    plain_fn = ref.pdx_prune_scan_multi_dskip_ref if prefetch else ref.pdx_prune_scan_multi_ref

    def plain(t=thr):
        return plain_fn(m.data, ids, qt, t, d_tile=d_tile, eps0=eps0, scale=sc,
                        offset=off, packed=m.packed, dim=m.dim)

    name = "K3 pdx_prune_scan_multi_prefetch" if prefetch else "K1 pdx_prune_scan_multi"
    name = f"{name} [{tag or m.dtype}]"
    summary, walk, ka = scan_parity(torch, ref, m, ids, qt, thr, eps0, prefetch, d_tile)
    live = ids >= 0
    full = plain(float("inf"))[0][live]
    extra = {}
    for label, t in (("inf", float("inf")),
                     ("q1", torch.kthvalue(full, max(1, full.numel() // 100)).values)):
        sx, walkx, _ = scan_parity(torch, ref, m, ids, qt, t, eps0, prefetch, d_tile)
        extra[f"thr_{label}"] = {"threshold": float(t), **sx,
                                 "lanes_per_tile": walkx.lanes.cpu().tolist()}
        assert sx["parity"], f"{name} disagrees with its plain version at thr {label}"
    del full
    P, _, C = m.data.shape
    lanes = walk.lanes.cpu().numpy()
    parts = walk.parts.cpu().numpy()
    w = tile_widths(m.dim, d_tile)
    # ids in, dists and alive (and K3's streamed) out; q/scale/offset; the
    # tiles either of the partitions alive entering each d-tile at the
    # mirror's width (partition level, the grain of the direct body) or of
    # the lanes alive entering it (lane level, as K6's row counts; the
    # row's bound, since the bulk body skips at a finer grain than a
    # partition); the operations of the lanes alive entering each tile
    fixed = P * C * (4 + 4 + 1) + (P * 4 if prefetch else 0) + 3 * m.dim * 4
    part_bytes = float((parts * w).sum()) * C * m.bytes_per_value + fixed
    nbytes = float((lanes * w).sum()) * m.bytes_per_value + fixed
    flops = float((lanes * w).sum()) * (5 if m.quantized else 3)
    b, by = bound_ms(nbytes, flops)
    b_part, _ = bound_ms(part_bytes, flops)
    args, kwargs = _prep_multi(m.data, ids, qt, thr, sc, off, eps0, d_tile, m.packed,
                               m.dim)
    geo = pdx_prune_scan_multi_geometry(args[0], dim=kwargs["dim"], d_tile=kwargs["d_tile"],
                                        quantized=kwargs["quantized"], prefetch=prefetch)
    rows = min(kwargs["d_tile"] // 2 if m.packed else kwargs["d_tile"], m.data.shape[1])
    first = first_vote_blocks(torch, ref, m, ids, qt, thr, eps0, kwargs["d_tile"],
                              geo["lanes_per_block"])
    # the look-ahead runs in the tail launch only (none where one d-tile)
    geo.update(blocks_alive_after_first_vote=first,
               lookahead_bytes_max=(geo["lookahead_tiles"] * first * rows
                                    * geo["lanes_per_block"] * m.data.element_size()
                                    * (geo["tail_blocks"] > 0)))
    kern = pdx_prune_scan_multi_prefetch_cuda if prefetch else pdx_prune_scan_multi_cuda
    ms, host_ms = cuda_times(torch, lambda: kern(*args, **kwargs))
    args0 = (*args[:3], torch.zeros_like(args[3]), *args[4:])  # thr = 0
    ms_sweep = cuda_ms(torch, lambda: kern(*args0, **kwargs))
    plain_ms = cuda_ms(torch, plain)
    row = {"name": name, "route": "cuda",
           "source": K3_SOURCE if prefetch else K1_SOURCE,
           "replaces": K3_REPLACES if prefetch else K1_REPLACES,
           "launches": launches, "max_abs_err": summary["max_abs_err"],
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
           "library_ms": None, "parity": summary["parity"],
           "bound_ms_partition": b_part, "host_ms": host_ms,
           "ms_sweep": ms_sweep, **geo, **row_extra}
    emit({"phase": "kernel_vs_plain", **summary, **row, "threshold": float(thr),
          "d_tile": d_tile, "eps0": eps0, "lanes_entering": int(live.sum()),
          "partitions_entering": int(live.any(dim=1).sum()),
          "lanes_alive_after": int(ka.sum()), "tiles_streamed": float(parts.sum()),
          "bound_bytes": nbytes, "bound_bytes_partition": part_bytes,
          "bound_flops": flops, **extra})
    assert summary["parity"], f"{name} disagrees with its plain version"
    assert launches == 0 or geo["body"] == "bulk", f"{name}: the path ran the {geo['body']} body"
    return row


def k2_kernel_row(torch, ref, data, Qt, sc, off, packed: bool, dim: int, dt: str,
                  name: str, launches: int, live_cols) -> dict:
    """K2 on the (P, D', C) tiles ``data`` for the (B, D) queries ``Qt``
    against its plain version (the op's CPU body, tile by tile) at K2's
    tolerance on the live columns, with the kernel's, the whole op's, the
    plain version's and ``torch.matmul``'s times and the bound.  Emits the
    phase line, returns the row."""
    from repro_torch.kernels.batched_matmul import batched_distance_quant_cuda
    from repro_torch.kernels.ops import _unpack_int4_levels, batched_distance_quant_op

    P, _, C = data.shape
    D = dim
    B = Qt.shape[0]
    kout = batched_distance_quant_op(data, Qt, sc, off, "l2", packed=packed, dim=dim)
    T32 = ref.dequantize_ref(data, sc, off, dim_axis=1, packed=packed, dim=dim)
    src = _unpack_int4_levels(data, dim) if packed else data

    def k2_plain():  # the op's CPU body, partition by partition
        return torch.cat([ref.batched_distance_quant_ref(t, Qt, sc, off) for t in src], dim=1)

    pout = k2_plain()
    qn = torch.sum(Qt * Qt, dim=1)
    xn = torch.sum(T32 * T32, dim=1).reshape(-1)
    tol = 1e-5 * (qn[:, None] + xn[None, :]) + 1e-3
    diff = (kout - pout).abs()[:, live_cols]
    err2 = float(diff.max())
    ok2 = bool((diff <= tol[:, live_cols]).all())
    # the kernel reads the tiles as stored (int4: packed bytes)
    ms2 = cuda_ms(torch, lambda: batched_distance_quant_cuda(
        data, Qt, qn, sc, off, metric="l2", dim=dim if packed else None))
    # the whole op: qn included
    op2 = cuda_ms(torch, lambda: batched_distance_quant_op(
        data, Qt, sc, off, "l2", packed=packed, dim=dim))
    plain2 = cuda_ms(torch, k2_plain)
    lib2 = cuda_ms(torch, lambda: torch.matmul(Qt, T32))
    # the search needs the live columns only: their tile values at the
    # tiles' width, the queries, (B, live) distances out; the product at
    # the split's rate, the column norms, the epilogue and the dequant FMA
    # where quantized on the SIMT cores
    n_live = int(live_cols.sum())
    bpv = {"f32": 4, "bf16": 2, "int8": 1, "int4": 0.5}[dt]
    quantized = sc is not None
    k2_bytes = (n_live * D * bpv + Qt.numel() * 4 + B * n_live * 4
                + (2 * D * 4 if quantized else 0))
    k2_flops = n_live * 2.0 * B * D
    k2_simt = n_live * (2.0 * D + 3.0 * B + (2.0 * D if quantized else 0.0))
    b2, by2 = bound_ms(k2_bytes, k2_flops, product_peak(True, dt == "f32"), k2_simt)
    row2 = {"name": name, "route": "cuda", "source": K2_SOURCE, "replaces": K2_REPLACES,
            "launches": launches, "max_abs_err": err2,
            "ms": ms2, "plain_ms": plain2, "bound_ms": b2, "bound_by": by2,
            "library_ms": lib2, "parity": ok2, "op_ms": op2}
    emit({"phase": "kernel_vs_plain", **row2,
          "library_call": "torch.matmul(Q, dequantized f32 tiles), cross term only",
          "bound_bytes": k2_bytes, "bound_flops": k2_flops, "bound_simt_flops": k2_simt,
          "live_columns": n_live, "columns_written": P * C, "tiles": P, "queries": B})
    assert ok2, f"{name} disagrees with its plain version"
    return row2


def stage_kernel_row(torch, ref, call: dict, ladder: str, stage: str) -> dict:
    """K2 per d-tile through ``batched_cascade_stage_op`` on the arguments a
    ``cascade-batch`` stage passed it on the path (compacted union columns
    at their real width S, the batch's entry alive and thresholds), held to
    the plain stage (``ref.batched_cascade_stage_ref``, the plain K2 per
    tile) at the path's thresholds, at +inf and at each query's 1 %
    quantile of its entering lanes' full distances.  Tolerance: K2's own
    per tile, ``|kernel - plain| <= 1e-5 * (||q||^2 + ||x^||^2) + 1e-3`` per
    d-tile summed over the tiles; alive masks may differ only on pairs
    whose keep test came within 1e-4 relative, or within that tolerance
    (times D / d_tile), of the bound.  Emits the phase line, returns the
    row."""
    from repro_torch.kernels.ops import _unpack_int4_levels, batched_cascade_stage_op
    from repro_torch.obs.meters import tile_widths

    T, alive, Qs, thr, sc, off = call["args"]
    kw = call["kwargs"]
    eps0, d_tile, packed, D = kw["eps0"], kw["d_tile"], kw["packed"], kw["dim"]
    B, S = alive.shape
    w = tile_widths(D, d_tile)
    levels = _unpack_int4_levels(T, D) if packed else T
    xn = torch.zeros(S, device=T.device)
    for lo in range(0, D, d_tile):
        hi = min(lo + d_tile, D)
        t = ref.dequantize_ref(levels[lo:hi], sc[lo:hi] if sc is not None else None,
                               off[lo:hi] if off is not None else None)
        xn += torch.sum(t * t, dim=0)
    del levels, t
    tol = 1e-5 * (torch.sum(Qs * Qs, dim=1)[:, None] + xn[None, :]) + 1e-3 * len(w)
    # the least bound over the tiles is the last tile's (eps0 >= 0), and an
    # acc error e moves acc * ratio by at most e * D / (first tile's width)
    slack_scale = float(D / w[0]) / ref._inflation(eps0, D)
    name = f"K2 batched_distance_quant in cascade stage [{ladder} {stage}]"

    def kernel(t):
        return batched_cascade_stage_op(T, alive, Qs, t, sc, off, **kw)

    def plain(t, trace=False):
        return ref.batched_cascade_stage_ref(T, alive, Qs, t, sc, off, trace=trace, **kw)

    def parity(t):
        kd, ka = kernel(t)
        pd_, pa, walk = plain(t, trace=True)
        pa = pa != 0
        mism = (ka != pa) & alive
        slack = torch.clamp(tol * slack_scale / t[:, None], min=1e-4)
        n_mism = int(mism.sum())
        both = ka & pa
        diff = (kd - pd_).abs()
        out = {"max_abs_err": float(diff[both].max()) if both.any() else 0.0,
               "alive_mismatches": n_mism,
               "mismatch_margin_max": float(walk.margin[mism].max()) if n_mism else 0.0,
               "mismatches_beyond_slack": int((mism & (walk.margin >= slack)).sum())}
        ok = (bool((diff <= tol)[both].all()) and out["mismatches_beyond_slack"] == 0
              and not bool(ka[~alive].any()))
        return {"parity": ok, **out}, walk

    summary, walk = parity(thr)
    full = torch.where(alive, plain(torch.full_like(thr, float("inf")))[0], float("inf"))
    n_in = alive.sum(dim=1)
    kth = torch.clamp(n_in // 100, min=1) - 1
    q1 = torch.sort(full, dim=1).values.gather(1, kth[:, None])[:, 0]
    del full
    extra = {}
    for label, t in (("inf", torch.full_like(thr, float("inf"))), ("q1", q1)):
        sx, walkx = parity(t)
        extra[f"thr_{label}"] = {**sx, "pairs_per_tile": walkx.lanes.cpu().tolist()}
        assert sx["parity"], f"{name} disagrees with its plain version at thr {label}"
    lanes = walk.lanes.cpu().numpy()
    parts = walk.parts.cpu().numpy()
    quantized = sc is not None
    bpv = 0.5 if packed else T.element_size()
    # the columns any query keeps entering each d-tile at the mirror's
    # width; entry alive, queries, thresholds, dequant vectors in; dists and
    # alive out.  Operations: the cross term of the pairs alive entering
    # each tile, its epilogue, accumulate and keep test (2w + 7 a pair), and
    # each entering column's norm and dequant
    nbytes = (float((parts * w).sum()) * bpv + B * S * (1 + 4 + 1) + Qs.numel() * 4
              + B * 4 + (2 * D * 4 if quantized else 0))
    # the cross term at the split's rate (queries f32; an f32 tile is the
    # second f32 operand), the rest on the SIMT cores
    flops = float((lanes * 2.0 * w).sum())
    simt = float((lanes * 7.0).sum()) + float(parts[0]) * D * (4.0 if quantized else 2.0)
    b, by = bound_ms(nbytes, flops, product_peak(True, T.dtype == torch.float32), simt)
    ms = cuda_ms(torch, lambda: kernel(thr))
    plain_ms = cuda_ms(torch, lambda: plain(thr))
    row = {"name": name, "route": "cuda", "source": K2_SOURCE, "replaces": K2_REPLACES,
           "launches": call["k2_launches"], "max_abs_err": summary["max_abs_err"],
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
           "library_ms": None, "parity": summary["parity"]}
    emit({"phase": "kernel_vs_plain", **summary, **row,
          "library_call": None, "batch": B, "columns": S,
          "columns_entering": int(parts[0]), "pairs_entering": int(alive.sum()),
          "pairs_per_tile": lanes.tolist(), "columns_per_tile": parts.tolist(),
          "d_tile": d_tile, "eps0": eps0, "bound_bytes": nbytes, "bound_flops": flops,
          "bound_simt_flops": simt, **extra})
    assert summary["parity"], f"{name} disagrees with its plain version"
    return row


class StageRecorder:
    """Stands in for ``ops.batched_cascade_stage_op`` while a
    ``cascade-batch`` run is counted: calls the op, keeps each stage's
    arguments (unless ``keep_args`` is false) and the K2 launches the call
    made.  The executor looks the op up at each call, so a server's
    executor thread goes through the recorder too."""

    def __init__(self, ops, k2, keep_args: bool = True):
        self.ops, self.k2, self.calls = ops, k2, []
        self.op, self.keep_args = ops.batched_cascade_stage_op, keep_args

    def __call__(self, *args, **kwargs):
        n0 = self.k2.launches
        out = self.op(*args, **kwargs)
        call = {"packed": bool(kwargs.get("packed")),
                "k2_launches": self.k2.launches - n0}
        if self.keep_args:
            call.update(args=args, kwargs=kwargs)
        self.calls.append(call)
        return out

    def __enter__(self):
        self.ops.batched_cascade_stage_op = self
        return self

    def __exit__(self, *exc):
        self.ops.batched_cascade_stage_op = self.op
        return False


def cascade_ladder(torch, eng, Q, Xd, Qd, gt, name: str, ladder: tuple,
                   counters: dict) -> tuple[dict, list]:
    """Drive one cascade ladder through both executors with the launch
    counters zeroed just before each run and read just after; assert the
    executors, launch counts, recall, returned distances and equal ids of
    the two executors; report survivors, bytes and re-rank width per stage
    from the port's own counters.  -> (the phase line, the arguments and
    K2 launches of each ``cascade-batch`` stage)."""
    import contextlib

    from repro_torch.core.engine import SearchSpec
    from repro_torch.core.spec import parse_cascade_stage
    from repro_torch.kernels import ops
    from repro_torch.obs import metrics

    spec = SearchSpec(k=K, cascade=ladder)
    eng.search(Q[0], spec)  # warm the allocator and the libraries, uncounted
    eng.search(Q, spec)
    torch.cuda.synchronize()
    stages = [parse_cascade_stage(s) for s in ladder][:-1]
    D = eng.store.dim
    # K2 runs once per d-tile of each stage: one tile on a projection
    # (d_tile = rank), ceil(D / 64) on a full-dimension stage
    k2_tiles = sum(1 if kind == "proj" else -(-D // 64) for kind, _, _ in stages)
    out = {"phase": "cascade", "ladder": name, "stages": list(ladder)}
    reg = metrics.get_registry()
    results = {}
    metrics.set_enabled(True)
    try:
        for executor, n_q, want in (
            ("cascade-scan", N_SINGLE, {"k1": N_SINGLE, "k3": N_SINGLE, "k2": 0}),
            ("cascade-batch", N_BATCH, {"k1": 0, "k3": 0, "k2": k2_tiles}),
        ):
            batch = executor == "cascade-batch"
            with (StageRecorder(ops, counters["k2"]) if batch
                  else contextlib.nullcontext()) as rec:
                reg.reset()
                for c in counters.values():
                    c.launches = 0
                t0 = time.perf_counter()
                if batch:
                    res = [eng.search(Q, spec)]
                else:
                    res = [eng.search(Q[i], spec) for i in range(N_SINGLE)]
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                got = {k: c.launches for k, c in counters.items()}
            if batch:
                stage_calls = rec.calls
                assert len(stage_calls) == len(stages), stage_calls
            for r in res:
                assert r.plan.executor == executor, r.plan
            assert got == want, f"ladder {name} {executor}: launches {got}, want {want}"
            ids = np.stack([r.ids for r in res]).reshape(n_q, K)
            dists = np.stack([r.dists for r in res]).reshape(n_q, K)
            rec = recall(ids, gt[:n_q])
            err = dist_error(torch, Xd, Qd[:n_q], ids, dists)
            tag = executor.replace("-", "_")
            rerank = reg.get("repro_device_bytes_total", executor=executor,
                             component="rerank", dtype="f32")
            out[tag] = {
                "recall_at_10": rec, "dist_rel_err": err,
                ("ms_per_query" if n_q == N_SINGLE else "ms_per_batch_of_64"):
                    wall * 1e3 / (N_SINGLE if n_q == N_SINGLE else 1),
                "launches": got,
                "survivors_per_query": [
                    reg.get("repro_cascade_stage_survivors", stage=str(si),
                            stage_name=ladder[si]) / n_q for si in range(len(stages))],
                "stage_bytes_per_query": [
                    reg.get("repro_cascade_stage_bytes", stage=str(si),
                            stage_name=ladder[si]) / n_q for si in range(len(stages))],
                "rk_eff_mean": rerank / (D * 4 * n_q),
            }
            results[executor] = ids
            assert err <= 1e-3, f"ladder {name} {executor}: returned distances off by {err}"
            assert rec >= CASCADE_RECALL_FLOOR, f"ladder {name} {executor}: recall {rec}"
    finally:
        metrics.set_enabled(False)
        reg.reset()
    same = np.array_equal(results["cascade-batch"][:N_SINGLE], results["cascade-scan"])
    out["batch_ids_equal_scan_ids"] = same
    assert same, f"ladder {name}: cascade-batch ids differ from cascade-scan's"
    out["cascade_batch"]["k2_launches_per_stage"] = [c["k2_launches"] for c in stage_calls]
    return out, stage_calls


def distance_parity(torch, got, want, metric: str, row_norm, q) -> tuple[float, bool]:
    """(max |kernel - plain|, within tolerance) for a plain distance scan:
    ``|kernel - plain| <= 1e-5 * s + 1e-4``, with s the scale of the sum's
    rounding: the distance itself for l2 and l1 (a sum of nonnegative
    terms), ``||x|| ||q||`` (>= sum |x_d q_d|) for ip, whose sum cancels."""
    diff = (got - want).abs()
    scale = want.abs() if metric != "ip" else row_norm * torch.linalg.vector_norm(q)
    return float(diff.max()), bool((diff <= 1e-5 * scale + 1e-4).all())


def library_distance(torch, A, q, metric: str):
    """One PyTorch call over rows ``A`` (n, D) computing the distances (up to
    sign): ``torch.mv`` for ip, ``torch.cdist`` squared for l2, p = 1 for
    l1.  A yardstick only; the port never calls it."""
    if metric == "ip":
        return lambda: torch.mv(A, q)
    if metric == "l2":
        return lambda: torch.cdist(A, q[None], p=2.0) ** 2
    return lambda: torch.cdist(A, q[None], p=1.0)


def table4(torch, ref, dev, seed: int, n: int, flush) -> tuple[list, list]:
    """The paper's Table 4 on the card: K4 on the PDX layout ``X.T`` against
    K5 on the N-ary layout ``X``, per dim and metric.  Data: standard
    normal (n, D) drawn on the card from a generator seeded with ``seed``,
    one D at a time, freed before the next.  Per D the two ops run once per
    metric with the launch counters zeroed just before and read just after
    (the path); then parity against the plain versions and CUDA-event
    medians (L2 flushed before each timed run) of the kernels, the plain
    versions and a library call on the same layout.  -> (phase lines,
    kernel rows: K4 and K5 by metric, summed over the sweep)."""
    from repro_torch.kernels.nary_scan import nary_distance_cuda
    from repro_torch.kernels.ops import nary_distance_op, pdx_distance_op
    from repro_torch.kernels.pdx_scan import pdx_distance_cuda

    gen = torch.Generator(device=dev).manual_seed(seed)
    flops_per_value = {"l2": 3, "ip": 2, "l1": 3}
    lines, speedups = [], {m: {} for m in TABLE4_METRICS}
    rows = {(k, m): {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
                     "max_abs_err": 0.0, "launches": 0, "parity": True}
            for k in ("K4", "K5") for m in TABLE4_METRICS}
    for D in TABLE4_DIMS:
        X = torch.randn((n, D), generator=gen, device=dev)
        q = torch.randn((D,), generator=gen, device=dev)
        T = X.T.contiguous()
        torch.cuda.synchronize()
        outs, launched = {}, {}
        for m in TABLE4_METRICS:
            pdx_distance_cuda.launches = 0
            nary_distance_cuda.launches = 0
            outs[m] = (pdx_distance_op(T, q, m), nary_distance_op(X, q, m))
            torch.cuda.synchronize()
            launched[m] = {"K4": pdx_distance_cuda.launches, "K5": nary_distance_cuda.launches}
            assert launched[m] == {"K4": 1, "K5": 1}, \
                f"table4 D={D} {m}: launched {launched[m]}, want one each"
        row_norm = torch.linalg.vector_norm(X, dim=1)
        nbytes = n * D * 4 + n * 4 + D * 4
        line = {"phase": "table4", "n": n, "dim": D, "collection_mb": n * D * 4 / 1e6,
                "fits_in_l2": n * D * 4 <= L2_CACHE_BYTES, "l2_flushed": True}
        for m in TABLE4_METRICS:
            k4, k5 = outs[m]
            err4, ok4 = distance_parity(torch, k4, ref.pdx_distance_ref(T, q, m), m, row_norm, q)
            err5, ok5 = distance_parity(torch, k5, ref.nary_distance_ref(X, q, m), m, row_norm, q)
            _, same = distance_parity(torch, k4, k5, m, row_norm, q)
            ms4 = cuda_ms(torch, lambda: pdx_distance_cuda(T, q, m), flush=flush)
            ms5 = cuda_ms(torch, lambda: nary_distance_cuda(X, q, m), flush=flush)
            plain4 = cuda_ms(torch, lambda: ref.pdx_distance_ref(T, q, m), flush=flush)
            plain5 = cuda_ms(torch, lambda: ref.nary_distance_ref(X, q, m), flush=flush)
            lib4 = cuda_ms(torch, library_distance(torch, T.t(), q, m), flush=flush)
            lib5 = cuda_ms(torch, library_distance(torch, X, q, m), flush=flush)
            b, by = bound_ms(nbytes, n * D * flops_per_value[m])
            speedups[m][D] = ms5 / ms4
            line[m] = {"k4_ms": ms4, "k5_ms": ms5, "speedup": ms5 / ms4,
                       "k4_plain_ms": plain4, "k5_plain_ms": plain5,
                       "k4_library_ms": lib4, "k5_library_ms": lib5,
                       "bound_ms": b, "bound_by": by, "k4_share": b / ms4, "k5_share": b / ms5,
                       "k4_max_abs_err": err4, "k5_max_abs_err": err5,
                       "k4_parity": ok4, "k5_parity": ok5, "k4_equals_k5": same}
            for k, ms, plain, lib, err, ok in (("K4", ms4, plain4, lib4, err4, ok4),
                                               ("K5", ms5, plain5, lib5, err5, ok5)):
                r = rows[(k, m)]
                r["ms"] += ms
                r["plain_ms"] += plain
                r["library_ms"] += lib
                r["bound_ms"] += b
                r["bound_by"] = by
                r["max_abs_err"] = max(r["max_abs_err"], err)
                r["launches"] += launched[m][k]
                r["parity"] = r["parity"] and ok
            assert ok4 and ok5 and same, f"table4 D={D} {m}: kernels disagree {line[m]}"
        lines.append(line)
        del X, T, q, outs, row_norm
        torch.cuda.empty_cache()

    def gm(xs):
        return float(np.exp(np.mean(np.log(xs))))

    summary = {"phase": "table4_summary", "n": n, "dims": list(TABLE4_DIMS)}
    for m in TABLE4_METRICS:
        sp = speedups[m]
        summary[m] = {"geomean_speedup_lowD": gm([v for d, v in sp.items() if d <= 32]),
                      "geomean_speedup_highD": gm([v for d, v in sp.items() if d > 32]),
                      "geomean_speedup_all": gm(list(sp.values()))}
    lines.append(summary)
    kernel_rows = []
    for (k, m), r in rows.items():
        src, rep = (K4_SOURCE, K4_REPLACES) if k == "K4" else (K5_SOURCE, K5_REPLACES)
        name = "pdx_distance" if k == "K4" else "nary_distance"
        layout = "X.T" if k == "K4" else "X"
        kernel_rows.append({
            "name": f"{k} {name} [{m}, Table 4 sweep]", "route": "cuda", "source": src,
            "replaces": rep, "launches": r["launches"], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "parity": r["parity"],
            "work": f"sum over the {len(TABLE4_DIMS)} dims of one call on {layout}, n = {n}",
            "library_call": "torch.mv" if m == "ip" else
                            f"torch.cdist(p={'2, squared' if m == 'l2' else '1'})"})
    return lines, kernel_rows


def flat_scan(torch, ref, eng, Xd, Qd, gt) -> tuple[dict, list]:
    """K4, K6 and K7 on the collection as one flat PDX block in the engine's
    rotated space, ``T = transform_batch(Xd).T`` (D, n) f32, lane v = id v.

    The path, counters zeroed just before and read just after: for each of
    the 16 single queries K4 (full l2 distances; their k-th smallest is
    the exact k = 10 threshold) then K6 at that threshold; K7 for the batch
    of 64 at f32 and bf16 operands, l2 and ip.  Then: survivors, recall@10
    of the survivors and lanes alive entering each d-tile (from the plain
    walk, K6's mask held to it by K1's rule); K6 on query 0 also at +inf
    and at the 1 % quantile, and against K1 on query 0's START partition of
    the engine's f32 mirror (masks equal); K6's time against K4's per query
    (pruned vs full), its sweep alone (thr = 0), the survivors its sweep
    listed, its bound at the lane and the 32-byte-sector level, the
    tail's gathers a second, and its device time by kernel on query 0; K7
    against its plain version at K2's tolerance.  -> (phase line, kernel
    rows)."""
    from repro_torch.core.layout import device_mirror
    from repro_torch.kernels.batched_matmul import batched_distance_cuda
    from repro_torch.kernels.ops import (
        batched_distance_op, pdx_distance_op, pdx_prune_scan_multi_op, pdx_prune_scan_op,
        squared_norms,
    )
    from repro_torch.kernels.pdx_scan import (
        pdx_distance_cuda, pdx_prune_scan_cuda, pdx_prune_scan_geometry,
        pdx_prune_scan_workspace,
    )
    from repro_torch.obs.meters import tile_widths

    pruner = eng.pruner
    eps0 = float(pruner.aux["eps0"])
    T = pruner.transform_batch(Xd).T.contiguous()
    Qt = pruner.transform_batch(Qd)
    D, n = T.shape
    T16, Q16 = T.to(torch.bfloat16), Qt.to(torch.bfloat16)
    torch.cuda.synchronize()
    counters = {"k4": pdx_distance_cuda, "k6": pdx_prune_scan_cuda, "k7": batched_distance_cuda}
    for c in counters.values():
        c.launches = 0
    thrs, k6_out, k7_out, k7_launches = [], [], {}, {}
    for i in range(N_SINGLE):
        full = pdx_distance_op(T, Qt[i], "l2")
        thr = torch.kthvalue(full, K).values
        thrs.append(thr)
        k6_out.append(pdx_prune_scan_op(T, Qt[i], thr, eps0=eps0))
    operands = {"f32": (T, Qt), "bf16": (T16, Q16)}
    for dt, (Tx, Qx) in operands.items():
        for m in ("l2", "ip"):
            n0 = batched_distance_cuda.launches
            k7_out[(dt, m)] = batched_distance_op(Tx, Qx, m)
            k7_launches[(dt, m)] = batched_distance_cuda.launches - n0
    torch.cuda.synchronize()
    got = {k: c.launches for k, c in counters.items()}
    want = {"k4": N_SINGLE, "k6": N_SINGLE, "k7": 4}
    assert got == want, f"flat_scan: launches {got}, want {want}"
    del full

    w = tile_widths(D, 64)
    per_query, k6_ms, k6_plain, k6_bound, k6_err, k6_ok = [], 0.0, 0.0, 0.0, 0.0, True
    k6_sector, k6_sweep, k6_listed = 0.0, 0.0, 0
    geo = pdx_prune_scan_geometry(T, d_tile=64)
    ws = pdx_prune_scan_workspace(n, T.device)
    zero = torch.zeros((1,), device=T.device)
    k4_ms = cuda_ms(torch, lambda: pdx_distance_cuda(T, Qt[0], "l2"))
    for i, (kd, ka) in enumerate(k6_out):
        q, thr = Qt[i], thrs[i]
        pd_, pa, walk = ref.pdx_prune_scan_ref(T, q, thr, d_tile=64, eps0=eps0, trace=True)
        pa = pa != 0
        mism = ka != pa
        n_mism = int(mism.sum())
        margin = float(walk.margin[mism].max()) if n_mism else 0.0
        both = ka & pa
        err = float((kd - pd_).abs()[both].max()) if both.any() else 0.0
        ok = margin < 1e-4 and bool(torch.allclose(kd[both], pd_[both], rtol=1e-4, atol=1e-3))
        lanes = walk.lanes.cpu().numpy()
        sectors = walk.sectors.cpu().numpy()
        # the rows of the lanes alive entering each d-tile (lane level) or
        # the 32-byte sectors holding one (sector level: what a gather of
        # live lanes fetches), q in, dists and alive out (no ids: every lane
        # is real); the l2 terms of those lanes
        fixed = D * 4 + n * (4 + 1)
        flops = float((lanes * w).sum()) * 3
        b, k6_by = bound_ms(float((lanes * w).sum()) * 4 + fixed, flops)
        b_sector, _ = bound_ms(float((sectors * w).sum()) * 32 + fixed, flops)
        thr1 = thr.reshape(1)
        ms = cuda_ms(torch, lambda: pdx_prune_scan_cuda(T, None, q, thr1, d_tile=64, eps0=eps0,
                                                        workspace=ws))
        ms_sweep = cuda_ms(torch, lambda: pdx_prune_scan_cuda(T, None, q, zero, d_tile=64,
                                                              eps0=eps0, workspace=ws))
        pdx_prune_scan_cuda(T, None, q, thr1, d_tile=64, eps0=eps0, workspace=ws)
        listed = int(ws[0])  # the sweep's survivors, the list the tail walks
        plain = cuda_ms(torch, lambda: ref.pdx_prune_scan_ref(T, q, thr, d_tile=64, eps0=eps0))
        alive_ids = set(torch.nonzero(ka).flatten().cpu().tolist())
        rec = len(alive_ids & set(gt[i].tolist())) / K
        # the tail's rate: one gather a lane alive entering each later
        # d-tile, for each of the tile's rows, in its time beyond the sweep's
        gathers = float((lanes[1:] * w[1:]).sum())
        per_query.append({"threshold": float(thr), "survivors": int(ka.sum()),
                          "recall_at_10": rec, "ms": ms, "ms_sweep": ms_sweep,
                          "tail_gathers_per_s": gathers / max(ms - ms_sweep, 1e-6) * 1e3,
                          "pruned_vs_full": k4_ms / ms, "bound_ms": b,
                          "bound_ms_sector": b_sector, "survivors_after_tile0": listed,
                          "alive_mismatches": n_mism, "mismatch_margin_max": margin,
                          "lanes_per_tile": lanes.tolist(), "sectors_per_tile": sectors.tolist()})
        k6_ms, k6_plain, k6_bound = k6_ms + ms, k6_plain + plain, k6_bound + b
        k6_sector, k6_sweep = k6_sector + b_sector, k6_sweep + ms_sweep
        k6_listed += listed
        k6_err, k6_ok = max(k6_err, err), k6_ok and ok
        assert ok, f"flat_scan: K6 disagrees with its plain version on query {i}"

    # K6 on query 0 at +inf and the 1 % quantile, against its plain version
    q0 = Qt[0]
    full0 = ref.pdx_distance_ref(T, q0)
    extra = {}
    for label, t in (("inf", torch.tensor(float("inf"), device=T.device)),
                     ("q1", torch.kthvalue(full0, n // 100).values)):
        kd, ka = pdx_prune_scan_op(T, q0, t, eps0=eps0)
        pd_, pa, walk = ref.pdx_prune_scan_ref(T, q0, t, d_tile=64, eps0=eps0, trace=True)
        pa = pa != 0
        mism = ka != pa
        both = ka & pa
        n_mism = int(mism.sum())
        sx = {"threshold": float(t), "survivors": int(ka.sum()), "alive_mismatches": n_mism,
              "mismatch_margin_max": float(walk.margin[mism].max()) if n_mism else 0.0,
              "max_abs_err": float((kd - pd_).abs()[both].max()) if both.any() else 0.0,
              "lanes_per_tile": walk.lanes.cpu().tolist()}
        sx["parity"] = (sx["mismatch_margin_max"] < 1e-4
                        and bool(torch.allclose(kd[both], pd_[both], rtol=1e-4, atol=1e-3)))
        extra[f"thr_{label}"] = sx
        assert sx["parity"], f"flat_scan: K6 disagrees with its plain version at thr {label}"
    # ... and against K1 on query 0's START partition of the f32 mirror
    store = eng.store
    p0 = int(eng.ivf.route(pruner.transform_query(Qd[0]), 1, "l2")[0][0])
    m32 = device_mirror(store, "f32")
    kd6, ka6 = pdx_prune_scan_op(m32.data[p0], q0, thrs[0], store.ids[p0], eps0=eps0)
    kd1, ka1 = pdx_prune_scan_multi_op(m32.data[p0:p0 + 1], store.ids[p0:p0 + 1], q0,
                                       thrs[0], eps0=eps0)
    vs_k1 = {"partition": p0, "lanes": int((store.ids[p0] >= 0).sum()),
             "survivors": int(ka6.sum()), "masks_equal": bool(torch.equal(ka6, ka1[0])),
             "max_abs_diff": float((kd6 - kd1[0]).abs().max())}
    extra["vs_k1_start_partition"] = vs_k1
    assert vs_k1["masks_equal"], f"flat_scan: K6 and K1 disagree on partition {p0}"

    # K6's device time by kernel on query 0: the sweep, the tail, the memset
    extra["k6_kernels_ms_query0"] = kernel_times(torch, lambda: pdx_prune_scan_cuda(
        T, None, q0, thrs[0].reshape(1), d_tile=64, eps0=eps0, workspace=ws))

    k4_plain = cuda_ms(torch, lambda: ref.pdx_distance_ref(T, q0))
    k4_lib = cuda_ms(torch, library_distance(torch, T.t(), q0, "l2"))
    row_norm = torch.linalg.vector_norm(T, dim=0)
    k4_err, k4_ok = distance_parity(torch, pdx_distance_op(T, q0, "l2"), full0, "l2",
                                    row_norm, q0)
    assert k4_ok, "flat_scan: K4 disagrees with its plain version"
    k4_bound, k4_by = bound_ms(n * D * 4 + n * 4 + D * 4, n * D * 3)
    del full0, row_norm
    rows = [{"name": f"K4 pdx_distance [l2, rotated {n} x {D}]", "route": "cuda",
             "source": K4_SOURCE, "replaces": K4_REPLACES, "launches": got["k4"],
             "max_abs_err": k4_err, "ms": k4_ms, "plain_ms": k4_plain, "bound_ms": k4_bound,
             "bound_by": k4_by, "library_ms": k4_lib, "parity": k4_ok,
             "library_call": "torch.cdist(p=2, squared)"},
            {"name": f"K6 pdx_prune_scan [f32, rotated {n} x {D}, {N_SINGLE} queries]",
             "route": "cuda", "source": K6_SOURCE, "replaces": K6_REPLACES,
             "launches": got["k6"], "max_abs_err": k6_err, "ms": k6_ms, "plain_ms": k6_plain,
             "bound_ms": k6_bound, "bound_by": k6_by, "library_ms": None, "parity": k6_ok,
             "bound_ms_sector": k6_sector, "ms_sweep": k6_sweep,
             "survivors_after_tile0": k6_listed, **geo,
             "work": f"sum over the {N_SINGLE} queries of one call each"}]
    assert geo["body"] == "list" and geo["tail_blocks"] > 0, f"flat_scan: K6 shape {geo}"

    # K7: the batch over the block, f32 and bf16 operands, l2 and ip
    k7 = {}
    for (dt, m), out in k7_out.items():
        Tx, Qx = operands[dt]
        T32, Q32 = Tx.to(torch.float32), Qx.to(torch.float32)
        qn, xn = squared_norms(Qx, 1), squared_norms(Tx, 0)
        want = ref.batched_distance_ref(Tx, Qx, m)
        diff = (out - want).abs()
        ok = bool((diff <= 1e-5 * (qn[:, None] + xn[None, :]) + 1e-3).all())
        err = float(diff.max())
        del diff, want
        B = Qx.shape[0]
        ms = cuda_ms(torch, lambda: batched_distance_cuda(Tx, Qx, qn, xn, metric=m))
        op_ms = cuda_ms(torch, lambda: batched_distance_op(Tx, Qx, m))
        plain = cuda_ms(torch, lambda: ref.batched_distance_ref(Tx, Qx, m))
        lib = cuda_ms(torch, lambda: torch.matmul(Q32, T32))
        # T and Q at their width, the (B, n) f32 output, the norms (l2); the
        # product at its operands' peak, the epilogue on the SIMT cores
        nbytes = (Tx.numel() * Tx.element_size() + Qx.numel() * Qx.element_size()
                  + B * n * 4 + ((B + n) * 4 if m == "l2" else 0))
        peak = product_peak(Tx.dtype == torch.float32, Qx.dtype == torch.float32)
        b, by = bound_ms(nbytes, 2.0 * B * D * n, peak, (3.0 if m == "l2" else 1.0) * B * n)
        k7[f"{dt}_{m}"] = {"ms": ms, "op_ms": op_ms, "bound_ms": b, "bound_by": by,
                           "max_abs_err": err, "launches": k7_launches[(dt, m)]}
        rows.append({"name": f"K7 batched_distance [{dt} {m}, B={B}, rotated {n} x {D}]",
                     "route": "cuda", "source": K7_SOURCE, "replaces": K7_REPLACES,
                     "launches": k7_launches[(dt, m)], "max_abs_err": err, "ms": ms,
                     "plain_ms": plain, "bound_ms": b, "bound_by": by, "library_ms": lib,
                     "parity": ok, "op_ms": op_ms,
                     "library_call": "torch.matmul(Q, T) on f32 operands, cross term only"})
        del T32, Q32
        assert ok, f"flat_scan: K7 {dt} {m} disagrees with its plain version"
    ratios = [r["pruned_vs_full"] for r in per_query]
    rec = statistics.mean(r["recall_at_10"] for r in per_query)
    # the exact threshold and ADSampling's test keep the true neighbours as
    # the fused-scan executor's do: held to its f32 floor
    assert rec >= RECALL_FLOORS["f32"][0], f"flat_scan: recall@10 of K6 survivors {rec}"
    line = {"phase": "flat_scan", "n": n, "dim": D, "eps0": eps0, "d_tile": 64,
            "launches": got, "k4_ms": k4_ms,
            "pruned_vs_full": {"median": statistics.median(ratios), "min": min(ratios),
                               "max": max(ratios)},
            "survivors_median": statistics.median(r["survivors"] for r in per_query),
            "recall_at_10_of_survivors": rec,
            "queries": per_query, "k7": k7, **extra}
    del T, T16, Q16, k6_out, k7_out, ws
    torch.cuda.empty_cache()
    return line, rows


def timed(torch, fn) -> tuple[object, float]:
    """(fn(), seconds) on the host clock, the card synchronized on both
    sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def mutable_round(torch, eng, Q, Qd, Xall, gt, dead, own, own_ids, counters,
                  tag: str) -> tuple[dict, dict]:
    """One pass over the mutable store: the device tensors and the mirrors
    the searches need, rebuilt and timed first; then, with the launch
    counters zeroed just before and read just after, 16 single queries
    (``fused-scan``) and a batch of 64 (``fused-batch``) at f32 and int8,
    16 single queries through cascade ladder A (``cascade-scan``), and the
    inserted rows ``own`` queried as themselves.  Asserts the executors,
    recall@10 against ``gt`` (the live set's ground truth), returned
    distances exact, no deleted id, each own row at rank 0, and every
    kernel launched.  -> (phase line, launches by kernel row name)."""
    from repro_torch.core.engine import SearchSpec
    from repro_torch.core.layout import device_mirror, projection_mirror
    from repro_torch.core.plan import _merge_write_head

    store = eng.store
    out = {"phase": "mutable", "round": tag, "tiles_version": store.tiles_version,
           "version": store.version, "partitions": store.num_partitions,
           "head_live_rows": store.head_count, "fragmentation": store.fragmentation}
    _, out["upload_s"] = timed(torch, lambda: store.data)
    _, out["mirror_int8_s"] = timed(torch, lambda: device_mirror(store, "int8"))
    _, out["mirror_int4_s"] = timed(torch, lambda: device_mirror(store, "int4"))
    _, out["projection_mirror_s"] = timed(torch, lambda: projection_mirror(store, 32, "int8"))
    for c in counters.values():
        c.launches = 0
    launches = {}

    def counted(name, kernel, fn):
        n0 = counters[kernel].launches
        res = fn()
        launches[name] = launches.get(name, 0) + counters[kernel].launches - n0
        return res

    for dt in ("f32", "int8"):
        spec = SearchSpec(k=K, scan_dtype=dt)
        singles, t_scan = timed(torch, lambda: counted(
            f"K1 pdx_prune_scan_multi [{dt}]", "k1",
            lambda: [eng.search(Q[i], spec) for i in range(N_SINGLE)]))
        batch, t_batch = timed(torch, lambda: counted(
            f"K2 batched_distance_quant [{dt}]", "k2", lambda: eng.search(Q, spec)))
        assert all(r.plan.executor == "fused-scan" for r in singles)
        assert batch.plan.executor == "fused-batch", batch.plan
        s_ids = np.stack([r.ids for r in singles])
        s_d = np.stack([r.dists for r in singles])
        line = {"fused_scan_recall_at_10": recall(s_ids, gt[:N_SINGLE]),
                "fused_batch_recall_at_10": recall(batch.ids, gt),
                "fused_scan_dist_rel_err": dist_error(torch, Xall, Qd[:N_SINGLE], s_ids, s_d),
                "fused_batch_dist_rel_err": dist_error(torch, Xall, Qd, batch.ids, batch.dists),
                "fused_scan_ms_per_query": t_scan / N_SINGLE * 1e3,
                "fused_batch_ms_per_batch_of_64": t_batch * 1e3}
        out[dt] = line
        assert not np.isin(s_ids, dead).any() and not np.isin(batch.ids, dead).any(), \
            f"{tag} {dt}: a deleted id was returned"
        assert max(line["fused_scan_dist_rel_err"], line["fused_batch_dist_rel_err"]) <= 1e-3
        f_scan, f_batch = RECALL_FLOORS[dt]
        assert line["fused_scan_recall_at_10"] >= f_scan, (tag, dt, line)
        assert line["fused_batch_recall_at_10"] >= f_batch, (tag, dt, line)
        # the inserted rows as queries: each finds itself first
        own_s = counted(f"K1 pdx_prune_scan_multi [{dt}]", "k1",
                        lambda: [eng.search(v, spec).ids[0] for v in own])
        own_b = counted(f"K2 batched_distance_quant [{dt}]", "k2",
                        lambda: eng.search(own, spec).ids[:, 0])
        assert np.array_equal(own_s, own_ids) and np.array_equal(own_b, own_ids), \
            (tag, dt, own_s, own_b, own_ids)
        if dt == "f32":  # the write-head merge alone, as execute runs it
            _, m64 = timed(torch, lambda: _merge_write_head(
                store, eng.pruner, Qd, spec, batch.ids, batch.dists))
            _, m1 = timed(torch, lambda: _merge_write_head(
                store, eng.pruner, Qd[:1], spec, s_ids[:1], s_d[:1]))
            out["merge_ms_batch_of_64"], out["merge_ms_single"] = m64 * 1e3, m1 * 1e3
    spec = SearchSpec(k=K, cascade=LADDERS["A"])
    k3_name = f"K3 pdx_prune_scan_multi_prefetch [{LADDERS['A'][1]}]"
    n1, n3 = counters["k1"].launches, counters["k3"].launches
    res, t_c = timed(torch, lambda: [eng.search(Q[i], spec) for i in range(N_SINGLE)])
    launches[f"K1 pdx_prune_scan_multi [{LADDERS['A'][0]}]"] = counters["k1"].launches - n1
    launches[k3_name] = counters["k3"].launches - n3
    assert all(r.plan.executor == "cascade-scan" for r in res)
    c_ids = np.stack([r.ids for r in res])
    c_d = np.stack([r.dists for r in res])
    out["cascade_scan"] = {"ladder": list(LADDERS["A"]),
                           "recall_at_10": recall(c_ids, gt[:N_SINGLE]),
                           "dist_rel_err": dist_error(torch, Xall, Qd[:N_SINGLE], c_ids, c_d),
                           "ms_per_query": t_c / N_SINGLE * 1e3}
    assert not np.isin(c_ids, dead).any(), f"{tag} cascade: a deleted id was returned"
    assert out["cascade_scan"]["recall_at_10"] >= CASCADE_RECALL_FLOOR, out["cascade_scan"]
    assert out["cascade_scan"]["dist_rel_err"] <= 1e-3, out["cascade_scan"]
    # one int8 tiered batch over the mutable store, a pool of P // 4 slots
    S = store.num_partitions // 4
    spec = SearchSpec(k=K, nprobe=TIERED_NPROBE, hbm_slots=S, scan_dtype="int8")
    n2 = counters["k2"].launches
    res, t_t = timed(torch, lambda: eng.search(Q[:TIERED_BATCH], spec))
    launches["K2 batched_distance_quant [int8, tiered pool]"] = counters["k2"].launches - n2
    assert res.plan.executor == "tiered-scan", res.plan
    Qb = Qd[:TIERED_BATCH]
    sel = eng.ivf.route_batch(eng.pruner.transform_batch(Qb), TIERED_NPROBE)
    truth, allowed = routed_truth(torch, eng.ivf, store.ids.cpu().numpy(), Xall, Qb, sel,
                                  extra=store.head_live()[0])
    outside = sum(len(set(g.tolist()) - a) for g, a in zip(res.ids, allowed))
    out["tiered"] = {"hbm_slots": S, "generation": store._tiered_cache[(S, "int8", 1)].generation,
                     "recall_at_10_routed": recall(res.ids, truth),
                     "dist_rel_err": dist_error(torch, Xall, Qb, res.ids, res.dists),
                     "ids_outside_routed_buckets": outside, "wall_ms": t_t * 1e3}
    store._tiered_cache = {}
    store.__dict__.pop("_host_rows_cache", None)
    assert not np.isin(res.ids, dead).any(), f"{tag} tiered: a deleted id was returned"
    assert out["tiered"]["recall_at_10_routed"] >= TIERED_RECALL_FLOOR, out["tiered"]
    assert out["tiered"]["dist_rel_err"] <= 1e-3 and outside == 0, out["tiered"]
    totals = {k: c.launches for k, c in counters.items()}
    out["launches"] = totals
    assert all(v > 0 for v in totals.values()), f"{tag}: a kernel never launched {totals}"
    out["device_mem_gb"] = torch.cuda.memory_allocated() / 1e9
    out["device_mem_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out, launches


def mutable_phase(torch, eng, Xd, Q, Qd, seed: int, counters: dict) -> tuple[list, dict, dict]:
    """The mutable store on the main path's IVF engine: MUT_DELETE ids chosen
    at random from ``seed`` deleted, MUT_INSERT new rows (``make_dataset``, the
    same kind, seed + 2) inserted in batches of 200 (flushes through
    free-slot fill), then ``mutable_round`` with live write-head rows, then
    ``compact()`` and ``mutable_round`` again.  The ground truth is that of
    the live set (the rows minus the deleted plus the inserted), computed
    on the card by direct f32 differences.  -> (phase lines, launches by
    kernel row name and round, the live set: ``Xall`` (row i the vector of
    id i), ``gt`` and the ``dead`` ids)."""
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.obs import metrics

    n, D = Xd.shape
    dev = Xd.device
    lines = []
    line = {"phase": "mutable", "round": "churn", "n": n, "dim": D,
            "deleted": MUT_DELETE, "inserted": MUT_INSERT, "insert_batch": MUT_BATCH}
    torch.cuda.reset_peak_memory_stats()
    line["device_mem_gb_before"] = torch.cuda.memory_allocated() / 1e9
    store, line["from_store_s"] = timed(torch, eng._ensure_mutable)
    line["device_mem_gb_after_from_store"] = torch.cuda.memory_allocated() / 1e9
    dead = np.random.default_rng(seed).choice(n, size=MUT_DELETE, replace=False)
    removed, line["delete_s"] = timed(torch, lambda: eng.delete(dead))
    assert removed == MUT_DELETE, removed
    new, _ = make_dataset(MUT_INSERT, D, "clustered", n_queries=1, seed=seed + 2)
    # the store's own meters count the flushes and the repacks they fall back to
    reg = metrics.get_registry()
    reg.reset()
    metrics.set_enabled(True)
    try:
        new_ids, line["insert_s"] = timed(torch, lambda: np.concatenate([
            eng.insert(new[lo:lo + MUT_BATCH]) for lo in range(0, MUT_INSERT, MUT_BATCH)]))
        line["flushes"] = reg.get("repro_store_mutations_total", op="flush")
        line["repacks"] = reg.get("repro_store_mutations_total", op="repack")
    finally:
        metrics.set_enabled(False)
        reg.reset()
    assert np.array_equal(new_ids, np.arange(n, n + MUT_INSERT)), new_ids[:4]
    line.update(tiles_version=store.tiles_version, version=store.version,
                head_live_rows=store.head_count, num_vectors=store.num_vectors)
    assert store.head_count > 0, "the write-head holds no live row at the first search"
    assert store.num_vectors == n
    lines.append(line)

    # row i of Xall is the vector of id i; the live set's ground truth
    Xall = torch.cat([Xd, torch.from_numpy(new).to(dev)])
    live_ids = np.setdiff1d(np.arange(n + MUT_INSERT), dead)
    live_t = torch.from_numpy(live_ids).to(dev)
    gt, t_gt = timed(torch, lambda: live_ids[ground_truth(torch, Xall[live_t], Qd, K)])
    lines[0]["ground_truth_s"] = t_gt
    # inserted rows queried as themselves: the first 8 were flushed into
    # sealed slots, the last 8 are live in the write-head
    pick = np.r_[0:MUT_SELF // 2, MUT_INSERT - MUT_SELF // 2:MUT_INSERT]
    own, own_ids = new[pick], new_ids[pick]
    assert all(store._id_loc[int(i)][0] == "h" for i in own_ids[MUT_SELF // 2:])
    launches = {}
    for tag in ("churn", "compacted"):
        if tag == "compacted":
            _, t_compact = timed(torch, eng.compact)
            assert store.head_count == 0
            assert store.fragmentation <= lines[1]["fragmentation"]
        line, launches[tag] = mutable_round(torch, eng, Q, Qd, Xall, gt, dead, own, own_ids,
                                            counters, tag)
        if tag == "compacted":
            line["compact_s"] = t_compact
            assert line["tiered"]["generation"] != lines[-1]["tiered"]["generation"], \
                "the tiered pool kept its generation across compact()"
        lines.append(line)
    return lines, launches, {"Xall": Xall, "gt": gt, "dead": dead}


def jit_masked_phase(torch, Xd, Q, seed: int, counters: dict) -> dict:
    """A flat ADSampling engine over the first 65,536 rows (64 partitions of
    1024 at the full D): 4 queries with ``prefer_static=True`` planned to
    ``jit-masked`` and their ids held to the ``adaptive`` executor's (as
    sets, as ``tests/test_pdxearch.py`` holds them).  ``kernel="torch"``
    keeps the planner off the fused executors, which a CUDA store picks
    first; both executors are plain PyTorch, so no kernel launches."""
    from repro_torch.core.engine import SearchSpec, VectorSearchEngine

    rows = MASKED_ROWS
    X = Xd[:rows].cpu().numpy()
    eng, t_build = timed(torch, lambda: VectorSearchEngine.build(
        X, pruner="adsampling", capacity=1024, seed=seed, device=Xd.device))
    masked = SearchSpec(k=K, prefer_static=True, kernel="torch")
    adaptive = SearchSpec(k=K, kernel="torch")
    eng.search(Q[0], masked)  # warm the allocator, uncounted
    for c in counters.values():
        c.launches = 0
    got, t_m = timed(torch, lambda: [eng.search(Q[i], masked) for i in range(MASKED_QUERIES)])
    want, t_a = timed(torch, lambda: [eng.search(Q[i], adaptive) for i in range(MASKED_QUERIES)])
    launched = {k: c.launches for k, c in counters.items()}
    assert all(r.plan.executor == "jit-masked" for r in got), got[0].plan
    assert all(r.plan.executor == "adaptive" for r in want), want[0].plan
    same = [set(g.ids.tolist()) == set(w.ids.tolist()) for g, w in zip(got, want)]
    close = all(np.allclose(np.sort(g.dists), np.sort(w.dists), rtol=1e-4)
                for g, w in zip(got, want))
    line = {"phase": "jit_masked", "rows": rows, "dim": X.shape[1],
            "partitions": eng.store.num_partitions, "queries": MASKED_QUERIES,
            "build_s": t_build, "jit_masked_ms_per_query": t_m / MASKED_QUERIES * 1e3,
            "adaptive_ms_per_query": t_a / MASKED_QUERIES * 1e3,
            "ids_equal_adaptive": same, "dists_close": close, "launches": launched}
    assert all(same) and close, line
    assert not any(launched.values()), launched
    return line


def tiered_queries(seed: int, D: int, n_clusters: int = 64) -> np.ndarray:
    """``benchmarks/bench_tiered.py:_clustered``'s query stream over the
    clusters of ``make_dataset(kind="clustered", seed=seed)``: that call's
    first two draws are its cluster centres and widths; zipf(a) ranks over
    a seeded permutation of the clusters pick the hot ones, and each query
    is a hot cluster's centre plus that cluster's noise."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, D)) * 4.0
    widths = rng.uniform(0.3, 1.2, size=(n_clusters, 1))
    qrng = np.random.default_rng(seed + 3)
    ranks = qrng.zipf(TIERED_ZIPF, size=TIERED_QUERIES)
    hot = qrng.permutation(n_clusters)[np.minimum(ranks - 1, n_clusters - 1)]
    Q = centers[hot] + qrng.standard_normal((TIERED_QUERIES, D)) * widths[hot]
    return Q.astype(np.float32)


def routed_truth(torch, ivf, ids_host, Xall, Qd, sel, extra=None):
    """(exact top-K ids within each query's routed buckets, by direct f32
    differences on the card; the routed id set of each query).  ``extra``
    ids (a write-head's live rows) join every query's set."""
    truth, allowed = [], []
    for qi, row in enumerate(sel):
        parts = ivf.partition_order(np.asarray(row), len(row))
        cand = ids_host[parts].reshape(-1)
        cand = cand[cand >= 0]
        if extra is not None:
            cand = np.concatenate([cand, extra])
        allowed.append(set(cand.tolist()))
        c = torch.from_numpy(cand.astype(np.int64)).to(Xall.device)
        diff = Xall[c] - Qd[qi][None, :]
        d = torch.sum(diff * diff, dim=1)
        top = torch.topk(d, min(K, len(cand)), largest=False).indices.cpu().numpy()
        truth.append(cand[top])
    return np.stack(truth), allowed


class CallTimer:
    """Wraps a callable, adding up the host seconds spent in it."""

    def __init__(self, fn):
        self.fn, self.seconds, self.calls = fn, 0.0, 0

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return self.fn(*args, **kwargs)
        finally:
            self.seconds += time.perf_counter() - t0
            self.calls += 1


def tiered_steps(plan, sel, cnts, region_slots: int) -> int:
    """(chunk, pass) steps the tiered executor runs for one batch."""
    chunks = plan._tiered_chunks(sel, cnts, lambda b: 0, region_slots)
    return sum(len(plan._chunk_passes(sel[c], cnts, lambda b: 0, region_slots))
               for c in chunks)


def tiered_pass(torch, eng, batches, sels, spec, reg, k2) -> dict:
    """The batches through ``engine.search`` under ``spec`` (tiered-scan):
    each batch's wall, K2 launched once per (chunk, pass) step, and the
    cache's counters over the pass (the registry is on).  -> the pass's
    record, ids and dists included."""
    from repro_torch.core import plan

    bc = plan._get_bucket_cache(eng.store, spec, ivf=eng.ivf)
    cnts = np.asarray(eng.ivf.part_counts)
    keys = ("hit", "miss", "evict")
    before = {e: reg.get("repro_tiered_cache_events_total", event=e) for e in keys}
    bytes0 = reg.get("repro_tiered_prefetch_bytes_total", dtype=spec.scan_dtype)
    walls, ids, dists, launched = [], [], [], 0
    for Qb, sel in zip(batches, sels):
        steps = tiered_steps(plan, sel, cnts, bc.region_slots)
        n0 = k2.launches
        t0 = time.perf_counter()
        res = eng.search(Qb, spec)
        walls.append((time.perf_counter() - t0) * 1e3)
        assert res.plan.executor == "tiered-scan", res.plan
        assert k2.launches - n0 == steps, (k2.launches - n0, steps)
        launched += steps
        ids.append(res.ids)
        dists.append(res.dists)
    ev = {e: reg.get("repro_tiered_cache_events_total", event=e) - before[e] for e in keys}
    looked = ev["hit"] + ev["miss"]
    h2d = reg.get("repro_tiered_prefetch_bytes_total", dtype=spec.scan_dtype) - bytes0
    # the counter holds the bytes that crossed: quantized where the worker
    # staged, f32 on the blocking path
    per_value = 4.0 if bc.sync_uploads or not bc.stage_on_host else bc.bytes_per_value
    return {"wall_ms_per_batch": walls, "wall_ms_median": statistics.median(walls),
            "hits": ev["hit"], "misses": ev["miss"], "evictions": ev["evict"],
            "uploaded_slots": h2d / (bc.dim * eng.store.capacity * per_value),
            "hit_rate": ev["hit"] / looked if looked else 1.0,
            "h2d_bytes": h2d, "k2_launches": launched,
            "ids": np.concatenate(ids), "dists": np.concatenate(dists)}


def tiered_phase(torch, ref, eng, Xd, seed: int, k2) -> tuple[list, list, dict]:
    """Tiered serving on the main path's IVF engine: 256 queries drawn as
    ``tiered_queries`` in 16 batches of 16 through ``tiered-scan`` with
    ``hbm_slots`` = P // 4 (the store at least 4x the pool), k = 10,
    nprobe = 8, per scan dtype a cold pass then a warm pass (K2 counted,
    once per step), held at f32 and int8 (recorded at int4) to: ids equal
    to a pool of all P slots, recall@10 against the exact top-10 within
    each query's routed buckets, exact returned distances, no id outside
    the routed buckets, a warm hit rate, and ``sync_uploads`` giving the
    same ids and misses.  Then the two-level tree on a copy of the index.
    Emits a phase line per dtype and the tree's, each before its asserts.
    -> (K2 rows on the pool's shape, K2 launches by dtype)."""
    import dataclasses

    from repro_torch.core import layout, plan
    from repro_torch.core.engine import SearchSpec
    from repro_torch.index.kmeans import build_centroid_tree
    from repro_torch.obs import metrics

    store, ivf = eng.store, eng.ivf
    P, D, C = store.data.shape
    S = P // 4
    cnts = np.asarray(ivf.part_counts)
    floor = int(np.sort(cnts)[-TIERED_NPROBE:].sum())
    assert S >= floor, (S, floor)  # any query's routed demand fits the pool
    Q = tiered_queries(seed, D)
    Qd = torch.from_numpy(Q).to(Xd.device)
    Qt = eng.pruner.transform_batch(Qd)
    sel = ivf.route_batch(Qt, TIERED_NPROBE)
    batches = [Q[lo:lo + TIERED_BATCH] for lo in range(0, TIERED_QUERIES, TIERED_BATCH)]
    sels = [sel[lo:lo + TIERED_BATCH] for lo in range(0, TIERED_QUERIES, TIERED_BATCH)]
    ids_host = store.ids.cpu().numpy()
    truth, allowed = routed_truth(torch, ivf, ids_host, Xd, Qd, sel)
    rows, launches = {}, {}
    reg = metrics.get_registry()
    reg.reset()
    metrics.set_enabled(True)
    rerank = CallTimer(plan._tiered_rerank)
    plan._tiered_rerank = rerank
    try:
        # the first search's set-up, timed step by step: the host pull of the
        # masters, the sorted host rows of the re-rank
        _, t_pull = timed(torch, lambda: layout._host_masters(store))
        _, t_rows = timed(torch, lambda: plan._host_master_rows(store))
        for dt in TIERED_DTYPES:
            reg.reset()  # the upload-wait histogram of this dtype's passes
            spec = SearchSpec(k=K, nprobe=TIERED_NPROBE, hbm_slots=S, scan_dtype=dt)
            line = {"phase": "tiered", "scan_dtype": dt, "n": Xd.shape[0], "dim": D,
                    "partitions": P, "hbm_slots": S, "nprobe": TIERED_NPROBE,
                    "queries": TIERED_QUERIES, "batch": TIERED_BATCH,
                    "routed_demand_floor_slots": floor,
                    "host_pull_s": t_pull, "host_rows_s": t_rows}
            bc = plan._get_bucket_cache(store, spec, ivf=ivf)
            quant = CallTimer(bc._host_quantize)
            bc._host_quantize = quant
            params = CallTimer(layout._host_quant_params)
            layout._host_quant_params = params
            try:  # the quant params, then the pool's allocation
                _, line["revalidate_s"] = timed(torch, bc._revalidate)
            finally:
                layout._host_quant_params = params.fn
            line["quant_params_s"] = params.seconds
            pool = bc._pool
            line["pool_bytes"] = pool.numel() * pool.element_size()
            line["device_mem_gb"] = torch.cuda.memory_allocated() / 1e9
            k2.launches = 0
            cold = tiered_pass(torch, eng, batches, sels, spec, reg, k2)
            line["host_quantize_s_cold"], line["host_quantize_extents_cold"] = (
                quant.seconds, quant.calls)
            warm = tiered_pass(torch, eng, batches, sels, spec, reg, k2)
            launches[dt] = k2.launches
            assert launches[dt] == cold["k2_launches"] + warm["k2_launches"]
            # K2 on the pool's shape (S slots, a batch of 16) against its plain
            # version, on the pool as the warm pass left it
            pool, ids_dev, _, sc, off = bc.arrays()
            rows[dt] = k2_kernel_row(
                torch, ref, pool, Qt[:TIERED_BATCH].contiguous(),
                sc if bc.quantized else None, off if bc.quantized else None,
                bc.packed, D, dt, f"K2 batched_distance_quant [{dt}, tiered pool]",
                launches[dt], (ids_dev >= 0).reshape(-1))
            del pool, ids_dev, sc, off
            hist = reg.snapshot()["histograms"].get("repro_cache_upload_wait_us", {})
            line["upload_wait_us"] = {k: {"count": v["count"], "sum": v["sum"]}
                                      for k, v in hist.items()}
            line["upload_overlap_ratio"] = reg.get("repro_cache_upload_overlap_ratio")
            got, dists = warm["ids"], warm["dists"]
            assert np.array_equal(cold["ids"], got), f"{dt}: cold and warm ids differ"
            line["recall_at_10_routed"] = recall(got, truth)
            line["dist_rel_err"] = dist_error(torch, Xd, Qd, got, dists)
            outside = sum(len(set(g.tolist()) - a) for g, a in zip(got, allowed))
            line["ids_outside_routed_buckets"] = outside
            # a pool of every slot: the fully resident cache
            full = spec.replace(hbm_slots=P)
            res_full = tiered_pass(torch, eng, batches, sels, full, reg, k2)
            line["ids_equal_full_pool"] = bool(np.array_equal(res_full["ids"], got))
            del store._tiered_cache[(P, dt, 1)], res_full
            # the blocking upload path on a fresh pool: same ids, same misses
            del store._tiered_cache[(S, dt, 1)]
            bc_sync = plan._get_bucket_cache(store, spec, ivf=ivf)
            bc_sync.sync_uploads = True
            bc_sync._revalidate()  # set-up, out of the timed pass
            sync = tiered_pass(torch, eng, batches, sels, spec, reg, k2)
            line["sync_ids_equal"] = bool(np.array_equal(sync["ids"], cold["ids"]))
            line["sync_misses_equal"] = sync["misses"] == cold["misses"]
            del store._tiered_cache[(S, dt, 1)]
            for name, rec in (("cold", cold), ("warm", warm), ("sync_cold", sync)):
                line[name] = {k: v for k, v in rec.items() if k not in ("ids", "dists")}
            if dt == TIERED_PROFILE_DTYPE:
                # where a cold and a warm batch spend their time, on a fresh pool
                bc = plan._get_bucket_cache(store, spec, ivf=ivf)
                bc._revalidate()  # set-up, out of the profiled batch
                for tag in ("cold", "warm"):
                    quant = CallTimer(bc._host_quantize)
                    bc._host_quantize = quant
                    r0 = rerank.seconds
                    prof = device_profile(torch, lambda: eng.search(batches[0], spec))
                    prof.update(host_quantize_s=quant.seconds,
                                host_rerank_s=rerank.seconds - r0)
                    line[f"profile_{tag}_batch"] = prof
            store._tiered_cache.clear()
            emit(line)
            if dt in TIERED_HELD:
                assert line["recall_at_10_routed"] >= TIERED_RECALL_FLOOR, line
                assert warm["hit_rate"] >= TIERED_HIT_FLOOR, line["warm"]
                assert line["ids_equal_full_pool"], f"{dt}: ids differ from a full pool"
                assert line["sync_ids_equal"] and line["sync_misses_equal"], line
            assert line["dist_rel_err"] <= 1e-3, line
            assert outside == 0, f"{dt}: {outside} ids outside the routed buckets"

        # the two-level tree, on copies of the index (other phases keep flat
        # routing): the bench rule's tree, and the same super-centroids with
        # the balance cap lifted (every centroid under its nearest super)
        nlist = ivf.nlist
        tree = dataclasses.replace(ivf)
        _, t_tree = timed(torch, lambda: tree.attach_tree(
            max(8, int(np.sqrt(nlist))), TREE_NPROBE_SUPER))
        SK, M = tree.super_children.shape
        free = dataclasses.replace(ivf)
        sc_free, ch_free = build_centroid_tree(ivf.centroids.cpu().numpy(), SK,
                                               balance=float(nlist), device=Xd.device)
        free.super_centroids = torch.from_numpy(sc_free).to(Xd.device)
        free.super_children = torch.from_numpy(ch_free).to(Xd.device)
        free.nprobe_super = TREE_NPROBE_SUPER
        spec = SearchSpec(k=K, nprobe=TIERED_NPROBE, hbm_slots=S, scan_dtype="int8")
        flat = tiered_pass(torch, eng, batches, sels, spec, reg, k2)
        tline = {"phase": "tiered_tree", "nlist": nlist, "super_k": SK, "max_children": M,
                 "nprobe_super": tree.nprobe_super, "routing_cost": tree.routing_cost(),
                 "max_children_uncapped": int(ch_free.shape[1]),
                 "routing_cost_uncapped": free.routing_cost(), "attach_s": t_tree,
                 "wall_ms_median_flat": flat["wall_ms_median"]}
        for tag, idx in (("", tree), ("_uncapped", free)):
            sel_t = idx.route_batch(Qt, TIERED_NPROBE)
            sels_t = [sel_t[lo:lo + TIERED_BATCH]
                      for lo in range(0, TIERED_QUERIES, TIERED_BATCH)]
            res = tiered_pass(torch, dataclasses.replace(eng, ivf=idx), batches, sels_t,
                              spec, reg, k2)
            truth_t, allowed_t = routed_truth(torch, idx, ids_host, Xd, Qd, sel_t)
            tline.update({
                f"bucket_overlap_with_flat{tag}": float(np.mean(
                    [len(set(a.tolist()) & set(b.tolist())) / TIERED_NPROBE
                     for a, b in zip(sel_t, sel)])),
                f"tiered_recall_vs_flat{tag}": recall(res["ids"], flat["ids"]),
                f"recall_at_10_routed{tag}": recall(res["ids"], truth_t),
                f"ids_outside_routed_buckets{tag}": sum(
                    len(set(g.tolist()) - a) for g, a in zip(res["ids"], allowed_t)),
                f"wall_ms_median_tree{tag}": res["wall_ms_median"]})
        store._tiered_cache.clear()
        emit(tline)
        assert tree.routing_cost() == SK + TREE_NPROBE_SUPER * M < nlist, tline
        # the executor answers exactly within whatever buckets the tree routes
        for tag in ("", "_uncapped"):
            assert tline[f"recall_at_10_routed{tag}"] >= TIERED_RECALL_FLOOR, tline
            assert tline[f"ids_outside_routed_buckets{tag}"] == 0, tline
        # the descent finds flat routing's buckets where the reference's
        # balance cap leaves each centroid under its nearest super; with the
        # cap the overlap is the reference's and is recorded (ROADMAP
        # section 3: the cap moves a whole cluster's lists out of reach)
        assert tline["bucket_overlap_with_flat_uncapped"] >= TREE_OVERLAP_FLOOR, tline
        assert tline["tiered_recall_vs_flat_uncapped"] >= TREE_RECALL_FLOOR, tline
    finally:
        plan._tiered_rerank = rerank.fn
        metrics.set_enabled(False)
        reg.reset()
        store._tiered_cache = {}
    # the host masters and sorted rows stay for phase serve, which drops them
    return list(rows.values()), launches


# ------------------------------------------------------------- serving
def serve_queries(seed: int, D: int, n: int, n_clusters: int = 64) -> np.ndarray:
    """``n`` queries drawn as the main path's are (``make_dataset``'s
    clustered kind): that call's first two draws are its cluster centres
    and widths; a stream of its own (``seed + 4``) picks each query's
    cluster and noise."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, D)) * 4.0
    widths = rng.uniform(0.3, 1.2, size=(n_clusters, 1))
    qrng = np.random.default_rng(seed + 4)
    qa = qrng.integers(0, n_clusters, size=n)
    Q = centers[qa] + qrng.standard_normal((n, D)) * widths[qa]
    return Q.astype(np.float32)


def ground_truth_many(torch, X, Q, k: int, cand: int = 64, chunk: int = 1 << 17,
                      qchunk: int = 256) -> np.ndarray:
    """Exact top-k ids of many queries: each query's nearest ``cand`` rows
    by the matmul form ``||x||^2 - 2 q.x`` in f32 (TF32 off), re-scored by
    direct f32 differences, the nearest ``k`` of those kept.  The form's
    error (about 1e-7 of the norms) is far below the gap between a
    clustered query's 10th and 64th neighbours."""
    xn = torch.sum(X * X, dim=1)
    out = []
    for q0 in range(0, Q.shape[0], qchunk):
        Qc = Q[q0:q0 + qchunk]
        best_d = best_i = None
        for lo in range(0, X.shape[0], chunk):
            d = xn[None, lo:lo + chunk] - 2.0 * (Qc @ X[lo:lo + chunk].T)
            dd, ii = torch.topk(d, min(cand, d.shape[1]), dim=1, largest=False)
            ii = ii + lo
            if best_d is not None:
                dd, sel = torch.topk(torch.cat([best_d, dd], 1), cand, dim=1, largest=False)
                ii = torch.gather(torch.cat([best_i, ii], 1), 1, sel)
            best_d, best_i = dd, ii
        diff = X[best_i] - Qc[:, None, :]
        exact = torch.sum(diff * diff, dim=2)
        top = torch.topk(exact, k, dim=1, largest=False).indices
        out.append(torch.gather(best_i, 1, top))
    return torch.cat(out).cpu().numpy()


def recording_server(VectorServer):
    """A ``VectorServer`` that keeps a record of every batch it runs (its
    bucket, executor, queries' futures and enqueue times, plan time, run
    window and the store's tiles_version after it) and of every swap it
    applies.  Adds nothing to the path but the bookkeeping."""

    class RecordingServer(VectorServer):
        def __init__(self, *args, **kwargs):
            self.batches, self.swaps = [], []
            super().__init__(*args, **kwargs)

        def _run_batch(self, b):
            rec = {"bucket": b.bucket, "n": len(b.items),
                   "futures": [it.future for it in b.items],
                   "t_enqueue": [it.t_enqueue for it in b.items],
                   "plan_s": b.t_plan1 - b.t_plan0, "t_run": time.perf_counter(),
                   "t_done": None}
            self.batches.append(rec)
            super()._run_batch(b)
            rec["executor"] = b.prepared.plan.executor
            rec["tiles_version"] = getattr(self.engine.store, "tiles_version", 0)
            rec["t_done"] = time.perf_counter()

        def records(self) -> list:
            """The batch records, once the executor has finished writing
            them (a batch's futures resolve just before its record does)."""
            t_end = time.perf_counter() + 5.0
            while (any(r["t_done"] is None for r in self.batches)
                   and time.perf_counter() < t_end):
                time.sleep(0.001)
            return self.batches

        def _apply_swap(self, s):
            v0 = getattr(self.engine.store, "tiles_version", 0)
            super()._apply_swap(s)
            self.swaps.append({"t": time.perf_counter(),
                               "adopted": self.engine.store.tiles_version != v0})

    return RecordingServer


def open_loop(torch, srv, Q, specs, rate: float, seed: int, profile: bool = False,
              until=None) -> dict:
    """Submit the rows of ``Q`` one by one (spec ``specs[i % len(specs)]``)
    at lognormal inter-arrival gaps of mean ``1 / rate`` (sigma 1, as
    ``benchmarks/bench_serve.py`` draws them), cycling through ``Q`` while
    ``until()`` is false when it is given; wait for every future (a
    failure raises).  With ``profile``, ``torch.profiler`` traces the card
    over the whole run; it starts and stops only while the server's
    threads are idle (before the first submission, after the last batch),
    never while another thread launches work.  Where the server's
    admission queue is full (``ServerOverloaded``, its backpressure), the
    query is offered again after a flush interval and the refusal counted:
    the loop then offers what the server drains.  -> per query: result,
    submit and done time; QPS, p50, p99, the refusals and the profile."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    from repro_torch.serve import ServerOverloaded

    n = len(Q) if until is None else 1 << 30
    gaps = np.random.default_rng(seed).lognormal(
        mean=np.log(1.0 / rate) - 0.5, sigma=1.0, size=min(n, 1 << 20))
    futs, t_sub, qi, done = [], [], [], {}
    refused = 0
    prof = prof_out = None
    if profile:
        torch.cuda.synchronize()
        prof = tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
    t_start = time.perf_counter()
    next_at = t_start
    i = 0
    while i < n and (until is None or not until()):
        next_at += gaps[i % len(gaps)]
        delay = next_at - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        t = time.perf_counter()
        try:
            f = srv.submit(Q[i % len(Q)], specs[i % len(specs)])
        except ServerOverloaded:
            refused += 1
            next_at = time.perf_counter() + SERVE_FLUSH_S
            continue
        t_sub.append(t)
        f.add_done_callback(lambda _f, j=i: done.__setitem__(j, time.perf_counter()))
        futs.append(f)
        qi.append(i % len(Q))
        i += 1
    res = [f.result(timeout=300) for f in futs]
    if prof is not None:
        srv.records()  # the executor has finished its last batch
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        prof.stop()
        busy = sum(e.self_device_time_total / 1e3 for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
        prof_out = {"window_ms": wall * 1e3, "device_busy_ms": busy,
                    "device_idle_share": max(0.0, 1 - busy / (wall * 1e3))}
    t_end = max(done.values())
    lat = np.array([done[j] - t_sub[j] for j in range(len(futs))])
    return {"ids": np.stack([r[0] for r in res]), "dists": np.stack([r[1] for r in res]),
            "query": np.asarray(qi), "t_submit": np.asarray(t_sub),
            "t_done": np.asarray([done[j] for j in range(len(futs))]),
            "futures": futs, "qps": len(futs) / (t_end - t_start),
            "p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "p99_ms": float(np.percentile(lat, 99)) * 1e3,
            "wall_s": t_end - t_start, "refused": refused, "profile": prof_out}


def batch_record(batches, futures=None) -> dict:
    """Per-bucket batch counts, fill, queue wait and plan time of the
    recorded batches (those serving ``futures`` when given)."""
    if futures is not None:
        mine = {id(f) for f in futures}
        batches = [b for b in batches if id(b["futures"][0]) in mine]
    by = {}
    for b in batches:
        by.setdefault(b["bucket"], []).append(b)
    waits = [b["t_run"] - t for b in batches for t in b["t_enqueue"]]
    return {"batches_per_bucket": {str(k): len(v) for k, v in sorted(by.items())},
            "fill_per_bucket": {str(k): float(np.mean([b["n"] / k for b in v]))
                                for k, v in sorted(by.items())},
            "queue_wait_ms_p50": float(np.percentile(waits, 50)) * 1e3 if waits else None,
            "queue_wait_ms_p99": float(np.percentile(waits, 99)) * 1e3 if waits else None,
            "plan_ms_mean": float(np.mean([b["plan_s"] for b in batches])) * 1e3
            if batches else None,
            "run_ms_per_bucket": {str(k): float(np.median([b["t_done"] - b["t_run"]
                                                           for b in v])) * 1e3
                                  for k, v in sorted(by.items())}}


def bucket_of(batches, futures) -> np.ndarray:
    """The bucket each future was served in."""
    where = {id(f): b["bucket"] for b in batches for f in b["futures"]}
    return np.asarray([where[id(f)] for f in futures])


def served_recall(ids, gt, buckets) -> dict:
    """recall@10 over the queries served in a bucket of one and in larger
    buckets (None where none was)."""
    one = buckets == 1
    return {"bucket_1": recall(ids[one], gt[one]) if one.any() else None,
            "buckets_ge_2": recall(ids[~one], gt[~one]) if (~one).any() else None,
            "queries_bucket_1": int(one.sum()), "queries_buckets_ge_2": int((~one).sum())}


def hold_served_recall(rec: dict, what: str) -> None:
    f_one, f_many = SERVE_RECALL_FLOORS
    assert rec["bucket_1"] is None or rec["bucket_1"] >= f_one, (what, rec)
    assert rec["buckets_ge_2"] is None or rec["buckets_ge_2"] >= f_many, (what, rec)


def k2_launches_per_batch(P: int, C: int, B: int) -> int:
    """K2 launches of one ``fused-batch`` batch of B: ``core.plan._tile_scan``
    takes the store in launches of at most MAX_PARTITIONS partitions and
    ``_FUSED_BATCH_OUT_BYTES`` of output."""
    from repro_torch.core.plan import _FUSED_BATCH_OUT_BYTES
    from repro_torch.kernels.batched_matmul import MAX_PARTITIONS

    step = max(1, min(MAX_PARTITIONS, _FUSED_BATCH_OUT_BYTES // (B * C * 4)))
    return -(-P // step)


class UploadLog:
    """Stands in for ``obs.meters.cache_upload_wait`` while a tiered run is
    logged: keeps every upload's (host wait, issue->complete window) in
    microseconds and calls through."""

    def __init__(self, meters):
        self.meters, self.fn, self.pairs = meters, meters.cache_upload_wait, []

    def __call__(self, wait_us, total_us):
        self.pairs.append((float(wait_us), float(total_us)))
        return self.fn(wait_us, total_us)

    def __enter__(self):
        self.meters.cache_upload_wait = self
        return self

    def __exit__(self, *exc):
        self.meters.cache_upload_wait = self.fn
        return False

    def summary(self) -> dict:
        w = np.array([p[0] for p in self.pairs])
        t = np.array([p[1] for p in self.pairs])
        return {"uploads": len(self.pairs),
                "upload_wait_us_sum": float(w.sum()),
                "upload_window_us_sum": float(t.sum()),
                "upload_overlap": float(1 - w.sum() / t.sum()) if t.sum() > 0 else None,
                "upload_overlap_mean": float(np.mean(np.maximum(0, 1 - w / t)))
                if len(t) else None}


def serve_phase(torch, eng, Xd, Qmain, seed: int, counters: dict) -> tuple[list, dict]:
    """The serving tier (``repro_torch.serve.VectorServer``) on the main
    path's engine, after the tiered phase and before the mutable one: the
    serial baseline, the served main path at f32 and int8, the served
    cascade (ladder A) and the served tiered path (int8); see the module
    docstring, phase 5c.  -> (phase lines, launches by kernel row name)."""
    from repro_torch.core.engine import SearchSpec
    from repro_torch.kernels import ops
    from repro_torch.obs import meters, metrics
    from repro_torch.serve import VectorServer

    Server = recording_server(VectorServer)
    store, ivf = eng.store, eng.ivf
    P, D, C = store.data.shape
    lines, launches = [], {}
    Q = serve_queries(seed, D, SERVE_OPEN)
    Qd = torch.from_numpy(Q).to(Xd.device)
    gt, t_gt = timed(torch, lambda: ground_truth_many(torch, Xd, Qd, K))
    specs = {dt: SearchSpec(k=K, scan_dtype=dt) for dt in SERVE_DTYPES}

    # the serial baseline: one query at a time through engine.search
    serial = {}
    for dt, spec in specs.items():
        _, t_s = timed(torch, lambda: [eng.search(Q[i], spec) for i in range(SERVE_SERIAL)])
        serial[dt] = SERVE_SERIAL / t_s
    line = {"phase": "serve", "path": "main", "n": Xd.shape[0], "dim": D,
            "max_batch": SERVE_MAX_BATCH, "flush_interval_s": SERVE_FLUSH_S,
            "open_loop_queries": SERVE_OPEN, "rate_over_serial": SERVE_RATE_X,
            "serial_queries": SERVE_SERIAL, "serial_qps": serial,
            "ground_truth_s": t_gt}
    srv = Server(eng, spec=specs["f32"], max_batch=SERVE_MAX_BATCH,
                 flush_interval_s=SERVE_FLUSH_S, queue_depth=SERVE_QUEUE_DEPTH)
    held = []
    try:
        seg0 = torch.cuda.memory_stats().get("segment.all.allocated", 0)
        warm, line["warmup_s"] = timed(torch, lambda: srv.warmup(specs=[specs["int8"]]))
        line["warmup_executors"] = {str(b): ex for b, ex in warm.items()}
        seg_warm = torch.cuda.memory_stats().get("segment.all.allocated", 0)
        for dt, spec in specs.items():
            srv.batches.clear()
            out = {}
            # a closed-loop burst: 64 at once drain as one bucket-64 batch
            want = eng.search(Qmain, spec)
            want1 = eng.search(Q[0], spec)
            for c in counters.values():
                c.launches = 0
            burst = [srv.submit(q, spec) for q in Qmain]
            b_ids = np.stack([f.result(timeout=120)[0] for f in burst])
            b_d = np.stack([f.result(timeout=120)[1] for f in burst])
            out["burst_buckets"] = batch_record(srv.records(), burst)["batches_per_bucket"]
            out["burst_ids_equal_engine_search"] = bool(np.array_equal(b_ids, want.ids))
            out["burst_dists_equal_engine_search"] = bool(np.array_equal(b_d, want.dists))
            # a single query alone: a bucket of one (fused-scan)
            one = srv.submit(Q[0], spec).result(timeout=120)
            out["single_ids_equal_engine_search"] = bool(np.array_equal(one[0], want1.ids))
            # the bucket-one recall floor is fused-scan's, a mean over the
            # main path's N_SINGLE queries: so many are served alone here,
            # and the open loop's own bucket-one queries join them (alone,
            # the open loop can serve as few as one, and one query at 9 of
            # 10 would fail a mean floor of 0.95)
            alone = np.stack([srv.submit(q, spec).result(timeout=120)[0]
                              for q in Q[:N_SINGLE]])
            rate = SERVE_RATE_X * serial[dt]
            run = open_loop(torch, srv, Q, [spec], rate, seed + 10)
            rec = batch_record(srv.records(), run["futures"])
            # the device's idle share, on a profiled run of its own of about
            # SERVE_PROFILE_S seconds of arrivals
            n_prof = min(len(Q), int(rate * SERVE_PROFILE_S) + 1)
            prof = open_loop(torch, srv, Q[:n_prof], [spec], rate, seed + 20,
                             profile=True)
            got = {k: c.launches for k, c in counters.items()}
            buckets = bucket_of(srv.records(), run["futures"])
            g = gt[run["query"]]
            out.update(
                qps=run["qps"], p50_ms=run["p50_ms"], p99_ms=run["p99_ms"],
                refused=run["refused"], qps_over_serial=run["qps"] / serial[dt],
                p99_over_p50=run["p99_ms"] / run["p50_ms"],
                recall_at_10=served_recall(
                    np.concatenate([alone, run["ids"]]), np.concatenate([gt[:N_SINGLE], g]),
                    np.concatenate([np.ones(N_SINGLE, buckets.dtype), buckets])),
                dist_rel_err=dist_error(torch, Xd, Qd[run["query"]], run["ids"], run["dists"]),
                profile=prof["profile"], launches=got, **rec)
            executors = {(b["bucket"] == 1, b["executor"]) for b in srv.records()}
            out["executors"] = sorted({ex for _, ex in executors})
            n1 = sum(b["bucket"] == 1 for b in srv.records())
            k2_want = sum(k2_launches_per_batch(P, C, b["bucket"]) for b in srv.records()
                          if b["bucket"] > 1)
            out["k1_launches_want"], out["k2_launches_want"] = n1, k2_want
            line[dt] = out
            launches[f"K1 pdx_prune_scan_multi [{dt}]"] = got["k1"]
            launches[f"K2 batched_distance_quant [{dt}]"] = got["k2"]
            held.append((dt, out, executors, got, n1, k2_want))
        line["setups_after_warmup"] = srv.jit_compiles_since_warmup()
        line["new_allocator_segments_after_warmup"] = (
            torch.cuda.memory_stats().get("segment.all.allocated", 0) - seg_warm)
        line["allocator_segments_in_warmup"] = seg_warm - seg0

        # the served cascade, ladder A
        cspec = SearchSpec(k=K, cascade=LADDERS["A"])
        _, t_cs = timed(torch, lambda: [eng.search(Q[i], cspec) for i in range(N_SINGLE)])
        c_serial = N_SINGLE / t_cs
        _, t_warm = timed(torch, lambda: srv.warmup(specs=[cspec]))
        # each cascade-batch batch calls the stage op once per scan stage,
        # in ladder order, on the executor thread: the recorder reads the
        # K2 launches of every call, so each stage row gets its own count
        with StageRecorder(ops, counters["k2"], keep_args=False) as srec:
            for c in counters.values():
                c.launches = 0
            srv.batches.clear()
            one = srv.submit(Q[0], cspec).result(timeout=120)
            run = open_loop(torch, srv, Q[:SERVE_CASCADE_OPEN], [cspec],
                            SERVE_RATE_X * c_serial, seed + 11)
            got = {k: c.launches for k, c in counters.items()}
        buckets = bucket_of(srv.records(), run["futures"])
        g = gt[run["query"]]
        cas = {"ladder": list(LADDERS["A"]), "warmup_s": t_warm, "serial_qps": c_serial,
               "queries": SERVE_CASCADE_OPEN, "qps": run["qps"], "p50_ms": run["p50_ms"],
               "p99_ms": run["p99_ms"], "refused": run["refused"],
               "recall_at_10": recall(run["ids"], g),
               "recall_at_10_by_bucket": served_recall(run["ids"], g, buckets),
               "single_recall_at_10": recall(one[0][None], gt[:1]),
               "dist_rel_err": dist_error(torch, Xd, Qd[run["query"]], run["ids"], run["dists"]),
               "launches": got, "setups_after_warmup": srv.jit_compiles_since_warmup(),
               "executors": sorted({b["executor"] for b in srv.records()}),
               **batch_record(srv.records())}
        n_cb = sum(b["bucket"] > 1 for b in srv.records())
        n_cs = sum(b["bucket"] == 1 for b in srv.records())
        # K2 runs once per d-tile of each stage a cascade-batch batch: the
        # projection's one tile, then ceil(D / 64)
        scan_stages = LADDERS["A"][:-1]
        tiles = {stage: 1 if stage.startswith("proj") else -(-D // 64)
                 for stage in scan_stages}
        calls = {stage: srec.calls[i::len(scan_stages)]
                 for i, stage in enumerate(scan_stages)}
        k2_stage = {stage: sum(c["k2_launches"] for c in cs) for stage, cs in calls.items()}
        cas.update(cascade_batch_batches=n_cb, cascade_scan_batches=n_cs,
                   k2_launches_want=n_cb * sum(tiles.values()),
                   stage_op_calls=len(srec.calls), k2_launches_by_stage=k2_stage,
                   k2_launches_by_stage_want={s: n_cb * n for s, n in tiles.items()},
                   stage_packed={s: sorted({c["packed"] for c in cs})
                                 for s, cs in calls.items()})
        line["cascade"] = cas
        launches[f"K1 pdx_prune_scan_multi [{LADDERS['A'][0]}]"] = got["k1"]
        launches[f"K3 pdx_prune_scan_multi_prefetch [{LADDERS['A'][1]}]"] = got["k3"]
        for stage, n in k2_stage.items():
            launches[f"K2 batched_distance_quant in cascade stage [A {stage}]"] = n
    finally:
        srv.close()
    emit(line)
    for dt, out, executors, got, n1, k2_want in held:
        assert out["burst_buckets"] == {str(SERVE_MAX_BATCH): 1}, (dt, out["burst_buckets"])
        assert out["burst_ids_equal_engine_search"], f"{dt}: served burst ids differ"
        assert out["single_ids_equal_engine_search"], f"{dt}: served single ids differ"
        assert all(ex == ("fused-scan" if one_q else "fused-batch")
                   for one_q, ex in executors), (dt, executors)
        hold_served_recall(out["recall_at_10"], f"serve {dt}")
        assert out["dist_rel_err"] <= 1e-3, (dt, out["dist_rel_err"])
        assert got["k1"] > 0 and got["k2"] > 0, (dt, got)
        assert got["k1"] == n1 and got["k2"] == k2_want, (dt, got, n1, k2_want)
    assert line["setups_after_warmup"] == 0, line["setups_after_warmup"]
    cas = line["cascade"]
    assert cas["recall_at_10"] >= CASCADE_RECALL_FLOOR, cas
    assert cas["dist_rel_err"] <= 1e-3, cas
    assert cas["setups_after_warmup"] == 0, cas
    assert all(v > 0 for v in cas["launches"].values()), cas["launches"]
    assert cas["launches"] == {"k1": cas["cascade_scan_batches"], "k3": cas["cascade_scan_batches"],
                               "k2": cas["k2_launches_want"]}, cas
    # the stage rows' counts are the recorder's, and add up to the counter
    assert cas["stage_op_calls"] == len(LADDERS["A"][:-1]) * cas["cascade_batch_batches"], cas
    assert sum(cas["k2_launches_by_stage"].values()) == cas["launches"]["k2"], cas
    assert cas["k2_launches_by_stage"] == cas["k2_launches_by_stage_want"], cas
    assert cas["stage_packed"] == {s: [s == "int4"] for s in LADDERS["A"][:-1]}, cas
    lines.append(line)

    # the served tiered path, int8
    S = P // 4
    tspec = SearchSpec(k=K, nprobe=TIERED_NPROBE, hbm_slots=S, scan_dtype="int8")
    Qz = tiered_queries(seed, D)
    Qzd = torch.from_numpy(Qz).to(Xd.device)
    sel = ivf.route_batch(eng.pruner.transform_batch(Qzd), TIERED_NPROBE)
    truth, allowed = routed_truth(torch, ivf, store.ids.cpu().numpy(), Xd, Qzd, sel)
    store._tiered_cache = {}
    block, t_block = timed(torch, lambda: [eng.search(q, tspec) for q in Qz])
    t_serial = TIERED_QUERIES / t_block
    block_ids = np.stack([r.ids for r in block])
    store._tiered_cache = {}
    tline = {"phase": "serve", "path": "tiered", "scan_dtype": "int8", "hbm_slots": S,
             "nprobe": TIERED_NPROBE, "queries": TIERED_QUERIES,
             "max_batch": SERVE_TIERED_MAX_BATCH, "serial_qps": t_serial}
    reg = metrics.get_registry()
    reg.reset()
    metrics.set_enabled(True)
    srv = Server(eng, spec=tspec, max_batch=SERVE_TIERED_MAX_BATCH,
                 flush_interval_s=SERVE_FLUSH_S, queue_depth=SERVE_QUEUE_DEPTH)
    try:
        _, tline["warmup_s"] = timed(torch, srv.warmup)
        counters["k2"].launches = 0
        srv.batches.clear()
        ev = {e: reg.get("repro_tiered_cache_events_total", event=e) for e in ("hit", "miss")}
        with UploadLog(meters) as log:
            run = open_loop(torch, srv, Qz, [tspec], SERVE_RATE_X * t_serial, seed + 12)
        tline["served"] = {**log.summary(), **{
            e: reg.get("repro_tiered_cache_events_total", event=e) - ev[e]
            for e in ("hit", "miss")}}
        tline["k2_launches"] = counters["k2"].launches
        launches["K2 batched_distance_quant [int8, tiered pool]"] = counters["k2"].launches
        tline.update(qps=run["qps"], p50_ms=run["p50_ms"], p99_ms=run["p99_ms"],
                     refused=run["refused"],
                     qps_over_serial=run["qps"] / t_serial,
                     setups_after_warmup=srv.jit_compiles_since_warmup(),
                     **batch_record(srv.records()))
    finally:
        srv.close()
        metrics.set_enabled(False)
    # the blocking path on a fresh pool: batches of 16 through engine.search
    store._tiered_cache = {}
    metrics.set_enabled(True)
    try:
        reg.reset()
        with UploadLog(meters) as log:
            for lo in range(0, TIERED_QUERIES, TIERED_BATCH):
                eng.search(Qz[lo:lo + TIERED_BATCH], tspec)
        tline["blocking_batches_of_16"] = {**log.summary(), **{
            e: reg.get("repro_tiered_cache_events_total", event=e) for e in ("hit", "miss")}}
    finally:
        metrics.set_enabled(False)
        reg.reset()
        store._tiered_cache = {}
        for name in ("_host_masters_cache", "_host_rows_cache"):
            store.__dict__.pop(name, None)
    got = run["ids"]
    tline["ids_equal_blocking_search"] = bool(np.array_equal(got, block_ids))
    tline["recall_at_10_routed"] = recall(got, truth)
    tline["dist_rel_err"] = dist_error(torch, Xd, Qzd, got, run["dists"])
    tline["ids_outside_routed_buckets"] = sum(
        len(set(g.tolist()) - a) for g, a in zip(got, allowed))
    emit(tline)
    assert tline["ids_equal_blocking_search"], "served tiered ids differ from blocking"
    assert tline["recall_at_10_routed"] >= TIERED_RECALL_FLOOR, tline
    assert tline["ids_outside_routed_buckets"] == 0, tline
    assert tline["dist_rel_err"] <= 1e-3, tline
    assert tline["setups_after_warmup"] == 0, tline
    assert tline["k2_launches"] >= sum(tline["batches_per_bucket"].values()), tline
    lines.append(tline)
    return lines, launches


def timed_method(fn, spans: list):
    """``fn`` (a method) with each call's (start, end) appended to ``spans``."""
    def inner(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(self, *args, **kwargs)
        finally:
            spans.append((t0, time.perf_counter()))
    return inner


def serve_churn_phase(torch, eng, Q, Qd, Xall, gt, dead, seed: int, counters: dict,
                      serial_qps: float) -> dict:
    """Balanced churn through a ``VectorServer`` on the mutable store the
    mutable phase compacted: ``CHURN_CYCLES`` cycles of inserting
    ``CHURN_ROWS`` standard-normal rows (far from every cluster, so they
    never enter a clustered query's top-10), querying each as itself while
    it is live, and deleting them, while f32 and int8 open-loop traffic
    runs and the maintenance thread clones, repacks and swaps (head fill
    threshold 0).  Held: a swap adopted, each inserted row its own rank 0
    while live, no deleted id returned (also by the deleted rows queried
    as themselves afterwards), recall@10 against the live set at the fused
    floors.  Recorded: clone and repack seconds, the first batch after a
    swap, p99 while a swap was being made, swaps, set-ups after it."""
    import threading

    from repro_torch.core.engine import SearchSpec
    from repro_torch.core.layout import MutablePDXStore
    from repro_torch.obs import metrics, setups
    from repro_torch.serve import VectorServer

    Server = recording_server(VectorServer)
    store = eng.store
    D = store.dim
    specs = [SearchSpec(k=K), SearchSpec(k=K, scan_dtype="int8")]
    clones, repacks = [], []
    orig = MutablePDXStore.clone, MutablePDXStore.repack
    MutablePDXStore.clone = timed_method(orig[0], clones)
    MutablePDXStore.repack = timed_method(orig[1], repacks)
    reg = metrics.get_registry()
    reg.reset()
    metrics.set_enabled(True)
    line = {"phase": "serve_churn", "churn_rows": CHURN_ROWS, "churn_cycles": CHURN_CYCLES,
            "maintenance_interval_s": CHURN_MAINT_S, "head_fill_threshold": 0.0,
            "tiles_version_before": store.tiles_version}
    srv = Server(eng, spec=specs[0], max_batch=SERVE_MAX_BATCH, flush_interval_s=SERVE_FLUSH_S,
                 queue_depth=SERVE_QUEUE_DEPTH, maintenance_interval_s=CHURN_MAINT_S,
                 head_fill_threshold=0.0)
    churn = {"selves": [], "deleted": [], "error": None, "done": False}

    def churn_loop():
        try:
            rng = np.random.default_rng(seed + 5)
            for _ in range(CHURN_CYCLES):
                rows = rng.standard_normal((CHURN_ROWS, D)).astype(np.float32)
                ids = srv.insert(rows).result(timeout=300)
                selves = [srv.submit(r, specs[0]) for r in rows]
                churn["selves"].append((ids, np.array([f.result(timeout=300)[0][0]
                                                       for f in selves])))
                assert srv.delete([int(i) for i in ids]).result(timeout=300) == CHURN_ROWS
                churn["deleted"].append((ids, rows))
                time.sleep(CHURN_GAP_S)
        except BaseException as e:  # reported by the main thread
            churn["error"] = e
        finally:
            churn["done"] = True

    try:
        _, line["warmup_s"] = timed(torch, lambda: srv.warmup(specs=specs[1:]))
        for c in counters.values():
            c.launches = 0
        srv.batches.clear()
        kinds0 = setups.by_kind()
        t0 = time.perf_counter()
        th = threading.Thread(target=churn_loop, name="churn", daemon=True)
        th.start()

        def enough():
            swapped = any(s["adopted"] for s in srv.swaps)
            late = time.perf_counter() - t0 > CHURN_SWAP_WAIT_S
            return churn["done"] and (swapped or late)

        run = open_loop(torch, srv, Q, specs, SERVE_RATE_X * serial_qps, seed + 13,
                        until=enough)
        th.join(timeout=300)
        if churn["error"] is not None:
            raise churn["error"]
        deleted = np.concatenate([ids for ids, _ in churn["deleted"]])
        rows = np.concatenate([r for _, r in churn["deleted"]])
        after = [srv.submit(r, specs[0]) for r in rows]
        after_ids = np.stack([f.result(timeout=300)[0] for f in after])
        line["setups_after_warmup"] = srv.jit_compiles_since_warmup()
        line["setups_after_warmup_by_kind"] = {
            k: v - kinds0.get(k, 0) for k, v in setups.by_kind().items()
            if v != kinds0.get(k, 0)}
    finally:
        try:
            srv.close()
        finally:
            MutablePDXStore.clone, MutablePDXStore.repack = orig
            metrics.set_enabled(False)
    swaps = reg.get("repro_serve_maintenance_total", event="swap")
    discards = reg.get("repro_serve_maintenance_total", event="discard")
    replayed = reg.get("repro_serve_replayed_rows_total")
    reg.reset()
    buckets = bucket_of(srv.records(), run["futures"])
    g = gt[run["query"]]
    is_f32 = (np.arange(len(run["futures"])) % 2) == 0
    adopted = [s["t"] for s in srv.swaps if s["adopted"]]
    lat = run["t_done"] - run["t_submit"]
    line.update(
        queries=len(run["futures"]), qps=run["qps"], p50_ms=run["p50_ms"],
        p99_ms=run["p99_ms"], refused=run["refused"], swaps_adopted=swaps, swaps_discarded=discards,
        rows_replayed=replayed, clone_s=[b - a for a, b in clones],
        repack_s=[b - a for a, b in repacks],
        tiles_version_after=store.tiles_version,
        recall_at_10={"f32": served_recall(run["ids"][is_f32], g[is_f32], buckets[is_f32]),
                      "int8": served_recall(run["ids"][~is_f32], g[~is_f32],
                                            buckets[~is_f32])},
        dist_rel_err=dist_error(torch, Xall, Qd[run["query"]], run["ids"], run["dists"]),
        launches={k: c.launches for k, c in counters.items()},
        **batch_record(srv.records(), run["futures"]))
    if adopted and clones:
        # p99 of the queries submitted while the first swap was being made
        win = (run["t_submit"] >= clones[0][0]) & (run["t_submit"] <= adopted[0])
        line["p99_ms_during_swap"] = (float(np.percentile(lat[win], 99)) * 1e3
                                      if win.any() else None)
        line["queries_during_swap"] = int(win.sum())
        first = next((b for b in srv.records() if b["t_run"] >= adopted[0]), None)
        if first is not None:
            line["first_batch_after_swap_ms"] = (first["t_done"] - first["t_run"]) * 1e3
            line["first_batch_after_swap_bucket"] = first["bucket"]
            line["first_batch_after_swap_latency_ms_max"] = max(
                first["t_done"] - t for t in first["t_enqueue"]) * 1e3
    selves = churn["selves"]
    line["self_rank0"] = int(sum((ids == got).sum() for ids, got in selves))
    line["self_queries"] = int(sum(len(ids) for ids, _ in selves))
    gone = np.concatenate([dead, deleted])
    line["deleted_ids_returned"] = int(np.isin(run["ids"], gone).sum())
    line["deleted_rows_found_as_themselves"] = int(np.isin(after_ids, deleted).sum())
    emit(line)
    assert swaps >= 1, f"no maintenance swap adopted: {line}"
    assert line["self_rank0"] == line["self_queries"], "an inserted row missed rank 0"
    assert line["deleted_ids_returned"] == 0 and line["deleted_rows_found_as_themselves"] == 0
    for dt in ("f32", "int8"):
        hold_served_recall(line["recall_at_10"][dt], f"serve_churn {dt}")
    assert line["dist_rel_err"] <= 1e-3, line["dist_rel_err"]
    return line


def routing_phase(torch, eng, Qd) -> dict:
    """Batched bucket routing on the main path's IVF index: for each route
    dtype and B in ROUTING_BATCHES, ``route_batch`` over the first B
    transformed queries held row for row, bit for bit, to the bucket order
    ``route`` ranks for that query alone (its partition order is the
    row's, cut at nprobe), and the ms per batch beside the per-query loop
    through ``route``.  Emits the phase line before its asserts."""
    from repro_torch.index.ivf import _route_chunk

    ivf, pruner = eng.ivf, eng.pruner
    Qt = pruner.transform_batch(Qd)
    nprobe = TIERED_NPROBE
    line = {"phase": "routing", "nlist": ivf.nlist,
            "centroid_tiles": list(ivf.centroid_store.data.shape), "nprobe": nprobe,
            "route_chunk": _route_chunk(ivf.centroid_store.data), "dtypes": {}}
    mismatched = []
    for dt in ROUTING_DTYPES:
        ivf.route_batch(Qt[:1], nprobe, "l2", dt)  # the mirror and its f32 copy
        row = {}
        for B in ROUTING_BATCHES:
            Qb = Qt[:B]
            full, t_batch = min((timed(torch, lambda: ivf.route_batch(
                Qb, ivf.nlist, "l2", dt)) for _ in range(ROUTING_REPS)),
                key=lambda r: r[1])
            singles, t_loop = min((timed(torch, lambda: [
                ivf.route(Qb[i], nprobe, "l2", dt) for i in range(B)])
                for _ in range(ROUTING_REPS)), key=lambda r: r[1])
            for i in range(B):
                alone = ivf.rank_buckets(Qb[i], "l2", dt)
                if not (np.array_equal(full[i], alone) and np.array_equal(
                        singles[i][0], ivf.partition_order(full[i], nprobe))):
                    mismatched.append((dt, B, i))
            row[str(B)] = {"batch_ms": t_batch * 1e3, "per_query_loop_ms": t_loop * 1e3,
                           "loop_over_batch": t_loop / t_batch}
        line["dtypes"][dt] = row
    line["rows_not_bitwise"] = len(mismatched)
    emit(line)
    assert not mismatched, f"route_batch rows differ from route: {mismatched[:8]}"
    return line


def mesh_phases(torch, ref, eng, Q, Qd, Xd, seed: int, k2) -> tuple[dict, list, dict]:
    """Phases 5e (``sharded``) and 5f (``routed``) in one NCCL world of one
    (``init_process_group("nccl", store=HashStore(), rank=0,
    world_size=1)``), destroyed at the end.  -> (K2 launches of the sharded
    phase by scan dtype, the routed phase's K2 rows, its K2 launches by
    kernel row name)."""
    import torch.distributed as tdist

    from repro_torch.dist import all_gather, make_mesh

    t0 = time.perf_counter()
    tdist.init_process_group("nccl", store=tdist.HashStore(), rank=0, world_size=1)
    try:
        meshes = {ax: make_mesh((1,), (ax,)) for ax in ("data", "model")}
        t_setup = time.perf_counter() - t0
        # NCCL sets its communicator up at a group's first collective: do
        # that outside the walls
        _, t_first = timed(torch, lambda: [all_gather(
            torch.zeros(1, device=eng.device), mesh, ax) for ax, mesh in meshes.items()])
        world = {"world": 1, "backend": "nccl",
                 "mesh_device": meshes["data"].device_type, "setup_s": t_setup,
                 "first_collectives_ms": t_first * 1e3}
        _, sharded_launches = sharded_phase(torch, eng, Q, k2, meshes, world)
        rows, routed_launches = routed_phase(torch, ref, eng, Q, Qd, Xd, seed, k2,
                                             meshes["data"])
    finally:
        tdist.destroy_process_group()
    return sharded_launches, rows, routed_launches


def sharded_phase(torch, eng, Q, k2, meshes: dict, world: dict) -> tuple[dict, dict]:
    """The broadcast mesh executors on a world of one (NCCL): the main
    path's 1M x 960 engine searched through ``search(..., mesh=)``, the
    executor forced (its IVF index would otherwise plan the bucket-routed
    search, phase 5f).  ``batch-block-sharded`` at f32 and int8 on the 64
    queries equals ``batch-matmul`` and ``fused-batch`` bit for bit (one
    shard, no padding: the same arithmetic), K2 counted from 0 around the
    int8 run and held to the steps ``_tile_scan`` takes; ``block-sharded``
    on 4 queries equals the masked PDXearch (``pdxearch_jit``) alone;
    ``dim-sharded`` on a ("model",) mesh of one equals ``batch-matmul``'s
    ids as sets; one all-gather per batch and two per query.  Emits the
    phase line before its asserts.  -> (the line, K2 launches by scan
    dtype)."""
    from repro_torch.core.engine import SearchSpec
    from repro_torch.core.pdxearch import pdxearch_jit
    from repro_torch.core.plan import _FUSED_BATCH_OUT_BYTES
    from repro_torch.kernels.batched_matmul import MAX_PARTITIONS
    from repro_torch.obs.meters import collective_counts

    t0 = time.perf_counter()
    data, model = meshes["data"], meshes["model"]
    P, _, C = eng.store.data.shape
    B = Q.shape[0]
    line = {"phase": "sharded", **world, "walls_ms": {}}
    fails = []
    launches = {}
    steps = -(-P // max(1, min(MAX_PARTITIONS, _FUSED_BATCH_OUT_BYTES // (B * C * 4))))
    for dt, single in (("f32", "batch-matmul"), ("int8", "fused-batch")):
        spec = SearchSpec(k=K, scan_dtype=dt)
        want, t_want = timed(torch, lambda: eng.search(
            Q, spec.replace(executor=single)))
        k2.launches = 0
        got, t_got = timed(torch, lambda: eng.search(
            Q, spec.replace(executor="batch-block-sharded"), mesh=data))
        launches[dt] = k2.launches
        line["walls_ms"][f"batch-block-sharded {dt}"] = t_got * 1e3
        line["walls_ms"][f"{single} {dt}"] = t_want * 1e3
        if got.plan.executor != "batch-block-sharded":
            fails.append(f"{dt}: planned {got.plan.executor}")
        if not (np.array_equal(got.ids, want.ids)
                and np.array_equal(got.dists, want.dists)):
            fails.append(f"batch-block-sharded {dt} differs from {single}")
    line["k2_launches"] = launches
    line["k2_steps_int8"] = steps
    if launches != {"f32": 0, "int8": steps}:
        fails.append(f"K2 launches {launches}, expected f32 0 and int8 {steps}")
    four = Q[:SHARDED_SINGLE]
    blk, t_blk = timed(torch, lambda: eng.search(
        four, SearchSpec(k=K, executor="block-sharded"), mesh=data))
    jm, t_jm = timed(torch, lambda: [pdxearch_jit(eng.store, torch.from_numpy(q).to(
        eng.device), K, eng.pruner) for q in four])
    line["walls_ms"]["block-sharded per query"] = t_blk * 1e3 / len(four)
    line["walls_ms"]["pdxearch_jit per query"] = t_jm * 1e3 / len(four)
    if not np.array_equal(blk.ids, np.stack([r.ids.cpu().numpy() for r in jm])):
        fails.append("block-sharded ids differ from the masked PDXearch's")
    dim, t_dim = timed(torch, lambda: eng.search(
        four, SearchSpec(k=K, executor="dim-sharded"), mesh=model))
    bm = eng.search(four, SearchSpec(k=K, executor="batch-matmul"))
    line["walls_ms"]["dim-sharded per query"] = t_dim * 1e3 / len(four)
    if dim.plan.executor != "dim-sharded" or any(
            set(a.tolist()) != set(b.tolist()) for a, b in zip(dim.ids, bm.ids)):
        fails.append("dim-sharded ids differ from batch-matmul's as sets")
    line["collectives"] = {
        "batch": collective_counts(lambda: eng.search(
            Q, SearchSpec(k=K, scan_dtype="int8", executor="batch-block-sharded"),
            mesh=data)),
        "query": collective_counts(lambda: eng.search(
            Q[0], SearchSpec(k=K, executor="block-sharded"), mesh=data)),
    }
    if line["collectives"] != {"batch": {"all_gather": 1},
                               "query": {"all_gather": 2}}:
        fails.append(f"collectives {line['collectives']}")
    line["seconds"] = time.perf_counter() - t0
    emit(line)
    assert not fails, fails
    return line, launches


def routed_phase(torch, ref, eng, Q, Qd, Xd, seed: int, k2, mesh) -> tuple[list, dict]:
    """The bucket-routed executors on a world of one (NCCL), no executor
    forced: the main path's IVF engine on the ("data",) mesh plans them.
    ``routed_bucket`` at f32 and int8, nprobe 8: the 64 main queries in one
    exchange round of 64 slots, then their first ``ROUTED_SPILL`` rows,
    which spill into two rounds (32, 16); held: recall@10 against the exact
    top-10 within each query's routed buckets, no id outside them, exact
    returned distances, one all-to-all per round and one all-gather, K2
    counted from 0 around each run (f32 0, int8 the steps ``_tile_scan``
    takes at the exchange's row count), and at int8 the spilled rows' ids
    equal to the same rows of the 64; recorded: walls beside
    ``fused-batch``'s, the plan's budget, rounds and occupancy, and
    ``routed_batch_bytes``' components.  K2 at the spilled exchange's row
    count (a shape no other row has) is held to its plain version.  Then
    ``routed_tiered`` on phase 5b's premise (P // 4 slots, the zipf
    queries in batches of 16, nprobe 8) at f32 and int8: each batch
    through ``tiered-scan`` and at once through ``routed_tiered`` on the
    same warm cache, held bit for bit equal (one region, one block in the
    merge), one all-gather and one K2 launch per step.  Emits a phase line
    before its asserts.  -> (K2 rows, K2 launches by kernel row name)."""
    from repro_torch.core import plan
    from repro_torch.core.engine import SearchSpec
    from repro_torch.core.layout import device_mirror
    from repro_torch.dist.routing import plan_routing
    from repro_torch.kernels.batched_matmul import MAX_PARTITIONS
    from repro_torch.obs.meters import collective_counts, routed_batch_bytes

    t0 = time.perf_counter()
    store, ivf = eng.store, eng.ivf
    P, D, C = store.data.shape
    B = Q.shape[0]
    nprobe = TIERED_NPROBE
    pl, t_pl = timed(torch, lambda: plan._get_placement(store, 1, "bucket", ivf=ivf))
    sel = ivf.route_batch(eng.pruner.transform_batch(Qd), nprobe)
    truth, allowed = routed_truth(torch, ivf, store.ids.cpu().numpy(), Xd, Qd, sel)
    line = {"phase": "routed", "world": 1, "backend": "nccl", "nprobe": nprobe,
            "batch": B, "spill_batch": ROUTED_SPILL, "placement_slots": pl.num_slots,
            "placement_s": t_pl, "walls_ms": {}, "first_call_ms": {}, "plans": {},
            "k2_launches": {}, "k2_steps": {}, "collectives": {}}
    fails = []

    def steps_for(rows: int) -> int:
        per = max(1, min(MAX_PARTITIONS, plan._FUSED_BATCH_OUT_BYTES // (rows * C * 4)))
        return -(-pl.num_slots // per)

    def hold(res, tag, truth_rows, allowed_rows, Qrows):
        if res.plan.executor != "routed_bucket":
            fails.append(f"{tag}: planned {res.plan.executor}")
        rec = recall(res.ids, truth_rows)
        out = sum(len(set(g.tolist()) - a) for g, a in zip(res.ids, allowed_rows))
        err = dist_error(torch, Xd, Qrows, res.ids, res.dists)
        line[f"recall_at_10_routed {tag}"] = rec
        line[f"ids_outside_routed_buckets {tag}"] = out
        line[f"dist_rel_err {tag}"] = err
        if rec < ROUTED_RECALL_FLOOR or out or err > 1e-3:
            fails.append(f"{tag}: recall {rec}, {out} ids outside, dist error {err}")

    launches, results = {}, {}
    for rows in (B, ROUTED_SPILL):
        rp = plan_routing(sel[:rows], pl.bucket_shard, pl.bucket_parts, 1)
        line["plans"][str(rows)] = {"budget": rp.budget, "round_budgets": list(rp.round_budgets),
                                    "occupancy": rp.occupancy}
        for dt in ("f32", "int8"):
            m = device_mirror(store, dt)
            line["plans"][str(rows)][f"bytes {dt}"] = routed_batch_bytes(
                rp, n_shards=1, D=D, C=C, num_slots=pl.num_slots, nprobe=nprobe, k=K,
                bytes_per_value=m.bytes_per_value, quantized=dt != "f32")
    want_rounds = {str(B): [B, 0], str(ROUTED_SPILL): [32, 16]}
    for rows, rounds in want_rounds.items():
        if line["plans"][rows]["round_budgets"] != rounds:
            fails.append(f"B = {rows}: rounds {line['plans'][rows]['round_budgets']}")
    for dt in ("f32", "int8"):
        spec = SearchSpec(k=K, nprobe=nprobe, scan_dtype=dt)
        # the first call binds the placement's arranged mirror: set-up
        _, t_first = timed(torch, lambda: eng.search(Q, spec, mesh=mesh))
        line["first_call_ms"][dt] = t_first * 1e3
        _, t_fb = timed(torch, lambda: eng.search(Q, SearchSpec(k=K, scan_dtype=dt)))
        line["walls_ms"][f"fused-batch {dt}"] = t_fb * 1e3
        for rows in (B, ROUTED_SPILL):
            tag = f"{dt} B={rows}"
            k2.launches = 0
            res, t_r = timed(torch, lambda: eng.search(Q[:rows], spec, mesh=mesh))
            launched = k2.launches
            line["walls_ms"][f"routed_bucket {tag}"] = t_r * 1e3
            slots = sum(line["plans"][str(rows)]["round_budgets"])
            want = 0 if dt == "f32" else steps_for(slots)
            line["k2_launches"][tag], line["k2_steps"][tag] = launched, want
            if launched != want:
                fails.append(f"{tag}: K2 launched {launched}, expected {want}")
            launches[(dt, rows)] = launched
            hold(res, tag, truth[:rows], allowed[:rows], Qd[:rows])
            results[(dt, rows)] = res
            line["collectives"][tag] = collective_counts(
                lambda: eng.search(Q[:rows], spec, mesh=mesh))
            spilled = rows != B
            if line["collectives"][tag] != {"all_to_all": 1 + spilled, "all_gather": 1}:
                fails.append(f"{tag}: collectives {line['collectives'][tag]}")
    line["spilled_int8_ids_equal"] = bool(np.array_equal(
        results[("int8", ROUTED_SPILL)].ids, results[("int8", B)].ids[:ROUTED_SPILL]))
    if not line["spilled_int8_ids_equal"]:
        fails.append("int8: the spilled batch's ids differ from the same rows of the 64")

    # routed_tiered beside tiered-scan, each batch through both in turn
    S = P // 4
    Qz = tiered_queries(seed, D)
    Qzt = eng.pruner.transform_batch(torch.from_numpy(Qz).to(Xd.device))
    selz = ivf.route_batch(Qzt, nprobe)
    batches = [(Qz[lo:lo + TIERED_BATCH], selz[lo:lo + TIERED_BATCH])
               for lo in range(0, TIERED_QUERIES, TIERED_BATCH)]
    cnts = np.asarray(ivf.part_counts)
    tiered = {}
    for dt in TIERED_HELD:
        spec = SearchSpec(k=K, nprobe=nprobe, hbm_slots=S, scan_dtype=dt)
        single = spec.replace(executor="tiered-scan")
        for Qb, _ in batches:  # the cold pass fills the pool, uncounted
            eng.search(Qb, single)
        bc = plan._get_bucket_cache(store, spec, ivf=ivf)
        rec = {"hbm_slots": S, "walls_ms": {"tiered-scan": [], "routed_tiered": []},
               "steps": 0, "k2_launches": 0, "bitwise_equal_batches": 0,
               "executors": set()}
        k2.launches = 0
        for Qb, sb in batches:
            steps = tiered_steps(plan, sb, cnts, bc.region_slots)
            want, t_w = timed(torch, lambda: eng.search(Qb, single))
            n0 = k2.launches
            got, t_g = timed(torch, lambda: eng.search(Qb, spec, mesh=mesh))
            rec["k2_launches"] += k2.launches - n0
            rec["steps"] += steps
            rec["walls_ms"]["tiered-scan"].append(t_w * 1e3)
            rec["walls_ms"]["routed_tiered"].append(t_g * 1e3)
            rec["executors"].add(got.plan.executor)
            rec["bitwise_equal_batches"] += bool(np.array_equal(got.ids, want.ids)
                                                 and np.array_equal(got.dists, want.dists))
        rec["executors"] = sorted(rec["executors"])
        for name in ("tiered-scan", "routed_tiered"):
            rec[f"wall_ms_median {name}"] = statistics.median(rec["walls_ms"][name])
        Qb, sb = batches[0]
        rec["collectives_batch0"] = collective_counts(lambda: eng.search(Qb, spec, mesh=mesh))
        rec["steps_batch0"] = tiered_steps(plan, sb, cnts, bc.region_slots)
        tiered[dt] = rec
        store._tiered_cache.clear()
        if rec["executors"] != ["routed_tiered"]:
            fails.append(f"tiered {dt}: planned {rec['executors']}")
        if rec["bitwise_equal_batches"] != len(batches):
            fails.append(f"tiered {dt}: {len(batches) - rec['bitwise_equal_batches']} "
                         "batches differ from tiered-scan")
        if rec["k2_launches"] != rec["steps"]:
            fails.append(f"tiered {dt}: K2 launched {rec['k2_launches']} for "
                         f"{rec['steps']} steps")
        if rec["collectives_batch0"] != {"all_gather": rec["steps_batch0"]}:
            fails.append(f"tiered {dt}: collectives {rec['collectives_batch0']}")
    line["routed_tiered"] = tiered

    # K2 at the spilled exchange's shape: the received rows (the 40 queries,
    # then the zero rows of the unused slots) over the arranged int8 mirror
    m = device_mirror(store, "int8")
    slots = sum(line["plans"][str(ROUTED_SPILL)]["round_budgets"])
    Qr = torch.zeros((slots, D), dtype=torch.float32, device=Xd.device)
    Qr[:ROUTED_SPILL] = eng.pruner.transform_batch(Qd[:ROUTED_SPILL])
    name = "K2 batched_distance_quant [int8, routed spill]"
    rows = [k2_kernel_row(torch, ref, pl.arranged_mirror(m), Qr, m.scale, m.offset,
                          False, D, "int8", name, launches[("int8", ROUTED_SPILL)],
                          (pl.ids >= 0).reshape(-1))]
    # the placement's copies of the tiles go: later phases do not route
    store._placement_cache.clear()
    torch.cuda.empty_cache()
    line["seconds"] = time.perf_counter() - t0
    emit(line)
    assert not fails, fails
    by_row = {"K2 batched_distance_quant [f32]": launches[("f32", B)],
              "K2 batched_distance_quant [int8]": launches[("int8", B)],
              name: launches[("int8", ROUTED_SPILL)],
              **{f"K2 batched_distance_quant [{dt}, tiered pool]": rec["k2_launches"]
                 for dt, rec in tiered.items()}}
    return rows, by_row


def synced(torch, fn):
    """(fn(), host ms) with the card synchronised before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def lm_phase(torch, dev, cfg, seed: int) -> tuple[dict, object, dict]:
    """The served LM at full width: params drawn on the card from a seeded
    ``torch.Generator`` at f32, ``GenerationEngine.generate`` on LM_REQUESTS
    prompts of LM_PROMPT tokens for LM_NEW new tokens.  Recorded: params and
    their bytes, prefill ms, decode ms per token (median over the steps)
    beside its byte bound (every weight read once a step), tokens/s, peak
    device memory beside what was allocated before the params, one decode step's and one prefill's device time by
    kernel (``device_profile``); the same generation with bf16 weights (its
    tokens/s and the share of greedy tokens equal to f32's, not held).  Two
    ``generate`` calls give equal tokens; prefill + one decode equals the
    parallel forward at the reference test's tolerance.  -> (line, engine,
    the request batch, its generated tokens)."""
    from repro_torch.models.lm import build_model
    from repro_torch.serve import GenerationEngine

    model = build_model(cfg)
    before = torch.cuda.memory_allocated()  # what earlier phases left
    params, init_ms = synced(torch, lambda: model.init(
        torch.Generator(device=dev).manual_seed(seed), device=dev))
    leaves = _tensors(params)
    n_params = sum(t.numel() for t in leaves)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    cache_len = LM_PROMPT * 3 + LM_NEW + 8  # launch/serve.py
    eng = GenerationEngine(model=model, params=params, cache_len=cache_len)
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (LM_REQUESTS, LM_PROMPT)).astype(np.int32)}
    eng.generate(batch, max_new_tokens=2)  # warm the libraries, uncounted
    torch.cuda.reset_peak_memory_stats()

    with torch.no_grad():
        (logits, caches), prefill_ms = synced(
            torch, lambda: model.prefill(params, batch, cache_len))
        step_ms = []
        tok = torch.argmax(logits, dim=-1)[:, None]
        for t in range(LM_NEW - 1):
            (logits, caches), ms = synced(torch, lambda: model.decode_step(
                params, tok, caches, LM_PROMPT + t))
            step_ms.append(ms)
            tok = torch.argmax(logits, dim=-1)[:, None]
        # where a step's time goes: one decode step (rewriting the last
        # row) and one prefill under torch.profiler
        prof_decode = device_profile(torch, lambda: model.decode_step(
            params, tok, caches, LM_PROMPT + LM_NEW - 1))
        prof_prefill = device_profile(torch, lambda: model.prefill(params, batch, cache_len))
    del caches, logits
    out, gen_ms = synced(torch, lambda: eng.generate(batch, max_new_tokens=LM_NEW))
    again = eng.generate(batch, max_new_tokens=LM_NEW)
    peak = torch.cuda.max_memory_allocated()
    assert np.array_equal(out, again), "two generate calls disagree"

    # prefill of all but the last token + one decode of it == the parallel
    # forward's last-token logits
    with torch.no_grad():
        h = model.forward_train(params, batch)
        par = (h[:, -1, :] @ model._head(params)).cpu().numpy()
        del h
        _, caches = model.prefill(params, {"tokens": batch["tokens"][:, :-1]}, cache_len)
        dec, _ = model.decode_step(params, batch["tokens"][:, -1:], caches, LM_PROMPT - 1)
        dec = dec.cpu().numpy()
        del caches
    tf_err = float(np.abs(par - dec).max())
    tf_ok = bool(np.allclose(dec, par, rtol=TEACHER_RTOL, atol=TEACHER_ATOL))

    # the same generation with bf16 weights (the reference's init(dtype=))
    p16 = model.init(torch.Generator(device=dev).manual_seed(seed), torch.bfloat16, device=dev)
    eng16 = GenerationEngine(model=model, params=p16, cache_len=cache_len)
    eng16.generate(batch, max_new_tokens=2)
    out16, gen16_ms = synced(torch, lambda: eng16.generate(batch, max_new_tokens=LM_NEW))
    del eng16, p16
    torch.cuda.empty_cache()

    decode_ms = statistics.median(step_ms)
    bound, by = bound_ms(param_bytes, 2.0 * n_params * LM_REQUESTS)
    line = {"phase": "lm", "arch": cfg.name, "dtype": "f32", "layers": cfg.n_layers,
            "d_model": cfg.d_model, "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
            "d_ff": cfg.d_ff, "vocab": cfg.vocab, "params": n_params,
            "param_bytes": param_bytes, "init_ms": init_ms,
            "requests": LM_REQUESTS, "prompt_tokens": LM_PROMPT, "new_tokens": LM_NEW,
            "cache_len": cache_len, "prefill_ms": prefill_ms,
            "decode_ms_per_token_median": decode_ms, "decode_ms_min": min(step_ms),
            "decode_ms_max": max(step_ms), "decode_bound_ms": bound,
            "decode_bound_by": by, "decode_share_of_bound": bound / decode_ms,
            "generate_ms": gen_ms, "tokens_per_s": LM_REQUESTS * LM_NEW / (gen_ms / 1e3),
            "peak_device_memory_gb": peak / 1e9,
            "device_memory_before_init_gb": before / 1e9, "repeat_generate_equal": True,
            "decode_profile": prof_decode, "prefill_profile": prof_prefill,
            "teacher_forcing_max_abs_err": tf_err, "teacher_forcing_ok": tf_ok,
            "bf16": {"generate_ms": gen16_ms,
                     "tokens_per_s": LM_REQUESTS * LM_NEW / (gen16_ms / 1e3),
                     "greedy_tokens_equal_to_f32": float((out16 == out).mean())},
            "first_row": out[0].tolist()}
    assert tf_ok, f"prefill + decode off the parallel forward by {tf_err}"
    return line, eng, batch, out


def _tensors(tree: dict) -> list:
    """Every tensor of a nested param dict."""
    return [t for v in tree.values() for t in (_tensors(v) if isinstance(v, dict) else [v])]


def rag_phase(torch, ref, eng, batch, seed: int, counters: dict,
              n_docs: int = RAG_DOCS) -> tuple[dict, list]:
    """``RagPipeline.build`` over ``n_docs`` documents of RAG_DOC_LEN tokens
    (the LM embeds them, the flat ADSampling store of capacity 256 takes the
    embeddings on the LM's device), then ``answer`` on the lm phase's
    requests with ``retrieve_k = 1``.  With the launch counters zeroed just
    before each call and read just after: RAG_BATCH sampled documents as
    one query batch (``fused-batch``, exactly one K2) and the first
    RAG_SINGLE of them one at a time (``fused-scan``, one K1 each).  Held:
    each document retrieves itself at rank 0; recall@10 against a ground
    truth of direct f32 differences on the card at the main path's floors;
    returned distances exact (1e-3 relative, where the direct distance is
    0 within K2's rounding scale 1e-5 (||q||^2 + ||x||^2)); the retrieval
    counter's executor label; ``add_documents`` of RAG_ADD documents returns
    consecutive ids that each retrieve themselves; K1 and K2 at the store's
    shape against their plain versions.  Recorded besides: the embedding's
    and the store build's seconds, one embedding chunk's device profile,
    retrieve and search walls at B = RAG_BATCH and 1, ``answer``'s wall.
    -> (line, kernel rows)."""
    import dataclasses

    from repro_torch.core.engine import SearchSpec
    from repro_torch.core.layout import device_mirror
    from repro_torch.core.plan import _start
    from repro_torch.core.topk import topk_threshold
    from repro_torch.obs import metrics
    from repro_torch.serve import RagPipeline

    k1, k2 = counters["k1"], counters["k2"]
    cfg = eng.model.cfg
    dev = eng.device
    rng = np.random.default_rng(seed + 3)
    docs = rng.integers(0, cfg.vocab, (n_docs, RAG_DOC_LEN)).astype(np.int32)
    sel = rng.choice(n_docs, RAG_BATCH, replace=False)

    # build, with the LM's embedding calls timed (and their outputs kept:
    # the ground truth's rows) apart from the store's build
    embed = CallTimer(eng.embed)
    rows = []

    def recording(b):
        rows.append(embed(b))
        return rows[-1]

    eng.embed = recording
    try:
        rag, build_ms = synced(torch, lambda: RagPipeline.build(eng, docs, device=dev))
    finally:
        del eng.embed
    assert rag.store.device == dev and rag.store.store.data.shape[1:] == (cfg.d_model, 256)
    Xd = torch.from_numpy(np.concatenate(rows)).to(dev)
    del rows
    prof_embed = device_profile(torch, lambda: eng.embed({"tokens": docs[:32]}))
    rag10 = dataclasses.replace(rag, retrieve_k=K)

    def counted(fn):
        k1.launches = k2.launches = 0
        out = fn()
        return out, k1.launches, k2.launches

    qbatch = {"tokens": docs[sel]}
    metrics.set_enabled(True)
    try:
        before = metrics.get_registry().get("repro_rag_retrievals_total", executor="fused-batch")
        ids_b, b_k1, b_k2 = counted(lambda: rag10.retrieve(qbatch))
        counted_b = metrics.get_registry().get("repro_rag_retrievals_total",
                                               executor="fused-batch") - before
    finally:
        metrics.set_enabled(False)
    assert (b_k1, b_k2) == (0, 1), f"the batch of {RAG_BATCH} launched K1 {b_k1}, K2 {b_k2}"
    assert counted_b == RAG_BATCH, f"retrievals counted as fused-batch: {counted_b}"
    singles = []
    for i in range(RAG_SINGLE):
        ids_s, s_k1, s_k2 = counted(lambda: rag10.retrieve({"tokens": docs[sel[i:i + 1]]}))
        assert (s_k1, s_k2) == (1, 0), f"single query {i}: K1 {s_k1}, K2 {s_k2}"
        singles.append(ids_s[0])
    ids_s = np.stack(singles)
    Q = eng.embed(qbatch)
    Qd = torch.from_numpy(Q).to(dev)
    spec = rag.store.spec.replace(k=K)
    plan_b = rag.store.plan(Q)
    plan_s = rag.store.plan(Q[:1])
    assert plan_b.executor == "fused-batch" and plan_s.executor == "fused-scan", (plan_b, plan_s)
    res_b = rag.store.search(Q, spec)
    res_s = [rag.store.search(Q[i], spec) for i in range(RAG_SINGLE)]
    assert np.array_equal(res_b.ids, ids_b), "retrieve and search disagree on the batch"
    self_b = int((ids_b[:, 0] == sel).sum())
    self_s = int((ids_s[:, 0] == sel[:RAG_SINGLE]).sum())
    gt = ground_truth(torch, Xd, Qd, K)
    r_b, r_s = recall(ids_b, gt), recall(ids_s, gt[:RAG_SINGLE])
    err_b = rag_dist_error(torch, Xd, Qd, res_b.ids, res_b.dists)
    err_s = rag_dist_error(torch, Xd, Qd[:RAG_SINGLE], np.stack([r.ids for r in res_s]),
                           np.stack([r.dists for r in res_s]))

    # walls: retrieve (the LM's embedding included) and the search alone
    def median_ms(fn):
        return statistics.median(synced(torch, fn)[1] for _ in range(RAG_REPS))

    walls = {"retrieve_ms_b64": median_ms(lambda: rag.retrieve(qbatch)),
             "retrieve_ms_b1": median_ms(lambda: rag.retrieve({"tokens": docs[sel[:1]]})),
             "search_ms_b64": median_ms(lambda: rag.store.search(Q, rag.store.spec)),
             "search_ms_b1": median_ms(lambda: rag.store.search(Q[0], rag.store.spec))}
    ((out, doc_ids), a_k1, a_k2), answer_ms = synced(
        torch, lambda: counted(lambda: rag.answer(batch, LM_NEW)))
    assert out.shape == (LM_REQUESTS, LM_NEW) and doc_ids.shape == (LM_REQUESTS, 1)
    assert (a_k1, a_k2) == (0, 1), f"answer's retrieval launched K1 {a_k1}, K2 {a_k2}"

    # K1 and K2 at the store's shape against their plain versions
    store, pruner = rag.store.store, rag.store.pruner
    m = device_mirror(store, "f32")
    qt, p0, start = _start(store, pruner, Qd[0], spec, None)
    ids_scan = store.ids.clone()
    ids_scan[p0] = -1
    tag = f"f32 rag D={store.dim} C={store.capacity}"
    rows_k = [scan_kernel_row(torch, ref, m, ids_scan, qt, topk_threshold(start),
                              float(pruner.aux["eps0"]), prefetch=False, launches=RAG_SINGLE,
                              tag=tag)]
    rows_k.append(k2_kernel_row(torch, ref, m.data, pruner.transform_batch(Qd), None, None,
                                False, m.dim, "f32", f"K2 batched_distance_quant [{tag}]",
                                b_k2 + a_k2, (store.ids >= 0).reshape(-1)))
    del m, ids_scan

    # documents added live: consecutive ids, each its own rank 0 (fused-scan
    # on the mutable store's write-head)
    new = rng.integers(0, cfg.vocab, (RAG_ADD, RAG_DOC_LEN)).astype(np.int32)
    new_ids, add_ms = synced(torch, lambda: rag.add_documents(new))
    new_self = []
    for j in range(RAG_ADD):
        got, n_k1, _ = counted(lambda: rag.retrieve({"tokens": new[j:j + 1]}))
        assert n_k1 == 1, f"new document {j}: K1 launched {n_k1} times"
        new_self.append(int(got[0, 0]))
    # a row's launches: the phase's counted runs (K1: the singles and the
    # added documents' queries; K2: the batch and answer's retrieval)
    for row, n in zip(rows_k, (RAG_SINGLE + RAG_ADD, b_k2 + a_k2)):
        row["launches"] = row["launches_rag"] = n

    line = {"phase": "rag", "docs": n_docs, "doc_tokens": RAG_DOC_LEN, "dim": cfg.d_model,
            "capacity": store.capacity, "partitions": store.num_partitions,
            "pruner": pruner.name, "embed_s": embed.seconds, "embed_calls": embed.calls,
            "embed_tokens_per_s": n_docs * RAG_DOC_LEN / embed.seconds,
            "embed_chunk_profile": prof_embed,
            "store_build_s": build_ms / 1e3 - embed.seconds, "build_s": build_ms / 1e3,
            "batch_executor": plan_b.executor, "single_executor": plan_s.executor,
            "batch_launches": {"k1": b_k1, "k2": b_k2}, "single_launches_each": {"k1": 1},
            "self_retrieved_batch": self_b, "self_retrieved_single": self_s,
            "recall_at_10_batch": r_b, "recall_at_10_single": r_s,
            "dist_rel_err_batch": err_b, "dist_rel_err_single": err_s,
            **walls, "answer_ms": answer_ms,
            "answer_tokens_per_s": LM_REQUESTS * LM_NEW / (answer_ms / 1e3),
            "answer_launches": {"k1": a_k1, "k2": a_k2}, "answer_doc_ids": doc_ids[:, 0].tolist(),
            "added_ids": np.asarray(new_ids).tolist(), "added_self": new_self,
            "add_documents_ms": add_ms}
    emit(line)
    assert self_b == RAG_BATCH and self_s == RAG_SINGLE, (self_b, self_s)
    f_s, f_b = RAG_RECALL_FLOORS
    assert r_b >= f_b and r_s >= f_s, f"RAG recall@10 batch {r_b}, single {r_s}"
    assert max(err_b, err_s) <= 1e-3, f"RAG returned distances off: {err_b}, {err_s}"
    assert np.asarray(new_ids).tolist() == list(range(n_docs, n_docs + RAG_ADD)), new_ids
    assert new_self == list(range(n_docs, n_docs + RAG_ADD)), new_self
    return line, rows_k


# ------------------------------------------------------------------ training
def _grad_step(torch, model, params, batch, remat: bool = True):
    """(loss, grads in leaf order) of ``model.loss`` under autograd."""
    from repro_torch.train._tree import leaves

    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    try:
        loss = model.loss(params, batch, remat=remat)
        # a leaf the loss does not reach (DeepSeek-V3's router bias) gets zeros
        return loss.detach(), list(torch.autograd.grad(
            loss, flat, allow_unused=True, materialize_grads=True))
    finally:
        for p in flat:
            p.requires_grad_(False)


def _clone(torch, tree: dict) -> dict:
    return {k: _clone(torch, v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _finite(torch, tensors) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in tensors)


class _Recorded:
    """Replaces ``module.name`` (looked up at each call) with a wrapper that
    calls ``hook(result, *args)``; restores it on exit (a class's
    staticmethod as such)."""

    def __init__(self, module, name: str, hook):
        self.module, self.name, self.hook = module, name, hook

    def __enter__(self):
        self.raw = vars(self.module)[self.name]
        real = getattr(self.module, self.name)

        def wrapped(*args, **kwargs):
            return self.hook(real, *args, **kwargs)
        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.raw)


def _timed_steps(torch, step, params, state, batch) -> dict:
    """TRAIN_STEPS steps of ``step`` on one batch (params updated in place,
    the optimizer state each step returns carried to the next: its step
    count is a new tensor), the last under ``torch.profiler``,
    ``opt_update`` timed through ``trainer.opt_update`` (synchronised
    around it) -> the losses, grad norms, step and optimizer walls, the
    profiled step, and the median, least and most of the step, of
    forward+backward and of the optimizer over the steps between the
    first (which pays the allocator and the libraries) and the profiled
    one."""
    from repro_torch.train import trainer

    opt_ms = []

    def timed_opt(real, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        torch.cuda.synchronize()
        opt_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    losses, gnorms, step_ms = [], [], []
    with _Recorded(trainer, "opt_update", timed_opt):
        for i in range(TRAIN_STEPS):
            if i == TRAIN_STEPS - 1:  # the last step under torch.profiler
                box = []
                prof = device_profile(torch, lambda: box.append(step(params, state, batch)))
                (_, state, m), ms = box[0], prof["wall_ms"]
            else:
                (_, state, m), ms = synced(torch, lambda: step(params, state, batch))
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            step_ms.append(ms)
    timed, opt = step_ms[1:-1], opt_ms[1:-1]
    fwd_bwd = [s - o for s, o in zip(timed, opt)]
    return {"losses": losses, "grad_norms": gnorms, "step_ms": step_ms, "opt_ms": opt_ms,
            "step_ms_median": statistics.median(timed), "step_ms_min": min(timed),
            "step_ms_max": max(timed), "fwd_bwd_ms_median": statistics.median(fwd_bwd),
            "fwd_bwd_ms_min": min(fwd_bwd), "fwd_bwd_ms_max": max(fwd_bwd),
            "opt_ms_median": statistics.median(opt), "opt_ms_min": min(opt),
            "opt_ms_max": max(opt), "profiled_step": prof}


def _ce_against_full(torch, model, params, batch) -> tuple[float, float]:
    """(the chunked loss, ``F.cross_entropy`` over the full logits) of the
    same hidden states (a VLM's text positions only)."""
    import torch.nn.functional as F

    from repro_torch.models.lm import chunked_ce_loss

    cfg = model.cfg
    with torch.no_grad():
        h = model.forward_train(params, batch)
        if cfg.vlm:
            h = h[:, cfg.n_patches:]
        head = model._head(params)
        chunked = float(chunked_ce_loss(h, batch["labels"], head))
        full = float(F.cross_entropy((h @ head).reshape(-1, cfg.vocab),
                                     batch["labels"].long().reshape(-1)))
    return chunked, full


def _hold_training(line: dict, launched: dict) -> None:
    """A training line's holds: the chunked loss against the full logits at
    CE_RTOL, every loss and grad norm finite, the last loss below the
    first, no kernel of the port launched."""
    arch, losses = line["arch"], line["losses"]
    assert line["chunked_vs_full_rel"] <= CE_RTOL, (
        f"{arch}: chunked loss {line['chunked_loss']} against full logits "
        f"{line['full_logits_loss']}")
    assert all(np.isfinite(losses)) and all(np.isfinite(line["grad_norms"])), (
        arch, losses, line["grad_norms"])
    assert losses[-1] < losses[0], (arch, losses)
    assert not any(launched.values()), f"{arch}: training launched a kernel of the port: {launched}"


def _remat_on_off(torch, model, params, batch) -> dict:
    """The loss and grads with remat and without, from the same params,
    both under ``torch.use_deterministic_algorithms(True, warn_only=True)``:
    on the card the MoE dispatch's gather takes its backward as atomic
    adds of a token's k slots, whose order changes from run to run, so
    two runs of one function differ; the mode sums them in a fixed order
    (cuBLAS only warns).  Held: both losses finite and within rtol 1e-6,
    every leaf's grads ``torch.allclose`` at rtol 1e-5 and 1e-6 x the
    leaf's largest |grad| (which fails a NaN); recorded: the largest gap,
    the leaf farthest off that bar (its gap over the bar, for the record
    only), whether they are bit for bit."""
    from repro_torch.train._tree import flatten_with_paths

    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        lr_on, g_on = _grad_step(torch, model, params, batch, remat=True)
        lr_off, g_off = _grad_step(torch, model, params, batch, remat=False)
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
    worst, worst_leaf, gap, close = 0.0, None, 0.0, True
    for (path, _), a, b in zip(flatten_with_paths(params), g_on, g_off):
        if not b.numel():
            continue
        big = float(b.abs().max())
        close = close and bool(torch.allclose(a, b, rtol=1e-5, atol=1e-6 * big))
        d = (a - b).abs()
        gap = max(gap, float(d.max()))
        off = float((d / (1e-5 * b.abs() + 1e-6 * big)).nan_to_num(0.0).max())
        if off > worst:
            worst, worst_leaf = off, ".".join(map(str, path))
    return {"loss_on": float(lr_on), "loss_off": float(lr_off), "grads_max_abs_diff": gap,
            "worst_leaf": worst_leaf, "worst_gap_over_bar": worst,
            "bitwise": all(torch.equal(a, b) for a, b in zip(g_on, g_off))
            and bool(lr_on == lr_off),
            "ok": bool(np.isfinite([float(lr_on), float(lr_off)]).all())
            and abs(float(lr_on) - float(lr_off)) <= 1e-6 * abs(float(lr_off)) and close}


def train_phase(torch, cfg, params, lm_batch, lm_out, seed: int, counters: dict) -> dict:
    """Full width: AdamW (lr 1e-4, no warmup) with remat, TRAIN_STEPS steps on
    one fixed ``TokenStream(cfg, TRAIN_SEQ, TRAIN_BATCH, seed)`` batch placed
    on the main thread, on phase 8's params (updated in place).  Held: the
    chunked loss of the params' hidden states equals ``F.cross_entropy``
    over their full logits at rtol CE_RTOL; every loss and grad norm finite;
    the last loss below the first; two ``generate`` calls on the trained
    params equal; no kernel of the port launched.  Recorded: the losses, the
    step's median, least and most ms split into forward+backward and
    ``opt_update`` (``_timed_steps``), tokens/s, the share of the f32 peak
    at 6 N T FLOP, the optimizer beside its byte bound, peak memory, the
    last step's device profile, and how many generated tokens differ from
    phase 8's."""
    from repro_torch.data.pipeline import TokenStream, to_device
    from repro_torch.models.lm import build_model
    from repro_torch.serve import GenerationEngine
    from repro_torch.train import trainer
    from repro_torch.train._tree import leaves
    from repro_torch.train.optimizer import OptConfig, opt_init

    model = build_model(cfg)
    dev = params["embed"].device
    before = torch.cuda.memory_allocated()
    n_params = sum(t.numel() for t in leaves(params))
    batch = to_device(dev)(TokenStream(cfg, TRAIN_SEQ, TRAIN_BATCH, seed).batch_at(0))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    launched = {k: c.launches for k, c in counters.items()}

    chunked, full = _ce_against_full(torch, model, params, batch)
    ce_rel = abs(chunked - full) / abs(full)

    oc = OptConfig(lr=TRAIN_LR, warmup_steps=0)
    state = opt_init(params, oc)
    step = trainer.make_train_step(model, trainer.TrainConfig(opt=oc))
    torch.cuda.reset_peak_memory_stats()
    steps = _timed_steps(torch, step, params, state, batch)
    peak = torch.cuda.max_memory_allocated()
    del state, step
    torch.cuda.empty_cache()

    eng = GenerationEngine(model=model, params=params, cache_len=LM_PROMPT * 3 + LM_NEW + 8)
    out = eng.generate(lm_batch, max_new_tokens=LM_NEW)
    again = eng.generate(lm_batch, max_new_tokens=LM_NEW)
    del eng
    launched = {k: c.launches - launched[k] for k, c in counters.items()}

    med = steps["step_ms_median"]
    opt_bound = OPT_BYTES_PER_PARAM * n_params / PEAK_BYTES_PER_S * 1e3
    line = {"phase": "train", "arch": cfg.name, "layers": cfg.n_layers, "dtype": "f32",
            "params": n_params, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "tokens": tokens,
            "optimizer": "adamw", "lr": TRAIN_LR, "remat": True,
            "chunked_loss": chunked, "full_logits_loss": full, "chunked_vs_full_rel": ce_rel,
            **steps, "opt_bound_ms": opt_bound,
            "opt_share_of_bound": opt_bound / steps["opt_ms_median"],
            "tokens_per_s": tokens / (med / 1e3),
            "f32_peak_share_6NT": 6.0 * n_params * tokens / (med / 1e3) / PEAK_F32_FLOPS,
            "peak_device_memory_gb": peak / 1e9,
            "device_memory_before_gb": before / 1e9,
            "generate_equal": bool(np.array_equal(out, again)),
            "tokens_changed_from_lm_phase": int((out != lm_out).sum()),
            "tokens_generated": int(out.size), "kernel_launches": launched}
    emit(line)
    _hold_training(line, launched)
    assert line["generate_equal"], "two generate calls on the trained params disagree"
    return line


def train_two_layer_phase(torch, cfg, seed: int, dev) -> dict:
    """Full width, 2 layers (``dataclasses.replace(cfg, n_layers=2)``),
    B = TRAIN_BATCH, S = TRAIN_SEQ.  Held: ``accum_steps=4`` against 1 from
    the same params (the loss and the grads' ``global_norm`` difference at
    rtol ACCUM_RTOL; at TRAIN_LR the params' difference's ``global_norm``
    below ACCUM_PARAM_BAR, the reference's bar; at the reference test's
    ACCUM_REF_LR it is recorded: Adam's first step moves an element by
    about lr sign(g) however small g is, so where a grad is near 0 the f32
    noise of summing it in another order moves it by up to 2 lr); remat on
    against off (losses rtol 1e-6, grads within rtol 1e-5 and 1e-6 x each
    leaf's largest |grad|); EF_STEPS ``compress_grads`` steps keep the
    error-feedback identity, sum of delivered grads + residual = sum of raw
    grads within EF_BAR (both read through ``trainer.ef_compress``); an
    Adafactor step is finite.  Recorded: step walls, the remat gaps."""
    import dataclasses

    from repro_torch.data.pipeline import TokenStream, to_device
    from repro_torch.models.lm import build_model
    from repro_torch.train import trainer
    from repro_torch.train._tree import leaves
    from repro_torch.train.compression import ef_init
    from repro_torch.train.optimizer import OptConfig, global_norm, opt_init

    cfg2 = dataclasses.replace(cfg, n_layers=2)
    model = build_model(cfg2)
    batch = to_device(dev)(TokenStream(cfg2, TRAIN_SEQ, TRAIN_BATCH, seed).batch_at(0))

    def fresh():
        return model.init(torch.Generator(device=dev).manual_seed(seed), device=dev)

    # accumulation against the full batch, at the phase's learning rate
    # (held) and at the reference test's 1e-3 (recorded)
    accum = {}
    for lr in (TRAIN_LR, ACCUM_REF_LR):
        oc = OptConfig(lr=lr, warmup_steps=0)
        p1 = fresh()
        p4 = _clone(torch, p1)
        seen = []

        def grab(real, grads, *args):
            seen.append(leaves(grads))  # read, never written by opt_update
            return real(grads, *args)

        with _Recorded(trainer, "opt_update", grab):
            (p1, _, m1), ms1 = synced(torch, lambda: trainer.make_train_step(
                model, trainer.TrainConfig(opt=oc))(p1, opt_init(p1, oc), batch))
            (p4, _, m4), ms4 = synced(torch, lambda: trainer.make_train_step(
                model, trainer.TrainConfig(opt=oc, accum_steps=4))(p4, opt_init(p4, oc), batch))
        l1, l4 = float(m1["loss"]), float(m4["loss"])
        accum[lr] = {
            "lr": lr, "loss_1": l1, "loss_4": l4, "loss_rel": abs(l1 - l4) / abs(l1),
            "grads_rel_diff": float(global_norm([a - b for a, b in zip(*seen)])
                                    / global_norm(seen[0])),
            "params_diff_global_norm": float(global_norm(
                [a - b for a, b in zip(leaves(p1), leaves(p4))])),
            "step_ms_1": ms1, "step_ms_4": ms4}
        n_params = sum(t.numel() for t in leaves(p1))
        del p1, p4, m1, m4, seen
        torch.cuda.empty_cache()
    held = accum[TRAIN_LR]

    # remat on against off
    remat = _remat_on_off(torch, model, fresh(), batch)
    torch.cuda.empty_cache()

    # compression: the error-feedback identity over EF_STEPS steps
    oc = OptConfig(lr=1e-3, warmup_steps=0)
    pc = fresh()
    sums = {"raw": [torch.zeros_like(t) for t in leaves(pc)],
            "out": [torch.zeros_like(t) for t in leaves(pc)]}

    def recording(real, grads, residual):
        for a, g in zip(sums["raw"], leaves(grads)):
            a.add_(g)
        out, res = real(grads, residual)
        for a, g in zip(sums["out"], leaves(out)):
            a.add_(g)
        return out, res

    step_c = trainer.make_train_step(model, trainer.TrainConfig(opt=oc, compress_grads=True))
    sc, ef = opt_init(pc, oc), ef_init(pc)
    comp_losses, comp_ms = [], []
    with _Recorded(trainer, "ef_compress", recording):
        for _ in range(EF_STEPS):
            (pc, sc, mc, ef), ms = synced(torch, lambda: step_c(pc, sc, batch, ef))
            comp_losses.append(float(mc["loss"]))
            comp_ms.append(ms)
    ef_err = max(float((o + e - r).abs().max())
                 for o, e, r in zip(sums["out"], leaves(ef), sums["raw"]))
    ef_finite = _finite(torch, leaves(ef))
    del pc, sc, ef, sums, mc
    torch.cuda.empty_cache()

    # one Adafactor step
    oa = OptConfig(lr=2e-2, warmup_steps=0, kind="adafactor")
    pa = fresh()
    (pa, _, ma), ms_a = synced(torch, lambda: trainer.make_train_step(
        model, trainer.TrainConfig(opt=oa))(pa, opt_init(pa, oa), batch))
    ada = {"loss": float(ma["loss"]), "grad_norm": float(ma["grad_norm"]),
           "params_finite": _finite(torch, leaves(pa)), "step_ms": ms_a}
    del pa, ma
    torch.cuda.empty_cache()

    line = {"phase": "train_2l", "arch": cfg2.name, "layers": 2, "params": n_params,
            "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "accum": list(accum.values()),
            "remat": {k: v for k, v in remat.items() if k != "ok"},
            "compress": {"losses": comp_losses, "step_ms": comp_ms,
                         "ef_identity_max_abs_err": ef_err, "residual_finite": ef_finite},
            "adafactor": ada}
    emit(line)
    assert held["loss_rel"] <= ACCUM_RTOL, held
    assert held["params_diff_global_norm"] < ACCUM_PARAM_BAR, held
    assert all(rec["grads_rel_diff"] <= ACCUM_RTOL for rec in accum.values()), accum
    assert remat["ok"], f"remat on and off differ: {remat['grads_max_abs_diff']}"
    assert all(np.isfinite(comp_losses)) and ef_finite, comp_losses
    assert ef_err < EF_BAR, f"error feedback: out + residual - raw = {ef_err}"
    assert np.isfinite(ada["loss"]) and np.isfinite(ada["grad_norm"]) and ada["params_finite"]
    return line


RESUME_CODE = r"""
import json, sys, tempfile
import numpy as np
import torch
torch.use_deterministic_algorithms(True)
sys.path.insert(0, sys.argv[1])
from repro_torch.launch.train import train_loop

seed, device = int(sys.argv[2]), sys.argv[3]
kw = dict(reduced=True, batch=2, seq=16, lr=1e-2, ckpt_every=3, log_every=100,
          seed=seed, device=device)
with tempfile.TemporaryDirectory() as root:
    full = train_loop("llama3.2-3b", steps=6, ckpt_dir=root + "/a", **kw)
    train_loop("llama3.2-3b", steps=3, ckpt_dir=root + "/b", **kw)
    resumed = train_loop("llama3.2-3b", steps=6, ckpt_dir=root + "/b", **kw)
    with np.load(root + "/a/step_0000000006/arrays.npz") as a, \
            np.load(root + "/b/step_0000000006/arrays.npz") as b:
        keys = sorted(a.files)
        same_keys = keys == sorted(b.files)
        diff = max(float(np.abs(a[k].astype(np.float64) - b[k]).max()) for k in keys)
print(json.dumps({"device": device, "keys": len(keys),
                  "same_keys": same_keys, "max_abs_diff": diff,
                  "history_full": full["history"], "history_resumed": resumed["history"]}))
"""


def train_reduced_phase(torch, seed: int, dev) -> dict:
    """The reduced config (``cfg.reduced()``): OVERFIT_STEPS steps on one
    batch drop the loss by more than OVERFIT_DROP for AdamW and for
    ``compress_grads`` (lr 1e-2, the reference's bar); then ``train_loop``
    for 6 steps in one go against 3, a restart from its ``ckpt_dir`` and 3
    more (checkpoints every 3), in a subprocess under
    ``torch.use_deterministic_algorithms(True)`` with
    ``CUBLAS_WORKSPACE_CONFIG`` set before its first cuBLAS handle (this
    process has made one): the step-6 checkpoints equal bit for bit and the
    resumed losses equal the uninterrupted run's."""
    import os

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.models.lm import build_model
    from repro_torch.train import trainer
    from repro_torch.train.compression import ef_init
    from repro_torch.train.optimizer import OptConfig, opt_init

    cfg = get_config(LM_ARCH).reduced()
    model = build_model(cfg)
    batch = TokenStream(cfg, 16, 4, seed).batch_at(0)
    overfit = {}
    for name, compress in (("adamw", False), ("compress", True)):
        oc = OptConfig(lr=1e-2, warmup_steps=0)
        params = model.init(torch.Generator(device=dev).manual_seed(seed), device=dev)
        state = opt_init(params, oc)
        step = trainer.make_train_step(model, trainer.TrainConfig(opt=oc, compress_grads=compress))
        extra = (ef_init(params),) if compress else ()
        losses = []
        t0 = time.perf_counter()
        for _ in range(OVERFIT_STEPS):
            out = step(params, state, batch, *extra)
            params, state, m = out[:3]
            extra = out[3:]
            losses.append(float(m["loss"]))
        overfit[name] = {"losses": losses, "drop": losses[0] - losses[-1],
                         "ms_per_step": (time.perf_counter() - t0) / OVERFIT_STEPS * 1e3}

    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-c", RESUME_CODE, str(ROOT / "src"), str(seed),
                          str(dev)],
                         env=env, capture_output=True, text=True, timeout=600)
    resume_s = time.perf_counter() - t0
    if run.returncode != 0:
        raise RuntimeError(f"the resume subprocess failed: {run.stderr[-3000:]}")
    resume = json.loads(run.stdout.strip().splitlines()[-1])
    resume["seconds"] = resume_s
    line = {"phase": "train_reduced", "arch": cfg.name, "overfit": overfit, "resume": resume}
    emit(line)
    for name, rec in overfit.items():
        assert rec["drop"] > OVERFIT_DROP, (name, rec["losses"])
    assert resume["same_keys"] and resume["max_abs_diff"] == 0.0, resume
    assert resume["history_resumed"] == resume["history_full"][3:], resume
    return line


# ------------------------------------------------------------ the families
def moe_loop(torch, p, x, cfg):
    """The plain MoE of one decode-shape input x (B, 1, d): per token, its
    top-k experts by selection logit (``torch.topk``), each weighted by its
    renormalised router probability, plus the shared experts."""
    from repro_torch.models.common import act_fn

    B, _, d = x.shape
    xf = x.reshape(B, d)
    logits = (xf @ p["router"]).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    select = logits + p["router_bias"] if cfg.router_aux_free else logits
    top = torch.topk(select, cfg.top_k, dim=-1).indices
    w = torch.gather(probs, -1, top)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    rows = []
    for b in range(B):
        y = torch.zeros(d, dtype=x.dtype, device=x.device)
        for j in range(cfg.top_k):
            e = int(top[b, j])
            h = act_fn(cfg.act, xf[b] @ p["w_gate"][e]) * (xf[b] @ p["w_up"][e])
            y = y + w[b, j].to(x.dtype) * (h @ p["w_down"][e])
        rows.append(y)
    y = torch.stack(rows)[:, None, :]
    if cfg.n_shared:
        s = p["shared"]
        y = y + (act_fn(cfg.act, x @ s["w_gate"]) * (x @ s["w_up"])) @ s["w_down"]
    return y


def moe_record(torch, run):
    """(run(), [(params, input)] of every ``moe_ffn.forward`` call in it)."""
    from repro_torch.models.moe import moe_ffn

    calls = []
    real = moe_ffn.__dict__["forward"]  # the staticmethod, restored as it was

    def recorded(p, x, cfg):
        calls.append((p, x))
        return real.__func__(p, x, cfg)
    moe_ffn.forward = staticmethod(recorded)
    try:
        out = run()
    finally:
        moe_ffn.forward = real
    return out, calls


def moe_holds(torch, cfg, prefill_calls, decode_calls) -> dict:
    """Each MoE layer at the decode shape against ``moe_loop`` (its dispatch
    must drop nothing), the drops at prefill, and the experts a decode step
    really routes to (distinct over the batch, per layer)."""
    from repro_torch.models.moe import moe_ffn

    errs, ok, active, drops_dec = [], True, [], 0
    with torch.no_grad():
        for p, x in decode_calls:
            idx, _, C_dec = moe_ffn.route(p, x, cfg)
            _, _, keep = moe_ffn.dispatch(idx, C_dec, cfg.n_experts)
            drops_dec += int((~keep).sum())
            active.append(int(torch.unique(idx).numel()))
            got, want = moe_ffn.forward(p, x, cfg), moe_loop(torch, p, x, cfg)
            errs.append(float((got - want).abs().max()))
            ok = ok and bool(torch.allclose(got, want, rtol=MOE_RTOL, atol=MOE_ATOL))
        drops_pre, pairs_pre = [], 0
        for p, x in prefill_calls:
            idx, _, C_pre = moe_ffn.route(p, x, cfg)
            _, _, keep = moe_ffn.dispatch(idx, C_pre, cfg.n_experts)
            drops_pre.append(int((~keep).sum()))
            pairs_pre += keep.numel()
    return {"layers": len(decode_calls), "experts": cfg.n_experts, "top_k": cfg.top_k,
            "shared": cfg.n_shared, "capacity_decode": C_dec, "capacity_prefill": C_pre,
            "drops_decode": drops_dec, "drops_prefill": sum(drops_pre),
            "drops_prefill_by_layer": drops_pre, "pairs_prefill": pairs_pre,
            "active_experts_decode": active, "loop_max_abs_err": max(errs),
            "loop_rtol": MOE_RTOL, "loop_atol": MOE_ATOL, "loop_ok": ok}


def mla_hold(torch, cfg, params, seed: int) -> dict:
    """One full-width MLA layer of the draw (stack 0, unit 0): prefill of
    LM_PROMPT - 1 rows and one absorbed-latent decode against
    ``forward_train``'s last row on the same LM_REQUESTS x LM_PROMPT inputs,
    at the teacher-forcing tolerance."""
    from repro_torch.models.attention import mla

    p = {k: v[0] for k, v in params["stack0"]["sub0"].items()}
    dev = p["wo"].device
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((LM_REQUESTS, LM_PROMPT, cfg.d_model), generator=g, device=dev)
    with torch.no_grad():
        full = mla.forward_train(p, x, cfg, torch.arange(LM_PROMPT, device=dev))
        _, cache = mla.forward_prefill(p, x[:, :-1], cfg, torch.arange(LM_PROMPT - 1, device=dev),
                                       LM_PROMPT + 8)
        y, _ = mla.forward_decode(p, x[:, -1:], cfg, cache, LM_PROMPT - 1)
    err = float((y[:, 0] - full[:, -1]).abs().max())
    return {"layer": "stack0.sub0", "kv_lora_rank": cfg.kv_lora_rank,
            "q_lora_rank": cfg.q_lora_rank, "heads": cfg.n_heads, "max_abs_err": err,
            "ok": bool(torch.allclose(y[:, 0], full[:, -1], rtol=TEACHER_RTOL,
                                      atol=TEACHER_ATOL))}


def _fit_depth(cfg, build_model, free_bytes: float) -> tuple:
    """``cfg`` cut (MoE layers first, keeping the dense ones) until its f32
    params leave FAMILY_HEADROOM_BYTES of ``free_bytes``: -> (cfg, bytes)."""
    import dataclasses

    def nbytes(c):
        return 4 * _n_params(c, build_model)
    b = nbytes(cfg)
    while b + FAMILY_HEADROOM_BYTES > free_bytes and cfg.n_layers > cfg.n_dense_layers + 1:
        cfg = dataclasses.replace(cfg, n_layers=cfg.n_layers - 1)
        b = nbytes(cfg)
    return cfg, b


def _n_params(cfg, build_model) -> int:
    """The params of ``cfg``'s model, counted from its shapes on no device."""
    from math import prod

    return sum(prod(s) for s in _shape_leaves(build_model(cfg).param_shapes()))


def _shape_leaves(tree: dict) -> list:
    return [s for v in tree.values()
            for s in (_shape_leaves(v) if isinstance(v, dict) else [v])]


def family_phase(torch, dev, name: str, seed: int) -> dict:
    """One family served at full width (f32, params drawn on the card from
    ``--seed``): ``GenerationEngine.generate`` on LM_REQUESTS prompts of
    LM_PROMPT tokens (after a VLM's patch embeddings, beside an
    encoder-decoder's frames, drawn as ``launch/serve.py`` draws them) for
    LM_NEW new tokens.  Held: two ``generate`` calls equal, every logit
    finite; FAMILY_TEACHER: prefill + one decode equals the parallel
    forward; MoE: every layer's decode output equals ``moe_loop`` with no
    drop; deepseek-v3: ``mla_hold``.  Recorded: the depth cut (``reduced``),
    params and bytes, prefill ms, decode ms a token beside two byte bounds
    (every weight read once a step, which the capacity dispatch does; the
    experts a step routes to only), tokens/s, peak memory beside what was
    allocated before, a decode step's device profile, the drops at
    prefill."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_model
    from repro_torch.serve import GenerationEngine

    full = get_config(name)
    cfg = full
    if name in FAMILY_LAYERS:
        cfg = dataclasses.replace(full, n_layers=FAMILY_LAYERS[name])
    free, total = torch.cuda.mem_get_info()
    reserved = torch.cuda.memory_reserved()
    cfg, _ = _fit_depth(cfg, build_model, free)
    _, published_bytes = _fit_depth(full, build_model, float("inf"))
    reduced = ({"n_layers": [full.n_layers, cfg.n_layers],
                "why": f"device memory: {published_bytes / 1e9:.1f} GB of f32 params at "
                       f"the published depth, {free / 1e9:.1f} GB free on the card"}
               if cfg.n_layers != full.n_layers else {})
    model = build_model(cfg)
    before = torch.cuda.memory_allocated()
    params, init_ms = synced(torch, lambda: model.init(
        torch.Generator(device=dev).manual_seed(seed), device=dev))
    leaves = _tensors(params)
    n_params = sum(t.numel() for t in leaves)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    pos0 = LM_PROMPT + (cfg.n_patches if cfg.vlm else 0)
    cache_len = pos0 + LM_PROMPT * 2 + LM_NEW + 8  # launch/serve.py's, past the patches
    eng = GenerationEngine(model=model, params=params, cache_len=cache_len)
    rng = np.random.default_rng(seed)
    host = {"tokens": rng.integers(0, cfg.vocab, (LM_REQUESTS, LM_PROMPT)).astype(np.int32)}
    if cfg.vlm:
        host["vision_embeds"] = rng.standard_normal(
            (LM_REQUESTS, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.encdec:
        host["enc_frames"] = rng.standard_normal(
            (LM_REQUESTS, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
    eng.generate(batch, max_new_tokens=2)  # warm the libraries, uncounted
    torch.cuda.reset_peak_memory_stats()

    finite = True
    with torch.no_grad():
        (logits, caches), prefill_ms = synced(
            torch, lambda: model.prefill(params, batch, cache_len))
        finite = finite and bool(torch.isfinite(logits).all())
        step_ms = []
        tok = torch.argmax(logits, dim=-1)[:, None]
        for t in range(LM_NEW - 1):
            (logits, caches), ms = synced(torch, lambda: model.decode_step(
                params, tok, caches, pos0 + t))
            step_ms.append(ms)
            finite = finite and bool(torch.isfinite(logits).all())
            tok = torch.argmax(logits, dim=-1)[:, None]
        prof_decode = device_profile(torch, lambda: model.decode_step(
            params, tok, caches, pos0 + LM_NEW - 1))
    del caches, logits
    out, gen_ms = synced(torch, lambda: eng.generate(batch, max_new_tokens=LM_NEW))
    again = eng.generate(batch, max_new_tokens=LM_NEW)
    peak = torch.cuda.max_memory_allocated()

    line = {"phase": "families", "arch": cfg.name, "family": cfg.family, "dtype": "f32",
            "layers": cfg.n_layers, "layers_published": full.n_layers, "reduced": reduced,
            "d_model": cfg.d_model, "vocab": cfg.vocab, "params": n_params,
            "param_bytes": param_bytes, "init_ms": init_ms, "requests": LM_REQUESTS,
            "prompt_tokens": LM_PROMPT, "new_tokens": LM_NEW, "pos0": pos0,
            "cache_len": cache_len, "prefill_ms": prefill_ms,
            "decode_ms_per_token_median": statistics.median(step_ms),
            "decode_ms_min": min(step_ms), "decode_ms_max": max(step_ms),
            "generate_ms": gen_ms, "tokens_per_s": LM_REQUESTS * LM_NEW / (gen_ms / 1e3),
            "peak_device_memory_gb": peak / 1e9, "device_memory_before_gb": before / 1e9,
            "device_free_gb_before": free / 1e9, "device_total_gb": total / 1e9,
            "allocator_reserved_gb_before": reserved / 1e9,
            "repeat_generate_equal": bool(np.array_equal(out, again)),
            "logits_finite": finite, "decode_profile": prof_decode,
            "first_row": out[0].tolist()}
    if cfg.vlm:
        line["patches"] = cfg.n_patches
    if cfg.encdec:
        line["encoder_frames"] = cfg.enc_seq
        line["encoder_layers"] = cfg.n_enc_layers

    read_bytes = param_bytes
    active_bytes = param_bytes
    if cfg.moe:
        with torch.no_grad():
            (_, caches), pre_calls = moe_record(
                torch, lambda: model.prefill(params, batch, cache_len))
            tok = torch.as_tensor(out[:, :1], device=dev)
            _, dec_calls = moe_record(torch, lambda: model.decode_step(
                params, tok, caches, pos0))
            del caches
        line["moe"] = moe_holds(torch, cfg, pre_calls, dec_calls)
        del pre_calls, dec_calls
        per_expert = 3 * cfg.d_model * cfg.d_ff_expert * 4
        active_bytes -= sum(cfg.n_experts - a for a in line["moe"]["active_experts_decode"]
                            ) * per_expert
    if cfg.mla:
        line["mla"] = mla_hold(torch, cfg, params, seed)
    if name in FAMILY_TEACHER:
        with torch.no_grad():
            h = model.forward_train(params, batch)
            par = (h[:, -1, :] @ model._head(params)).cpu().numpy()
            del h
            pre = dict(batch, tokens=batch["tokens"][:, :-1])
            _, caches = model.prefill(params, pre, cache_len)
            dec, _ = model.decode_step(params, batch["tokens"][:, -1:], caches, pos0 - 1)
            dec = dec.cpu().numpy()
            del caches
        line["teacher_forcing_max_abs_err"] = float(np.abs(par - dec).max())
        line["teacher_forcing_ok"] = bool(np.allclose(dec, par, rtol=TEACHER_RTOL,
                                                      atol=TEACHER_ATOL))
    decode_ms = line["decode_ms_per_token_median"]
    for tag, nbytes in (("read", read_bytes), ("active", active_bytes)):
        # every param f32; a weight's product takes 2 flops a row, and the
        # capacity dispatch runs LM_REQUESTS rows (C = 8) through each expert
        bound, by = bound_ms(nbytes, 2.0 * nbytes / 4 * LM_REQUESTS)
        line[f"decode_bound_ms_{tag}"] = bound
        line[f"decode_bound_by_{tag}"] = by
        line[f"decode_share_of_bound_{tag}"] = bound / decode_ms
    line["decode_bytes_read"], line["decode_bytes_active"] = read_bytes, active_bytes
    del eng, params, leaves, batch
    gc.collect()
    torch.cuda.empty_cache()
    return line


def families_phase(torch, dev, seed: int) -> list:
    """``family_phase`` for each of FAMILY_ARCHS in turn, one model on the
    card at a time; every line is printed before its holds are checked."""
    lines = []
    for name in FAMILY_ARCHS:
        t0 = time.perf_counter()
        line = family_phase(torch, dev, name, seed)
        line["seconds"] = time.perf_counter() - t0
        emit(line)
        lines.append(line)
        assert line["repeat_generate_equal"], f"{name}: two generate calls disagree"
        assert line["logits_finite"], f"{name}: a logit is not finite"
        if "teacher_forcing_ok" in line:
            assert line["teacher_forcing_ok"], (
                f"{name}: prefill + decode off the parallel forward by "
                f"{line['teacher_forcing_max_abs_err']}")
        if "moe" in line:
            moe = line["moe"]
            assert moe["drops_decode"] == 0, f"{name}: the decode dispatch dropped {moe}"
            assert moe["loop_ok"], f"{name}: MoE off the per-token loop by {moe}"
        if "mla" in line:
            assert line["mla"]["ok"], f"{name}: absorbed MLA decode off {line['mla']}"
    return lines


def _flops_6nt(model, params, rows: int, seq: int) -> tuple[float, int]:
    """(6 N T of a training step, the params of the products a decoder
    token passes): each stack's params (a MoE layer's routed experts at
    top_k of n_experts) times the tokens that pass it (an encoder's frames,
    else the model's positions); the head and norms at the text positions
    (``LMModel.loss`` takes no logits at a VLM's patch positions); an
    untied embedding table not at all (a lookup)."""
    from repro_torch.train._tree import leaves

    cfg = model.cfg
    rest = reached = sum(t.numel() for t in leaves(params)) - (
        0 if cfg.tie_embeddings else params["embed"].numel())
    work = 0.0
    for si, sd in enumerate(model.stacks):
        tree = params[f"stack{si}"]
        whole = n = sum(t.numel() for t in leaves(tree))
        for j, (kind, _) in enumerate(sd.spec):
            if kind == "moe":
                experts = sum(tree[f"sub{j}"][k].numel() for k in ("w_gate", "w_up", "w_down"))
                n -= experts * (cfg.n_experts - cfg.top_k) // cfg.n_experts
        rest -= whole
        reached -= whole if sd.role == "encoder" else whole - n
        work += n * rows * (cfg.enc_seq if sd.role == "encoder" else seq)
    text = seq - (cfg.n_patches if cfg.vlm else 0)
    return 6.0 * (work + rest * rows * text), reached


def _two_layers(cfg):
    """The 2-layer cut of the remat hold: whisper 2 encoder and 2 decoder
    layers, deepseek-moe-16b its dense layer and one MoE layer, a stack of
    dense layers only 2 of them, the rest 2 layers."""
    import dataclasses

    if cfg.encdec:
        return dataclasses.replace(cfg, n_layers=2, n_enc_layers=2)
    if cfg.n_dense_layers and cfg.n_layers == cfg.n_dense_layers:
        return dataclasses.replace(cfg, n_layers=2, n_dense_layers=2)
    return dataclasses.replace(cfg, n_layers=2)


def train_family_phase(torch, dev, name: str, seed: int, counters: dict) -> dict:
    """One family trained at full width (f32, params drawn on the card from
    ``--seed``): AdamW at TRAIN_LR with remat, TRAIN_STEPS steps on one
    ``TokenStream(cfg, seq, TRAIN_BATCH, seed)`` batch (its patch
    embeddings and frames too), depth cut to TRAIN_FAMILY_LAYERS.
    Recorded, for ``_hold_training`` and the remat hold: the chunked loss and the full logits' cross entropy, the losses
    and grad norms, the launches; the remat hold at the 2-layer cut
    (``_two_layers``, fresh params, ``_remat_on_off``); the cut
    (``reduced``), params and the params a token reaches, the step's
    walls (``_timed_steps``), tokens/s, the share of the f32 peak at
    6 N T, the optimizer beside its byte bound, peak memory, the profiled
    step; a MoE's drops at the train capacity, layer by layer."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenStream, to_device
    from repro_torch.models.lm import build_model
    from repro_torch.models.moe import moe_ffn
    from repro_torch.train import trainer
    from repro_torch.train._tree import leaves
    from repro_torch.train.optimizer import OptConfig, opt_init

    def state_bytes(c):
        return TRAIN_BYTES_PER_PARAM * _n_params(c, build_model)

    full = get_config(name)
    cfg, reduced = full, {}
    free, total = torch.cuda.mem_get_info()
    if name in TRAIN_FAMILY_LAYERS:
        cfg = dataclasses.replace(full, **TRAIN_FAMILY_LAYERS[name])
        reduced = {k: [getattr(full, k), v] for k, v in TRAIN_FAMILY_LAYERS[name].items()}
        why = (f"device memory: {state_bytes(full) / 1e9:.0f} GB of f32 training state "
               f"({TRAIN_BYTES_PER_PARAM} B a param) at the published depth, "
               f"{state_bytes(cfg) / 1e9:.1f} GB at this cut, a card of {total / 1e9:.1f} GB")
        if cfg.n_dense_layers == cfg.n_layers < full.n_layers:
            dense = state_bytes(dataclasses.replace(full, n_layers=full.n_dense_layers))
            layer = state_bytes(dataclasses.replace(
                full, n_layers=full.n_dense_layers + 1)) - dense
            why += (f"; dense MLA layers only: one MoE layer alone is "
                    f"{layer / TRAIN_BYTES_PER_PARAM / 1e9:.2f} B params, "
                    f"{layer / 1e9:.0f} GB of f32 training state; all "
                    f"{full.n_dense_layers} dense layers, {dense / 1e9:.1f} GB, and the "
                    f"step's activations outgrow what the earlier phases leave free")
        reduced["why"] = why
    seq = TRAIN_FAMILY_SEQ.get(name, TRAIN_SEQ) + (cfg.n_patches if cfg.vlm else 0)
    model = build_model(cfg)
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(seed), device=dev)
    n_params = sum(t.numel() for t in leaves(params))
    batch = to_device(dev)(TokenStream(cfg, seq, TRAIN_BATCH, seed).batch_at(0))
    tokens = TRAIN_BATCH * seq
    launched = {k: c.launches for k, c in counters.items()}

    (chunked, full_ce), moe_calls = moe_record(
        torch, lambda: _ce_against_full(torch, model, params, batch))
    drops = []
    with torch.no_grad():
        for p, x in moe_calls:
            idx, _, capacity = moe_ffn.route(p, x, cfg)
            _, _, keep = moe_ffn.dispatch(idx, capacity, cfg.n_experts)
            drops.append((int((~keep).sum()), keep.numel(), capacity))
    del moe_calls

    t1 = time.perf_counter()
    oc = OptConfig(lr=TRAIN_LR, warmup_steps=0)
    state = opt_init(params, oc)
    step = trainer.make_train_step(model, trainer.TrainConfig(opt=oc))
    torch.cuda.reset_peak_memory_stats()
    steps = _timed_steps(torch, step, params, state, batch)
    peak = torch.cuda.max_memory_allocated()
    flops, reached = _flops_6nt(model, params, TRAIN_BATCH, seq)
    del state, step, params
    gc.collect()
    torch.cuda.empty_cache()

    # remat on against off at the 2-layer cut, fresh params
    t2 = time.perf_counter()
    cfg2 = _two_layers(cfg)
    model2 = build_model(cfg2)
    remat = _remat_on_off(torch, model2, model2.init(
        torch.Generator(device=dev).manual_seed(seed), device=dev), batch)
    launched = {k: c.launches - launched[k] for k, c in counters.items()}
    split = {"init_and_loss_check_s": t1 - t0, "steps_s": t2 - t1,
             "remat_hold_s": time.perf_counter() - t2}
    del batch
    gc.collect()
    torch.cuda.empty_cache()

    med = steps["step_ms_median"]
    opt_bound = OPT_BYTES_PER_PARAM * n_params / PEAK_BYTES_PER_S * 1e3
    line = {"phase": "train_families", "arch": cfg.name, "family": cfg.family, "dtype": "f32",
            "layers": cfg.n_layers, "layers_published": full.n_layers, "reduced": reduced,
            "d_model": cfg.d_model, "vocab": cfg.vocab, "params": n_params,
            "params_per_token": reached, "training_state_gb": state_bytes(cfg) / 1e9,
            "training_state_gb_published": state_bytes(full) / 1e9,
            "batch": TRAIN_BATCH, "seq": seq, "tokens": tokens,
            "optimizer": "adamw", "lr": TRAIN_LR,
            "remat": "dots_with_no_batch_dims_saveable",
            "chunked_loss": chunked, "full_logits_loss": full_ce,
            "chunked_vs_full_rel": abs(chunked - full_ce) / abs(full_ce),
            **steps, "opt_bound_ms": opt_bound,
            "opt_share_of_bound": opt_bound / steps["opt_ms_median"],
            "tokens_per_s": tokens / (med / 1e3), "flops_6NT": flops,
            "f32_peak_share_6NT": flops / (med / 1e3) / PEAK_F32_FLOPS,
            "peak_device_memory_gb": peak / 1e9, "device_memory_before_gb": before / 1e9,
            "device_free_gb_before": free / 1e9,
            "remat_2_layers": {"layers": cfg2.n_layers, **remat},
            "kernel_launches": launched, "seconds_split": split}
    if cfg.n_dense_layers:
        line["dense_layers"] = cfg.n_dense_layers
    if cfg.vlm:
        line["patches"], line["text_seq"] = cfg.n_patches, seq - cfg.n_patches
    if cfg.encdec:
        line["encoder_frames"], line["encoder_layers"] = cfg.enc_seq, cfg.n_enc_layers
    if drops:
        line["moe"] = {"experts": cfg.n_experts, "top_k": cfg.top_k, "shared": cfg.n_shared,
                       "capacity": drops[0][2], "drops": sum(d for d, _, _ in drops),
                       "pairs": sum(n for _, n, _ in drops),
                       "drops_by_layer": [d for d, _, _ in drops]}
    return line


def train_families_phase(torch, dev, seed: int, counters: dict) -> list:
    """``train_family_phase`` for each of TRAIN_FAMILY_ARCHS in turn, one
    model on the card at a time; every line is printed before its holds
    are checked: ``_hold_training`` and remat on against off at the 2-layer
    cut.  The done line names TRAIN_FAMILY_UNTRAINED and why: the params
    of one period of its hybrid stack at TRAIN_BYTES_PER_PARAM."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_model

    t_phase = time.perf_counter()
    lines = []
    for name in TRAIN_FAMILY_ARCHS:
        t0 = time.perf_counter()
        line = train_family_phase(torch, dev, name, seed, counters)
        line["seconds"] = time.perf_counter() - t0
        emit(line)
        lines.append(line)
        _hold_training(line, line["kernel_launches"])
        assert line["remat_2_layers"]["ok"], (
            f"{name}: remat on and off differ: {line['remat_2_layers']}")
    jamba = get_config(TRAIN_FAMILY_UNTRAINED)
    period = dataclasses.replace(jamba, n_layers=jamba.hybrid_period)
    n = _n_params(period, build_model)
    emit({"phase": "train_families_done", "models": [f["arch"] for f in lines],
          "seconds_by_model": {f["arch"]: f["seconds"] for f in lines},
          "not_trained": {jamba.name: (
              f"one period of {jamba.hybrid_period} layers (the least cut that keeps the "
              f"hybrid layout, {jamba.n_layers // jamba.hybrid_period} periods published) holds "
              f"{n / 1e9:.2f} B params, {n * TRAIN_BYTES_PER_PARAM / 1e9:.0f} GB of f32 "
              f"training state at {TRAIN_BYTES_PER_PARAM} B a param: no card holds it")},
          "seconds": time.perf_counter() - t_phase})
    return lines


# ---------------------------------------------------------- the LM's mesh
def _greedy(torch, model, params, tokens, cache_len: int, steps: int, reshard=None):
    """Prefill ``tokens`` and ``steps`` greedy decode steps (the logits
    gathered whole where they are DTensors; ``reshard`` puts the prefill's
    caches on their shardings) -> (tokens (B, 1 + steps), prefill ms,
    decode ms a step)."""
    def whole(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    with torch.no_grad():
        (logits, caches), prefill_ms = synced(
            torch, lambda: model.prefill(params, {"tokens": tokens}, cache_len))
        if reshard is not None:
            caches = reshard(caches)
        out, step_ms = [whole(logits).argmax(-1)], []
        for t in range(steps):
            (logits, caches), ms = synced(torch, lambda: model.decode_step(
                params, out[-1][:, None], caches, tokens.shape[1] + t))
            out.append(whole(logits).argmax(-1))
            step_ms.append(ms)
    return torch.stack(out, 1).cpu().numpy(), prefill_ms, step_ms


def _mesh_train(torch, dev, mesh, cfg2, seed: int, seq: int = TRAIN_SEQ):
    """The FSDP x TP train step of ``cfg2`` (f32, AdamW at TRAIN_LR,
    remat; DTensor params, moments and batch of ``seq`` positions, the
    hints active) against the plain step from the same params -> (the
    record, the plain step's params, their shardings)."""
    from repro_torch.data.pipeline import TokenStream, to_device
    from repro_torch.dist import hints
    from repro_torch.dist.sharding import (
        NamedSharding, PartitionSpec, batch_shardings, device_put, param_shardings)
    from repro_torch.models.lm import build_model
    from repro_torch.train import trainer
    from repro_torch.train._tree import leaves
    from repro_torch.train.optimizer import OptConfig, global_norm, opt_init

    model2 = build_model(cfg2)
    oc = OptConfig(lr=TRAIN_LR, warmup_steps=0)
    step = trainer.make_train_step(model2, trainer.TrainConfig(opt=oc))
    batch = to_device(dev)(TokenStream(cfg2, seq, TRAIN_BATCH, seed).batch_at(0))
    plain = model2.init(torch.Generator(device=dev).manual_seed(seed), device=dev)
    ps = param_shardings(plain, mesh, cfg2)
    os_ = {"mu": ps, "nu": ps, "step": NamedSharding(mesh, PartitionSpec())}
    sb = device_put(batch, batch_shardings(batch, mesh))
    # one step of each on copies first: the walls below are warm
    with hints.activation_sharding(mesh):
        step(device_put(plain, ps), device_put(opt_init(plain, oc), os_), sb)
    step(_clone(torch, plain), opt_init(plain, oc), batch)
    sp, so = device_put(plain, ps), device_put(opt_init(plain, oc), os_)
    with hints.activation_sharding(mesh):
        (sp, so, ms_), sharded_ms = synced(torch, lambda: step(sp, so, sb))
    on_layout = all(tuple(x.placements) == s.placements
                    for tree in (sp, so["mu"], so["nu"])
                    for x, s in zip(leaves(tree), leaves(ps)))
    full = [x.full_tensor() for x in leaves(sp)]
    del so  # the sharded moments: room for the plain step's own
    (plain, _, mp), plain_ms = synced(torch, lambda: step(plain, opt_init(plain, oc), batch))
    ls, lp = float(ms_["loss"].full_tensor()), float(mp["loss"])
    diff = float(global_norm([a - b for a, b in zip(full, leaves(plain))]))
    train = {"layers": cfg2.n_layers, "batch": TRAIN_BATCH, "seq": seq, "lr": TRAIN_LR,
             "loss_sharded": ls, "loss_plain": lp, "loss_rel": abs(ls - lp) / abs(lp),
             "grad_norm_sharded": float(ms_["grad_norm"].full_tensor()),
             "grad_norm_plain": float(mp["grad_norm"]),
             "params_diff_global_norm": diff,
             "bitwise": ls == lp and all(torch.equal(a, b)
                                         for a, b in zip(full, leaves(plain))),
             "on_param_shardings": on_layout,
             "step_ms_sharded": sharded_ms, "step_ms_plain": plain_ms}
    return train, plain, ps


def _mesh_serve(torch, dev, mesh, cfg, seed: int, dtype, profile: bool = False) -> dict:
    """``cfg`` drawn at ``dtype`` serves LM_REQUESTS prompts of LM_PROMPT
    tokens for LM_NEW greedy steps, plain and then in the weight-stationary
    layout (``strip_axes(param_shardings(...), data_axes(mesh))``, the
    prefill's caches on ``cache_shardings``) -> the record: the tokens'
    equality, prefill and decode ms of both, with ``profile`` a sharded
    decode step's device profile.  The plain params are freed once their
    DTensor copies exist."""
    from repro_torch.dist import hints
    from repro_torch.dist.sharding import (
        batch_shardings, cache_shardings, data_axes, device_put, param_shardings, strip_axes)
    from repro_torch.models.lm import build_model
    from repro_torch.train._tree import leaves

    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed), dtype, device=dev)
    cache_len = LM_PROMPT * 3 + LM_NEW + 8
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab, (LM_REQUESTS, LM_PROMPT)).astype(np.int32)).to(dev)
    want, plain_prefill, plain_steps = _greedy(torch, model, params, tokens, cache_len,
                                               LM_NEW)
    stationary = strip_axes(param_shardings(params, mesh, cfg), data_axes(mesh))
    wp = device_put(params, stationary)
    del params
    torch.cuda.empty_cache()
    with hints.activation_sharding(mesh):
        st = device_put({"tokens": tokens}, batch_shardings({"tokens": tokens}, mesh))
        got, prefill_ms, steps = _greedy(
            torch, model, wp, st["tokens"], cache_len, LM_NEW,
            reshard=lambda c: device_put(c, cache_shardings(c, mesh, cfg)))
        prof = None
        if profile:
            # where a sharded decode step's time goes: one step (prefill and
            # the first token again) under torch.profiler
            with torch.no_grad():
                logits, caches = model.prefill(wp, st, cache_len)
                caches = device_put(caches, cache_shardings(caches, mesh, cfg))
                first = logits.full_tensor().argmax(-1)[:, None]
                prof = device_profile(torch, lambda: model.decode_step(
                    wp, first, caches, LM_PROMPT))
                del logits, caches
    serve = {"layers": cfg.n_layers, "dtype": str(dtype).split(".")[-1],
             "requests": LM_REQUESTS, "prompt_tokens": LM_PROMPT,
             "new_tokens": LM_NEW, "cache_len": cache_len,
             "param_bytes": sum(t.numel() * t.element_size() for t in leaves(wp)),
             "tokens_equal": bool(np.array_equal(got, want)),
             "prefill_ms": prefill_ms, "prefill_ms_plain": plain_prefill,
             "decode_ms_per_token_median": statistics.median(steps),
             "decode_ms_per_token_median_plain": statistics.median(plain_steps),
             "first_row": got[0].tolist()}
    if profile:
        serve["decode_profile"] = prof
    del wp, st, model
    gc.collect()
    torch.cuda.empty_cache()
    return serve


def _mesh_moe(torch, dev, mesh, seed: int) -> dict:
    """MESH_MOE_ARCH at full width on ``mesh``: its FSDP x TP train step at
    2 layers (f32) against the plain step, and its weight-stationary decode
    at full depth in MESH_MOE_DTYPE against the plain decode, each MoE
    layer through the expert-parallel path (``hints.per_experts``, recorded:
    the mesh dims that split the experts, each rank's experts and the
    first of them)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.dist import hints

    cfg = get_config(MESH_MOE_ARCH)
    calls = []

    def record(real, fn, p, x, experts, **kw):
        dims = list(hints.expert_dims(p[experts[0]]))

        def inner(pl, xl, first, a2a):
            calls.append((dims, int(pl[experts[0]].shape[0]), first))
            return fn(pl, xl, first, a2a)
        return real(inner, p, x, experts, **kw)

    with _Recorded(hints, "per_experts", record):
        train, plain, _ = _mesh_train(torch, dev, mesh, dataclasses.replace(cfg, n_layers=2),
                                      seed)
        del plain
        gc.collect()
        torch.cuda.empty_cache()
        n_train = len(calls)
        serve = _mesh_serve(torch, dev, mesh, cfg, seed, getattr(torch, MESH_MOE_DTYPE))
    ep = {"train_calls": n_train, "serve_calls": len(calls) - n_train,
          "ep_dims": sorted({d for dims, _, _ in calls for d in dims}),
          "experts_local": sorted({n for _, n, _ in calls}),
          "first": sorted({f for _, _, f in calls})}
    return {"arch": cfg.name, "experts": cfg.n_experts, "train": train, "serve": serve,
            "expert_parallel": ep}


def _mesh_tp(torch, dev, mesh, seed: int) -> list:
    """MESH_TP_ARCHS at full width, cut to MESH_TP_LAYERS: each one's FSDP x
    TP step (f32) against the plain step through the head-split paths, at
    TRAIN_FAMILY_SEQ's positions where it names the model (mamba2's four
    SSD chunks, so that the carried state and its backward run), then its
    weight-stationary decode (``_mesh_serve``, f32) against the plain
    decode, recorded: the Mamba2 mixer's blocks of heads in the step and in
    the decode (``hints.per_heads``; on the mesh, not its ``per_rows``
    fallback; the decode's ``in_proj`` as the rank holds it), MLA's head
    products laid out by ``hints.column_operands`` (a weight with a head
    axis), the heads each rank attends over in the step (``hints.per_head``)
    and in the absorbed decode (``mla._absorbed``'s query, split by heads
    over "model")."""
    import dataclasses

    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.dist import hints
    from repro_torch.models.attention import mla

    out = []
    for arch in MESH_TP_ARCHS:
        cfg = dataclasses.replace(get_config(arch), **MESH_TP_LAYERS[arch])
        seen = {"blocks": set(), "operands": 0, "attn_heads": set(), "decode_blocks": set(),
                "per_rows": 0, "latent_heads": set()}

        def per_heads(real, fn, p, x, n_heads, *a, **kw):
            decode = "own" in kw

            def inner(pl, xl, heads, *aa, **kk):
                if decode:
                    seen["decode_blocks"].add((heads.lo, heads.hi, heads.n, heads.axis,
                                               int(pl["in_proj"].shape[-1])))
                else:
                    seen["blocks"].add((heads.lo, heads.hi, heads.n, heads.axis))
                return fn(pl, xl, heads, *aa, **kk)
            return real(inner, p, x, n_heads, *a, **kw)

        def operands(real, x, w):
            seen["operands"] += w.ndim == 3
            return real(x, w)

        def per_head(real, fn, q, *a, **kw):
            seen["attn_heads"].add(int(q.to_local().shape[2]))
            return real(fn, q, *a, **kw)

        def per_rows(real, *a, **kw):
            seen["per_rows"] += 1
            return real(*a, **kw)

        def absorbed(real, q_nope, *a, **kw):
            if isinstance(q_nope, DTensor):  # the sharded decode, not the plain one
                model = q_nope.device_mesh.mesh_dim_names.index("model")
                seen["latent_heads"].add((int(q_nope.to_local().shape[2]),
                                          q_nope.placements[model].is_shard(2)))
            return real(q_nope, *a, **kw)

        with _Recorded(hints, "per_heads", per_heads), \
                _Recorded(hints, "column_operands", operands), \
                _Recorded(hints, "per_head", per_head):
            train, plain, _ = _mesh_train(torch, dev, mesh, cfg, seed,
                                          TRAIN_FAMILY_SEQ.get(arch, TRAIN_SEQ))
        del plain
        gc.collect()
        torch.cuda.empty_cache()
        # a cut of dense layers alone leaves an MoE stack of no units, which
        # neither package can prefill: the decode runs the same layers as
        # one dense stack
        scfg = (dataclasses.replace(cfg, moe=False, n_dense_layers=0, d_ff=cfg.d_ff_dense)
                if cfg.moe and cfg.n_layers == cfg.n_dense_layers else cfg)
        with _Recorded(hints, "per_heads", per_heads), _Recorded(hints, "per_rows", per_rows), \
                _Recorded(mla, "_absorbed", absorbed):
            serve = _mesh_serve(torch, dev, mesh, scfg, seed, torch.float32)
        heads = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim if cfg.ssm else cfg.n_heads
        out.append({"arch": cfg.name, "heads": heads, "train": train, "serve": serve,
                    "ssd_chunks": train["seq"] // cfg.ssm_chunk if cfg.ssm else None,
                    "in_proj_cols": (2 * cfg.ssm_expand * cfg.d_model
                                     + 2 * cfg.ssm_groups * cfg.ssm_state + heads
                                     if cfg.ssm else None),
                    "mixer_blocks": [list(b) for b in sorted(seen["blocks"])],
                    "decode_blocks": [list(b) for b in sorted(seen["decode_blocks"])],
                    "decode_per_rows_calls": seen["per_rows"],
                    "heads_operands_calls": seen["operands"],
                    "attn_local_heads": sorted(seen["attn_heads"]),
                    "decode_local_heads": [list(h) for h in sorted(seen["latent_heads"])]})
    return out


def mesh_lm_phase(torch, dev, seed: int, lm_decode_ms: float, counters: dict) -> dict:
    """Phase 12 (``mesh_lm``): the LM side's mesh layer on a (1, 1)
    ("data", "model") mesh in an NCCL world of one (its own, destroyed at
    the end), llama3.2-3b at full width, f32.  Held: the FSDP x TP train
    step at 2 layers (B = TRAIN_BATCH, S = TRAIN_SEQ, AdamW at TRAIN_LR,
    remat) on DTensor params, optimizer state and batch
    (``param_shardings``, ``batch_shardings``, the hints active) against
    the plain step from the same params: losses at rtol CE_RTOL, the
    params' difference's ``global_norm`` < ACCUM_PARAM_BAR, every param
    and moment on its sharding; at full depth the weight-stationary layout
    (``strip_axes(param_shardings(...), data_axes(mesh))``, the prefill's
    caches on ``cache_shardings``): prefill + LM_NEW greedy decode steps
    give the plain path's tokens; ``pipeline_apply`` on a ("stage",) mesh
    of one, one full-width unit in train mode over 4 microbatches, equals
    the unit applied to each (rtol 1e-6) with 4 ppermutes and 1 psum;
    ``restore(shardings=)`` of the trained 2-layer params equals the saved
    tensors bit for bit on the card.  The expert-parallel MoE
    (``_mesh_moe``): MESH_MOE_ARCH at full width, its 2-layer step held as
    llama's, its weight-stationary decode at full depth in MESH_MOE_DTYPE
    giving the plain decode's tokens, every MoE layer through
    ``hints.per_experts`` with its experts split over "model".  The
    head-split paths (``_mesh_tp``): mamba2-370m's (at 1024 positions, four
    SSD chunks) and deepseek-v3's 2-layer steps held as llama's, the Mamba2
    mixer through ``hints.per_heads`` on the mesh (one block of every
    head), MLA's head products through ``hints.column_operands``; their
    weight-stationary decodes at the same cut (f32) giving the plain
    decodes' tokens, the Mamba2 decode through ``per_heads`` on the mesh
    (never ``per_rows``), MLA's query split by heads.  No
    kernel of the port launched.  Recorded: bit-for-bit equality of the sharded
    and plain steps, both step walls, decode ms a token beside the plain
    path's (and llama's beside phase lm's), a sharded llama decode step's
    device profile."""
    import dataclasses
    import tempfile

    import torch.distributed as tdist

    from repro_torch.configs import get_config
    from repro_torch.dist import make_mesh
    from repro_torch.dist.pipeline import pipeline_apply
    from repro_torch.models.lm import apply_unit, build_model
    from repro_torch.obs.meters import collective_counts
    from repro_torch.train import checkpoint
    from repro_torch.train._tree import leaves, tree_map

    launched = {k: c.launches for k, c in counters.items()}
    t0 = time.perf_counter()
    tdist.init_process_group("nccl", store=tdist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        world = {"world": 1, "backend": tdist.get_backend(), "mesh": [1, 1],
                 "mesh_device": mesh.device_type, "setup_s": time.perf_counter() - t0}
        cfg = get_config(LM_ARCH)

        # ---- the FSDP x TP step at 2 layers against the plain step
        train, plain, ps = _mesh_train(torch, dev, mesh, dataclasses.replace(cfg, n_layers=2),
                                       seed)

        # ---- restore(shardings=) of the trained 2-layer params, on the card
        with tempfile.TemporaryDirectory() as tmp:
            _, save_ms = synced(torch, lambda: checkpoint.save(tmp, 1, plain))
            (_, got), restore_ms = synced(torch, lambda: checkpoint.restore(
                tmp, plain, shardings=ps))
        restore = {"leaves": len(leaves(plain)),
                   "bytes": sum(t.numel() * t.element_size() for t in leaves(plain)),
                   "save_ms": save_ms, "restore_ms": restore_ms,
                   "device": str(leaves(got)[0].to_local().device),
                   "on_shardings": all(tuple(x.placements) == s.placements
                                       for x, s in zip(leaves(got), leaves(ps))),
                   "bitwise": all(torch.equal(x.full_tensor(), t)
                                  for x, t in zip(leaves(got), leaves(plain)))}
        del got, plain, ps
        gc.collect()
        torch.cuda.empty_cache()

        # ---- the pipeline of one stage: one full-width unit, 4 microbatches
        model1 = build_model(dataclasses.replace(cfg, n_layers=1))
        unit = model1.init(torch.Generator(device=dev).manual_seed(seed), device=dev)["stack0"]
        spec = model1.stacks[0].spec
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        xs = torch.randn((4, 2, TRAIN_SEQ, cfg.d_model), generator=gen, device=dev)
        pos = torch.arange(TRAIN_SEQ, device=dev)

        def stage_fn(w, xb):
            return apply_unit(w, xb, spec, cfg, "train", pos)[0]

        stage = make_mesh((1,), ("stage",))
        res = {}
        with torch.no_grad():
            counts = collective_counts(lambda: res.update(
                y=pipeline_apply(stage, stage_fn, unit, xs)))
            direct = torch.stack([stage_fn(tree_map(lambda a: a[0], unit), xb) for xb in xs])
        pipe = {"stages": 1, "microbatches": 4, "microbatch": [2, TRAIN_SEQ, cfg.d_model],
                "counts": counts,
                "max_abs_err": float((res["y"] - direct).abs().max()),
                "bitwise": bool(torch.equal(res["y"], direct)),
                "ok": bool(torch.allclose(res["y"], direct, rtol=1e-6, atol=1e-6))}
        del unit, xs, res, direct, model1
        torch.cuda.empty_cache()

        # ---- weight-stationary serving at full depth
        serve = _mesh_serve(torch, dev, mesh, cfg, seed, torch.float32, profile=True)
        serve["decode_ms_per_token_lm_phase"] = lm_decode_ms

        # ---- the expert-parallel MoE: deepseek-moe-16b at full width
        moe = _mesh_moe(torch, dev, mesh, seed)

        # ---- the head-split paths: mamba2's mixer and deepseek-v3's MLA
        tp = _mesh_tp(torch, dev, mesh, seed)
    finally:
        tdist.destroy_process_group()
    launched = {k: c.launches - launched[k] for k, c in counters.items()}
    line = {"phase": "mesh_lm", "arch": cfg.name, "dtype": "f32", **world, "train": train,
            "restore": restore, "pipeline": pipe, "serve": serve, "moe": moe,
            "tensor_parallel": tp, "kernel_launches": launched}
    emit(line)
    assert train["loss_rel"] <= CE_RTOL, train
    assert train["params_diff_global_norm"] < ACCUM_PARAM_BAR, train
    assert train["on_param_shardings"], "a param or moment left its sharding"
    assert restore["bitwise"] and restore["on_shardings"], restore
    assert pipe["ok"] and pipe["counts"] == {"ppermute": 4, "psum": 1}, pipe
    assert serve["tokens_equal"], "the weight-stationary decode's tokens differ"
    mt, ms, ep = moe["train"], moe["serve"], moe["expert_parallel"]
    assert mt["loss_rel"] <= CE_RTOL, mt
    assert mt["params_diff_global_norm"] < ACCUM_PARAM_BAR, mt
    assert mt["on_param_shardings"], "an MoE param or moment left its sharding"
    assert ms["tokens_equal"], "the MoE's weight-stationary decode's tokens differ"
    assert ep["train_calls"] > 0 and ep["serve_calls"] > 0 and ep["ep_dims"] == [1], ep
    assert ep["experts_local"] == [moe["experts"]] and ep["first"] == [0], ep
    for rec in tp:
        t = rec["train"]
        assert t["loss_rel"] <= CE_RTOL, (rec["arch"], t)
        assert t["params_diff_global_norm"] < ACCUM_PARAM_BAR, (rec["arch"], t)
        assert t["on_param_shardings"], f"a {rec['arch']} param or moment left its sharding"
    mamba, v3 = tp
    for rec in tp:
        assert rec["serve"]["tokens_equal"], (rec["arch"], "the decode's tokens differ")
    # a (1, 1) mesh: one block of every head, on the mesh (its sum and gather),
    # in the step and in the decode (in_proj's one block of columns)
    assert mamba["mixer_blocks"] == [[0, mamba["heads"], mamba["heads"], "model"]], mamba
    assert mamba["decode_blocks"] == [[0, mamba["heads"], mamba["heads"], "model",
                                       mamba["in_proj_cols"]]], mamba
    assert mamba["decode_per_rows_calls"] == 0, "the Mamba2 decode took its per_rows fallback"
    assert mamba["ssd_chunks"] >= 4, "the mesh step ran too few SSD chunks to carry a state"
    assert v3["heads_operands_calls"] > 0 and v3["attn_local_heads"] == [v3["heads"]], v3
    assert v3["decode_local_heads"] == [[v3["heads"], True]], v3
    assert not any(launched.values()), f"mesh_lm launched a kernel of the port: {launched}"
    return line


# ------------------------------------------------------------------ dry-run
def _dryrun_clis(out_dir: Path) -> list:
    """Start the dry-run CLIs in subprocesses (each its own fake group:
    one process has one world) -> [(cell, process, record path, log)]."""
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    runs = [(f"{a} x {sh}", ["repro_torch.launch.dryrun", "--arch", a, "--shape", sh],
             out_dir / f"{a}__{sh}__single_pod.json") for a, sh in DRYRUN_CELLS]
    runs += [(f"pdx {v}", ["repro_torch.launch.dryrun_pdx", "--variant", v],
              out_dir / f"pdx-search-{v}__batch128__single_pod.json") for v in DRYRUN_PDX]
    procs = []
    for cell, args, rec in runs:
        rec.unlink(missing_ok=True)
        log = open(out_dir / (rec.stem + ".log"), "w")
        procs.append((cell, subprocess.Popen(
            [sys.executable, "-m", *args, "--mesh", "single_pod", "--out", str(out_dir)],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT), rec, log))
    return procs


def _dryrun_cli_lines(procs: list, t0: float) -> list:
    """Wait for the CLIs -> one line per cell; a CLI that has not ended by
    DRYRUN_CLI_TIMEOUT_S after ``t0`` is killed and fails the phase."""
    lines = []
    for cell, proc, rec, log in procs:
        try:
            rc = proc.wait(timeout=max(1.0, DRYRUN_CLI_TIMEOUT_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = "timeout"
        log.close()
        r = json.loads(rec.read_text()) if rec.exists() else {}
        lines.append({"cell": cell, "rc": rc, "status": r.get("status"),
                      "meta_run_s": r.get("lower_s"), "jaxpr_cost": r.get("jaxpr_cost"),
                      "collectives": r.get("collectives"), "memory": r.get("memory"),
                      "error": r.get("error")})
    return lines


def _estimate_hold(torch, name: str, fn, meta_args, real_args) -> dict:
    """``step_cost`` and the live-storage estimate of ``fn`` on meta
    tensors, then ``fn`` on the card's tensors: the step's
    ``max_memory_allocated`` above what was allocated before it (the
    arguments), after one warm-up call."""
    from repro_torch.launch.analysis import memory_trace, step_cost

    cost = step_cost(fn, *meta_args)
    _, _, mem = memory_trace(fn, *meta_args)
    est = mem["peak_memory_in_bytes"] - mem["argument_size_in_bytes"]
    out = fn(*real_args)  # warm-up: the libraries' workspaces
    del out
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, ms = synced(torch, lambda: fn(*real_args))
    measured = torch.cuda.max_memory_allocated() - base
    del out
    bound, by = bound_ms(cost["bytes"], cost["dot_flops"], PEAK_BF16_FLOPS, cost["ew_flops"])
    return {"cell": name, "dot_flops": cost["dot_flops"], "ew_flops": cost["ew_flops"],
            "bytes": cost["bytes"], "estimate_temp_bytes": est,
            "estimate_argument_bytes": mem["argument_size_in_bytes"],
            "measured_temp_bytes": measured, "measured_argument_bytes": base,
            "temp_rel_err": abs(est - measured) / measured, "ms": ms,
            "bound_ms": bound, "bound_by": by}


def _dryrun_estimator(torch, dev, seed: int) -> tuple[list, dict]:
    """The estimator against the card: llama3.2-3b at full width, bf16."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_model

    cfg = get_config(LM_ARCH)
    model = build_model(cfg)
    bf16, f8 = torch.bfloat16, torch.float8_e4m3fn
    params = model.init(torch.Generator(device=dev).manual_seed(seed), dtype=bf16, device=dev)
    with torch.device("meta"):
        mparams = model._draw(torch.Generator(), bf16)
    rng = np.random.default_rng(seed)
    rows = []
    B, S = DRYRUN_PREFILL
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)), dtype=torch.int32)

    def prefill(p, b):
        return model.prefill(p, b, S)

    with torch.no_grad():
        rows.append(_estimate_hold(
            torch, f"prefill B={B} S={S}", prefill,
            (mparams, {"tokens": torch.empty((B, S), dtype=torch.int32, device="meta")}),
            (params, {"tokens": tok.to(dev)})))
        B, L = DRYRUN_DECODE
        first = torch.as_tensor(rng.integers(0, cfg.vocab, (B, 1)), dtype=torch.int32).to(dev)

        def decode(p, c, t):
            return model.decode_step(p, t, c, L - 1)

        for kv in (bf16, f8):
            caches = model.init_caches(B, L, bf16, kv_dtype=kv, device=dev)
            mcaches = model.init_caches(B, L, bf16, kv_dtype=kv, device="meta")
            rows.append({**_estimate_hold(
                torch, f"decode B={B} cache={L} kv={str(kv).split('.')[-1]}", decode,
                (mparams, mcaches, torch.empty((B, 1), dtype=torch.int32, device="meta")),
                (params, caches, first)), "cache_bytes": sum(
                    t.numel() * t.element_size() for c in caches for u in c.values()
                    for t in u.values())})
            del caches

        def greedy(kv):
            caches = model.init_caches(B, L, bf16, kv_dtype=kv, device=dev)
            tok, out = first, []
            for pos in range(DRYRUN_GREEDY_STEPS):
                logits, caches = model.decode_step(params, tok, caches, pos)
                tok = logits.argmax(-1)[:, None].to(torch.int32)
                out.append(tok)
            return torch.cat(out, 1)

        agree = float((greedy(bf16) == greedy(f8)).float().mean())
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return rows, {"steps": DRYRUN_GREEDY_STEPS, "batch": B, "agreement": agree}


def _dryrun_pdx_rank(torch, dev, seed: int) -> list:
    """``dryrun_pdx``'s per-rank body on one rank's real shard, its
    all-gathers over an NCCL world of one."""
    import torch.distributed as tdist

    from repro_torch.dist import make_mesh
    from repro_torch.launch import dryrun_pdx as dp

    # rank 0's partitions: 12,207 padded to a multiple of the 256 ranks
    P = -(-(dp.N_VECTORS // dp.CAPACITY) // 256)
    C, D, Qn = dp.CAPACITY, dp.DIM, dp.QUERIES
    rows = []
    tdist.init_process_group("nccl", store=tdist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        g = torch.Generator(device=dev).manual_seed(seed)
        Q = torch.randn((Qn, D), generator=g, device=dev)
        ids = torch.arange(P * C, dtype=torch.int32, device=dev).reshape(P, C)
        for variant in ("block_matmul", "block_matmul_bf16", "block_matmul_int8"):
            if "int8" in variant:
                data = torch.randint(-127, 128, (P, D, C), generator=g, device=dev,
                                     dtype=torch.int8)
            else:
                data = torch.randn((P, D, C), generator=g, device=dev)
                if "bf16" in variant:
                    data = data.to(torch.bfloat16)
            fn = dp.local_fn(variant, mesh)
            dists, got = fn(data, ids, Q)
            # every tile's distances, one stable selection over them all
            every = torch.cat([dp.tile_dists(t, Q, "bf16" in variant) for t in data], dim=1)
            d_sorted, order = torch.sort(every, dim=1, stable=True)
            want_d, want = d_sorted[:, :dp.K], ids.reshape(-1)[order[:, :dp.K]]
            del every, d_sorted, order
            ms = cuda_ms(torch, lambda: fn(data, ids, Q), reps=3, warmup=1)
            nbytes = sum(t.numel() * t.element_size() for t in (data, ids, Q))
            flops = 2.0 * Qn * D * P * C
            f32 = data.dtype == torch.float32  # else both operands are bf16
            bound, by = bound_ms(nbytes, flops, product_peak(f32, f32))
            rows.append({"variant": variant, "shard": [P, D, C], "dtype": str(data.dtype)[6:],
                         "shard_bytes": data.numel() * data.element_size(),
                         "ids_equal": bool(torch.equal(got, want)),
                         "dists_equal": bool(torch.equal(dists, want_d)),
                         "ms": ms, "gflop": flops / 1e9, "bound_ms": bound, "bound_by": by})
            del data
            torch.cuda.empty_cache()
    finally:
        tdist.destroy_process_group()
    return rows


def dryrun_phase(torch, dev, seed: int, smi: str, counters: dict) -> dict:
    """Phase 13 (``dryrun``): the dry-run's CLIs under the card's torch, the
    estimator against the card, and the paper's workload on one rank's
    shard (the module docstring's 13)."""
    t0 = time.perf_counter()
    launched = {k: c.launches for k, c in counters.items()}
    procs = _dryrun_clis(ROOT / "build" / "dryrun")
    try:
        est, greedy = _dryrun_estimator(torch, dev, seed)
        pdx = _dryrun_pdx_rank(torch, dev, seed)
    finally:
        cli = _dryrun_cli_lines(procs, t0)
    for row in cli:
        emit({"phase": "dryrun_cell", **row})
    launched = {k: c.launches - launched[k] for k, c in counters.items()}
    line = {"phase": "dryrun", "nvidia_smi": smi, "estimator": est,
            "f8_greedy": greedy, "pdx_rank": pdx, "kernel_launches": launched,
            "seconds": time.perf_counter() - t0}
    emit(line)
    for row in cli:
        assert row["rc"] == 0 and row["status"] == "ok", row
        assert row["jaxpr_cost"]["flops"] > 0 and row["memory"]["peak_memory_in_bytes"] > 0, row
        if row["cell"] == "pdx dim":
            assert row["collectives"]["count"]["all-reduce"] == DRYRUN_PDX_PSUMS, row
    for row in est:
        assert row["temp_rel_err"] <= DRYRUN_MEM_RTOL, row
    for row in pdx:
        assert row["ids_equal"] and row["dists_equal"], row
    assert not any(launched.values()), f"dryrun launched a kernel of the port: {launched}"
    return line


def rag_dist_error(torch, X, Q, ids, dists) -> float:
    """Largest |returned - direct f32 distance| / max(direct, 1e-2 (||q||^2 +
    ||x||^2)): held to 1e-3, that is relative where the distance is not near
    0, and within K2's rounding scale 1e-5 (||q||^2 + ||x||^2) where it is
    (a document queried as itself)."""
    ids_t = torch.from_numpy(ids.astype(np.int64)).to(X.device)
    vecs = X[ids_t]                                         # (B, k, D)
    diff = vecs - Q[:, None, :]
    true = torch.sum(diff * diff, dim=2)
    floor = 1e-2 * (torch.sum(Q * Q, dim=1)[:, None] + torch.sum(vecs * vecs, dim=2))
    got = torch.from_numpy(dists).to(X.device)
    return float(((got - true).abs() / torch.maximum(true, floor)).max())


def recall(found, true) -> float:
    found, true = found.reshape(len(true), -1), true
    hits = sum(len(set(f.tolist()) & set(t.tolist())) for f, t in zip(found, true))
    return hits / true.size


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=960)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "__init__.py").exists():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.engine import SearchSpec, VectorSearchEngine
    from repro_torch.core.layout import device_mirror, projection_mirror
    from repro_torch.core.plan import _inflate, _quant_err_norm
    from repro_torch.core.topk import topk_from_batch, topk_threshold
    from repro_torch.core.distance import pdx_distance
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.batched_matmul import batched_distance_quant_cuda
    from repro_torch.kernels.ops import pdx_prune_scan_multi_op
    from repro_torch.kernels.pdx_scan import (
        pdx_prune_scan_multi_cuda, pdx_prune_scan_multi_prefetch_cuda,
    )


    dev = torch.device("cuda")
    smi = nvidia_smi()

    # ---------------------------------------------------------- 1. device
    t0 = time.perf_counter()
    build = _build.build_all()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "build_s": build["seconds"], "built": build["built"],
          "ptxas": ptxas_summary(build["logs"]),
          "seconds": time.perf_counter() - t0})

    # ------------------------------------------ 1b. Table 4, PDX vs N-ary
    t0 = time.perf_counter()
    flush = Flush(torch, dev)
    t4_lines, paper_rows = table4(torch, ref, dev, args.seed, TABLE4_N, flush)
    for line in t4_lines:
        emit(line)
    emit({"phase": "table4_done", "seconds": time.perf_counter() - t0})

    # ------------------------------------------------------- 2. main path
    t0 = time.perf_counter()
    X, Q = make_dataset(args.n, args.dim, "clustered", n_queries=N_BATCH,
                        seed=args.seed)
    t_data = time.perf_counter() - t0
    t1 = time.perf_counter()
    # the rotation and k-means draw from their own seed: seeded like the
    # data, their first standard_normal draws would be the cluster centres'
    engine_seed = args.seed + 1
    eng = VectorSearchEngine.build(X, index="ivf", pruner="adsampling",
                                   capacity=1024, seed=engine_seed, device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t1
    Xd = torch.from_numpy(X).to(dev)
    Qd = torch.from_numpy(Q).to(dev)
    del X
    gt = ground_truth(torch, Xd, Qd, K)
    t2 = time.perf_counter()
    for dt in DTYPES:
        device_mirror(eng.store, dt)
    torch.cuda.synchronize()
    t_mirrors = time.perf_counter() - t2
    emit({"phase": "build", "n": args.n, "dim": args.dim,
          "data_seed": args.seed, "engine_seed": engine_seed,
          "nlist": eng.ivf.nlist, "partitions": eng.store.num_partitions,
          "capacity": eng.store.capacity, "data_s": t_data, "engine_s": t_build,
          "mirrors_s": t_mirrors,
          "device_mem_gb": torch.cuda.memory_allocated() / 1e9,
          "seconds": time.perf_counter() - t0})

    specs = {dt: SearchSpec(k=K, scan_dtype=dt) for dt in DTYPES}
    for dt in DTYPES:  # warm the allocator and the libraries, uncounted
        eng.search(Q[0], specs[dt])
        eng.search(Q, specs[dt])
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    pdx_prune_scan_multi_cuda.launches = 0
    batched_distance_quant_cuda.launches = 0
    per_dtype = {}
    for dt in DTYPES:
        k1_before = pdx_prune_scan_multi_cuda.launches
        k2_before = batched_distance_quant_cuda.launches
        ts = time.perf_counter()
        singles = [eng.search(Q[i], specs[dt]) for i in range(N_SINGLE)]
        t_scan = time.perf_counter() - ts
        tb = time.perf_counter()
        batch = eng.search(Q, specs[dt])
        t_batch = time.perf_counter() - tb
        k1 = pdx_prune_scan_multi_cuda.launches - k1_before
        k2 = batched_distance_quant_cuda.launches - k2_before
        for r in singles:
            assert r.plan.executor == "fused-scan", r.plan
        assert batch.plan.executor == "fused-batch", batch.plan
        assert k1 == N_SINGLE, f"{dt}: K1 launched {k1} times for {N_SINGLE} queries"
        assert k2 >= 1, f"{dt}: K2 never launched by fused-batch"
        s_ids = np.stack([r.ids for r in singles])
        s_d = np.stack([r.dists for r in singles])
        r_scan = recall(s_ids, gt[:N_SINGLE])
        r_batch = recall(batch.ids, gt)
        err_scan = dist_error(torch, Xd, Qd[:N_SINGLE], s_ids, s_d)
        err_batch = dist_error(torch, Xd, Qd, batch.ids, batch.dists)
        per_dtype[dt] = {"k1": k1, "k2": k2}
        emit({"phase": "main_path", "scan_dtype": dt,
              "fused_scan_recall_at_10": r_scan,
              "fused_batch_recall_at_10": r_batch,
              "fused_scan_dist_rel_err": err_scan,
              "fused_batch_dist_rel_err": err_batch,
              "fused_scan_ms_per_query": t_scan / N_SINGLE * 1e3,
              "fused_batch_ms_per_batch_of_64": t_batch * 1e3,
              "k1_launches": k1, "k2_launches": k2})
        # re-ranked (and f32-scanned) distances are those of the ids returned
        assert max(err_scan, err_batch) <= 1e-3, f"{dt}: returned distances off"
        if RECALL_FLOORS[dt] is not None:
            f_scan, f_batch = RECALL_FLOORS[dt]
            assert r_scan >= f_scan, f"{dt}: fused-scan recall {r_scan}"
            assert r_batch >= f_batch, f"{dt}: fused-batch recall {r_batch}"
    emit({"phase": "main_path_done",
          "k1_launches": pdx_prune_scan_multi_cuda.launches,
          "k2_launches": batched_distance_quant_cuda.launches,
          "seconds": time.perf_counter() - t0})
    emit(scan_walls(torch, eng, Q, specs))

    # --------------------------------------------------------- 3. cascade
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    pm = projection_mirror(eng.store, 32, "int8")  # ladder A's first stage
    torch.cuda.synchronize()
    t_proj = time.perf_counter() - t0
    counters = {"k1": pdx_prune_scan_multi_cuda,
                "k3": pdx_prune_scan_multi_prefetch_cuda,
                "k2": batched_distance_quant_cuda}
    # launches on the cascade path: K1 by first stage (a dtype, or ladder
    # A's projection), K3 by second-stage dtype, K2 by stage
    k1_cascade = {}
    k3_path_launches = {dt: 0 for dt in DTYPES}
    stage_calls = {}
    for name, ladder in LADDERS.items():
        row, calls = cascade_ladder(torch, eng, Q, Xd, Qd, gt, name, ladder, counters)
        if name == "A":
            row["projection_mirror_build_s"] = t_proj
        emit(row)
        launched = row["cascade_scan"]["launches"]
        k1_cascade[ladder[0]] = k1_cascade.get(ladder[0], 0) + launched["k1"]
        k3_path_launches[ladder[1]] += launched["k3"]
        for stage, call in zip(ladder, calls):
            stage_calls[(name, stage)] = call
    emit({"phase": "cascade_done", "k1_launches": k1_cascade,
          "k3_launches": k3_path_launches,
          "k2_launches_per_stage": {f"{a} {s}": c["k2_launches"]
                                    for (a, s), c in stage_calls.items()},
          "seconds": time.perf_counter() - t0})

    # ------------------------------------ 4b. the flat block: K4, K6, K7
    t0 = time.perf_counter()
    line, rows = flat_scan(torch, ref, eng, Xd, Qd, gt)
    paper_rows += rows
    emit({**line, "seconds": time.perf_counter() - t0})

    for dt in ("f32", "int8"):
        emit(where_time_goes(torch, eng, Q, specs[dt], "fused", scan_dtype=dt))
    emit(where_time_goes(torch, eng, Q, SearchSpec(k=K, cascade=LADDERS["A"]),
                         "cascade", cascade=list(LADDERS["A"])))

    # ------------------------------------------- 3. kernels vs plain
    store, pruner = eng.store, eng.pruner
    P, D, C = store.data.shape
    eps0 = float(pruner.aux["eps0"])
    qt = pruner.transform_query(Qd[0])
    order, _ = eng.ivf.route(qt, 1, "l2")
    p0 = int(order[0])
    start = topk_from_batch(pdx_distance(store.data[p0], qt), store.ids[p0], K)
    thr = topk_threshold(start)
    ids_scan = store.ids.clone()
    ids_scan[p0] = -1
    Qt = pruner.transform_batch(Qd)
    live_cols = (store.ids >= 0).reshape(-1)
    kernels = []
    for dt in DTYPES:
        m = device_mirror(store, dt)
        sc = m.scale if m.quantized else None
        off = m.offset if m.quantized else None

        by_executor = {"fused-scan": per_dtype[dt]["k1"],
                       "cascade-scan": k1_cascade.get(dt, 0)}
        kernels.append(scan_kernel_row(torch, ref, m, ids_scan, qt, thr, eps0,
                                       prefetch=False, launches=sum(by_executor.values()),
                                       launches_by_executor=by_executor))

        # K2 ------------------------------------------------------------
        row2 = k2_kernel_row(torch, ref, m.data, Qt, sc, off, m.packed, m.dim, dt,
                             f"K2 batched_distance_quant [{dt}]", per_dtype[dt]["k2"],
                             live_cols)
        kernels.append(row2)

    # K3 ----------------------------------------------------------------
    # its ids are the survivors of a real previous stage: ladder A's
    # projection stage (K1 at d_tile = rank, eps0 = 0) for the first query
    # that has any, so entry-dead partitions are present
    for i in range(N_SINGLE):
        qt3 = pruner.transform_query(Qd[i])
        p3 = int(eng.ivf.route(qt3, 1, "l2")[0][0])
        thr3 = topk_threshold(topk_from_batch(
            pdx_distance(store.data[p3], qt3), store.ids[p3], K))
        ids3 = store.ids.clone()
        ids3[p3] = -1
        qp3, thr_p = qt3 @ pm.components, _inflate(thr3, _quant_err_norm(pm))
        _, alive0 = pdx_prune_scan_multi_op(
            pm.data, ids3, qp3, thr_p, pm.scale, pm.offset, eps0=0.0,
            d_tile=pm.rank, dim=pm.dim)
        if bool(alive0.any()):
            break
    # K1 at ladder A's first stage: the int8 projection mirror, one test at
    # d = rank with eps 0 and the inflated threshold
    kernels.append(scan_kernel_row(
        torch, ref, pm, ids3, qp3, thr_p, 0.0, prefetch=False, d_tile=pm.rank,
        tag=LADDERS["A"][0], launches=k1_cascade[LADDERS["A"][0]],
        launches_by_executor={"cascade-scan": k1_cascade[LADDERS["A"][0]]}))
    ids_k3 = torch.where(alive0, ids3, -1)
    live3 = ids_k3 >= 0
    assert bool(live3.any()), "no query keeps a lane through the projection stage"
    # a row's launches: K3 on the cascade path at that dtype (the path runs
    # it at int4 and int8 only; the f32 and bf16 rows are held off the path)
    for dt in DTYPES:
        m = device_mirror(store, dt)
        thr_m = _inflate(thr3, _quant_err_norm(m))  # the cascade's own threshold
        kernels.append(scan_kernel_row(
            torch, ref, m, ids_k3, qt3, thr_m, eps0, prefetch=True,
            launches=k3_path_launches[dt], on_path=k3_path_launches[dt] > 0))

    # K2 per d-tile in cascade-batch, on each stage's compacted columns
    for (name, stage), call in stage_calls.items():
        kernels.append(stage_kernel_row(torch, ref, call, name, stage))
    del stage_calls

    # ----------------------------------------------------- 5b. tiered
    t0 = time.perf_counter()
    pool_rows, tiered_launches = tiered_phase(torch, ref, eng, Xd, args.seed,
                                              batched_distance_quant_cuda)
    emit({"phase": "tiered_done", "k2_launches": tiered_launches,
          "seconds": time.perf_counter() - t0})
    k2_rows = {f"K2 batched_distance_quant [{dt}]": dt for dt in DTYPES}
    for row in kernels:
        if row["name"] in k2_rows:
            row["launches_tiered"] = tiered_launches.get(k2_rows[row["name"]], 0)
    kernels += pool_rows

    # ----------------------------------------- 5d. routing, 5e. the mesh
    t0 = time.perf_counter()
    routing_phase(torch, eng, Qd)
    emit({"phase": "routing_done", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    sharded_launches, routed_rows, routed_launches = mesh_phases(
        torch, ref, eng, Q, Qd, Xd, args.seed, batched_distance_quant_cuda)
    emit({"phase": "mesh_done", "seconds": time.perf_counter() - t0})
    for row in kernels:
        if row["name"] in k2_rows and k2_rows[row["name"]] in sharded_launches:
            row["launches_sharded"] = sharded_launches[k2_rows[row["name"]]]
        if row["name"] in routed_launches:
            row["launches_routed"] = routed_launches[row["name"]]
    kernels += routed_rows

    # ----------------------------------------------------- 5c. serving
    t0 = time.perf_counter()
    serve_lines, serve_launches = serve_phase(torch, eng, Xd, Q, args.seed, counters)
    emit({"phase": "serve_done", "launches": serve_launches,
          "seconds": time.perf_counter() - t0})

    # ------------------------------- 6. the mutable store, 7. jit-masked
    # the frozen store's tensors go: the mutable store takes the card
    del store, m, pm, ids_scan, ids3, ids_k3, live_cols, start
    counters = {"k1": pdx_prune_scan_multi_cuda, "k2": batched_distance_quant_cuda,
                "k3": pdx_prune_scan_multi_prefetch_cuda}
    t0 = time.perf_counter()
    lines, mut_launches, live = mutable_phase(torch, eng, Xd, Q, Qd, args.seed, counters)
    for line in lines:
        emit(line)
    emit({"phase": "mutable_done", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    serve_churn_phase(torch, eng, Q, Qd, live["Xall"], live["gt"], live["dead"],
                      args.seed, counters, serve_lines[0]["serial_qps"]["f32"])
    emit({"phase": "serve_churn_done", "seconds": time.perf_counter() - t0})
    del live
    t0 = time.perf_counter()
    emit({**jit_masked_phase(torch, Xd, Q, engine_seed, counters),
          "seconds": time.perf_counter() - t0})
    del Xd
    for row in kernels:
        for tag, counts in mut_launches.items():
            if row["name"] in counts:
                row.setdefault("launches_mutable", {})[tag] = counts[row["name"]]
        if row["name"] in serve_launches:
            row["launches_serve"] = serve_launches[row["name"]]

    # --------------------------------------- 8. the served LM, 9. RAG
    # the vector engine leaves the card: the LM's 12.85 GB of f32 take it
    del eng
    torch.cuda.empty_cache()
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    lm_line, lm_eng, lm_batch, lm_out = lm_phase(torch, dev, get_config(LM_ARCH), args.seed)
    emit({**lm_line, "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    _, rag_rows = rag_phase(torch, ref, lm_eng, lm_batch, args.seed, counters)
    emit({"phase": "rag_done", "seconds": time.perf_counter() - t0})
    kernels += rag_rows

    # ---------------------------------------------------------- 10. train
    # phase 9's store is gone with its pipeline; the LM's params stay
    params = lm_eng.params
    del lm_eng
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_phase(torch, get_config(LM_ARCH), params, lm_batch, lm_out, args.seed, counters)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    train_two_layer_phase(torch, get_config(LM_ARCH), args.seed, dev)
    t2 = time.perf_counter()
    train_reduced_phase(torch, args.seed, dev)
    emit({"phase": "train_done", "full_width_s": t1 - t0, "two_layer_s": t2 - t1,
          "reduced_s": time.perf_counter() - t2, "seconds": time.perf_counter() - t0})

    # ------------------------------------------------------- 11. families
    # llama's params and train state are gone: one family at a time
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fam = families_phase(torch, dev, args.seed)
    emit({"phase": "families_done", "models": [f["arch"] for f in fam],
          "seconds_by_model": {f["arch"]: f["seconds"] for f in fam},
          "seconds": time.perf_counter() - t0})

    # ----------------------------------------------- 11b. train_families
    # the served families are gone: each trained in turn
    gc.collect()
    torch.cuda.empty_cache()
    train_families_phase(torch, dev, args.seed, counters)

    # ------------------------------------------------------ 12. mesh_lm
    # the trained families are gone: the LM side's mesh layer on a world of one
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh_lm_phase(torch, dev, args.seed, lm_line["decode_ms_per_token_median"], counters)
    emit({"phase": "mesh_lm_done", "seconds": time.perf_counter() - t0})

    # ------------------------------------------------------- 13. dryrun
    gc.collect()
    torch.cuda.empty_cache()
    dryrun_phase(torch, dev, args.seed, smi, counters)

    # ----------------------------------------------------- 4. the record
    emit({"kernels": kernels + paper_rows})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
