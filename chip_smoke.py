#!/usr/bin/env python3
"""Smoke run of the PyTorch port (deeprec_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, each of which must pass (the card-vs-CPU cells at 2^12 slots
build DLRM-DCN with one cross layer, SMALL_CROSS_DEPTH, at FULL's widths;
the seconds of every phase are printed at the end):
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the port from csrc/ (one nvcc per source,
     started together);
  3. each kernel against its plain PyTorch version on the card, bit-exact,
     at the main paths' shape (26 tables x 2^20 slots x 128, 2048 ids per
     table) and at edge shapes, with its time, the plain version's time,
     one PyTorch library call's time and the memory-bound least time:
     `gather_rows` (row gather, f32 and bf16), `apply_rows_sr` (row
     scatter, f32 and bf16 given the same random bits, the whole table
     compared) and `fused_gather_combine` (#4, pooled bags: one 2^20 x 128
     f32 table, batch 2048 of L = 100 zipf(1.2) ids, 5 % pads, mean
     weights, against embedding_bag; edge shapes in f32 and bf16, D 128,
     16, 12 and 7, sum, mean and sqrtn weights; and, each timed beside
     its byte bound and embedding_bag, the shapes the main paths launch it
     at: one-hot bags of 2048 over 2^20 rows at D 128 and 16, and the
     multi-hot request's [2048, 100] bags with the first L positions real
     for each MLPerf bag length L over 204,800 rows at D 128; then each
     main path's group, one grouped launch per request (26 one-hot
     features at D 128, 26 at D 16, BST's 3 at D 16, the 26 multi-hot
     features at the MLPerf lengths), bit-exact against the grouped plain
     version and timed as one grouped launch, as 26 single-feature
     launches and as embedding_bag per feature, beside its byte bound and
     the device time of one empty launch; and grouped edge cases in f32
     and bf16: mixed L and C, D 7 and 12, a bag of pads only, a head-heavy
     bag, a slice of a stacked table, a group past the launch's capacity);
  4. the serving main path at full width: MLPerf DLRM-DCN (emb_dim 128,
     26 x 2^20-slot tables, bottom 512-256-128, top 512-256-1, cross depth
     3) restored from a full checkpoint written with numpy from --seed
     (2^15 live keys per table; 2^16 before phase 20, 2^17 before phase 19), answering 5 requests of batch 2048 and one
     each of batch 1 and 37 (ids 90% live, 5% unseen, 5% pad). Live ids must
     return their checkpoint row bit for bit, unseen ids the blocked default,
     probabilities must be finite in (0, 1), and every kernel of the path
     must have launched during those requests (one gather and one #4
     launch, its 26 pooled features in one group, per request); then
     multi-hot requests to the same Predictor: bags of the MLPerf
     multi-hot sizes padded with -1 to L = 100 (5 of batch 2048, one of 1,
     one of 37), one #4 launch per request, 64 bags
     of every feature bit-exact against a numpy recomputation, #4 against
     its plain version at the L = 100 feature's own rows and bags, p50,
     p90 and a profile;
  5. the same model at capacity 2^12 restored on the card and on the CPU,
     answering one batch and one multi-hot batch within PROB_ATOL;
  6. the training main path at full width: the same model from empty
     tables, Adagrad(0.05) on the tables and Adam(1e-3) on the dense
     parameters, batch 2048 of SyntheticCriteo(vocab=1_000_000) staged on
     the card; 5 checked steps (finite losses, no failed insert, table sizes
     equal to the distinct ids seen, rows the step's batch does not hold
     unchanged across it, every kernel of the path launched as the bundles
     imply), then 30 timed steps and 3 profiled ones; the trained state is
     saved and served back by Predictor bit for bit;
  7. the same widths at capacity 2^12 and batch 256 from one initial state,
     3 train steps on the card and 3 on the CPU, within TRAIN_RTOL and
     ROW_ATOL;
  8. the fused bag step at full width: 26 tables of 2^20 x 128 f32 with
     Adagrad(0.05), stacked by bag length (the MLPerf DLRM-DCNv2
     multi-hot sizes: 12 groups), batch 2048 of zipf(1.2) ids over 10^6
     with 10 % pads in multi-hot bags; each step runs, per group, the train
     lookup, row_ix = slot_ix[inverse], bag_forward (kernel #6),
     g = out * 0.25 + 1 and apply_bag_gradients (kernel #7). 5 checked
     steps (launch counts, finite bags and rows), 20 timed, 3 profiled;
     then on copies of the L = 100 and L = 1 groups (and a bf16 copy of one
     table, and a head-heavy bag matrix: one row in all 2048 x 100
     positions) both kernels bit for bit against their plain versions,
     rows off the batch unchanged, and a tight budget whose overflow both
     count alike and whose out-of-budget positions add nothing; the device
     operations of one #6 and one #7 call at the L = 100 and L = 1 groups
     (torch.profiler; at most 3 and 5); per-step device times of both
     kernels, their plain versions and embedding_bag;
  9. DLRM-DCN training with Trainer(unique_budget="auto"): 5 steps,
     update_budgets, 5 steps at the measured budget, no overflow;
 10. the flash attention kernels (forward #8; backward #9, a dK/dV and a dQ
     launch) against their plain versions on the card at BST's attention
     shape [2048, 4, 256, 8] (masks of SyntheticBehaviorSequence histories
     plus the target, padded to 256) and at FLASH_SHAPES (causal, blocks 64
     and 128, dead rows, Dh 64, a padded Dh, a scattered mask), o and lse within 1e-5
     relative and the gradients within 1e-4 of their largest (bf16
     q, k, v at [2, 2, 256, 32]: one bf16 ulp more); at BST's
     shape the device times of both, their plain versions and
     scaled_dot_product_attention (forward and backward), and the bounds;
 11. BST with use_flash=True as modelzoo/bst/train.py runs it (emb 16,
     3 tables of 2^20 slots, two of them shared by the histories, heads 4,
     ff 128, hidden 256-64, Adagrad 0.2 + Adam 1e-3), histories of 200,
     batch 2048 of SyntheticBehaviorSequence(vocab=100_000): 5 checked
     steps (finite losses, no failed insert, table sizes, rows off the
     batch unchanged, one launch each of flash fwd, dK/dV and dQ and the
     gather/scatter launches the bundles imply per step), 30 timed, 3
     profiled, on to 60 steps (300, then 200, 150, 100 and 80, before the
     file-fed, serving and online-loop phases needed the time); held-out
     AUC over 8 batches at step 0 and step 60, at least 0.60 at the end; card vs CPU at capacity 2^12
     (bst_agreement);
 12. the phase-11 state saved and served by Predictor: 30 requests of
     batch 2048 and one each of batch 1 and 37, every answer equal to
     Trainer.eval_step's on the trained state bit for bit, one flash
     forward and one #4 launch (user, target_item, target_cat) per
     request; p50 and p90;
 13. the thirteen modelzoo models at the modelzoo's widths (emb 16, 2^20
     slots per table, batch 2048): WDL, DeepFM, DCN, DCNv2 and MaskNet
     (Criteo vocab 10^6), DIN and DIEN (histories of 50 over vocab 10^5;
     DIEN's GRU and AUGRU), DSSM (4 user and 4 item features over vocab
     10^5) and the multi-task SimpleMultiTask, ESMM, MMoE, PLE and DBMTL
     (8 categorical and 4 numeric features, vocab 10^6, a ctr and a cvr or
     ctcvr label): 5 checked steps (finite losses, no failed insert, the
     gather and scatter launches the bundles imply), 20 timed (DIEN then 1
     profiled; DSSM and MMoE too before phase 20), on to 150 steps (the depth cut in half to
     make room for phase 16); held-out AUC (`auc_ctr` for the
     multi-task models, every other task's printed) at least 0.60; the
     state saved and served by Predictor, 5 requests equal to eval_step bit
     for bit, task by task, with one #4 launch per request.
 14. the training loop of modelzoo/common.py `run()`: (a) at the full
     widths and 2^12 slots on the card, bit for bit, K = 4 windows of
     train_steps in "off" and "lookahead" and 4 train_step calls (f32
     tables, then bf16), off against lookahead on a 40-id vocabulary and
     under unique_budget 64, remat against none, stage="auto" against
     "off" (batch 2048); train_step_accum(A=4) card vs CPU within
     TRAIN_RTOL and ROW_ATOL; a counting-Bloom-filter table's sketch and
     keys equal to the CPU's, evict_tables (TTL and L2) and maintain's
     growth keeping every survivor's rows per key, and a checkpoint that
     restores the sketch and the grown capacity; (b) the loop at MLPerf
     DLRM-DCN widths with bf16 tables, CounterFilter(2) and
     GlobalStepEvict(200), each table starting at the power of two below
     half its distinct ids (the model's options and the optimizers made by
     the port's driver: `ev_option`, `_retable`, `make_optimizers` of
     deeprec_tpu_torch/modelzoo/common.py): stage(depth=2) feeding 40 windows of
     train_steps(K=8) (lookahead; 5 in "off", 5 fed host batches, 2
     profiled), evict_tables and maintain(max_capacity=2^20) after every
     5th window, train_step_accum(A=4) over 2 windows' batches, evaluate on
     8 held-out batches: finite losses, no failed insert after the last
     maintain, every table grown, keys evicted, the launches of #1-#5 and
     #4 the path implies, held-out AUC >= 0.60.
 15. multi-tier storage: (a) card against CPU at D 128 and 2^12 slots, from
     one state made on the CPU: the tier operations (train-mode inserts over
     5 x 2^12 ids, deterministic row writes, freqs stamped from a
     permutation, sync, sync_async + drain, probe_rows, fold_candidates,
     lookup_with_fallback over every id) on hbm_dram f32, hbm_dram bf16
     (#1 and #2 on the card) and hbm_dram_ssd (a host_capacity that spills)
     bit for bit per key: reports, device rows, host store, disk log, fold
     outcomes and retry keys, fallback rows; maintain(hbm_budget_bytes=) on
     an HBM DLRM-DCN filled past its growth threshold (a budget that grows,
     one that auto-tiers) with equal reports and rows per key; 2 rounds (3
     before phase 20) of pager observe + fold_tier_prefetch +
     train_steps(K=4) at batch 256 (512 before phase 20) + maintain() on
     a tiered DLRM-DCN, losses within TRAIN_RTOL, demoted counts and folds
     equal, every key in one tier, value rows in the same tier within
     steps x lr x TRAIN_RTOL and Adagrad accumulators within TRAIN_RTOL;
     (b) the tiered loop at MLPerf DLRM-DCN widths: hbm_dram tables of
     TIER["capacity"] slots (LFU, watermarks 0.8 / 0.6), enable_tier_paging
     + warm_tier_folds, stage(depth=2) feeding 14 windows (40 before
     phase 17, 30 before phase 18, 20 before phase 19, 16 before phase 20)
     of train_steps(K=8) in "lookahead", each followed by fold_tier_prefetch
     and maintain(tier_async=True) (every 5th a synchronous maintain(); 2
     windows profiled), a final maintain(), evaluate on 8 held-out batches:
     finite losses, rows demoted and brought back, occupancy at most the
     high watermark after every synchronous maintain, every key in one
     tier and no key lost but failed inserts (per table, the keys in no
     tier at most the failed inserts counted; both printed), lookup_with_fallback over every distinct id bit for bit against
     the table and the host store, the #3 / #5 / #4 launches the path and
     its tier events imply, AUC >= 0.60; (c) the modelzoo's budget path
     (maintain every window of 8 steps with hbm_budget_bytes) on HBM tables
     from TIER["budget"]["capacity"] slots, 10 windows (12 before phase 20, 18 before phase
     17): one growth, then auto-tiering that demotes.

 16. the checkpoint lifecycle of modelzoo/common.py `run()`: (a) at the
     full widths and 2^12 slots, one state trained on the card: a full
     save, 3 steps, a TTL eviction, a synchronous delta, 3 steps,
     save_incremental_async with 3 more steps issued before wait(); the
     chain restored on the card and on the CPU equal per key bit for bit
     (rows, accumulators, freq, version, dirty; dense and Adam) and to the
     live state at the last delta; the async delta's files equal to a
     synchronous delta's of a copy; a flipped byte in the middle delta
     quarantined alike on both devices and the next save a full one; (b)
     `run()` with --data criteo_stats --bf16 --filter_freq 2
     --steps_to_live 32 --evict_every 16 --save_steps 32
     --incremental_save_steps 8 --steps 64 at MLPerf DLRM-DCN widths (26
     bf16 tables of 2^20 slots, Adagrad 0.05, Adam 1e-3, batch 2048 of
     CriteoStats staged with mark_consumed), CheckpointManager(keep=3,
     datasets=), deltas synchronous to step 32 and async after it,
     StepWindowTracer on steps 10-19 and MetricsLogger every 8 steps; after
     the delta at step 56 Predictor on the chain answers as eval_step on
     the live state bit for bit, a second trainer, manager and CriteoStats
     restore full-32 + incr-40, 48, 56 equal to the live state per key bit
     for bit with the stream at index 56, and both trainers take steps
     57-64 (losses within TRAIN_RTOL, rows within one bf16 ulp and
     accumulators within TRAIN_RTOL relative per step); retention leaves
     what the JAX _gc leaves; the trace holds phase_lookup ranges and the
     metrics file one line per log; #1 / #3 launched once per member per
     save and #2 / #5 once per bundle with rows per restored link; held-out
     AUC >= 0.55; the save, stall, write, transfer, disk and restore
     figures and the examples/s of windows with and without an async delta
     in flight printed. (b) runs through the port's driver: `run()` of
     deeprec_tpu_torch/modelzoo/common.py with those flags, in this process,
     observed from outside (Trainer and CheckpointManager methods wrapped
     for the length of the call: the deltas after step 32 on the async
     writer, the saves and train steps timed, the restore gates and the
     restored twin at step 56).
 17. training from files and streams: 4 Criteo TSV files of 50,000 rows
     and a held-out file of 8 x 2048 rows written (without a loop over
     rows) from CriteoStats; (a) on the card's host, bit for bit: the
     native parser (criteo_parse_mt and criteo_parse) against
     criteo_block_parse on every file, ParallelInputPipeline(k_stack=2,
     shard_batches=2: 48 shards, several waves at every worker count) at
     1, 2 and 4 workers (8 before phase 20) against the serial CriteoCSVReader stream (a
     digest per unit; records/s and MB/s), and MultiHashTable,
     DynamicDimEmbedding and AdaptiveEmbedding card vs CPU at 2^12 slots
     per key (routing and masks exact, rows within COMPOSE_ROW_ATOL); (b)
     DLRM-DCN at MLPerf widths with bf16 tables (Adagrad 0.05 with f32
     accumulators, Adam 1e-3, CounterFilter(2), batch 2048) fed by
     ParallelInputPipeline(num_workers=4, k_stack=8) through Trainer.stage
     into train_steps(K=8, "lookahead"): an uninterrupted run over all 12
     units, a run with CheckpointManager(datasets={"pipeline": ...}) that
     saves after window 4 and stops after window 6, and a second trainer
     and pipeline that restore and run to the end of the data; every
     unit consumed exactly once across the two runs and equal to the
     serial stream's, the final state equal to the uninterrupted run's per
     key bit for bit (compared on the card), held-out AUC >= 0.55, the
     training thread's stall per window (the registry's staged counter,
     held against the Prefetcher's own total; the metrics must be on);
     (e) as many windows on a fresh trainer fed by CriteoStats through
     Trainer.stage in units of 8 stacked batches, and on another the same
     units made before the windows (the two runs' losses equal), their
     examples/s and stalls beside the file-fed oracle's;
     (c) run()'s --workqueue leg at 2^17 slots: WorkQueue(num_slices=2)
     -> input_dataset(drop_remainder=True) -> stage -> 16 train_steps, a
     save after 8 whose queue position (and state) a second manager
     restores; (d) FileStreamServer -> TCPStreamReader -> 8 train_steps
     with a save / restore of the reader after 4, every record once; the
     launches of #1, #3, #2, #5 and #4 the path implies.
 18. the serving stack: (a) MLPerf DLRM-DCN at full width from empty f32
     tables (Adagrad 0.05, Adam 1e-3, batch 2048 of SyntheticCriteo(vocab=
     10^6)): a full save after 8 steps; (b) HttpServer(ModelServer(
     Predictor(quality_gate=QualityGate(probe)), max_batch=2048,
     poll_updates_secs=0.5)) on 127.0.0.1, warmed (one bucket on the card), under 8
     client threads sending 100 request bodies of 1-256 rows encoded
     beforehand (3 in 4 JSON, 1 in 4 protobuf) while two deltas of 8 steps
     each land: every answer finite in (0, 1), each client's stamped
     versions never decreasing, every boot-version answer equal to the
     solo Predictor.predict of its rows within COALESCE_ATOL (bit for bit
     on the card, whose Predictor runs its dense model at 2048 rows per
     call), one
     version bump per delta, /healthz 200, /v1/model_info at the last step,
     /v1/stats and /metrics answering, and after the last swap the probe
     batch equal bit for bit to a fresh Predictor on the chain; requests/s,
     e2e p50/p90/p99, the queue / pad / device / post split, rows per
     device batch, the worst request during each update against the
     steady p99 and last_apply_lag_seconds printed; (d) a delta whose dense
     leaves are NaN rejected by the quality gate: poll_updates False, the
     directory quarantined, the old version answering bit for bit, health
     degraded / quality_gate, deeprec_quality_gate_rejections up by 1;
     (c) Predictor(quantize="bf16") and ("int8") on the final chain: max
     |dp| against f32 under BF16_ATOL and INT8_ATOL on the probe batch,
     residency bytes equal to the model, int8 at most INT8_SHARE of f32, a
     bf16 predict launching #1 once per lookup group and #3 never, int8
     neither, p50/p90 at batch 2048 and each restore's seconds; (e)
     ServerGroup(replicas=2) on the one card with one member, answering;
     the phase's launches of #1, #3, #2, #5 and #4 equal to what its path
     implies (train steps and saves, each Predictor's restored links and
     warm replay, every predict, device batch, warm batch and gate pass).
 19. the rest of serving: DSSM at the modelzoo's widths (phase 13's saved
     state, else 20 steps); (b) int8, bf16 and f32 RetrievalEngines over
     1,000,000 items (block_rows 4096, 32,768-row encode chunks), 8-row
     queries at k = 100 through ModelServer.retrieve_versioned: per
     residency the ingest seconds, p50/p90, the sweep alone, its device
     operations and its byte bound; the f32 answer against an exact f64
     scan of its vectors (items equal where no neighbour is within
     RETR_ATOL, exact scores within RETR_ATOL of the k best everywhere),
     int8 tie-aware recall@10 and @100 at least RECALL_FLOOR, 8 client
     threads' answers equal to solo ones bit for bit, measured = modeled
     bytes; an int8 engine over 10,000,000 items timed; (d) two in-process
     fp32 shards behind a Frontend: the merged top-k equal to the single
     engine's bit for bit, partial and degraded after one stops; a
     backend process (spawn_backends --device cuda) under PRED load
     SIGKILLed with no failed request; (c) 8 steps with the dense half
     frozen on 64 corpus items, a delta, one poll: the fold's rows equal
     the rows whose item features were trained (numpy), no other row
     moved, each equal to a fresh engine's; (e) Predictor(stores={
     RemoteKVClient}) over a RemoteKVServer equal to an in-process HostKV
     store bit for bit, the C ABI library (g++ at first use) loaded with
     ctypes answering JSON and protobuf process() equal to predict bit for
     bit; the phase's launches of #1, #3, #2, #5 and #4 equal to what its
     path implies.
 20. the guarded online train-to-serve loop (GUARD): WDL at the modelzoo's
     widths (26 + 13 features, emb 16, 2^20 slots, hidden 1024-512-256)
     with the step sentinel (spike 1.5, EMA 0.9, grad norm 5e3, row norm
     50, evict quantile 0.9); (a) card against CPU at 2^12 slots from one
     state: the sentinel off and on (untripped) over 3 train_steps and one
     K = 4 lookahead window bit for bit, the loss and EMA of step k within
     max(1, k / 3) x TRAIN_RTOL of the CPU's (with the MLPs' operands in
     f32, every loss within TRAIN_RTOL / 10), the flags of a clean, a NaN, an
     extreme, a label-flipped (against a seeded EMA) and an exploding-lr
     step equal (all five bits between them), a TrainLoop rollback equal
     per key and dense leaf to a clean run minus the poisoned batch,
     maintain()'s anomaly eviction of an exploded row; (b) `python -m
     deeprec_tpu_torch.modelzoo --model wide_and_deep --steps 20
     --eval_every 10 --log_every 10` on the card, exit 0 with its
     `global_step/sec:` and `Eval AUC:` lines; (c) 40 clean warmup steps
     (80 in GUARD_BENCH) through TrainLoop, the step's ms with the sentinel
     off and on in turns, then TrainLoop(guard=GuardPolicy(2, 128),
     save_every 8, full_every 3) over 40 PoisonInjector deliveries (nan at
     6, repeats at 10 and 14, extreme at 18, label_flip at 26) and one
     exploding-lr step, ServeLoop(QualityGate) serving the chain to a
     scorer thread: every injection detected within one dispatch,
     delivery 6 quarantined, 0 failed requests, the lowest served AUC at
     least the baseline less 0.05, a sentinel-less shadow trainer's NaN
     delta rejected by the gate while serving continues; rollback_ms per
     rollback; #3 (touched_row_norms' gather), #5 (a clamp_rows scatter at
     the same rows, on a copy of the table) and #4 (one served request)
     bit for bit against their plain versions; (d) FRESHNESS_BENCH's
     protocol: `python -m deeprec_tpu_torch.online.loop --device cuda` at
     26 + 13 features, emb 16, 2^20 slots under the Supervisor, fed over
     TCP at batch 128, a save every 8 steps, 4 batches/s, 25 requests/s,
     poll 0.25 s: 40 steady steps (80 in the bench) all reflected, p50 /
     p95 freshness, the worker SIGKILLed (one restart, recovery s), the
     newest delta corrupted (quarantined, a full save past it, recovery
     s), 0 failed requests; the launches of #1, #3, #2, #5 and #4 of (c)
     and (d)'s in-process path equal to what its events imply (train
     steps, saves, directory imports, read-only forwards, the
     comparisons' own launches).
 21. the sharded engine (deeprec_tpu_torch/parallel/, SHARD): DLRM-DCN at
     FULL's widths (26 x 2^20 x 128 f32 slots in all), Adagrad 0.05 + Adam
     1e-3, a global batch of 2048 from SyntheticCriteo(vocab=10^6); every
     rank a process started by `python -m deeprec_tpu_torch.launch`
     running this file with --sharded-rank. (a) world 1 over NCCL on the
     card: the Trainer, then ShardedTrainer(allgather) with the f32 wire
     (losses and the touched keys' rows bit for bit) and with the default
     bf16 wire (within 1e-3), 4 steps each from the parameters of the
     model built from --seed; (b) world 4 over gloo, every rank on the one
     card (host-staged): allgather and a2a on the 1-D and the 2x2 mesh,
     hier on 2x2, 3 steps each (the first loss equal across comms, the
     flat comms bit for bit across the meshes, summed a2a_overflow 0,
     losses within 1e-4 of (a)'s bf16 wire at steps 1-2 and within
     TRAIN_RTOL after), a part-file save after the 2x2 allgather leg and
     its restore at 4 (the next loss bit for bit), and a bf16-table a2a leg
     (#1 and #2); (c) the part files restored at world 2 (the 1-D mesh
     plan_mesh_after_rescale gives) and at world 1 (their processes start
     with (b) and wait for it; the world-1 one then runs (a)): every key's
     row, accumulator, freq and version bit for bit, the resumed step's
     loss within 1e-4 of world 4's; every rank's launches of #1, #3, #2
     and #5 equal to what its steps imply. Each leg's step ms carries the
     card's name and power limit (the world-4 ones: gloo, host-staged, one
     card, not a multi-GPU figure).

Prints the kernel table as one JSON line, then as the last line
{"ok": true, "device": {...}}. Exits non-zero, with no result line, when a
phase fails, when CUDA is absent, or when the package is missing.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import dataclasses
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
# CUDA vs CPU probabilities: same bf16-operand / f32-accumulate math, but
# the f32 sums run in another order, and a 1-ulp difference before a bf16
# rounding flips that operand by 2^-8 relative. Width 3456 makes flips common.
PROB_ATOL = 1e-3
# CUDA vs CPU training, 3 steps: the same flips reach the loss (a mean over
# the batch) and the gradients; an Adagrad step is at most lr per element
# and a gradient difference of 1e-3 relative moves it by far less than
# ROW_ATOL; dense parameters move at most 2 lr per step apart under Adam.
TRAIN_RTOL = 1e-3
ROW_ATOL = 1e-4

FULL = dict(emb_dim=128, capacity=1 << 20, bottom=(512, 256, 128))
LIVE_KEYS = 1 << 15
SMALL_CAPACITY, SMALL_LIVE = 1 << 12, 1500
# The card-vs-CPU cells at SMALL_CAPACITY (phases 5, 7, 14 (a), 15 (a),
# 16 (a)) keep FULL's widths and cut DLRM-DCN's cross net to one layer
# (three on the main paths): a depth cut for time. Each cross layer is a
# [3456, 3456] matrix, so three of them are most of the dense and Adam
# state that these cells train, save and restore on the CPU.
SMALL_CROSS_DEPTH = 1
TRAIN = dict(batch=2048, vocab=1_000_000, checked=5, timed=30, profiled=3,
             lr=0.05, dense_lr=1e-3, agree_batch=256, sample=4096)


def _ms(fn, dev, reps=50, warm=3):
    """(device ms, call ms) of fn() after `warm` calls. Device: the summed
    duration of the kernels one call launches, from torch.profiler over
    `reps` calls, the larger of two such windows (the profiler now and then
    drops a window's kernels). Call: CUDA events around `reps` back-to-back
    calls, which times the host's launch interval wherever that is longer
    than the kernels (a wrapper's Python checks and a ctypes launch take
    tens of microseconds). (None, None) off the card: a CPU rehearsal
    measures nothing."""
    if dev.type != "cuda":
        return None, None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    call = a.elapsed_time(b) / reps
    busy_us = 0.0
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        busy_us = max(busy_us, sum(e.self_device_time_total for e in prof.key_averages()
                                   if getattr(e, "device_type", None) == DeviceType.CUDA))
    return busy_us / reps / 1e3, call


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _cycled_ms(fn, args, dev, reps=50):
    """_ms of fn over a cycle of argument tuples."""
    it = itertools.cycle(args)
    return _ms(lambda: fn(*next(it)), dev, reps=reps)


def _timed_record(rec, label, kernel, plain, library):
    """Fill a kernel record's ms, plain_ms and library_ms with device times
    from ((device, call) ms pairs), and print the per-call times beside
    them."""
    rec.update(ms=kernel[0], plain_ms=plain[0], library_ms=library[0])
    print(f"{label} timing, device ms (per-call ms): kernel {kernel[0]} "
          f"({kernel[1]}), plain {plain[0]} ({plain[1]}), library "
          f"{library[0]} ({library[1]}), byte bound {rec['bound_ms']}")
    return rec


# bf16 launches of #3 and #5 on the main paths, read by `_row_counts`:
# they are the launches of #1 and #2, whose work is those kernels' bf16
# branches on this card.
PAIR_LAUNCHES = {"gather_rows": 0, "apply_rows_sr": 0}

_BUILT = {}


def _built(make, *key):
    """A copy of the model make() builds, built once per key: the models'
    initializers run on the host (about 1.5 s a DLRM-DCN and 0.5 s a WDL
    at full widths), a copy takes milliseconds, and the copies are the same
    bits."""
    if key not in _BUILT:
        _BUILT[key] = make()
    return copy.deepcopy(_BUILT[key])


def _dlrm_dcn(seed, **kw):
    """DLRMDCN(**kw, seed=seed), built once per configuration."""
    from deeprec_tpu_torch.models import DLRMDCN

    return _built(lambda: DLRMDCN(**kw, seed=seed), "DLRMDCN", repr(sorted(kw.items())), seed)


def _zero_row_counts():
    """Zero the launch counts of #3 and #5, their bf16 branches' too, just
    before a main path."""
    from deeprec_tpu_torch.ops.fused_lookup import apply_rows_sr, gather_rows

    for k in (gather_rows, apply_rows_sr):
        k.launches = k.launches_bf16 = 0


def _row_counts():
    """(apply_rows_sr, gather_rows) launches just after a main path; the
    bf16 ones among them are added to PAIR_LAUNCHES."""
    from deeprec_tpu_torch.ops.fused_lookup import apply_rows_sr, gather_rows

    for k in (gather_rows, apply_rows_sr):
        PAIR_LAUNCHES[k.__name__] += k.launches_bf16
    return apply_rows_sr.launches, gather_rows.launches


# ------------------------------------------------------------ phase 3


def kernel_phase(dev, main_shape, edge_shapes, seed):
    """gather_rows against its plain version; returns the kernel records
    {dtype: record}, timed at the main shape: f32, the table dtype of the
    main paths (#3), and bf16, the branch that stands for the TPU's
    pair-granule gather (#1)."""
    from deeprec_tpu_torch.ops.fused_lookup import gather_rows, gather_rows_plain

    g = torch.Generator(device=dev).manual_seed(seed)
    records = {}
    for T, C, D, n in [main_shape] + list(edge_shapes):
        values32 = torch.randn((T, C, D), generator=g, device=dev)
        ix = torch.randint(-8, C + 8, (T, n), generator=g, device=dev,
                           dtype=torch.int32)
        for dtype in (torch.float32, torch.bfloat16):
            values = values32 if dtype == torch.float32 else values32.to(dtype)
            got, want = gather_rows(values, ix), gather_rows_plain(values, ix)
            _sync(dev)
            if got.shape != (T, n, D) or not torch.equal(got, want):
                raise AssertionError(
                    f"gather_rows {dtype} T={T} C={C} D={D} n={n}: kernel "
                    "differs from the plain version")
            err = float((got.float() - want.float()).abs().max())
            print(f"gather_rows {str(dtype)[6:]} T={T} C={C} D={D} n={n}: "
                  f"bit-exact (max_abs_err {err})")
            if (T, C, D, n) == tuple(main_shape):
                records[dtype] = time_gather(values, n, g, err)
            del values
        del values32, ix
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return records


def time_gather(values, n, g, err, sets=8):
    """The kernel record at one shape: the kernel, its plain version and
    torch.index_select timed over `sets` index sets in turn, so the rows
    one call reads were not read by the call before (8 sets of 26 x 2048
    rows of 512 B span 218 MB, past the 50 MB L2). The bound counts the
    distinct rows each set reads, its indices and the rows written."""
    from deeprec_tpu_torch.ops.fused_lookup import gather_rows, gather_rows_plain

    T, C, D = values.shape
    dev = values.device
    ixs = [torch.randint(0, C, (T, n), generator=g, device=dev, dtype=torch.int32)
           for _ in range(sets)]
    flat = values.view(T * C, D)
    gidx = [(torch.arange(T, device=dev)[:, None] * C + ix.long()).flatten()
            for ix in ixs]
    row = D * values.element_size()
    moved = sum(int(torch.unique(gi).numel()) * row + T * n * (row + 4)
                for gi in gidx) / sets
    bf16 = values.dtype == torch.bfloat16
    rec = {
        "name": "gather_rows_pair" if bf16 else "gather_rows", "route": "cuda",
        "source": "deeprec_tpu_torch/csrc/gather_rows.cu",
        "replaces": "deeprec_tpu/ops/fused_lookup.py:" + ("204" if bf16 else "367"),
        "launches": 0, "max_abs_err": err,
        "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
    }
    return _timed_record(
        rec, f"gather_rows {str(values.dtype)[6:]}", _cycled_ms(gather_rows, [(values, ix) for ix in ixs], dev),
        _cycled_ms(gather_rows_plain, [(values, ix) for ix in ixs], dev),
        _cycled_ms(torch.index_select, [(flat, 0, gi) for gi in gidx], dev))


def _scatter_inputs(T, C, D, U, g, dev, skip=0.05):
    """Unique slots per table (about `skip` of them -1) and f32 rows."""
    slot = torch.stack([torch.randperm(C, generator=g, device=dev)[:U]
                        for _ in range(T)]).to(torch.int32)
    drop = torch.rand((T, U), generator=g, device=dev) < skip
    slot = torch.where(drop, -1, slot)
    rows = torch.randn((T, U, D), generator=g, device=dev)
    return slot, rows


def scatter_phase(dev, main_shape, edge_shapes, seed):
    """apply_rows_sr against its plain version on the same input and bits:
    the whole table after the write, bit-exact in f32 and bf16. Returns the
    kernel records {dtype: record} timed at the main shape: f32 (#5) and
    bf16, the branch that stands for the TPU's pair-granule scatter (#2)."""
    from deeprec_tpu_torch.ops.fused_lookup import (
        apply_rows_sr, apply_rows_sr_plain, sr_bits)

    g = torch.Generator(device=dev).manual_seed(seed + 7)
    records = {}
    for T, C, D, U in [main_shape] + list(edge_shapes):
        slot, rows = _scatter_inputs(T, C, D, U, g, dev)
        values32 = torch.randn((T, C, D), generator=g, device=dev)
        for dtype in (torch.bfloat16, torch.float32):  # f32 last: it writes values32
            bits = sr_bits(seed, (T, U, D), dev) if dtype == torch.bfloat16 else None
            want = values32.to(dtype, copy=True)
            apply_rows_sr_plain(want, slot, rows, bits)
            got = values32 if dtype == torch.float32 else values32.to(dtype)
            apply_rows_sr(got, slot, rows, bits=bits)
            _sync(dev)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"apply_rows_sr {dtype} T={T} C={C} D={D} U={U}: kernel "
                    "differs from the plain version")
            err = float((got.float() - want.float()).abs().max())
            print(f"apply_rows_sr {str(dtype)[6:]} T={T} C={C} D={D} U={U} "
                  f"({int((slot >= 0).sum())} rows written): whole table "
                  f"bit-exact (max_abs_err {err})")
            del want
            if (T, C, D, U) == tuple(main_shape):
                records[dtype] = time_scatter(got, U, g, err, seed)
            del got
        del values32, slot, rows
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return records


def time_scatter(values, U, g, err, seed, sets=8):
    """The kernel record at one shape: the kernel, its plain version and
    (f32) index_copy_ of the valid rows into the flattened table with
    pre-offset int64 indices, timed over `sets` slot sets in turn (8 sets
    of 26 x 2048 rows of 512 B read and written span 436 MB, past the 50 MB
    L2). The bound counts, per set, the rows written (read once from
    `rows` and, for bf16, one row of 4-byte bits each; written once) and
    every slot index."""
    from deeprec_tpu_torch.ops.fused_lookup import (
        apply_rows_sr, apply_rows_sr_plain, sr_bits)

    T, C, D = values.shape
    dev = values.device
    bf16 = values.dtype == torch.bfloat16
    ins = [_scatter_inputs(T, C, D, U, g, dev) for _ in range(sets)]
    args = [(values, slot, rows, sr_bits(seed, (T, U, D), dev) if bf16 else None)
            for slot, rows in ins]
    moved = 0
    for slot, _ in ins:
        n = int((slot >= 0).sum())
        moved += n * D * (4 + values.element_size() + (4 if bf16 else 0)) + T * U * 4
    moved /= sets
    rec = {
        "name": "apply_rows_sr_pair" if bf16 else "apply_rows_sr", "route": "cuda",
        "source": "deeprec_tpu_torch/csrc/apply_rows_sr.cu",
        "replaces": "deeprec_tpu/ops/fused_lookup.py:" + ("278" if bf16 else "564"),
        "launches": 0, "max_abs_err": err,
        "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
    }
    library = (None, None)
    if not bf16:  # no single PyTorch call rounds stochastically
        flat = values.view(T * C, D)
        lib = []
        for slot, rows in ins:
            ok = slot >= 0
            gi = (torch.arange(T, device=dev)[:, None] * C + slot.long())[ok]
            lib.append((0, gi, rows[ok]))
        library = _cycled_ms(flat.index_copy_, lib, dev)
    return _timed_record(
        rec, f"apply_rows_sr {str(values.dtype)[6:]}",
        _cycled_ms(lambda v, s, r, b: apply_rows_sr(v, s, r, bits=b), args, dev),
        _cycled_ms(apply_rows_sr_plain, args, dev), library)


# ------------------------------------------------------------ phase 3: #4

# Kernel #4 at the use the JAX docstring names, bags pooled straight out of
# a full table: one 2^20 x 128 f32 table, batch 2048 of L = 100 zipf(1.2)
# ids over 10^6 mapped to rows by a random permutation, 5 % pads, mean
# weights; `sets` index sets (each with its own permutation) timed in turn,
# so one call's rows were not read by the call before. The edge shapes
# (C, D, B, L, dtype), each under sum, mean and sqrtn weights with a bag of
# pads only and rows past the table: B = 37, L = 1, bf16 at D 128 and 16,
# f32 at the modelzoo's D 16, D 12 (three 16-byte vectors a row) and D 7
# (the scalar path).
COMBINE = dict(capacity=1 << 20, dim=128, batch=2048, L=100, vocab=1_000_000,
               zipf=1.2, pad=0.05, sets=4)
COMBINE_EDGES = [(4096, 128, 37, 100, torch.float32), (4096, 128, 2048, 1, torch.float32),
                 (4096, 128, 64, 8, torch.bfloat16), (4096, 16, 64, 8, torch.bfloat16),
                 (4096, 16, 2048, 20, torch.float32), (1000, 12, 37, 9, torch.float32),
                 (1000, 7, 37, 9, torch.float32)]

# Grouped edge cases, each in f32 and bf16 under sum, mean and sqrtn
# weights: (D, B, [(C, L, kind)] per feature), kind "rand" (rows in
# [-1, C + 3): pads and rows past the table), "head" (one row in every
# position) or "stacked" ("rand" over a slice of a stacked [3, C, D]
# table); the first feature's bag 1 is pads only. The last group is larger
# than one launch's capacity (GROUP_CAPACITY).
COMBINE_GROUP_EDGES = [
    (128, 2048, [(4096, 100, "rand"), (50, 1, "rand"), (100_000, 100, "head"),
                 (300, 7, "stacked")]),
    (16, 2048, [(4096, 1, "rand"), (1000, 100, "stacked"), (4096, 100, "head")]),
    (12, 37, [(1000, 9, "rand"), (50, 1, "stacked"), (1000, 100, "head")]),
    (7, 37, [(1000, 9, "rand"), (50, 100, "stacked"), (1000, 1, "head")]),
    (16, 64, [(64 + k, 1 + k % 5, "rand") for k in range(70)]),
]


def combine_weights(row_ix, combiner):
    """The combiner's per-position weights [B, L] of the read-only path
    (`combiners.pooled_operands`) for rows `row_ix`, < 0 at pads."""
    from deeprec_tpu_torch.embedding.combiners import pooled_operands

    return pooled_operands(row_ix, row_ix >= 0, combiner)[1]


def compare_combine(values, row_ix, w, what):
    """Kernel #4 against its plain version on the same inputs, bit for bit.
    Returns the max abs error (0)."""
    from deeprec_tpu_torch.ops.fused_lookup import (
        fused_gather_combine, fused_gather_combine_plain)

    got = fused_gather_combine(values, row_ix, w)
    want = fused_gather_combine_plain(values, row_ix, w)
    _sync(values.device)
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"fused_gather_combine {what}: kernel differs from the "
                             "plain version")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    print(f"fused_gather_combine {what}: bit-exact (max_abs_err {err})")
    return err


def _zipf_rows(rng, cfg, perm, dev):
    """[B, L] int32 rows: zipf ids over `vocab` through the permutation
    `perm` of the table's rows, about `pad` of them -1."""
    from deeprec_tpu_torch.data.synthetic import zipf_ids

    ids = zipf_ids(rng, cfg["vocab"], cfg["zipf"], (cfg["batch"], cfg["L"]))
    rows = perm[torch.from_numpy(ids).to(dev)].to(torch.int32)
    pad = torch.from_numpy(rng.random(ids.shape) < cfg["pad"]).to(dev)
    return torch.where(pad, -1, rows)


def combine_phase(dev, seed, cfg=COMBINE, edges=COMBINE_EDGES,
                  group_edges=COMBINE_GROUP_EDGES):
    """Kernel #4 against its plain version at the edge shapes and at the
    main shape; at the main shape the device times of the kernel, its plain
    version and embedding_bag (clamped rows, the weights as
    per_sample_weights, 0 at pads), and the byte bound. Returns the kernel
    record."""
    from deeprec_tpu_torch.ops.fused_lookup import (
        fused_gather_combine, fused_gather_combine_plain)

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(seed + 31)
    rng = np.random.default_rng(seed + 31)
    err = 0.0
    for C, D, B, L, dtype in edges:
        values = torch.randn((C, D), generator=g, device=dev).to(dtype)
        row_ix = torch.randint(-1, C + 3, (B, L), generator=g, device=dev,
                               dtype=torch.int32)
        row_ix[min(1, B - 1)] = -1  # a bag of pads only
        for combiner in ("sum", "mean", "sqrtn"):
            err = max(err, compare_combine(
                values, row_ix, combine_weights(row_ix, combiner),
                f"C={C} D={D} B={B} L={L} {str(dtype)[6:]} {combiner}"))
    C, D, B, L = cfg["capacity"], cfg["dim"], cfg["batch"], cfg["L"]
    values = torch.randn((C, D), generator=g, device=dev)
    sets = []
    for _ in range(cfg["sets"]):
        row_ix = _zipf_rows(rng, cfg, torch.randperm(C, generator=g, device=dev), dev)
        sets.append((row_ix, combine_weights(row_ix, "mean")))
    err = max(err, compare_combine(values, *sets[0],
                                   f"main shape C={C} D={D} B={B} L={L} mean"))
    # the bound by the table's rule: each distinct row read once, 8 bytes of
    # row_ix and weight per position, out written once; and, beside it, the
    # figure with every non-pad position's row read
    moved = per_position = 0
    for row_ix, _ in sets:
        live = row_ix[row_ix >= 0]
        fixed = row_ix.numel() * 8 + B * D * 4
        moved += int(torch.unique(live).numel()) * D * 4 + fixed
        per_position += int(live.numel()) * D * 4 + fixed
    moved, per_position = moved / len(sets), per_position / len(sets)
    rec = {"name": "fused_gather_combine", "route": "cuda",
           "source": "deeprec_tpu_torch/csrc/fused_gather_combine.cu",
           "replaces": "deeprec_tpu/ops/fused_lookup.py:441",
           "launches": 0, "max_abs_err": err,
           "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    print(f"fused_gather_combine main shape: {moved / 1e6:.3f} MB by the table's rule "
          f"(distinct rows), {per_position / 1e6:.3f} MB with every non-pad "
          f"position's row: bounds {rec['bound_ms']:.5f} / "
          f"{per_position / HBM_BYTES_PER_S * 1e3:.5f} ms at "
          f"{HBM_BYTES_PER_S / 1e12} TB/s")
    lib = [(row_ix.clamp(min=0), w) for row_ix, w in sets]
    _timed_record(
        rec, f"fused_gather_combine (C={C} D={D} B={B} L={L})",
        _cycled_ms(lambda ix, w: fused_gather_combine(values, ix, w), sets, dev),
        _cycled_ms(lambda ix, w: fused_gather_combine_plain(values, ix, w), sets, dev,
                   reps=4),
        _cycled_ms(lambda ix, w: torch.nn.functional.embedding_bag(
            ix, values, per_sample_weights=w, mode="sum"), lib, dev))
    del values, sets, lib
    rec["max_abs_err"] = max(err, combine_launch_shapes(dev, g, cfg),
                             combine_group_phase(dev, g, cfg, group_edges))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    print(f"fused_gather_combine checks and timing took {time.perf_counter() - t0:.1f} s")
    return rec


def combine_launch_shapes(dev, g, cfg):
    """Kernel #4 alone at the shapes the main paths launch it at, checked
    bit for bit against its plain version and timed beside its byte bound
    and embedding_bag: one-hot bags (L = 1) of `batch` over a
    `capacity`-row table at D 128 (DLRM-DCN serving) and D 16 (BST and the
    modelzoo), and the multi-hot request's bags, [batch, 100] with the
    first L positions real for each MLPerf bag length L, over the U = N
    rows of its read-only view at D 128. Rows are distinct, 5 % of the
    real positions pads, mean weights. Returns the max abs error (0)."""
    from deeprec_tpu_torch.ops.fused_lookup import fused_gather_combine

    B, Lp = cfg["batch"], max(MULTI_HOT)
    shapes = [(cfg["capacity"], 128, 1, 1), (cfg["capacity"], 16, 1, 1)]
    shapes += [(B * Lp, 128, Lp, L) for L in sorted(set(MULTI_HOT))]
    err = 0.0
    for C, D, width, L in shapes:
        values = torch.randn((C, D), generator=g, device=dev)
        rows = torch.randperm(C, generator=g, device=dev)[:B * L].view(B, L)
        pad = torch.rand((B, L), generator=g, device=dev) < 0.05
        row_ix = torch.full((B, width), -1, dtype=torch.int32, device=dev)
        row_ix[:, :L] = torch.where(pad, -1, rows).to(torch.int32)
        w = combine_weights(row_ix, "mean")
        what = f"launch shape C={C} D={D}, {B} bags of {L} real of {width} positions"
        err = max(err, compare_combine(values, row_ix, w, what))
        nbytes = (int((row_ix >= 0).sum()) * D * 4 + row_ix.numel() * 8 + B * D * 4)
        lib = row_ix.clamp(min=0)
        kernel = _ms(lambda: fused_gather_combine(values, row_ix, w), dev, reps=20)
        library = _ms(lambda: torch.nn.functional.embedding_bag(
            lib, values, per_sample_weights=w, mode="sum"), dev, reps=20)
        print(f"fused_gather_combine {what}: device ms {kernel[0]} (per call "
              f"{kernel[1]}), byte bound {nbytes / HBM_BYTES_PER_S * 1e3:.5f} ms "
              f"({nbytes / 1e6:.3f} MB), embedding_bag {library[0]}")
        del values, rows, pad, row_ix, w, lib
    return err


def combine_groups():
    """Kernel #4's groups on the main paths, one grouped launch per request
    each: (name, D, [(real L, padded L)] per feature)."""
    return [("DLRM-DCN one-hot", 128, [(1, 1)] * 26),
            ("modelzoo one-hot", 16, [(1, 1)] * 26),
            ("BST", 16, [(1, 1)] * 3),
            ("multi-hot", 128, [(L, max(MULTI_HOT)) for L in MULTI_HOT])]


def combine_group(g, dtype, D, B, specs, combiner, dev):
    """The (values, row_ix, weights) lists of one grouped edge case on `dev`
    (see COMBINE_GROUP_EDGES), drawn from the generator `g` on its own
    device: per (C, L, kind) a feature of C rows and [B, L] bags; bag 1 of
    the first feature is pads only; the combiner's weights."""
    values, row_ix, weights = [], [], []
    for k, (C, L, kind) in enumerate(specs):
        v = torch.randn((3 if kind == "stacked" else 1, C, D), generator=g,
                        device=g.device)
        ix = torch.randint(-1, C + 3, (B, L), generator=g, device=g.device,
                           dtype=torch.int32)
        if kind == "head":
            ix.fill_(C // 2)
        if k == 0:
            ix[min(1, B - 1)] = -1
        values.append(v.to(dev, dtype)[1 if kind == "stacked" else 0])
        row_ix.append(ix.to(dev))
        weights.append(combine_weights(row_ix[-1], combiner))
    return values, row_ix, weights


def compare_group(values, row_ix, w, what):
    """One grouped #4 launch against the grouped plain version, feature by
    feature, bit for bit; the launch count must rise by one per
    GROUP_CAPACITY features. Returns the max abs error (0)."""
    from deeprec_tpu_torch.ops.fused_lookup import (
        GROUP_CAPACITY, fused_gather_combine, fused_gather_combine_grouped,
        fused_gather_combine_grouped_plain)

    before = fused_gather_combine.launches
    got = fused_gather_combine_grouped(values, row_ix, w)
    launched = fused_gather_combine.launches - before
    want = fused_gather_combine_grouped_plain(values, row_ix, w)
    _sync(values[0].device)
    if values[0].device.type == "cuda" and launched != -(-len(values) // GROUP_CAPACITY):
        raise AssertionError(f"fused_gather_combine_grouped {what}: {launched} launches "
                             f"for {len(values)} features")
    for f, (a, b) in enumerate(zip(got, want)):
        if a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"fused_gather_combine_grouped {what}: feature {f} "
                                 "differs from the plain version")
    err = max(float((a - b).abs().max()) if a.numel() else 0.0 for a, b in zip(got, want))
    print(f"fused_gather_combine_grouped {what}: {len(values)} features in {launched} "
          f"launch(es), bit-exact (max_abs_err {err})")
    return err


def combine_group_phase(dev, g, cfg, edges=COMBINE_GROUP_EDGES):
    """Kernel #4's grouped launch: the edge groups, then each main path's
    group over the rows of its read-only view (a stacked [F, U, D] f32
    table, U = batch x padded L: the U = N view; rows distinct, 5 % of the
    real positions pads, mean weights), checked bit for bit and timed as one
    grouped launch, as one single-feature launch per feature and as
    embedding_bag per feature, beside its byte bound and the device time of
    one empty launch (torch.cuda._sleep(0)). Returns the max abs error (0)."""
    from deeprec_tpu_torch.ops.fused_lookup import (
        fused_gather_combine, fused_gather_combine_grouped)

    err = 0.0
    for D, B, specs in edges:
        for dtype in (torch.float32, torch.bfloat16):
            for combiner in ("sum", "mean", "sqrtn"):
                err = max(err, compare_group(
                    *combine_group(g, dtype, D, B, specs, combiner, dev),
                    f"D={D} B={B} L={sorted({L for _, L, _ in specs})} "
                    f"{sorted({k for _, _, k in specs})} {str(dtype)[6:]} {combiner}"))
    floor = _ms(lambda: torch.cuda._sleep(0), dev, reps=20)[0]
    print(f"empty launch (torch.cuda._sleep(0)): device ms {floor}")
    B = cfg["batch"]
    for name, D, lengths in combine_groups():
        U = B * lengths[0][1]
        table = torch.randn((len(lengths), U, D), generator=g, device=dev)
        values, row_ix, w = list(table.unbind(0)), [], []
        for L, width in lengths:
            rows = torch.randperm(U, generator=g, device=dev)[:B * L].view(B, L)
            pad = torch.rand((B, L), generator=g, device=dev) < 0.05
            ix = torch.full((B, width), -1, dtype=torch.int32, device=dev)
            ix[:, :L] = torch.where(pad, -1, rows).to(torch.int32)
            row_ix.append(ix)
            w.append(combine_weights(ix, "mean"))
        what = f"{name} group: {len(lengths)} features, D {D}, batch {B}"
        err = max(err, compare_group(values, row_ix, w, what))
        nbytes = sum(int((ix >= 0).sum()) * D * 4 + ix.numel() * 8 + B * D * 4
                     for ix in row_ix)
        lib = [ix.clamp(min=0) for ix in row_ix]
        grouped = _ms(lambda: fused_gather_combine_grouped(values, row_ix, w), dev,
                      reps=20)
        single = _ms(lambda: [fused_gather_combine(v, ix, x)
                              for v, ix, x in zip(values, row_ix, w)], dev, reps=20)
        library = _ms(lambda: [torch.nn.functional.embedding_bag(
            ix, v, per_sample_weights=x, mode="sum") for v, ix, x in zip(values, lib, w)],
            dev, reps=20)
        print(f"fused_gather_combine_grouped {what}: device ms per request: grouped "
              f"{grouped[0]} (per call {grouped[1]}), {len(lengths)} single launches "
              f"{single[0]} (per call {single[1]}), embedding_bag {library[0]}; byte "
              f"bound {nbytes / HBM_BYTES_PER_S * 1e3:.5f} ms ({nbytes / 1e6:.3f} MB), "
              f"empty launch {floor}")
        del table, values, row_ix, w, lib
    return err


# ------------------------------------------------------------ checkpoint


def write_checkpoint(model, path, live, seed):
    """A full checkpoint in the JAX format, data from numpy: `live` random
    keys per table with random rows, freqs and versions, and the model's
    own (seeded) dense weights. Returns {feature: (keys, values)}."""
    from deeprec_tpu_torch.nn import jax_leaf_names
    from deeprec_tpu_torch.training.checkpoint import table_file, write_full
    from deeprec_tpu_torch.training.trainer import build_bundles

    rng = np.random.default_rng(seed)
    host, files, bundles = {}, {}, {}
    for bname, b in build_bundles(model.features).items():
        bundles[bname] = [f.name for f in b.features]
        for k, f in enumerate(b.features):
            keys = np.unique(rng.integers(0, 1 << 30, 2 * live))[:live]
            keys = rng.permutation(keys).astype(np.int32)
            values = rng.standard_normal((live, b.table.cfg.dim), np.float32) * 0.05
            host[f.name] = (keys, values)
            files[table_file(bname, k if b.stacked else None)] = {
                "keys": keys, "values": values,
                "freqs": rng.integers(1, 100, live).astype(np.int32),
                "versions": rng.integers(0, 1000, live).astype(np.int32),
            }
    params = dict(model.named_parameters())
    leaves = [params[n].detach().numpy() for n in jax_leaf_names(model)]
    write_full(os.path.join(path, "full-1000"), 1000, files, leaves, bundles)
    return host


def make_batch(model, host, B, rng):
    """Ids 90% live, 5% never seen (>= 2^30, outside every key range), 5%
    pad (-1); dense features lognormal like Criteo counts."""
    batch = {}
    for f in model.features:
        if f.name in host:
            keys = host[f.name][0]
            ids = keys[rng.integers(0, len(keys), B)]
            u = rng.random(B)
            ids = np.where(u < 0.10, rng.integers(1 << 30, (1 << 31) - 1, B), ids)
            batch[f.name] = np.where(u < 0.05, -1, ids).astype(np.int32)
        else:
            batch[f.name] = rng.lognormal(0, 1, (B, f.width)).astype(np.float32)
    return batch


def check_rows(p, host, batch):
    """Through forward_views: live ids return their checkpoint row bit for
    bit; unseen and pad ids the blocked default. Returns the count of live
    positions checked."""
    dflt = p.model.features[0].table.ev.init.default_value_no_permission
    views, _ = p._trainer.forward_views(p._snap.state, p._device_batch(batch))
    checked = 0
    for name, (keys, values) in host.items():
        emb, inv, _ = views[name]
        got = emb[inv[:, 0].long()].float().cpu().numpy()
        ids = batch[name]
        order = np.argsort(keys)
        pos = np.searchsorted(keys[order], ids)
        pos = order[np.clip(pos, 0, len(keys) - 1)]
        live = keys[pos] == ids
        if not np.array_equal(got[live], values[pos[live]]):
            raise AssertionError(f"{name}: a live id did not return its checkpoint row")
        if not np.all(got[~live] == dflt):
            raise AssertionError(f"{name}: an unseen or pad id did not serve the default")
        checked += int(live.sum())
    return checked


def _per_request(trainer):
    """Launches of (gather_rows, fused_gather_combine) one read-only forward
    implies: a gather per lookup group (a stacked bundle at once, a shared
    table per feature) and a #4 launch per group of pooled features whose
    rows share dtype and width (GROUP_CAPACITY features a launch)."""
    from deeprec_tpu_torch.ops.fused_lookup import GROUP_CAPACITY

    groups = collections.Counter((b.table.cfg.value_dtype, b.table.cfg.dim)
                                 for b in trainer.bundles.values()
                                 for f in b.features if f.pooling != "none")
    return (sum(1 if b.stacked else len(b.features) for b in trainer.bundles.values()),
            sum(-(-n // GROUP_CAPACITY) for n in groups.values()))


def serve_phase(dev, model_kw, live, ckdir, seed, batches, timed):
    """Write a checkpoint, restore it through Predictor and answer
    `batches` on the main path, counting kernel launches; then time
    `timed` more requests of the first batch. Returns (predictor, first
    batch, stats, the checkpoint's {feature: (keys, rows)})."""
    from deeprec_tpu_torch.ops.fused_lookup import fused_gather_combine
    from deeprec_tpu_torch.serving import Predictor

    model = _dlrm_dcn(seed, **model_kw)
    t0 = time.perf_counter()
    host = write_checkpoint(model, ckdir, live, seed)
    write_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    p = Predictor(model, ckdir, device=dev)
    _sync(dev)
    restore_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 1)
    reqs = [make_batch(model, host, B, rng) for B in batches]

    tables = [b.table for b in p._trainer.bundles.values()]
    _zero_row_counts()  # the main path starts here
    fused_gather_combine.launches = 0
    for t in tables:
        t.probe_syncs = 0
    for b in reqs:
        probs = p.predict(b)
        n = len(next(iter(b.values())))
        if probs.shape != (n,) or not np.all(np.isfinite(probs)) or not (
                np.all(probs > 0) and np.all(probs < 1)):
            raise AssertionError(f"batch {n}: probabilities not finite in (0, 1)")
    launches = _row_counts()[1]  # ... and ends here
    combines = fused_gather_combine.launches
    probe_syncs = sum(t.probe_syncs for t in tables) / len(reqs)
    per_request, groups_per_request = _per_request(p._trainer)
    if dev.type == "cuda" and (launches, combines) != (per_request * len(reqs),
                                                       groups_per_request * len(reqs)):
        raise AssertionError(
            f"(gather_rows, fused_gather_combine) launched {(launches, combines)} "
            f"times on the main path, the path implies "
            f"{(per_request * len(reqs), groups_per_request * len(reqs))}")
    live_checked = check_rows(p, host, reqs[0])

    lat = []
    for _ in range(timed):
        t0 = time.perf_counter()
        p.predict(reqs[0])
        lat.append((time.perf_counter() - t0) * 1e3)
    stats = {
        "write_s": write_s, "restore_s": restore_s, "launches": launches,
        "combine_launches": combines, "combine_per_request": groups_per_request,
        "requests": len(reqs), "launches_per_request": per_request,
        "live_ids_checked": live_checked, "probe_syncs": probe_syncs,
        "p50_ms": float(np.percentile(lat, 50)) if lat else None,
        "p90_ms": float(np.percentile(lat, 90)) if lat else None,
        "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                    if dev.type == "cuda" else None),
    }
    return p, reqs[0], stats, host


def profile_device(fn, reps):
    """Device kernel time by name over `reps` calls of fn() and the wall
    time they took. The first profiled window (CUPTI start-up) is
    discarded. Returns (wall_us per call, busy_us per call, kernels per
    call, [(device us per call, name, count per call)] by time, {phase
    range: (host us per call, device us per call)} of the `phase_*`
    ranges and of the autograd engine's backward)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for n in (1, reps):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    # A `phase_*` range appears twice: its host range (device type CPU,
    # whose device time sums the kernels launched inside it) and its span
    # on the device timeline, which is no kernel and is left out of the
    # busy time.
    rows = sorted((
        (e.self_device_time_total / reps, e.key, e.count // reps)
        for e in events
        if getattr(e, "device_type", None) == DeviceType.CUDA
        and not e.key.startswith("phase_")
    ), reverse=True)
    busy = sum(r[0] for r in rows)
    host = [e for e in events if getattr(e, "device_type", None) == DeviceType.CPU]
    phases = {e.key: (e.cpu_time_total / reps, e.device_time_total / reps)
              for e in host if e.key.startswith("phase_")}
    # The backward's kernels are launched by autograd's engine thread, so
    # they fall outside the main thread's `phase_dense_fwd_bwd` range.
    bwd = [e for e in host if e.key.startswith("autograd::engine::evaluate_function")]
    if bwd:
        phases["autograd_engine_backward"] = (
            sum(e.cpu_time_total for e in bwd) / reps,
            sum(e.device_time_total for e in bwd) / reps)
    return wall_us / reps, busy, sum(r[2] for r in rows), rows, phases


def print_train_profile(what, reps, prof, step_ms):
    """The `profile:` lines of `reps` profiled train steps (profile_device's
    result): the step's wall and device-busy time, its idle share, kernels
    per step, each phase range's host and device time and the kernels that
    take the most device time."""
    wall, busy, kernels, rows, phases = prof
    print(f"profile: {reps} {what}: wall {wall / 1e3:.3f} ms/step, device busy "
          f"{busy / 1e3:.3f} ms/step, idle share {1 - busy / wall:.3f} (of the timed "
          f"step {1 - busy / 1e3 / step_ms:.3f}), {kernels} kernels/step")
    for name, (host_us, dev_us) in phases.items():
        print(f"profile:   {name:24s} host {host_us / 1e3:8.3f} ms/step, "
              f"device {dev_us / 1e3:8.3f} ms/step")
    for dt, key, count in rows[:14]:
        print(f"profile:   {dt:10.1f} us/step  x{count:<4d} {key[:100]}")


def profile_predict(p, batch, p50_ms, reps=5):
    """The share of wall time the device was idle over `reps` predicts: of
    the profiled wall time, and of the unprofiled p50 latency (the
    profiler slows the host, not the device)."""
    wall, busy, kernels, rows, _ = profile_device(lambda: p.predict(batch), reps)
    print(f"profile: {reps} predicts of batch {len(next(iter(batch.values())))}: "
          f"wall {wall / 1e3:.3f} ms/request, device busy "
          f"{busy / 1e3:.3f} ms/request, idle share "
          f"{1 - busy / wall:.3f} (of the p50 latency "
          f"{1 - busy / 1e3 / p50_ms:.3f}), {kernels} kernels/request")
    for dt, key, count in rows[:12]:
        print(f"profile:   {dt:10.1f} us/request  x{count:<4d} {key[:100]}")


# ------------------------------------------------------------ multi-hot serving

# Multi-hot requests to phase 4's Predictor: each of the 26 features gets
# bags of its MLPerf DLRM-DCNv2 `multi_hot_sizes` length (MULTI_HOT), padded
# with -1 to the longest, L = 100 (one stacked bundle needs one id shape);
# 5 requests of batch 2048, one of 1 and one of 37, 10 timed.
MULTI = dict(batch=2048, requests=5, timed=10, check_bags=64, profiled=3)


def make_multi_hot(model, host, B, rng, lengths=None):
    """[B, max(lengths)] ids per feature: within the feature's real length
    the ids of make_batch (90 % live, 5 % never seen, 5 % pad), -1 past it;
    dense features lognormal."""
    lengths = MULTI_HOT if lengths is None else lengths
    L, lengths = max(lengths), iter(lengths)
    batch = {}
    for f in model.features:
        if f.name not in host:
            batch[f.name] = rng.lognormal(0, 1, (B, f.width)).astype(np.float32)
            continue
        keys = host[f.name][0]
        ids = keys[rng.integers(0, len(keys), (B, L))]
        u = rng.random((B, L))
        ids = np.where(u < 0.10, rng.integers(1 << 30, (1 << 31) - 1, (B, L)), ids)
        ids = np.where(u < 0.05, -1, ids)
        real = np.arange(L)[None, :] < next(lengths)
        batch[f.name] = np.where(real, ids, -1).astype(np.int32)
    return batch


def check_pooled(p, host, batch, nbags):
    """The read-only forward's pooled inputs of the first `nbags` bags of
    every feature against numpy: the checkpoint row of each live id, the
    blocked default of an unseen one, pads skipped, summed in position order
    in f32 as out = out + w * row with w = 1/max(n, 1) (mean). Bit for bit.
    Returns the count of bags checked."""
    dflt = np.float32(p.model.features[0].table.ev.init.default_value_no_permission)
    trainer = p._trainer
    dbatch = p._device_batch(batch)
    views, _ = trainer.forward_views(p._snap.state, dbatch)
    inputs = trainer._build_inputs({n: v[0] for n, v in views.items()}, views, dbatch,
                                   read_only=True)
    checked = 0
    for name, (keys, values) in host.items():
        ids = batch[name][:nbags]
        order = np.argsort(keys)
        pos = order[np.clip(np.searchsorted(keys[order], ids), 0, len(keys) - 1)]
        rows = np.where((keys[pos] == ids)[..., None], values[pos], dflt)
        real = ids != -1
        w = np.float32(1) / np.maximum(real.sum(1), 1).astype(np.float32)
        want = np.zeros((len(ids), values.shape[1]), np.float32)
        for pos_l in range(ids.shape[1]):
            want = np.where(real[:, pos_l, None], want + w[:, None] * rows[:, pos_l], want)
        got = inputs.pooled[name][:nbags].cpu().numpy()
        if not np.array_equal(got, want):
            raise AssertionError(f"{name}: pooled bags differ from numpy by "
                                 f"{np.abs(got - want).max()}")
        checked += len(ids)
    return checked, views


def multi_hot_phase(dev, p, host, seed, cfg=MULTI):
    """Multi-hot serving at full width on phase 4's Predictor (see MULTI).
    Returns stats."""
    from deeprec_tpu_torch.ops.fused_lookup import fused_gather_combine

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 41)
    B = cfg["batch"]
    reqs = [make_multi_hot(p.model, host, B, rng) for _ in range(cfg["requests"])]
    extra = make_multi_hot(p.model, host, 37, rng)
    reqs += [{k: a[:1] for k, a in reqs[0].items()}, extra]
    trainer = p._trainer
    _zero_row_counts()  # the main path starts here
    fused_gather_combine.launches = 0
    for b in reqs:
        probs = p.predict(b)
        n = len(next(iter(b.values())))
        if probs.shape != (n,) or not (np.all(np.isfinite(probs)) and np.all(probs > 0)
                                       and np.all(probs < 1)):
            raise AssertionError(f"multi-hot batch {n}: probabilities not finite in (0, 1)")
    launches = (_row_counts()[1], fused_gather_combine.launches)  # ... and ends here
    per_request = _per_request(trainer)
    want = tuple(len(reqs) * n for n in per_request)
    if dev.type == "cuda" and launches != want:
        raise AssertionError(f"multi-hot serving launched (gather_rows, "
                             f"fused_gather_combine) {launches}, the path implies {want}")
    checked, views = check_pooled(p, host, reqs[0], cfg["check_bags"])
    # main shape (b): the L = 100 feature's unique rows and inverse
    name = f"C{MULTI_HOT.index(max(MULTI_HOT)) + 1}"
    emb, inv, mask = views[name]
    row_ix = torch.where(mask, inv.to(torch.int32), -1)
    err = compare_combine(emb, row_ix, combine_weights(row_ix, "mean"),
                          f"serving shape {name}: rows {tuple(emb.shape)}, "
                          f"bags {tuple(row_ix.shape)}")
    real = int((row_ix >= 0).sum())
    del views, emb, inv, mask, row_ix
    lat = []
    for _ in range(cfg["timed"]):
        t1 = time.perf_counter()
        p.predict(reqs[0])
        lat.append((time.perf_counter() - t1) * 1e3)
    stats = {"launches": launches, "per_request": per_request, "requests": len(reqs),
             "bags_checked": checked, "err": err, "ids": real,
             "p50_ms": float(np.percentile(lat, 50)),
             "p90_ms": float(np.percentile(lat, 90))}
    if dev.type == "cuda":
        wall, busy, kernels, rows, _ = profile_device(lambda: p.predict(reqs[0]),
                                                      cfg["profiled"])
        combine_us = sum(r[0] for r in rows if "gather_combine_kernel" in r[1])
        stats["profile"] = (wall, busy, kernels, rows, combine_us)
    stats["seconds"] = time.perf_counter() - t0
    return stats


# ------------------------------------------------------------ training


def _table_rows(ts, t, slots):
    """(values rows, accum rows) of table t at `slots`, copied."""
    return (ts.values[t, slots].clone(), ts.slots["accum"][t, slots].clone())


def _untouched_sample(trainer, state, batch, n, gen):
    """Per table (each member of a stacked bundle; a shared table once, for
    all its features): up to `n` resident slots whose key the batch does
    not hold, with their key, value and accum rows."""
    out = []
    for bname, b in trainer.bundles.items():
        ts = state.tables[bname]
        sentinel = torch.iinfo(ts.keys.dtype).min
        members = (list(enumerate([f] for f in b.features)) if b.stacked
                   else [(0, b.features)])
        for t, feats in members:
            ids = torch.cat([batch[f.name].flatten() for f in feats]).to(ts.keys.dtype)
            live = torch.nonzero(ts.keys[t] != sentinel).flatten()
            keep = live[~torch.isin(ts.keys[t, live], ids)]
            pick = keep[torch.randperm(keep.numel(), generator=gen)[:n].to(keep.device)]
            out.append((bname, t, pick, ts.keys[t, pick].clone(),
                        *_table_rows(ts, t, pick)))
    return out


def _check_untouched(state, sample):
    for bname, t, pick, keys, values, accum in sample:
        ts = state.tables[bname]
        now = _table_rows(ts, t, pick)
        if not (torch.equal(ts.keys[t, pick], keys) and torch.equal(now[0], values)
                and torch.equal(now[1], accum)):
            raise AssertionError(
                f"{bname}[{t}]: a row the step's batch does not hold changed")
    return sum(s[2].numel() for s in sample)


def _path_launches(trainer):
    """Launches of (apply_rows_sr, gather_rows) one train step implies:
    per lookup group, the initializer scatter, the value write-back and one
    write-back per per-row slot; the forward gather, one gather per per-row
    slot, and a value re-gather where the apply cannot reuse the lookup's
    rows (shared tables)."""
    from deeprec_tpu_torch.optim.sparse import SCALAR_PREFIX

    nslots = sum(1 for name in trainer.sparse_opt.slot_specs(1)
                 if not name.startswith(SCALAR_PREFIX))
    apply = gather = 0
    for b in trainer.bundles.values():
        groups = 1 if b.stacked else len(b.features)
        reuse = b.stacked or len(b.features) == 1
        apply += groups * (2 + nslots)
        gather += groups * (1 + nslots + (0 if reuse else 1))
    return apply, gather


def train_phase(dev, model_kw, ckdir, seed, cfg):
    """The training main path at full width (see the module docstring).
    Returns stats."""
    from deeprec_tpu_torch.data import SyntheticCriteo
    from deeprec_tpu_torch.optim import Adagrad, adam
    from deeprec_tpu_torch.serving import Predictor
    from deeprec_tpu_torch.training.checkpoint import CheckpointManager
    from deeprec_tpu_torch.training.trainer import Trainer

    model = _dlrm_dcn(seed, **model_kw)
    trainer = Trainer(model, Adagrad(lr=cfg["lr"]), adam(cfg["dense_lr"]), device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = trainer.init()
    _sync(dev)
    init_s = time.perf_counter() - t0
    # the profiler discards its first window: one more batch for it
    nsteps = cfg["checked"] + cfg["timed"] + cfg["profiled"] + 1
    gen = SyntheticCriteo(batch_size=cfg["batch"], vocab=cfg["vocab"], seed=seed,
                          num_cat=model.num_cat, num_dense=model.num_dense)
    host = [gen.batch() for _ in range(nsteps)]
    staged = [trainer.device_batch(b) for b in host]  # inputs on the device
    _sync(dev)
    tables = [b.table for b in trainer.bundles.values()]
    cpu_gen = torch.Generator().manual_seed(seed)

    _zero_row_counts()  # the main path starts here
    for t in tables:
        t.probe_syncs = 0
    losses, untouched = [], 0
    for i in range(cfg["checked"]):
        sample = (_untouched_sample(trainer, state, staged[i], cfg["sample"], cpu_gen)
                  if i else [])
        state, m = trainer.train_step(state, staged[i])
        losses.append(float(m["loss"]))
        untouched += _check_untouched(state, sample)
    launches = _row_counts()  # ... and ends here
    probe_syncs = sum(t.probe_syncs for t in tables) / cfg["checked"]
    per_step = _path_launches(trainer)
    if dev.type == "cuda" and launches != tuple(cfg["checked"] * n for n in per_step):
        raise AssertionError(
            f"train path launched (apply_rows_sr, gather_rows) {launches}, the "
            f"bundles imply {tuple(cfg['checked'] * n for n in per_step)}")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    fails = sum(int(ts.insert_fails.sum()) for ts in state.tables.values())
    if fails:
        raise AssertionError(f"{fails} ids failed to insert")
    for bname, b in trainer.bundles.items():
        size = b.table.size(state.tables[bname]).cpu().numpy()
        want = [len(np.unique(np.concatenate([h[f.name] for h in host[:cfg["checked"]]])))
                for f in b.features]
        if not np.array_equal(size, want):
            raise AssertionError(f"{bname}: table sizes {size}, distinct ids {want}")

    _sync(dev)
    t0 = time.perf_counter()
    for i in range(cfg["checked"], cfg["checked"] + cfg["timed"]):
        state, m = trainer.train_step(state, staged[i])
    _sync(dev)
    timed_s = time.perf_counter() - t0
    losses.append(float(m["loss"]))
    stats = {
        "init_s": init_s, "losses": losses, "launches": launches,
        "per_step": per_step, "probe_syncs_per_step": probe_syncs,
        "untouched_rows_checked": untouched,
        "examples_per_s": cfg["timed"] * cfg["batch"] / timed_s,
        "step_ms": timed_s / cfg["timed"] * 1e3,
        "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                    if dev.type == "cuda" else None),
    }
    if dev.type == "cuda":
        box = [state]
        nxt = iter(staged[cfg["checked"] + cfg["timed"]:])

        def step():
            box[0] = trainer.train_step(box[0], next(nxt))[0]

        stats["profile"] = profile_device(step, cfg["profiled"])
        state = box.pop()

    # the trained rows, served back through a checkpoint and Predictor
    served = {}
    for bname, b in trainer.bundles.items():
        ts = state.tables[bname]
        for t, f in enumerate(b.features):
            live = torch.nonzero(ts.keys[t] != torch.iinfo(ts.keys.dtype).min).flatten()
            pick = live[torch.randperm(live.numel(), generator=cpu_gen)[:cfg["sample"]]
                        .to(live.device)]
            served[f.name] = (ts.keys[t, pick].cpu().numpy(),
                              ts.values[t, pick].float().cpu().numpy())
    t0 = time.perf_counter()
    state, _ = CheckpointManager(ckdir, trainer).save(state)
    stats["save_s"] = time.perf_counter() - t0
    del state, staged, trainer
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    p = Predictor(model, ckdir, device=dev)
    n = min(len(k) for k, _ in served.values())
    rng = np.random.default_rng(seed + 2)
    req = {f.name: rng.lognormal(0, 1, (n, f.width)).astype(np.float32)
           for f in model.features if f.name not in served}
    req.update({name: keys[:n] for name, (keys, _) in served.items()})
    stats["served_checked"] = check_rows(
        p, {name: (k[:n], v[:n]) for name, (k, v) in served.items()}, req)
    return stats


def _copy_table_state(ts, dev):
    """A deep copy of a TableState on `dev`."""
    return type(ts)(**{k: ({n: a.to(dev, copy=True) for n, a in v.items()}
                           if isinstance(v, dict) else None if v is None
                           else v.to(dev, copy=True)) for k, v in vars(ts).items()})


def _copy_state(state, dev):
    """A deep copy of a TrainState on `dev`."""
    import copy

    from deeprec_tpu_torch.optim.dense import AdamState

    out = copy.copy(state)
    out.tables = {b: _copy_table_state(ts, dev) for b, ts in state.tables.items()}
    out.dense = {n: p.to(dev, copy=True) for n, p in state.dense.items()}
    o = state.opt_state
    out.opt_state = AdamState(
        count=o.count.to(dev, copy=True),
        mu={n: a.to(dev, copy=True) for n, a in o.mu.items()},
        nu={n: a.to(dev, copy=True) for n, a in o.nu.items()})
    return out


def train_agreement(dev, model, gen, cfg, steps=3, step=None):
    """One initial state of `model` made on the CPU and copied to `dev`;
    `steps` train steps on each, on batches of `gen` (`step(trainer, state,
    batch)` -> (state, metrics), default `train_step`); returns (max loss
    relative difference, max row difference, max dense difference, rows
    compared)."""
    from deeprec_tpu_torch.optim import Adagrad, adam
    from deeprec_tpu_torch.training.trainer import Trainer

    trainers = {d: Trainer(model, Adagrad(lr=cfg["lr"]), adam(cfg["dense_lr"]), device=d)
                for d in ("cpu", dev)}
    states = {"cpu": trainers["cpu"].init()}
    states[dev] = _copy_state(states["cpu"], dev)
    loss_diff = 0.0
    for _ in range(steps):
        b = gen.batch()
        ls = {}
        for d in ("cpu", dev):
            states[d], m = (step or Trainer.train_step)(trainers[d], states[d], b)
            ls[d] = float(m["loss"])
        loss_diff = max(loss_diff, abs(ls[dev] - ls["cpu"]) / abs(ls["cpu"]))
    row_diff, compared = 0.0, 0
    for bname, ts in states["cpu"].tables.items():
        tsd = states[dev].tables[bname]
        for t in range(ts.keys.shape[0]):
            rows = {}
            for side, s in (("cpu", ts), ("dev", tsd)):
                keys = s.keys[t].cpu().numpy()
                live = np.nonzero(keys != np.iinfo(keys.dtype).min)[0]
                v = s.values[t].float().cpu().numpy()[live]
                a = s.slots["accum"][t].cpu().numpy()[live]
                rows[side] = dict(zip(keys[live].tolist(), zip(v, a)))
            if rows["cpu"].keys() != rows["dev"].keys():
                raise AssertionError(f"{bname}[{t}]: card and CPU hold other keys")
            for k, (v, a) in rows["cpu"].items():
                dv, da = rows["dev"][k]
                row_diff = max(row_diff, float(np.abs(dv - v).max()),
                               float(np.abs(da - a).max()))
            compared += len(rows["cpu"])
    dense_diff = max(float((states[dev].dense[n].cpu() - p).abs().max())
                     for n, p in states["cpu"].dense.items())
    return loss_diff, row_diff, dense_diff, compared


def run_training(dev, full, small, ckroot, seed, cfg):
    """Phases 6 and 7. Returns the training stats."""
    st = train_phase(dev, full, os.path.join(ckroot, "train"), seed, cfg)
    apply_n, gather_n = st["launches"]
    losses = st["losses"]
    print(f"training: DLRM-DCN {full} from empty tables (init {st['init_s']:.2f} s), "
          f"batch {cfg['batch']}: {cfg['checked']} checked steps launched "
          f"apply_rows_sr {apply_n} and gather_rows {gather_n} times "
          f"({st['per_step'][0]} and {st['per_step'][1]} per step), "
          f"{st['untouched_rows_checked']} untouched rows unchanged, "
          f"{st['served_checked']} trained ids served back bit for bit "
          f"(checkpoint saved in {st['save_s']:.2f} s)")
    print(f"training: {st['examples_per_s']:.1f} examples/s over {cfg['timed']} "
          f"timed steps ({st['step_ms']:.3f} ms/step); loss step 1 {losses[0]:.6f}, "
          f"step {cfg['checked']} {losses[cfg['checked'] - 1]:.6f}, step "
          f"{cfg['checked'] + cfg['timed']} {losses[-1]:.6f}; peak device memory "
          f"{st['peak_gb']} GB; probe loop {st['probe_syncs_per_step']:.1f} host "
          f"syncs per step")
    if "profile" in st:
        print_train_profile(f"train steps of batch {cfg['batch']}", cfg["profiled"],
                            st["profile"], st["step_ms"])
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    from deeprec_tpu_torch.data import SyntheticCriteo

    model = _dlrm_dcn(seed, **small)
    loss_d, row_d, dense_d, n = train_agreement(
        dev, model, SyntheticCriteo(batch_size=cfg["agree_batch"], vocab=cfg["vocab"],
                                    seed=seed + 3, num_cat=model.num_cat,
                                    num_dense=model.num_dense), cfg)
    print(f"agreement: training at capacity {small['capacity']}, batch "
          f"{cfg['agree_batch']}, 3 steps on {dev.type} vs cpu: loss rel diff "
          f"{loss_d:.3g} (tolerance {TRAIN_RTOL}), max row diff {row_d:.3g} over "
          f"{n} keys (tolerance {ROW_ATOL}), max dense diff {dense_d:.3g} "
          f"(bound {6 * cfg['dense_lr']:.3g})")
    if loss_d > TRAIN_RTOL or row_d > ROW_ATOL or dense_d > 6 * cfg["dense_lr"]:
        raise AssertionError("card and CPU training disagree")
    return st


# ------------------------------------------------------------ fused bag step

# Bag lengths of the 26 categorical features: `multi_hot_sizes` of the
# public MLPerf DLRM-DCNv2 reference (Criteo 1TB multi-hot).
MULTI_HOT = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12,
             100, 27, 10, 3, 1, 1)
FUSED = dict(batch=2048, vocab=1_000_000, zipf=1.2, pad=0.1, checked=5,
             timed=20, lr=0.05, capacity=1 << 20, dim=128, compare=(100, 1))


def bag_groups(lengths):
    """{L: feature indices}: features of one bag length stack into one
    bundle, as the JAX package groups features whose id shapes match."""
    groups = {}
    for i, L in enumerate(lengths):
        groups.setdefault(L, []).append(i)
    return dict(sorted(groups.items()))


def make_bags(rng, groups, cfg, dev):
    """One step's ids per group on `dev`: [T, B, L] int32 zipf ids over
    `vocab`, about `pad` of the positions padded (-1) in multi-hot bags."""
    from deeprec_tpu_torch.data.synthetic import zipf_ids

    out = {}
    for L, members in groups.items():
        ids = zipf_ids(rng, cfg["vocab"], cfg["zipf"], (len(members), cfg["batch"], L))
        if L > 1:
            ids = np.where(rng.random(ids.shape) < cfg["pad"], -1, ids)
        out[L] = torch.from_numpy(ids.astype(np.int32)).to(dev)
    return out


def fused_step(bundles, bags, step, opt):
    """One fused bag step through the public API, per group (the JAX
    package's fused bench, tools/bench_lookup.py): the train lookup
    resolves the keys, row_ix = slot_ix[inverse] where not pad,
    bag_forward, g = out * 0.25 + 1, apply_bag_gradients. Returns {L:
    (row_ix, FusedBags)}."""
    from deeprec_tpu_torch.ops.dedup import resolve_size
    from deeprec_tpu_torch.optim.apply import apply_bag_gradients

    out = {}
    for L, (table, st) in bundles.items():
        ids = bags[L]
        T, B, _ = ids.shape
        look = table.lookup_unique(st, ids, step=step, train=True, pad_value=-1)
        slot = look.slot_ix.gather(1, look.inverse.reshape(T, -1).long())
        row_ix = torch.where(ids != -1, slot.view(T, B, L), -1)
        res = table.bag_forward(st, row_ix, combiner="sum",
                                unique_size=resolve_size(B * L, B * L))
        apply_bag_gradients(table, st, opt, res, res.out * 0.25 + 1.0, row_ix,
                            combiner="sum", step=step)
        out[L] = (row_ix, res)
    return out


def _bag_multisets(res):
    return [sorted(zip(res.uids[t].tolist(), res.counts[t].tolist()))
            for t in range(res.uids.shape[0])]


def _check_bags(kres, pres, what):
    if not torch.equal(kres.overflow, pres.overflow):
        raise AssertionError(f"{what}: overflow {kres.overflow.tolist()} vs "
                             f"{pres.overflow.tolist()}")
    if not torch.equal(kres.out, pres.out):
        raise AssertionError(f"{what}: pooled bags differ from the plain version")
    if _bag_multisets(kres) != _bag_multisets(pres):
        raise AssertionError(f"{what}: uids/counts differ as multisets")


def compare_fused(values, accum, row_ix, opt, step, what):
    """Kernels #6 and #7 against their plain versions on copies: out bit
    for bit, uids/counts as multisets, overflow; then each backward on its
    own copy of (values, accum) from its own forward, the tables compared
    whole (every row id) bit for bit; rows off the batch unchanged.
    Returns the count of rows written."""
    from deeprec_tpu_torch.ops import fused_lookup as fl
    from deeprec_tpu_torch.ops.dedup import resolve_size

    T, B, L = row_ix.shape
    U = resolve_size(B * L, B * L)
    kres = fl.fused_sparse_forward(values, row_ix, combiner="sum", unique_size=U)
    pres = fl.fused_sparse_forward_plain(values, row_ix, combiner="sum", unique_size=U)
    _check_bags(kres, pres, what)
    kv, ka, pv, pa = values.clone(), accum.clone(), values.clone(), accum.clone()
    fl.fused_sparse_backward(kv, {"accum": ka}, kres.out * 0.25 + 1.0, row_ix, kres,
                             opt, combiner="sum", step=step, seed=step)
    fl.fused_sparse_backward_plain(pv, {"accum": pa}, pres.out * 0.25 + 1.0, row_ix,
                                   pres, opt, combiner="sum", step=step, seed=step)
    if not (torch.equal(kv, pv) and torch.equal(ka, pa)):
        raise AssertionError(f"{what}: the backward's rows differ from the plain version")
    changed = (kv != values).any(-1) | (ka != accum).any(-1)  # [T, C]
    touched = torch.zeros_like(changed)
    ok = kres.uids >= 0
    t = torch.arange(T, device=values.device)[:, None].expand_as(ok)
    touched[t[ok], kres.uids[ok].long()] = True
    if bool((changed & ~touched).any()):
        raise AssertionError(f"{what}: a row off the batch changed")
    written = int(touched.sum())
    del kv, ka, pv, pa, changed, touched
    print(f"fused {what}: T={T} B={B} L={L}: out, overflow "
          f"{kres.overflow.tolist()[:3]}, uids/counts and {written} written rows "
          "bit-exact against the plain version; rows off the batch unchanged")
    return written


def tight_budget(values, row_ix, what):
    """A budget of a quarter of the batch's unique rows: equal overflow
    counts, and out-of-budget positions add nothing (the kernel's out equals
    the l-order sum of the budgeted positions' rows)."""
    from deeprec_tpu_torch.ops import fused_lookup as fl
    from deeprec_tpu_torch.ops.dedup import resolve_size

    T, B, L = row_ix.shape
    C = values.shape[1]
    n = int((fl.fused_sparse_forward(values, row_ix, combiner="sum",
                                     unique_size=resolve_size(B * L, B * L)
                                     ).uids >= 0).sum(-1).min())
    U = resolve_size(n // 4, B * L)
    kres = fl.fused_sparse_forward(values, row_ix, combiner="sum", unique_size=U)
    pres = fl.fused_sparse_forward_plain(values, row_ix, combiner="sum", unique_size=U)
    if not torch.equal(kres.overflow, pres.overflow) or int(kres.overflow.min()) <= 0:
        raise AssertionError(f"{what}: tight-budget overflow {kres.overflow.tolist()} "
                             f"vs {pres.overflow.tolist()}")
    t = torch.arange(T, device=values.device)[:, None, None]
    rows = values[t, row_ix.long().clamp(0, C - 1)].float()
    rows = torch.where((kres.inverse > 0)[..., None], rows, 0.0)
    want = torch.zeros_like(kres.out)
    for pos in range(L):
        want = want + rows[:, :, pos]
    if not torch.equal(kres.out, want):
        raise AssertionError(f"{what}: an out-of-budget position reached its bag")
    print(f"fused {what}: budget U={U} of {n} unique rows: overflow "
          f"{kres.overflow.tolist()[:3]} equal in kernel and plain version; "
          "out-of-budget positions add nothing")


def fused_bytes(bundles, last, slot_width):
    """The byte bounds (forward, backward) of one step from the fused
    model's terms (ops/traffic.py fused_sparse_step_traffic(fused=True) of
    the JAX package), summed over tables, with this step's unique rows: ids
    read once per direction, each unique row read once (and written once
    backward, with its slot rows), bags out, gradients in."""
    fwd = bwd = 0
    for L, (table, st) in bundles.items():
        row_ix, res = last[L]
        T, B, _ = row_ix.shape
        N, D = B * L, st.values.shape[2]
        vb = st.values.element_size()
        for u in (res.uids >= 0).sum(-1).tolist():
            fwd += 4 * N + u * D * vb + B * D * 4
            bwd += B * D * 4 + 4 * N + 2 * u * D * vb + 2 * slot_width * 4 * u
    return fwd, bwd


# Device operations per call of #6 (the memset and two launches) and of
# #7 under Adagrad and combiner "sum" (lr's fill, the scalar vector's
# stack, three launches): the most each may issue.
FUSED_OPS = (3, 5)


def device_ops(fn, calls=20):
    """Device operations (kernels, memsets, copies) per call of fn: the
    events torch.profiler records over `calls` calls, divided by `calls` and
    rounded, the larger of two windows (a window can lose an event)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    most = 0
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        most = max(most, sum(e.count for e in prof.key_averages()
                             if getattr(e, "device_type", None) == DeviceType.CUDA))
    return round(most / calls)


def fused_ops_per_call(bundles, last, opt, step, groups):
    """{L: (#6, #7) device operations of one call} at the groups' main-path
    shapes (`device_ops`); fails above FUSED_OPS."""
    from deeprec_tpu_torch.ops import fused_lookup as fl
    from deeprec_tpu_torch.ops.dedup import resolve_size

    out = {}
    for L in groups:
        _, st = bundles[L]
        row_ix, res = last[L]
        N = row_ix.shape[1] * L
        grad = res.out * 0.25 + 1.0
        fwd = device_ops(lambda: fl.fused_sparse_forward(
            st.values, row_ix, combiner="sum", unique_size=resolve_size(N, N)))
        bwd = device_ops(lambda: fl.fused_sparse_backward(
            st.values, st.slots, grad, row_ix, res, opt, combiner="sum", step=step,
            seed=step))
        out[L] = (fwd, bwd)
        print(f"fused L={L}: device operations per call: fused_sparse_forward {fwd} "
              f"(at most {FUSED_OPS[0]}), fused_sparse_backward {bwd} (at most "
              f"{FUSED_OPS[1]})")
        if fwd > FUSED_OPS[0] or bwd > FUSED_OPS[1]:
            raise AssertionError(f"fused L={L}: {fwd} and {bwd} device operations per "
                                 f"call, above {FUSED_OPS}")
    return out


def fused_phase(dev, seed, cfg):
    """The fused bag step at full width (see the module docstring). Returns
    (stats, forward record, backward record)."""
    from deeprec_tpu_torch.config import TableConfig
    from deeprec_tpu_torch.embedding.table import EmbeddingTable
    from deeprec_tpu_torch.ops import fused_lookup as fl
    from deeprec_tpu_torch.ops.dedup import resolve_size
    from deeprec_tpu_torch.optim import Adagrad
    from deeprec_tpu_torch.optim.apply import ensure_slots

    opt = Adagrad(lr=cfg["lr"])
    groups = bag_groups(MULTI_HOT)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    bundles = {}
    for L, members in groups.items():
        table = EmbeddingTable(TableConfig(name=f"bag{L}", dim=cfg["dim"],
                                           capacity=cfg["capacity"]))
        bundles[L] = (table, ensure_slots(table, table.create(len(members), dev), opt))
    rng = np.random.default_rng(seed + 11)
    nsteps = cfg["checked"] + cfg["timed"] + 1
    bags = [make_bags(rng, groups, cfg, dev) for _ in range(nsteps)]
    _sync(dev)

    kernels = (fl.fused_sparse_forward, fl.fused_sparse_backward)
    for k in kernels:  # the main path starts here
        k.launches = 0
    _zero_row_counts()
    for s in range(cfg["checked"]):
        last = fused_step(bundles, bags[s], s, opt)
        for L, (_, res) in last.items():
            if not bool(torch.isfinite(res.out).all()):
                raise AssertionError(f"bag length {L}: non-finite pooled bags")
    launches = [k.launches for k in kernels] + list(_row_counts()[::-1])  # ... and ends here
    want = cfg["checked"] * len(groups)
    if dev.type == "cuda" and launches != [want] * 4:
        raise AssertionError(
            f"fused path launched (forward, backward, gather_rows, apply_rows_sr) "
            f"{launches} times, the {len(groups)} groups imply {want} each")
    for L, (table, st) in bundles.items():
        row_ix, res = last[L]
        ok = res.uids >= 0
        t = torch.arange(ok.shape[0], device=dev)[:, None].expand_as(ok)
        rows = st.values[t[ok], res.uids[ok].long()]
        if not bool(torch.isfinite(rows).all()):
            raise AssertionError(f"bag length {L}: non-finite trained rows")

    _sync(dev)
    t0 = time.perf_counter()
    for s in range(cfg["checked"], cfg["checked"] + cfg["timed"]):
        last = fused_step(bundles, bags[s], s, opt)
    _sync(dev)
    step_ms = (time.perf_counter() - t0) / cfg["timed"] * 1e3
    stats = {"launches": launches, "groups": len(groups), "step_ms": step_ms,
             "examples_per_s": cfg["batch"] / step_ms * 1e3,
             "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                         if dev.type == "cuda" else None)}
    step = cfg["checked"] + cfg["timed"]
    if dev.type == "cuda":
        # the last staged batch, three times (its keys are resident after
        # the first, as in a steady state)
        box = [step]

        def one_step():
            last.update(fused_step(bundles, bags[-1], box[0], opt))
            box[0] += 1

        stats["profile"] = profile_device(one_step, 2)
        step = box[0]

    # kernel and plain version on copies of two groups, one step further
    written = 0
    for L in cfg["compare"]:
        table, st = bundles[L]
        one = fused_step({L: bundles[L]}, {L: bags[-1][L]}, step, opt)
        row_ix = one[L][0]
        written += compare_fused(st.values, st.slots["accum"], row_ix, opt,
                                 step + 1, f"L={L} f32")
        if L == cfg["compare"][0]:
            written += compare_fused(st.values[:1].to(torch.bfloat16),
                                     st.slots["accum"][:1], row_ix[:1], opt,
                                     step + 1, f"L={L} bf16 (table 0)")
            tight_budget(st.values, row_ix, f"L={L} f32")
            # one row in every position: a slot past the CTA's shared memory
            head = torch.full_like(row_ix[:1], int(row_ix[row_ix >= 0][0]))
            written += compare_fused(st.values[:1], st.slots["accum"][:1], head, opt,
                                     step + 1, f"L={L} head-heavy (table 0)")
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    stats["rows_compared"] = written
    if dev.type == "cuda":
        stats["peak_gb_checks"] = torch.cuda.max_memory_allocated() / 1e9

    # per-step device times at the main path's shapes: all groups once
    fwd_b, bwd_b = fused_bytes(bundles, last, cfg["dim"])
    items = [(L, table, st, *last[L]) for L, (table, st) in bundles.items()]
    U = {L: resolve_size(row_ix.shape[1] * L, row_ix.shape[1] * L)
         for L, _, _, row_ix, _ in items}

    def fwd(fn):
        return lambda: [fn(st.values, row_ix, combiner="sum", unique_size=U[L])
                        for L, _, st, row_ix, _ in items]

    lib_args = []
    for L, _, st, row_ix, _ in items:
        T, C, D = st.values.shape
        ok = row_ix >= 0
        flat = (torch.arange(T, device=dev)[:, None, None] * C + row_ix.long())[ok]
        per_bag = ok.sum(-1).flatten()
        offsets = torch.cumsum(per_bag, 0) - per_bag
        lib_args.append((flat, st.values.view(T * C, D), offsets))

    def library():
        return [torch.nn.functional.embedding_bag(i, w, o, mode="sum")
                for i, w, o in lib_args]

    grads = {L: res.out * 0.25 + 1.0 for L, _, _, _, res in items}

    def bwd(fn):
        return lambda: [fn(st.values, st.slots, grads[L], row_ix, res, opt,
                           combiner="sum", step=step, seed=step)
                        for L, _, st, row_ix, res in items]

    f_rec = {
        "name": "fused_sparse_forward", "route": "cuda",
        "source": "deeprec_tpu_torch/csrc/fused_sparse_forward.cu",
        "replaces": "deeprec_tpu/ops/fused_lookup.py:778",
        "launches": launches[0], "max_abs_err": 0.0,
        "bound_ms": fwd_b / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
    }
    b_rec = {
        "name": "fused_sparse_backward", "route": "cuda",
        "source": "deeprec_tpu_torch/csrc/fused_sparse_backward.cu",
        "replaces": "deeprec_tpu/ops/fused_lookup.py:1028",
        "launches": launches[1], "max_abs_err": 0.0,
        "bound_ms": bwd_b / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
    }
    if dev.type == "cuda":
        stats["ops_per_call"] = fused_ops_per_call(bundles, last, opt, step, cfg["compare"])
    _timed_record(f_rec, f"fused_sparse_forward ({len(items)} groups, per step)",
                  _ms(fwd(fl.fused_sparse_forward), dev, reps=10),
                  _ms(fwd(fl.fused_sparse_forward_plain), dev, reps=2, warm=1),
                  _ms(library, dev, reps=10))
    _timed_record(b_rec, f"fused_sparse_backward ({len(items)} groups, per step)",
                  _ms(bwd(fl.fused_sparse_backward), dev, reps=10),
                  _ms(bwd(fl.fused_sparse_backward_plain), dev, reps=1, warm=1),
                  (None, None))
    stats["bytes"] = (fwd_b, bwd_b)
    return stats, f_rec, b_rec


def budget_phase(dev, model_kw, seed, cfg, steps=5):
    """DLRM-DCN trained with Trainer(unique_budget="auto"): `steps` steps at
    U = N through the hash engine, update_budgets, `steps` steps at the
    measured budget. Returns stats; fails on overflow or a launch count
    the path does not imply."""
    from deeprec_tpu_torch.data import SyntheticCriteo
    from deeprec_tpu_torch.ops.dedup import hash_dedup
    from deeprec_tpu_torch.optim import Adagrad, adam
    from deeprec_tpu_torch.training.trainer import Trainer

    model = _dlrm_dcn(seed, **model_kw)
    trainer = Trainer(model, Adagrad(lr=cfg["lr"]), adam(cfg["dense_lr"]), device=dev,
                      unique_budget="auto")
    state = trainer.init()
    gen = SyntheticCriteo(batch_size=cfg["batch"], vocab=cfg["vocab"], seed=seed + 5,
                          num_cat=model.num_cat, num_dense=model.num_dense)
    staged = [trainer.device_batch(gen.batch()) for _ in range(2 * steps)]
    ids = staged[0][trainer.sparse_specs[0].name][None, :, None]
    sizes = {}
    _zero_row_counts()  # the main path starts here
    hash_dedup.probe_syncs = 0
    losses = []
    for i in range(2 * steps):
        if i == steps:
            state, report = trainer.update_budgets(state)
        for b in trainer.bundles.values():
            sizes.setdefault(b.name, []).append(trainer._budget_for_lookup(b, ids, True))
        state, m = trainer.train_step(state, staged[i])
        losses.append(float(m["loss"]))
    launches = _row_counts()  # ... and ends here
    syncs = hash_dedup.probe_syncs / (2 * steps)
    per_step = _path_launches(trainer)
    if dev.type == "cuda" and launches != tuple(2 * steps * n for n in per_step):
        raise AssertionError(
            f"budgeted path launched (apply_rows_sr, gather_rows) {launches}, "
            f"the bundles imply {tuple(2 * steps * n for n in per_step)}")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"non-finite budgeted training loss: {losses}")
    stats = trainer.dedup_stats(state)
    overflow = sum(r["dedup_overflow"] for r in stats.values()) + sum(
        r["dedup_overflow"] for r in report.values())
    if overflow:
        raise AssertionError(f"{overflow} ids overflowed the auto budget")
    for name, s in sizes.items():
        if not s[steps] < s[0]:
            raise AssertionError(f"{name}: the auto budget did not engage ({s})")
    return {"launches": launches, "losses": losses, "report": report,
            "probe_syncs_per_step": syncs,
            "sizes": {k: (v[0], v[-1]) for k, v in sizes.items()},
            "unique_fraction": {k: r["unique_fraction"] for k, r in stats.items()}}


# ------------------------------------------------------------ flash attention and BST

PEAK_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores (data sheet)
# Flash kernels against their plain versions on the card: expf is not
# torch.exp and the sums run in another order, so they are not bit-exact.
# o and lse within 1e-5 * max(1, |plain|); dq, dk and dv within 1e-4 of the
# tensor's largest |plain| gradient.
FLASH_FWD_RTOL, FLASH_GRAD_TOL = 1e-5, 1e-4
# (B, H, Lq, S, D, causal, block_q, block_k, mask), besides BST's own
# shape: tests/test_attention.py's [2, 2, 256, 32] at blocks 64 and 128;
# rows that see no real key (mask "dead"); a head width of 64; a width the
# kernels pad; a scattered mask (about 40 % real at random, so real keys
# are no prefix: the kernels list each batch row's real keys). Mask None:
# lengths in [S/2, S].
FLASH_SHAPES = [
    (2, 2, 256, 256, 32, False, 64, 64, None),
    (2, 2, 256, 256, 32, True, 64, 64, None),
    (2, 2, 256, 256, 32, False, 128, 128, None),
    (2, 2, 256, 256, 32, True, 128, 128, None),
    (4, 2, 256, 256, 16, False, 64, 64, "dead"),
    (4, 2, 256, 256, 16, True, 64, 64, "dead"),
    (64, 4, 256, 256, 64, False, 128, 128, None),
    (2, 3, 128, 384, 12, True, 64, 128, None),
    (4, 2, 256, 256, 8, False, 128, 128, "scattered"),
]
# bf16 q, k, v, do (the JAX function takes them; the kernels upcast on load
# and store o, dq, dk, dv in bf16): tests/test_attention.py's shape.
FLASH_BF16_SHAPES = [(2, 2, 256, 256, 32, False, 64, 64, None)]
# BST as modelzoo/bst/train.py runs it (emb 16, capacity 2^20, batch 2048,
# vocab 100,000, Adagrad 0.2, Adam 1e-3; heads 4, ff 128, one block,
# hidden 256-64) with use_flash=True and histories at max_len 200. The
# agreement cell's vocabulary keeps every id of its 3 batches inside
# capacity 2^12.
BST_RUN = dict(emb_dim=16, capacity=1 << 20, heads=4, ff=128, blocks=1, max_len=200,
               hidden=(256, 64), batch=2048, vocab=100_000, seq_len=200, lr=0.2,
               dense_lr=1e-3, checked=5, timed=30, profiled=3, steps=60,
               eval_batches=8, auc_floor=0.60, agree_capacity=1 << 12,
               agree_batch=128, agree_vocab=2000, requests=30, sample=4096)


def _bst(cfg, seed, **over):
    from deeprec_tpu_torch.models import BST

    kw = {k: cfg[k] for k in ("emb_dim", "capacity", "heads", "ff", "blocks",
                              "max_len", "hidden")}
    return BST(**{**kw, **over}, use_flash=True, seed=seed)


def _bf16_ulp(x):
    """One bf16 ulp of each element of x (8 significant bits), 0 at 0."""
    a = x.abs().double()
    e = torch.floor(torch.log2(torch.where(a > 0, a, torch.ones_like(a))))
    return torch.where(a > 0, torch.exp2(e - 7), torch.zeros_like(a))


def _flash_errs(got, want, grad):
    """(max abs error, the measure the tolerance applies to, its
    tolerance): forward tensors by error / max(1, |plain|), gradients by
    error over the largest |plain| gradient. bf16 tensors may differ by one
    more bf16 ulp of the plain value (a sum in another order rounds to the
    neighbour): their measure is the largest error over that widened
    tolerance, held to 1."""
    if want.dtype == torch.bfloat16:
        err = (got.double() - want.double()).abs()
        base = (FLASH_GRAD_TOL * float(want.double().abs().max()) if grad
                else FLASH_FWD_RTOL * torch.clamp(want.double().abs(), min=1.0))
        return float(err.max()), float((err / (base + _bf16_ulp(want))).max()), 1.0
    err = (got - want).abs()
    if grad:
        return float(err.max()), float(err.max()), FLASH_GRAD_TOL * float(want.abs().max())
    rel = float((err / torch.clamp(want.abs(), min=1.0)).max())
    return float(err.max()), rel, FLASH_FWD_RTOL


def compare_flash(q, k, v, mask, do, causal, block_q, block_k, what):
    """Both flash kernels against their plain versions (the backward from
    the plain forward's o and lse); a row that sees no key gets exactly 0
    gradients. Returns {tensor: max abs error}."""
    from deeprec_tpu_torch.ops import flash_attention as fa

    scale = 1.0 / q.shape[-1] ** 0.5
    o, lse = fa.flash_forward(q, k, v, mask, causal, scale, block_q, block_k)
    po, plse = fa.flash_forward_plain(q, k, v, mask, causal, scale, block_q, block_k)
    got = fa.flash_backward(q, k, v, mask, causal, scale, block_q, block_k, po, plse, do)
    want = fa.flash_backward_plain(q, k, v, mask, causal, scale, block_q, block_k,
                                   po, plse, do)
    _sync(q.device)
    errs, parts = {}, []
    for name, a, b, grad in (("o", o, po, False), ("lse", lse, plse, False),
                             ("dq", got[0], want[0], True), ("dk", got[1], want[1], True),
                             ("dv", got[2], want[2], True)):
        err, measure, tol = _flash_errs(a, b, grad)
        if not measure <= tol:
            raise AssertionError(f"flash {what}: {name} off by {measure:.3g} "
                                 f"(tolerance {tol:.3g})")
        errs[name] = err
        parts.append(f"{name} {err:.3g} ({measure:.3g} <= {tol:.3g})")
    dead = ~mask.any(dim=1)
    if bool(dead.any()) and not all(bool((g[dead] == 0).all()) for g in got):
        raise AssertionError(f"flash {what}: a dead row's gradient is not 0")
    print(f"flash {what}: kernel vs plain, max abs err " + ", ".join(parts))
    return errs


def _bst_attention_inputs(cfg, seed, dev):
    """q, k, v, do [B, H, 256, D] normal and the key mask BST's encoder
    gives flash attention: SyntheticBehaviorSequence histories of max_len,
    the always-real target at position max_len, zero padding to 256."""
    from deeprec_tpu_torch.data import SyntheticBehaviorSequence

    B, L = cfg["batch"], cfg["max_len"] + 1
    H, D = cfg["heads"], 2 * cfg["emb_dim"] // cfg["heads"]
    Lp = -(-L // 128) * 128
    hist = SyntheticBehaviorSequence(batch_size=B, vocab=cfg["vocab"],
                                     seq_len=cfg["seq_len"], seed=seed + 21).batch()
    mask = np.zeros((B, Lp), bool)
    mask[:, :cfg["seq_len"]] = hist["hist_items"] != -1
    mask[:, L - 1] = True
    g = torch.Generator(device=dev).manual_seed(seed + 21)
    q, k, v, do = (torch.randn((B, H, Lp, D), generator=g, device=dev) for _ in range(4))
    return q, k, v, torch.from_numpy(mask).to(dev), do


def flash_phase(dev, seed, cfg, shapes):
    """Phase 10: both flash kernels against their plain versions at BST's
    shape and at `shapes`; at BST's shape the device times of the kernels,
    their plain versions and scaled_dot_product_attention (forward, and its
    backward), and the bounds. Returns the two kernel records."""
    from deeprec_tpu_torch.ops import flash_attention as fa

    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(seed + 23)
    errs = []
    for B, H, Lq, S, D, causal, bq, bk, pattern in shapes:
        q = torch.randn((B, H, Lq, D), generator=g, device=dev)
        k, v = (torch.randn((B, H, S, D), generator=g, device=dev) for _ in range(2))
        do = torch.randn((B, H, Lq, D), generator=g, device=dev)
        lengths = torch.randint(S // 2, S + 1, (B,), generator=g, device=dev)
        mask = torch.arange(S, device=dev)[None, :] < lengths[:, None]
        if pattern == "dead":  # batch 0 sees no key; batch 1's first 64 keys are masked
            mask[0] = False
            mask[1, :64] = False
        elif pattern == "scattered":
            mask = torch.rand((B, S), generator=g, device=dev) < 0.4
        label = {"dead": " dead rows", "scattered": " scattered mask"}.get(pattern, "")
        errs.append(compare_flash(q, k, v, mask, do, causal, bq, bk,
                                  f"B={B} H={H} Lq={Lq} S={S} D={D} causal={causal} "
                                  f"blocks {bq}/{bk}{label}"))
    for B, H, Lq, S, D, causal, bq, bk, _ in FLASH_BF16_SHAPES:
        q, k, v, do = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
                       for shape in ((B, H, Lq, D), (B, H, S, D), (B, H, S, D),
                                     (B, H, Lq, D)))
        lengths = torch.randint(S // 2, S + 1, (B,), generator=g, device=dev)
        mask = torch.arange(S, device=dev)[None, :] < lengths[:, None]
        compare_flash(q, k, v, mask, do, causal, bq, bk,
                      f"bf16 B={B} H={H} Lq={Lq} S={S} D={D} causal={causal} "
                      f"blocks {bq}/{bk}")
    q, k, v, mask, do = _bst_attention_inputs(cfg, seed, dev)
    B, H, Lq, D = q.shape
    errs.append(compare_flash(q, k, v, mask, do, False, 128, 128,
                              f"BST B={B} H={H} L={Lq} D={D}"))
    fwd_err = max(max(e["o"], e["lse"]) for e in errs)
    bwd_err = max(max(e["dq"], e["dk"], e["dv"]) for e in errs)

    # bounds, with the key pairs this run's mask needs (masked keys give
    # exactly-zero terms): forward 2 products, backward 5, of 2 D flops each
    scale = 1.0 / D ** 0.5
    pairs = H * Lq * int(mask.sum())
    elem = B * H * Lq * D * 4
    fwd_bytes = 3 * elem + mask.numel() + elem + B * H * Lq * 4
    bwd_bytes = 5 * elem + B * H * Lq * 4 + mask.numel() + 3 * elem

    def bound(ops, nbytes):
        t_ops, t_bytes = ops / PEAK_F32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"

    f_bound, f_by = bound(4 * D * pairs, fwd_bytes)
    b_bound, b_by = bound(10 * D * pairs, bwd_bytes)
    f_rec = {"name": "flash_attention_fwd", "route": "cuda",
             "source": "deeprec_tpu_torch/csrc/flash_attention_fwd.cu",
             "replaces": "deeprec_tpu/ops/flash_attention.py:136",
             "launches": 0, "max_abs_err": fwd_err, "bound_ms": f_bound, "bound_by": f_by}
    b_rec = {"name": "flash_attention_bwd", "route": "cuda",
             "source": "deeprec_tpu_torch/csrc/flash_attention_bwd.cu",
             "replaces": "deeprec_tpu/ops/flash_attention.py:309",
             "launches": 0, "max_abs_err": bwd_err, "bound_ms": b_bound, "bound_by": b_by}
    print(f"flash BST shape [{B}, {H}, {Lq}, {D}]: {int(mask.sum())} real keys of "
          f"{mask.numel()}; bounds forward {f_bound:.5f} ms ({f_by}), backward "
          f"{b_bound:.5f} ms ({b_by}) at {PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s f32, "
          f"{HBM_BYTES_PER_S / 1e12} TB/s")
    o, lse = fa.flash_forward_plain(q, k, v, mask, False, scale, 128, 128)
    am = mask[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    lib_out = sdpa(*leaves, attn_mask=am)
    _timed_record(f_rec, "flash_attention_fwd (BST shape)",
                  _ms(lambda: fa.flash_forward(q, k, v, mask, False, scale, 128, 128),
                      dev, reps=20),
                  _ms(lambda: fa.flash_forward_plain(q, k, v, mask, False, scale, 128, 128),
                      dev, reps=2, warm=1),
                  _ms(lambda: sdpa(q, k, v, attn_mask=am), dev, reps=20))
    _timed_record(b_rec, "flash_attention_bwd (BST shape)",
                  _ms(lambda: fa.flash_backward(q, k, v, mask, False, scale, 128, 128,
                                                o, lse, do), dev, reps=20),
                  _ms(lambda: fa.flash_backward_plain(q, k, v, mask, False, scale, 128,
                                                      128, o, lse, do),
                      dev, reps=2, warm=1),
                  _ms(lambda: torch.autograd.grad(lib_out, leaves, do, retain_graph=True),
                      dev, reps=20))
    del q, k, v, mask, do, o, lse, leaves, lib_out
    return f_rec, b_rec


def _flash_counts():
    from deeprec_tpu_torch.ops import flash_attention as fa

    return (fa.flash_forward.launches, fa.flash_backward.launches_dkdv,
            fa.flash_backward.launches_dq)


def _reset_flash_counts():
    from deeprec_tpu_torch.ops import flash_attention as fa

    fa.flash_forward.launches = 0
    fa.flash_backward.launches_dkdv = fa.flash_backward.launches_dq = 0


def bst_train_phase(dev, seed, cfg):
    """Phase 11: BST with flash attention trained at full width (see the
    module docstring). Returns (trainer, state, stats)."""
    from deeprec_tpu_torch.data import SyntheticBehaviorSequence
    from deeprec_tpu_torch.optim import Adagrad, adam
    from deeprec_tpu_torch.training.trainer import Trainer

    model = _bst(cfg, seed)
    trainer = Trainer(model, Adagrad(lr=cfg["lr"]), adam(cfg["dense_lr"]), device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    state = trainer.init()

    def gen(s):
        return SyntheticBehaviorSequence(batch_size=cfg["batch"], vocab=cfg["vocab"],
                                         seq_len=cfg["seq_len"], seed=s)

    held = gen(seed + 1)
    evals = [trainer.device_batch(held.batch()) for _ in range(cfg["eval_batches"])]
    auc0 = trainer.evaluate(state, evals)["auc"]
    train_gen = gen(seed)
    nsteps = cfg["checked"] + cfg["timed"] + cfg["profiled"] + 1
    host = [train_gen.batch() for _ in range(nsteps)]
    staged = [trainer.device_batch(b) for b in host]
    _sync(dev)
    cpu_gen = torch.Generator().manual_seed(seed)

    _reset_flash_counts()  # the main path starts here
    _zero_row_counts()
    losses, untouched = [], 0
    for i in range(cfg["checked"]):
        sample = (_untouched_sample(trainer, state, staged[i], cfg["sample"], cpu_gen)
                  if i else [])
        state, m = trainer.train_step(state, staged[i])
        losses.append(float(m["loss"]))
        untouched += _check_untouched(state, sample)
    flash = _flash_counts()
    rows = _row_counts()  # ... and ends here
    per_step = _path_launches(trainer)
    n = cfg["checked"]
    if dev.type == "cuda" and (flash != (n, n, n)
                               or rows != tuple(n * c for c in per_step)):
        raise AssertionError(
            f"BST train path launched (flash fwd, dK/dV, dQ) {flash} and "
            f"(apply_rows_sr, gather_rows) {rows}; {n} steps imply {(n, n, n)} and "
            f"{tuple(n * c for c in per_step)}")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"non-finite BST training loss: {losses}")
    fails = sum(int(ts.insert_fails.sum()) for ts in state.tables.values())
    if fails:
        raise AssertionError(f"{fails} ids failed to insert")
    for bname, b in trainer.bundles.items():
        ids = np.concatenate([h[f.name].ravel() for h in host[:n] for f in b.features])
        want = len(np.unique(ids[ids != b.features[0].pad_value]))
        size = int(b.table.size(state.tables[bname]).sum())
        if size != want:
            raise AssertionError(f"{bname}: table size {size}, distinct ids {want}")

    _sync(dev)
    t0 = time.perf_counter()
    for i in range(n, n + cfg["timed"]):
        state, m = trainer.train_step(state, staged[i])
    _sync(dev)
    timed_s = time.perf_counter() - t0
    stats = {"flash": flash, "rows": rows, "per_step": per_step, "losses": losses,
             "untouched": untouched, "step_ms": timed_s / cfg["timed"] * 1e3,
             "examples_per_s": cfg["timed"] * cfg["batch"] / timed_s}
    done = n + cfg["timed"]
    if dev.type == "cuda":
        box = [state]
        nxt = iter(staged[done:])

        def step():
            box[0] = trainer.train_step(box[0], next(nxt))[0]

        stats["profile"] = profile_device(step, cfg["profiled"])
        state = box.pop()
        done += cfg["profiled"] + 1
        stats["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del staged
    stats["rest_from"] = done
    t0 = time.perf_counter()
    for _ in range(done, cfg["steps"]):
        state, m = trainer.train_step(state, train_gen.batch())
    losses.append(float(m["loss"]))
    stats["rest_s"] = time.perf_counter() - t0
    auc = trainer.evaluate(state, evals)["auc"]
    stats.update(auc0=auc0, auc=auc, steps=state.step)
    if not np.isfinite(losses[-1]) or not auc >= cfg["auc_floor"]:
        raise AssertionError(f"BST after {state.step} steps: loss {losses[-1]}, "
                             f"held-out AUC {auc} (floor {cfg['auc_floor']})")
    return trainer, state, stats


def _eval_probs(trainer, state, batch, rows):
    """Trainer.eval_step's probabilities for `batch`, computed at `rows`
    rows (the batch padded by repeating its last row) where rows is set."""
    n = len(next(iter(batch.values())))
    if rows and n < rows:
        batch = {k: np.concatenate([v, np.repeat(v[-1:], rows - n, axis=0)])
                 for k, v in batch.items()}
    return trainer.eval_step(state, batch)[1].cpu().numpy()[:n]


def bst_serve_phase(dev, trainer, state, ckdir, seed, cfg):
    """Phase 12: the trained state saved and served by Predictor: `requests`
    requests of the full batch and one each of batch 1 and 37, every
    answer equal to Trainer.eval_step's on the trained state bit for bit
    (eval_step at the Predictor's `read_rows` rows where it has them: the
    batch padded by repeating its last row, as the card's Predictor pads
    its dense model's input), one flash forward and one #4 launch (user, target_item and target_cat in
    one group) per request. Returns stats."""
    from deeprec_tpu_torch.data import SyntheticBehaviorSequence
    from deeprec_tpu_torch.ops.fused_lookup import fused_gather_combine
    from deeprec_tpu_torch.serving import Predictor
    from deeprec_tpu_torch.training.checkpoint import CheckpointManager

    t0 = time.perf_counter()
    state, _ = CheckpointManager(ckdir, trainer).save(state)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    p = Predictor(trainer.model, ckdir, device=dev)
    _sync(dev)
    restore_s = time.perf_counter() - t0
    gen = SyntheticBehaviorSequence(batch_size=cfg["batch"], vocab=cfg["vocab"],
                                    seq_len=cfg["seq_len"], seed=seed + 2)
    reqs = [gen.batch() for _ in range(cfg["requests"])]
    reqs += [{k: a[:n] for k, a in reqs[0].items()} for n in (1, 37)]
    want = [_eval_probs(trainer, state, b, p.read_rows) for b in reqs]

    _reset_flash_counts()  # the main path starts here
    _zero_row_counts()
    fused_gather_combine.launches = 0
    got, lat = [], []
    for b in reqs:
        t0 = time.perf_counter()
        got.append(p.predict(b))
        lat.append((time.perf_counter() - t0) * 1e3)
    launches = (_flash_counts()[0], _row_counts()[1],
                fused_gather_combine.launches)  # ... and ends here
    per_request, groups_per_request = _per_request(p._trainer)
    want_launches = tuple(len(reqs) * c for c in (1, per_request, groups_per_request))
    if dev.type == "cuda" and launches != want_launches:
        raise AssertionError(
            f"BST serving launched (flash fwd, gather_rows, fused_gather_combine) "
            f"{launches}; {len(reqs)} requests imply {want_launches}")
    for b, g, w in zip(reqs, got, want):
        if g.shape != w.shape or not np.array_equal(g, w):
            raise AssertionError(
                f"BST serving, batch {len(w)}: Predictor differs from eval_step by "
                f"{np.abs(g - w).max() if g.shape == w.shape else g.shape}")
        if not (np.all(np.isfinite(g)) and np.all(g > 0) and np.all(g < 1)):
            raise AssertionError("BST serving: probabilities not finite in (0, 1)")
    full = lat[:cfg["requests"]]
    return {"save_s": save_s, "restore_s": restore_s, "launches": launches,
            "requests": len(reqs), "per_request": per_request,
            "p50_ms": float(np.percentile(full, 50)),
            "p90_ms": float(np.percentile(full, 90))}


@contextlib.contextmanager
def _f32_dense_operands():
    """dense_apply's bf16 operand rounding switched off in the port for the
    duration (the "f32 numerics" of tests/test_torch_bst.py)."""
    from deeprec_tpu_torch import nn as dnn

    rounding = dnn._bf16
    dnn._bf16 = lambda x: x
    try:
        yield
    finally:
        dnn._bf16 = rounding


def bst_agreement(dev, seed, cfg):
    """BST trained on the card and on the CPU from one state at capacity
    2^12 and batch 128 (256 before phase 21). A 1-ulp difference before a
    bf16 operand rounding flips that operand by 2^-8, and Adam's first step
    moves a dense element by about lr whatever the size of its gradient, so
    a flipped sign moves it 2 lr apart; the next steps' embedding gradients
    carry that apart
    (card vs CPU rows 3.6e-3 after 3 steps, with or without flash
    attention). So: in the models' own numerics, 1 step within TRAIN_RTOL
    and ROW_ATOL and 3 steps' losses within TRAIN_RTOL; with dense_apply's
    operands in f32 on both sides, 3 steps within TRAIN_RTOL and ROW_ATOL.
    Dense parameters within 2 lr per step. Returns printable results."""
    from deeprec_tpu_torch.data import SyntheticBehaviorSequence

    def agree(steps):
        model = _bst(cfg, seed, capacity=cfg["agree_capacity"])
        gen = SyntheticBehaviorSequence(batch_size=cfg["agree_batch"],
                                        vocab=cfg["agree_vocab"],
                                        seq_len=cfg["seq_len"], seed=seed + 3)
        return train_agreement(dev, model, gen, cfg, steps=steps)

    out = []
    for numerics, steps, rows_held in (("bf16", 1, True), ("bf16", 3, False),
                                       ("f32", 3, True)):
        if numerics == "f32":
            with _f32_dense_operands():
                loss_d, row_d, dense_d, n = agree(steps)
        else:
            loss_d, row_d, dense_d, n = agree(steps)
        dense_bound = 2 * steps * cfg["dense_lr"] + 1e-6  # + f32 rounding
        line = (f"{numerics} numerics, {steps} step(s): loss rel diff {loss_d:.3g} "
                f"(tolerance {TRAIN_RTOL}), max row diff {row_d:.3g} over {n} keys "
                f"({'tolerance ' + str(ROW_ATOL) if rows_held else 'not held'}), max "
                f"dense diff {dense_d:.3g} (bound {dense_bound:.3g})")
        out.append(line)
        if (loss_d > TRAIN_RTOL or (rows_held and row_d > ROW_ATOL)
                or dense_d > dense_bound):
            raise AssertionError(f"card and CPU BST training disagree: {line}")
    return out


def run_bst(dev, seed, cfg, ckroot):
    """Phases 11 and 12, and the card-vs-CPU BST agreement. Returns
    (training stats, serving stats)."""
    trainer, state, st = bst_train_phase(dev, seed, cfg)
    fl, (apply_n, gather_n) = st["flash"], st["rows"]
    print(f"BST training: emb {cfg['emb_dim']}, 3 tables of {cfg['capacity']} slots "
          f"(two shared), batch {cfg['batch']}, histories of {cfg['seq_len']}: "
          f"{cfg['checked']} checked steps launched flash fwd / dK/dV / dQ {fl}, "
          f"apply_rows_sr {apply_n} and gather_rows {gather_n} "
          f"({st['per_step'][0]} and {st['per_step'][1]} per step); "
          f"{st['untouched']} untouched rows unchanged")
    print(f"BST training: {st['examples_per_s']:.1f} examples/s over {cfg['timed']} "
          f"timed steps ({st['step_ms']:.3f} ms/step); loss step 1 "
          f"{st['losses'][0]:.6f}, step {st['steps']} {st['losses'][-1]:.6f}; held-out "
          f"AUC over {cfg['eval_batches']} batches {st['auc0']:.6f} at step 0, "
          f"{st['auc']:.6f} at step {st['steps']} (floor {cfg['auc_floor']}); peak "
          f"device memory {st.get('peak_gb')} GB; steps {st['rest_from'] + 1}-"
          f"{st['steps']} (batches made on the host) took {st['rest_s']:.1f} s")
    if "profile" in st:
        print_train_profile("BST train steps", cfg["profiled"], st["profile"],
                            st["step_ms"])
    sv = bst_serve_phase(dev, trainer, state, os.path.join(ckroot, "bst"), seed, cfg)
    print(f"BST serving: restored in {sv['restore_s']:.2f} s (saved in "
          f"{sv['save_s']:.2f} s); {sv['requests']} requests launched (flash fwd, "
          f"gather_rows, fused_gather_combine) {sv['launches']} "
          f"({sv['per_request']} gathers per request); "
          f"every answer equal to eval_step's bit for bit; p50 {sv['p50_ms']:.3f} ms, "
          f"p90 {sv['p90_ms']:.3f} ms at batch {cfg['batch']}")
    del trainer, state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    for line in bst_agreement(dev, seed, cfg):
        print(f"agreement: BST at capacity {cfg['agree_capacity']}, batch "
              f"{cfg['agree_batch']}, {dev.type} vs cpu, {line}")
    return st, sv


# ------------------------------------------------------------ the modelzoo

# The modelzoo at its widths (modelzoo/common.py: emb 16, capacity 2^20 per
# table, batch 2048, Adagrad 0.05, Adam 1e-3) and each model's own default
# architecture: WDL, DeepFM, DCN, DCNv2 and MaskNet on
# SyntheticCriteo(vocab=1_000_000); DIN and DIEN on SyntheticBehaviorSequence
# at its default seq_len of 50 over vocab 100,000 with Adagrad 0.2
# (modelzoo/din/train.py, modelzoo/dien/train.py); DSSM on SyntheticTwoTower
# (4 user and 4 item features, vocab 100,000, Adagrad 0.2,
# modelzoo/dssm/train.py); SimpleMultiTask, ESMM, MMoE, PLE and DBMTL on
# SyntheticMultiTask(num_cat=8, num_dense=4, vocab=1_000_000). Each: 5
# checked steps, 20 timed (DIEN then 1 profiled; DSSM and MMoE too before
# phase 20), on to
# `steps` (150, half the modelzoo's 300, so the script keeps to half its time
# limit with phase 16); held-out AUC over 8 batches of another seed at step 0
# and at the end (`auc`, or `auc_ctr` for the multi-task models, against the
# floor); the
# state saved, restored by Predictor and asked 5 requests of batch 2048.
MULTI_TASK = ("SimpleMultiTask", "ESMM", "MMoE", "PLE", "DBMTL")
ZOO = dict(emb_dim=16, capacity=1 << 20, batch=2048, dense_lr=1e-3, checked=5,
           timed=20, steps=150, eval_batches=8, auc_floor=0.60, requests=5,
           profiled=1, profile=("DIEN",),
           criteo=dict(vocab=1_000_000, lr=0.05),
           behavior=dict(vocab=100_000, lr=0.2, seq_len=50),
           two_tower=dict(vocab=100_000, lr=0.2),
           multitask=dict(vocab=1_000_000, lr=0.05),
           models=("WDL", "DeepFM", "DCN", "DCNv2", "MaskNet", "DIN", "DIEN", "DSSM",
                   *MULTI_TASK))


def zoo_model(name, seed, cfg):
    """(model, data generator factory seed -> generator, sparse lr)."""
    from deeprec_tpu_torch import data, models

    model = getattr(models, name)(emb_dim=cfg["emb_dim"], capacity=cfg["capacity"],
                                  seed=seed)
    B = cfg["batch"]
    if name in ("DIN", "DIEN"):
        d = cfg["behavior"]
        return model, (lambda s: data.SyntheticBehaviorSequence(
            batch_size=B, vocab=d["vocab"], seq_len=d["seq_len"], seed=s)), d["lr"]
    if name == "DSSM":
        d = cfg["two_tower"]
        return model, (lambda s: data.SyntheticTwoTower(
            batch_size=B, num_user=len(model.user_feats),
            num_item=len(model.item_feats), vocab=d["vocab"], seed=s)), d["lr"]
    d, cls = ((cfg["multitask"], data.SyntheticMultiTask) if name in MULTI_TASK
              else (cfg["criteo"], data.SyntheticCriteo))
    return model, (lambda s: cls(batch_size=B, vocab=d["vocab"], seed=s,
                                 num_cat=model.num_cat, num_dense=model.num_dense)), \
        d["lr"]


def _by_task(probs):
    """{task: probabilities} of an answer; a single-task model's under the
    task ""."""
    return probs if isinstance(probs, dict) else {"": probs}


def zoo_run(dev, name, seed, cfg, ckdir):
    """One model of the modelzoo phase: trained, evaluated, saved and served
    (see ZOO). Returns stats."""
    from deeprec_tpu_torch.embedding.combiners import pooled_operands
    from deeprec_tpu_torch.ops.fused_lookup import fused_gather_combine
    from deeprec_tpu_torch.optim import Adagrad, adam
    from deeprec_tpu_torch.serving import Predictor
    from deeprec_tpu_torch.training.checkpoint import CheckpointManager
    from deeprec_tpu_torch.training.trainer import Trainer

    t0 = time.perf_counter()
    model, gen, lr = zoo_model(name, seed, cfg)
    auc_key = "auc_ctr" if name in MULTI_TASK else "auc"  # the one held to the floor
    trainer = Trainer(model, Adagrad(lr=lr), adam(cfg["dense_lr"]), device=dev)
    state = trainer.init()
    held = gen(seed + 1)
    evals = [trainer.device_batch(held.batch()) for _ in range(cfg["eval_batches"])]
    aucs0 = trainer.evaluate(state, evals)
    train_gen = gen(seed)
    n = cfg["checked"]
    profiled = cfg["profiled"] if dev.type == "cuda" and name in cfg["profile"] else 0
    staged = [trainer.device_batch(train_gen.batch())
              for _ in range(n + cfg["timed"] + (profiled + 1 if profiled else 0))]
    _sync(dev)

    _zero_row_counts()  # the main path starts here
    losses = []
    for i in range(n):
        state, m = trainer.train_step(state, staged[i])
        losses.append(float(m["loss"]))
    rows = _row_counts()  # ... and ends here
    per_step = _path_launches(trainer)
    if dev.type == "cuda" and rows != tuple(n * c for c in per_step):
        raise AssertionError(f"{name} train path launched (apply_rows_sr, gather_rows) "
                             f"{rows}; {n} steps imply {tuple(n * c for c in per_step)}")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"{name}: non-finite training loss: {losses}")
    fails = sum(int(ts.insert_fails.sum()) for ts in state.tables.values())
    if fails:
        raise AssertionError(f"{name}: {fails} ids failed to insert")
    _sync(dev)
    t1 = time.perf_counter()
    for i in range(n, n + cfg["timed"]):
        state, m = trainer.train_step(state, staged[i])
    _sync(dev)
    timed_s = time.perf_counter() - t1
    done = n + cfg["timed"]
    prof = None
    if profiled:
        box, nxt = [state], iter(staged[done:])

        def step():
            box[0] = trainer.train_step(box[0], next(nxt))[0]

        prof = profile_device(step, profiled)
        state = box.pop()
        done += profiled + 1
    del staged
    for _ in range(done, cfg["steps"]):
        state, m = trainer.train_step(state, train_gen.batch())
    losses.append(float(m["loss"]))
    aucs = trainer.evaluate(state, evals)
    if not np.isfinite(losses[-1]) or not aucs[auc_key] >= cfg["auc_floor"]:
        raise AssertionError(f"{name} after {state.step} steps: loss {losses[-1]}, "
                             f"held-out {auc_key} {aucs[auc_key]} (floor "
                             f"{cfg['auc_floor']})")

    state, _ = CheckpointManager(ckdir, trainer).save(state)
    p = Predictor(model, ckdir, device=dev)
    serve_gen = gen(seed + 2)
    reqs = [serve_gen.batch() for _ in range(cfg["requests"])]
    want = [{t: v.cpu().numpy()
             for t, v in _by_task(trainer.eval_step(state, b)[1]).items()}
            for b in reqs]
    _zero_row_counts()  # the main path starts here
    fused_gather_combine.launches = 0
    got, lat = [], []
    for b in reqs:
        t1 = time.perf_counter()
        got.append(p.predict(b))
        lat.append((time.perf_counter() - t1) * 1e3)
    served = (_row_counts()[1], fused_gather_combine.launches)  # ... and ends here
    per_request = _per_request(trainer)
    if dev.type == "cuda" and served != tuple(len(reqs) * c for c in per_request):
        raise AssertionError(f"{name} serving launched (gather_rows, "
                             f"fused_gather_combine) {served}; {len(reqs)} requests "
                             f"imply {tuple(len(reqs) * c for c in per_request)}")
    for g, w in zip(map(_by_task, got), want):
        if g.keys() != w.keys():
            raise AssertionError(f"{name} serving: tasks {sorted(g)}, eval_step's "
                                 f"{sorted(w)}")
        for t, wt in w.items():
            gt = g[t]
            if gt.shape != wt.shape or not np.array_equal(gt, wt):
                raise AssertionError(f"{name} serving {t!r}: Predictor differs from "
                                     f"eval_step")
            if not (np.all(np.isfinite(gt)) and np.all(gt > 0) and np.all(gt < 1)):
                raise AssertionError(f"{name} serving {t!r}: probabilities not finite "
                                     f"in (0, 1)")
    # #4 at this model's own serving shape: the first pooled feature of the
    # first request, rows [U, emb] and bags [batch, 1]
    f = next(f for f in trainer.sparse_specs if f.pooling != "none")
    views, _ = p._trainer.forward_views(p._snap.state, p._device_batch(reqs[0]))
    emb, inv, mask = views[f.name]
    row_ix, w = pooled_operands(inv, mask, f.pooling)
    err = compare_combine(emb, row_ix, w, f"{name} serving shape {f.name}: rows "
                          f"{tuple(emb.shape)}, bags {tuple(row_ix.shape)}")
    del views, emb, inv, mask, row_ix, w
    stats = {"rows": rows, "per_step": per_step, "served": served, "err": err,
             "per_request": per_request, "losses": losses, "auc_key": auc_key,
             "auc0": aucs0[auc_key], "auc": aucs[auc_key],
             "other_aucs": {k: v for k, v in aucs.items()
                            if k.startswith("auc") and k != auc_key},
             "profile": prof, "steps": state.step,
             "step_ms": timed_s / cfg["timed"] * 1e3,
             "examples_per_s": cfg["timed"] * cfg["batch"] / timed_s,
             "p50_ms": float(np.percentile(lat, 50)),
             "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                         if dev.type == "cuda" else None)}
    del p, trainer, state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    stats["seconds"] = time.perf_counter() - t0
    return stats


def zoo_phase(dev, seed, cfg, ckroot):
    """Every model of ZOO in turn, each model's tables freed before the
    next. Returns {model: stats}."""
    out = {}
    for name in cfg["models"]:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        st = zoo_run(dev, name, seed, cfg, os.path.join(ckroot, f"zoo-{name}"))
        out[name] = st
        print(f"modelzoo {name}: emb {cfg['emb_dim']}, capacity {cfg['capacity']}, "
              f"batch {cfg['batch']}: {cfg['checked']} checked steps launched "
              f"(apply_rows_sr, gather_rows) {st['rows']} ({st['per_step']} per step); "
              f"{st['examples_per_s']:.1f} examples/s over {cfg['timed']} timed steps "
              f"({st['step_ms']:.3f} ms/step); loss step 1 {st['losses'][0]:.6f}, step "
              f"{st['steps']} {st['losses'][-1]:.6f}; held-out {st['auc_key']} "
              f"{st['auc0']:.6f} at step 0, {st['auc']:.6f} at step {st['steps']} "
              f"(floor {cfg['auc_floor']})"
              + "".join(f", {k} {v:.6f}" for k, v in st["other_aucs"].items())
              + f"; served {cfg['requests']} requests equal to eval_step bit for bit"
              f"{' task by task' if name in MULTI_TASK else ''}, (gather_rows, "
              f"fused_gather_combine) launched {st['served']} ({st['per_request']} per "
              f"request), p50 {st['p50_ms']:.3f} ms; peak device memory "
              f"{st['peak_gb']} GB; {st['seconds']:.1f} s")
        if st["profile"] is not None:
            print_train_profile(f"{name} train steps of batch {cfg['batch']}",
                                cfg["profiled"], st["profile"], st["step_ms"])
    return out


# ------------------------------------------------------------ main


# ------------------------------------------------------------ the training loop

# Phase 14: the loop of modelzoo/common.py `run()` on the port. (a) agreement
# on the card at the full widths and 2^12 slots; (b) the loop at MLPerf
# DLRM-DCN widths with bf16 tables, CounterFilter(2) and GlobalStepEvict(200)
# (the options `ev_option` builds from --filter_freq 2 --steps_to_live 200),
# Adagrad 0.05 + Adam 1e-3, batch 2048 of SyntheticCriteo(vocab=10^6): the
# ring of `stage(depth=2)` feeds 40 windows of train_steps(K=8) in
# "lookahead" (20-21 under the profiler; 25-29 in "off" and 35-39 from host
# batches with no staging, each against 30-34: the tables reach their last
# capacity at window 25 in this run, and a fuller table takes more probe
# rounds, each a host sync); evict_tables and maintain(max_capacity 2^20)
# after every 5th window; then train_step_accum(A=4) over 2 windows'
# batches and evaluate on 8 held-out batches. Each table starts at the power
# of two below half the distinct ids it sees in the run, so it has to grow.
LOOP = dict(batch=2048, vocab=1_000_000, K=8, windows=40, every=5, accum_windows=2,
            accum=4, eval_batches=8, filter_freq=2, steps_to_live=200, lr=0.05,
            dense_lr=1e-3, max_capacity=1 << 20, auc_floor=0.60, off_windows=(25, 30),
            raw_windows=(35, 40), profiled=20, agree_batch=256, agree_K=4,
            tiny_vocab=40, budget=64, stage_batch=2048, stage_windows=2,
            cbf=dict(filter_freq=2, max_element_size=1 << 14), cbf_steps=3,
            ttl=1, l2_per_dim=0.0025)


def _retable(model, **cfg):
    """Every table config of `model` with `cfg` replaced: the driver's own
    `_retable` (deeprec_tpu_torch/modelzoo/common.py; bf16 values)."""
    from deeprec_tpu_torch.modelzoo.common import _retable as retable

    return retable(model, **cfg)


def _zoo_args(*flags, model="mlperf"):
    """The driver's flags (deeprec_tpu_torch/modelzoo/common.py
    `build_argparser`, with `model`'s per-model defaults) parsed from
    `flags`: what `python -m deeprec_tpu_torch.modelzoo` would run with."""
    from deeprec_tpu_torch.modelzoo.common import MODELS, build_argparser

    p = build_argparser(model)
    p.set_defaults(model=model, **MODELS[model][1])
    return p.parse_args([str(f) for f in flags])


def _state_diff(a, b):
    """The tensors of two TrainStates that differ in any bit (empty when
    they are the same state)."""
    out = [] if a.step == b.step else ["step"]
    for bname, x in a.tables.items():
        y = b.tables[bname]
        for f in ("keys", "values", "meta", "insert_fails", "dedup_unique", "dedup_ids",
                  "dedup_overflow", "bloom"):
            u, v = getattr(x, f), getattr(y, f)
            if (u is None) != (v is None) or (u is not None and not torch.equal(u, v)):
                out.append(f"{bname}.{f}")
        out += [f"{bname}.{k}" for k in x.slots if not torch.equal(x.slots[k], y.slots[k])]
    out += [n for n in a.dense if not torch.equal(a.dense[n], b.dense[n])]
    oa, ob = a.opt_state, b.opt_state
    out += [] if torch.equal(oa.count, ob.count) else ["count"]
    out += [f"mu.{n}" for n in oa.mu if not torch.equal(oa.mu[n], ob.mu[n])]
    out += [f"nu.{n}" for n in oa.nu if not torch.equal(oa.nu[n], ob.nu[n])]
    return out


def _rows_by_key(ts, t):
    """{key: (value row, accum row, meta column)} of table t, on the host."""
    keys = ts.keys[t].cpu().numpy()
    live = np.nonzero(keys != np.iinfo(keys.dtype).min)[0]
    v = ts.values[t].float().cpu().numpy()[live]
    a = ts.slots["accum"][t].cpu().numpy()[live]
    m = ts.meta[t].cpu().numpy()[:, live].T
    return {int(k): (v[i], a[i], tuple(m[i])) for i, k in enumerate(keys[live])}


def _same_rows(got, want, what):
    """Every key of `want` in `got` with the same rows and metadata, bit
    for bit."""
    if got.keys() != set(want):
        raise AssertionError(f"{what}: {len(got)} keys, want {len(want)}")
    for k, (v, a, m) in want.items():
        gv, ga, gm = got[k]
        if not (np.array_equal(gv, v) and np.array_equal(ga, a) and gm == m):
            raise AssertionError(f"{what}: key {k} changed")
    return len(want)


def loop_agreement(dev, seed, small, cfg, ckdir):
    """Phase 14 (a): the loop's entry points held bit for bit on the card
    (and, for the micro-batched step and the CBF sketch, against the CPU
    port) at the full widths and 2^12 slots. Returns the printed lines."""
    from deeprec_tpu_torch.config import (
        CBFFilter, EmbeddingVariableOption, GlobalStepEvict, L2WeightEvict)
    from deeprec_tpu_torch.data import SyntheticCriteo
    from deeprec_tpu_torch.optim import Adagrad, adam
    from deeprec_tpu_torch.training.checkpoint import CheckpointManager
    from deeprec_tpu_torch.training.trainer import Trainer

    lines = []

    def trainer(model, device=dev, **kw):
        return Trainer(model, Adagrad(lr=cfg["lr"]), adam(cfg["dense_lr"]),
                       device=device, **kw)

    # one build (the initializers run on the host, about 1.5 s a model at
    # these widths), copied per variant: `ev` only reaches the table configs
    base = _dlrm_dcn(seed, **small)

    def model(dtype="float32", ev=EmbeddingVariableOption()):
        return _retable(copy.deepcopy(base), value_dtype=dtype, ev=ev)

    def window(vocab, batch=cfg["agree_batch"], n=cfg["agree_K"], s=0):
        gen = SyntheticCriteo(batch_size=batch, vocab=vocab, seed=seed + 60 + s)
        return [gen.batch() for _ in range(n)]

    def check(what, diff):
        if diff:
            raise AssertionError(f"{what}: differ in {diff[:8]}")
        lines.append(f"{what}: bit for bit")

    def modes(m, batches, **kw):
        """(off window, lookahead window) from one initial state."""
        out = []
        for mode in ("off", "lookahead"):
            t = trainer(m, pipeline_mode=mode, **kw)
            st, mets = t.train_steps(t.init(), batches)
            out.append((st, mets))
        return out

    for dtype in ("float32", "bfloat16"):
        m, batches = model(dtype), window(cfg["vocab"])
        (s_off, m_off), (s_la, m_la) = modes(m, batches)
        t = trainer(m)
        s_seq, seq = t.init(), []
        for b in batches:
            s_seq, mm = t.train_step(s_seq, b)
            seq.append(mm["loss"])
        same_loss = (torch.equal(m_off["loss"], m_la["loss"])
                     and torch.equal(m_off["loss"], torch.stack(seq)))
        check(f"{dtype} tables, K = {cfg['agree_K']}: off, lookahead and "
              f"{cfg['agree_K']} x train_step (losses {m_off['loss'].tolist()})",
              ([] if same_loss else ["loss"]) + _state_diff(s_off, s_la)
              + _state_diff(s_off, s_seq))
    (s_off, m_off), (s_la, m_la) = modes(model(), window(cfg["tiny_vocab"]))
    check(f"tiny vocabulary ({cfg['tiny_vocab']} ids): off and lookahead",
          ([] if torch.equal(m_off["loss"], m_la["loss"]) else ["loss"])
          + _state_diff(s_off, s_la))
    (s_off, m_off), (s_la, m_la) = modes(model(), window(cfg["vocab"], s=1),
                                         unique_budget=cfg["budget"])
    ovf = sum(int(ts.dedup_overflow.sum()) for ts in s_off.tables.values())
    check(f"unique_budget={cfg['budget']} (overflow {ovf}): off and lookahead",
          ([] if torch.equal(m_off["loss"], m_la["loss"]) else ["loss"])
          + _state_diff(s_off, s_la))
    m, batches = model(), window(cfg["vocab"], s=2)
    runs = []
    for remat in (False, True):
        t = trainer(m, remat=remat)
        runs.append(t.train_steps(t.init(), batches))
    check("remat=True and remat=False",
          ([] if torch.equal(runs[0][1]["loss"], runs[1][1]["loss"]) else ["loss"])
          + _state_diff(runs[0][0], runs[1][0]))
    host = window(cfg["vocab"], batch=cfg["stage_batch"],
                  n=cfg["agree_K"] * cfg["stage_windows"], s=3)
    runs = []
    for stage in ("auto", "off"):
        t = trainer(m, stage=stage, pipeline_mode="lookahead")
        st, data, losses = t.init(), iter(t.stage(iter(host))), []
        for _ in range(cfg["stage_windows"]):
            st, mets = t.train_steps(st, [next(data) for _ in range(cfg["agree_K"])])
            losses.append(mets["loss"])
        runs.append((st, torch.cat(losses)))
    check(f"stage='auto' and stage='off', {cfg['stage_windows']} windows of batch "
          f"{cfg['stage_batch']}", ([] if torch.equal(runs[0][1], runs[1][1]) else ["loss"])
          + _state_diff(runs[0][0], runs[1][0]))
    del runs, s_off, s_la, s_seq
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    A = cfg["accum"]
    loss_d, row_d, dense_d, n = train_agreement(
        dev, model(), SyntheticCriteo(batch_size=cfg["agree_batch"], vocab=cfg["vocab"],
                                      seed=seed + 64), cfg, steps=2,
        step=lambda t, st, b: t.train_step_accum(st, b, A))
    lines.append(f"train_step_accum(A={A}), 2 steps of batch {cfg['agree_batch']}, "
                 f"{dev.type} vs cpu: loss rel diff {loss_d:.3g} (tolerance {TRAIN_RTOL}), "
                 f"max row diff {row_d:.3g} over {n} keys (tolerance {ROW_ATOL}), max "
                 f"dense diff {dense_d:.3g} (bound {4 * cfg['dense_lr']:.3g})")
    if loss_d > TRAIN_RTOL or row_d > ROW_ATOL or dense_d > 4 * cfg["dense_lr"]:
        raise AssertionError("micro-batched steps: card and CPU disagree")

    # a CBF table (with TTL and L2 eviction): the sketch, admission and
    # sizes on the card equal the CPU port's; eviction and growth keep every
    # survivor's rows; a checkpoint carries the sketch and the capacity
    ev = EmbeddingVariableOption(cbf_filter=CBFFilter(**cfg["cbf"]),
                                 global_step_evict=GlobalStepEvict(cfg["ttl"]),
                                 l2_weight_evict=L2WeightEvict(
                                     cfg["l2_per_dim"] * small["emb_dim"]))
    m = model(ev=ev)
    tr = {d: trainer(m, device=d) for d in ("cpu", dev)}
    states = {"cpu": tr["cpu"].init()}
    states[dev] = _copy_state(states["cpu"], dev)
    gen = SyntheticCriteo(batch_size=cfg["agree_batch"], vocab=cfg["vocab"], seed=seed + 65)
    for _ in range(cfg["cbf_steps"]):
        b = gen.batch()
        for d in ("cpu", dev):
            states[d], _ = tr[d].train_step(states[d], b)
    st = states[dev]
    (bname, b), = tr[dev].bundles.items()
    ts, tc = st.tables[bname], states["cpu"].tables[bname]
    sizes = b.table.size(ts).cpu()
    if not (torch.equal(ts.bloom.cpu(), tc.bloom) and torch.equal(sizes, b.table.size(tc))
            and all(torch.equal(ts.keys[t].cpu().sort().values, tc.keys[t].sort().values)
                    for t in range(ts.keys.shape[0]))):
        raise AssertionError("CBF table: card and CPU hold other sketches or keys")
    lines.append(f"CBF table ({cfg['cbf_steps']} steps of batch {cfg['agree_batch']}): "
                 f"sketch [{ts.bloom.shape[0]}, {ts.bloom.shape[1]}] "
                 f"(sum {int(ts.bloom.sum())}), admitted keys per table "
                 f"{sizes.min().item()}-{sizes.max().item()}, equal to the CPU's bit for bit")
    T = ts.keys.shape[0]
    before = [_rows_by_key(ts, t) for t in range(T)]
    drop = b.table.evict_mask(ts, st.step)
    dropped = [set(ts.keys[t][drop[t]].tolist()) for t in range(T)]
    st = tr[dev].evict_tables(st)
    survivors = [{k: r for k, r in before[t].items() if k not in dropped[t]}
                 for t in range(T)]
    kept = sum(_same_rows(_rows_by_key(st.tables[bname], t), survivors[t],
                          f"evict_tables, table {t}") for t in range(T))
    n_drop = sum(map(len, dropped))
    if not n_drop or not kept:
        raise AssertionError(f"eviction dropped {n_drop} keys and kept {kept}")
    C = b.table.cfg.capacity
    st, rep = tr[dev].maintain(st, grow_threshold=0.0, max_capacity=4 * C)
    grew = rep[bname].get("grew_to")
    ts = st.tables[bname]
    if grew != 2 * C or ts.keys.shape[1] != grew or b.table.cfg.capacity != grew:
        raise AssertionError(f"maintain did not grow {C} to {2 * C}: {rep}")
    for t in range(T):
        _same_rows(_rows_by_key(ts, t), survivors[t], f"maintain, table {t}")
    st, _ = CheckpointManager(ckdir, tr[dev]).save(st)
    back = CheckpointManager(ckdir, tr[dev]).restore().tables[bname]
    if not (torch.equal(back.bloom, ts.bloom) and back.keys.shape == ts.keys.shape):
        raise AssertionError("the checkpoint lost the sketch or the capacity")
    for t in range(T):  # a restore stamps no dirty flag
        _same_rows({k: (v, a, m[:2]) for k, (v, a, m) in _rows_by_key(back, t).items()},
                   {k: (v, a, m[:2]) for k, (v, a, m) in survivors[t].items()},
                   f"restore, table {t}")
    lines.append(f"CBF table, TTL {cfg['ttl']} and L2 "
                 f"{cfg['l2_per_dim'] * small['emb_dim']}: evict_tables dropped "
                 f"{n_drop} keys and kept {kept} with their rows, slots and metadata bit "
                 f"for bit; maintain grew {C} to {grew} slots keeping them; a checkpoint "
                 f"restored the sketch and the {grew} slots")
    return lines


def _loop_launches(trainer):
    """Launches per train step of (#1 bf16 gathers, #3 f32 gathers, #2 bf16
    scatters, #5 f32 scatters) on bf16 tables: per lookup group the forward
    gather (and a re-gather where the apply cannot reuse it), the
    initializer scatter and the value write-back in bf16; a gather and a
    write-back per per-row optimizer slot, which is f32."""
    from deeprec_tpu_torch.optim.sparse import SCALAR_PREFIX

    nslots = sum(1 for name in trainer.sparse_opt.slot_specs(1)
                 if not name.startswith(SCALAR_PREFIX))
    out = np.zeros(4, np.int64)
    for b in trainer.bundles.values():
        groups = 1 if b.stacked else len(b.features)
        reuse = b.stacked or len(b.features) == 1
        out += groups * np.array([1 + (0 if reuse else 1), nslots, 2, nslots])
    return out


def _launch_counts():
    """(#1, #3, #2, #5, #4) launches since the counts were zeroed."""
    from deeprec_tpu_torch.ops.fused_lookup import (
        apply_rows_sr, fused_gather_combine, gather_rows)

    return np.array([gather_rows.launches_bf16,
                     gather_rows.launches - gather_rows.launches_bf16,
                     apply_rows_sr.launches_bf16,
                     apply_rows_sr.launches - apply_rows_sr.launches_bf16,
                     fused_gather_combine.launches])


def loop_phase(dev, seed, full, cfg):
    """Phase 14 (b): the loop at full width (see LOOP), the model and the
    optimizers made by the driver's `ev_option`, `_retable` and
    `make_optimizers`. Returns stats."""
    from deeprec_tpu_torch.data import SyntheticCriteo
    from deeprec_tpu_torch.modelzoo import common as zoo
    from deeprec_tpu_torch.models import DLRMDCN
    from deeprec_tpu_torch.ops.fused_lookup import fused_gather_combine
    from deeprec_tpu_torch.training.trainer import Trainer

    K, W, B = cfg["K"], cfg["windows"], cfg["batch"]
    gen = SyntheticCriteo(batch_size=B, vocab=cfg["vocab"], seed=seed + 70)
    t0 = time.perf_counter()
    host = [gen.batch() for _ in range((W + cfg["accum_windows"]) * K)]
    held_out = SyntheticCriteo(batch_size=B, vocab=cfg["vocab"], seed=seed + 71)
    evals = [held_out.batch() for _ in range(cfg["eval_batches"])]
    cats = [k for k in host[0] if k.startswith("C")]
    distinct = [len(np.unique(np.concatenate([h[c] for h in host]))) for c in cats]
    C0 = 1 << ((min(distinct) // 2).bit_length() - 1)
    data_s = time.perf_counter() - t0
    # the model and optimizers as the driver builds them from its flags
    args = _zoo_args("--bf16", "--filter_freq", cfg["filter_freq"], "--steps_to_live",
                     cfg["steps_to_live"], "--learning_rate", cfg["lr"], "--dense_lr",
                     cfg["dense_lr"])
    model = _retable(DLRMDCN(**dict(full, capacity=C0), ev=zoo.ev_option(args), seed=seed),
                     value_dtype="bfloat16")
    trainer = Trainer(model, *zoo.make_optimizers(args), device=dev,
                      pipeline_mode="lookahead")
    state = trainer.init()
    staged = trainer.stage(iter(host[:cfg["raw_windows"][0] * K]), depth=2)
    windows, maint, losses, evicted, reports = [], [], [], [], []
    prof, fails_after = None, None

    def one_window(w, profiled=False):
        nonlocal state
        raw = cfg["raw_windows"][0] <= w < cfg["raw_windows"][1]
        trainer.pipeline_mode = ("off" if cfg["off_windows"][0] <= w < cfg["off_windows"][1]
                                 else "lookahead")
        syncs = sum(b.table.probe_syncs for b in trainer.bundles.values())
        _sync(dev)
        t0 = time.perf_counter()
        src = iter(host[w * K:(w + 1) * K]) if raw else staged
        state, mets = trainer.train_steps(state, [next(src) for _ in range(K)])
        _sync(dev)
        windows.append((w, "profiled" if profiled else trainer.pipeline_mode,
                        "off" if raw else "auto", time.perf_counter() - t0,
                        sum(b.table.probe_syncs for b in trainer.bundles.values()) - syncs))
        losses.extend(mets["loss"].tolist())

    _zero_row_counts()  # the main path starts here
    fused_gather_combine.launches = 0
    w = 0
    while w < W:
        if dev.type == "cuda" and w == cfg["profiled"]:
            ws = iter((w, w + 1))
            prof = profile_device(lambda: one_window(next(ws), True), 1)
            w += 2
        else:
            one_window(w)
            w += 1
        if w % cfg["every"]:
            continue
        (bname, b), = trainer.bundles.items()
        size0 = int(b.table.size(state.tables[bname]).sum())
        _sync(dev)
        t0 = time.perf_counter()
        state = trainer.evict_tables(state)
        size1 = int(b.table.size(state.tables[bname]).sum())
        # the rebuild's insert_fails: survivors it could not re-insert
        lost = int(state.tables[bname].insert_fails.sum())
        t1 = time.perf_counter()
        state, rep = trainer.maintain(state, max_capacity=cfg["max_capacity"])
        _sync(dev)
        maint.append((w, t1 - t0, time.perf_counter() - t1))
        evicted.append((w, size0, size1, lost))
        reports.append((w, rep[bname]))
        fails_after = sum(int(ts.insert_fails.sum()) for ts in state.tables.values())
    A = cfg["accum"]
    t0 = time.perf_counter()
    for i in range(cfg["accum_windows"] * K // A):
        part = host[(W * K) + i * A:(W * K) + (i + 1) * A]
        state, mets = trainer.train_step_accum(
            state, {k: np.concatenate([h[k] for h in part]) for k in part[0]}, A)
        losses.append(float(mets["loss"]))
    _sync(dev)
    accum_s = time.perf_counter() - t0
    fails_end = sum(int(ts.insert_fails.sum()) for ts in state.tables.values())
    auc = trainer.evaluate(state, evals)["auc"]
    launches = _launch_counts()
    _row_counts()  # ... and ends here (adds the bf16 launches to PAIR_LAUNCHES)
    staged.close()
    steps = W * K + cfg["accum_windows"] * K
    per_req = _per_request(trainer)
    want = np.concatenate([steps * _loop_launches(trainer), [0]])
    want[0] += cfg["eval_batches"] * per_req[0]
    want[4] = cfg["eval_batches"] * per_req[1]
    (bname, b), = trainer.bundles.items()
    caps = [ts.keys.shape[1] for ts in state.tables.values()]
    grew = [r["grew_to"] for _, r in reports if "grew_to" in r]
    removed = sum(s0 - s1 - lost for _, s0, s1, lost in evicted)
    stats = dict(distinct=distinct, C0=C0, data_s=data_s, windows=windows, maint=maint,
                 losses=losses, evicted=evicted, reports=reports, accum_s=accum_s,
                 fails=(fails_after, fails_end), auc=auc, launches=launches, want=want,
                 profile=prof, grew=grew, caps=caps, removed=removed,
                 bundle_tables=b.num_tables)
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss in the loop: {losses}")
    if fails_end != fails_after:
        raise AssertionError(f"{fails_end - fails_after} inserts failed after the last maintain")
    if not grew or min(caps) <= C0:
        raise AssertionError(f"a table never grew: capacities {caps}, start {C0}")
    if removed <= 0:
        raise AssertionError(f"the TTL eviction removed no key: {evicted}")
    if dev.type == "cuda" and not np.array_equal(launches, want):
        raise AssertionError(f"the loop launched (#1, #3, #2, #5, #4) {launches.tolist()}, "
                             f"the path implies {want.tolist()}")
    if not auc >= cfg["auc_floor"]:
        raise AssertionError(f"held-out AUC {auc} (floor {cfg['auc_floor']})")
    return stats


def run_loop(dev, seed, full, small, cfg, ckroot):
    """Phase 14: (a) then (b), printed. Returns (b)'s stats."""
    t0 = time.perf_counter()
    for line in loop_agreement(dev, seed, small, cfg, os.path.join(ckroot, "loop")):
        print(f"loop agreement at capacity {small['capacity']} on {dev.type}: {line}")
    a_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    st = loop_phase(dev, seed, full, cfg)
    K, B = cfg["K"], cfg["batch"]
    print(f"loop: DLRM-DCN {full} with bf16 tables, CounterFilter({cfg['filter_freq']}), "
          f"GlobalStepEvict({cfg['steps_to_live']}); distinct ids per table over the run "
          f"{min(st['distinct'])}-{max(st['distinct'])}, so every table starts at "
          f"{st['C0']} slots ({st['bundle_tables']} tables in one stacked bundle; data made "
          f"in {st['data_s']:.1f} s)")
    rate = {}
    maint_after = {w for w, _, _ in st["maint"]}
    for w, mode, stage, sec, syncs in st["windows"]:
        key = ("before maintain" if w + 1 in maint_after else mode, stage)
        rate.setdefault(key, []).append((K * B / sec, syncs / K))
    for (kind, stage), r in sorted(rate.items()):
        ex, syncs = zip(*r)
        print(f"loop: {len(r)} windows ({kind}, stage={stage}) examples/s: median "
              f"{np.median(ex):.1f}, min {min(ex):.1f}, max {max(ex):.1f}; probe-loop "
              f"host syncs per step {min(syncs):.1f}-{max(syncs):.1f}")
    ex = {w: (round(K * B / sec, 1), syncs / K) for w, _, _, sec, syncs in st["windows"]}
    base = range(cfg["off_windows"][1], cfg["raw_windows"][0])
    for what, (lo, hi) in (("in 'off'", cfg["off_windows"]),
                           ("fed host batches (stage='off')", cfg["raw_windows"])):
        print(f"loop: windows {lo}-{hi - 1} {what} {[ex[w] for w in range(lo, hi)]} against "
              f"{base[0]}-{base[-1]} (lookahead, staged) {[ex[w] for w in base]} "
              f"(examples/s, probe syncs per step)")
    for (w, ev_s, m_s), (_, s0, s1, lost), (_, rep) in zip(st["maint"], st["evicted"],
                                                           st["reports"]):
        print(f"loop: after window {w - 1}: evict_tables {ev_s:.3f} s ({s0} -> {s1} live "
              f"keys, {lost} of them lost by the rebuild), maintain {m_s:.3f} s: occupancy {rep['occupancy']:.4f} of "
              f"{rep['capacity']} (max live {round(rep['occupancy'] * rep['capacity'])}), "
              f"insert_fails {rep['insert_fails']}, grew_to {rep.get('grew_to')}")
    print(f"loop: every table grew ({st['C0']} -> {sorted(set(st['caps']))}), the TTL "
          f"eviction removed {st['removed']} keys; inserts failed (after the last "
          f"maintain, at the end) {st['fails']}; train_step_accum(A={cfg['accum']}) over "
          f"{cfg['accum_windows']} windows' batches in {st['accum_s']:.2f} s; losses "
          f"{st['losses'][0]:.6f} .. {st['losses'][-1]:.6f}; held-out AUC over "
          f"{cfg['eval_batches']} batches {st['auc']:.6f} (floor {cfg['auc_floor']})")
    print(f"loop: launched (#1 gather bf16, #3 gather f32, #2 scatter bf16, #5 scatter "
          f"f32, #4) {st['launches'].tolist()}, the path implies {st['want'].tolist()} "
          f"(the Adagrad slot rows are f32)")
    if st["profile"] is not None:
        # one profiled window, shown per step
        wall, busy, kernels, rows, phases = st["profile"]
        per_step = (wall / K, busy / K, round(kernels / K),
                    [(dt / K, key, count // K) for dt, key, count in rows],
                    {k: (h / K, d / K) for k, (h, d) in phases.items()})
        la = [sec for w, mode, stage, sec, _ in st["windows"]
              if mode == "lookahead" and stage == "auto" and w + 1 not in maint_after]
        print_train_profile(f"loop steps (one profiled window of K = {K})", K, per_step,
                            float(np.median(la)) / K * 1e3)
    print(f"phase 14 (the training loop) took {time.perf_counter() - t0:.1f} s "
          f"(agreement {a_s:.1f} s)")
    return st


# ------------------------------------------------------------ phase 15

# Phase 15, multi-tier storage. (b) trains MLPerf DLRM-DCN with a device
# tier of `capacity` slots per table: over its 14 windows the run's ids
# (SyntheticCriteo, vocab 10^6) pass 2^15 slots' high watermark at window
# 10, and the later windows demote, promote and fold. (c) starts the modelzoo's budget path at `capacity`
# slots with a budget of 3 tables' worth of bytes: one growth fits, the
# next does not.
TIER = dict(batch=2048, vocab=1_000_000, K=8, windows=14, capacity=1 << 15, every=5,
            strategy="lfu", high=0.8, depth=4, chunk=256, lr=0.05, dense_lr=1e-3, eval_batches=8,
            auc_floor=0.60, profiled=12,
            # (a)'s tier sequence: per round the boundary, the ids looked up
            # and the share of them drawn from the tier stores' keys
            # (capacity 2^12 and twice these sizes before phase 21)
            ops=dict(capacity=1 << 11, vocab_mult=5, host_capacity=512, picks=300,
                     rounds=(("sync", 1500, 0.0), ("sync", 1500, 0.0), ("sync", 600, 0.5),
                             ("async", 300, 0.5), ("async", 350, 0.5))),
            train=dict(batch=256, K=4, rounds=2, prefill=6, depth=8),
            budget=dict(capacity=1 << 14, windows=10, budget_tables=3))
FILLS = (("accum", 0.1),)


def _tier_launches():
    """(#3 f32 gathers, #5 f32 scatters, #1 bf16 gathers, #2 bf16 scatters)
    since the counts were zeroed."""
    from deeprec_tpu_torch.ops.fused_lookup import apply_rows_sr, gather_rows

    return np.array([gather_rows.launches - gather_rows.launches_bf16,
                     apply_rows_sr.launches - apply_rows_sr.launches_bf16,
                     gather_rows.launches_bf16, apply_rows_sr.launches_bf16])


def _member_rows(ts, t):
    """{key: (value row f32, accum row, meta column)} of member t."""
    keys = ts.keys[t].cpu().numpy()
    live = np.nonzero(keys != np.iinfo(keys.dtype).min)[0]
    v = ts.values[t].float().cpu().numpy()[live]
    a = ts.slots["accum"][t].cpu().numpy()[live]
    m = ts.meta[t].cpu().numpy()[:, live].T
    return {int(k): (v[i], a[i], tuple(m[i])) for i, k in enumerate(keys[live])}


def _store_rows(kv):
    """{key: (packed row, freq, version)} of a HostKV (or None)."""
    if kv is None:
        return {}
    k, v, f, ver = kv.export()
    return {int(k[i]): (v[i], int(f[i]), int(ver[i])) for i in range(len(k))}


def _disk_rows(disk):
    if disk is None:
        return {}
    keys = np.fromiter(disk.index, np.int64, len(disk.index))
    v, f, ver, _ = disk.get(keys)
    return {int(keys[i]): (v[i], int(f[i]), int(ver[i])) for i in range(len(keys))}


def _tier_member_arrays(ts, t):
    """Member t's live rows as arrays sorted by key: (keys, value rows f32,
    accum rows, meta columns [n, 3])."""
    keys = ts.keys[t].cpu().numpy()
    live = np.nonzero(keys != np.iinfo(keys.dtype).min)[0]
    live = live[np.argsort(keys[live], kind="stable")]
    return (keys[live], ts.values[t].float().cpu().numpy()[live],
            ts.slots["accum"][t].cpu().numpy()[live], ts.meta[t].cpu().numpy()[:, live].T)


def _tier_store_arrays(kv):
    """A HostKV's rows as arrays sorted by key: (keys, packed rows, freqs,
    versions); empty without a store."""
    if kv is None:
        return (np.zeros(0, np.int64), np.zeros((0, 0), np.float32), np.zeros(0, np.int64),
                np.zeros(0, np.int64))
    k, v, f, ver = kv.export()
    order = np.argsort(k, kind="stable")
    return k[order], v[order], f[order], ver[order]


def _same_tier_arrays(a, b, what):
    """Two row sets of `_tier_member_arrays` / `_tier_store_arrays` equal
    bit for bit (the same keys, each key's rows equal). Returns the key
    count."""
    if not np.array_equal(a[0], b[0]):
        raise AssertionError(f"{what}: {len(a[0])} keys against {len(b[0])} "
                             f"({len(np.setxor1d(a[0], b[0]))} differ)")
    for x, y in zip(a[1:], b[1:]):
        if not np.array_equal(x, y):
            raise AssertionError(f"{what}: rows differ")
    return len(a[0])


def _same_map(a, b, what):
    """Two {key: tuple of arrays / ints} maps equal bit for bit."""
    if a.keys() != b.keys():
        raise AssertionError(f"{what}: {len(a)} keys against {len(b)} "
                             f"({len(a.keys() ^ b.keys())} differ)")
    for k, row in a.items():
        for x, y in zip(row, b[k]):
            if not np.array_equal(np.asarray(x), np.asarray(y)):
                raise AssertionError(f"{what}: key {k} differs")
    return len(a)


def tier_ops(dev, table, state0, cfg, seed, path):
    """Phase 15 (a), the tier operations on `dev` from a copy of the CPU
    state `state0` (one [1, C] table with an Adagrad slot): rounds of
    train-mode inserts over a vocabulary vocab_mult x C, deterministic value
    and accumulator writes (scatter_update; apply_rows_sr on the slot) and
    freqs stamped from a permutation (no ties in the demote order); `sync`
    in the first two rounds, `sync_async` + `drain` in the rest; then
    probe_rows over tier-resident, device and absent ids, a third of them
    looked up again first (some stamped past their tier copy), and
    fold_candidates; then lookup_with_fallback over every id. Returns the
    outcomes on the host."""
    from deeprec_tpu_torch.embedding import MultiTierTable
    from deeprec_tpu_torch.embedding.table import META_FREQ, empty_key
    from deeprec_tpu_torch.ops.fused_lookup import apply_rows_sr

    mt = MultiTierTable(table, slot_fills=FILLS, storage_path=path)
    st = _copy_table_state(state0, dev)
    C, D = table.cfg.capacity, table.cfg.dim
    vocab = cfg["vocab_mult"] * C
    rng = np.random.default_rng(seed + 90)
    perm = torch.as_tensor(rng.permutation(vocab).astype(np.int32) + 1, device=dev)
    col = torch.arange(D, device=dev, dtype=torch.float32)
    sent = empty_key(table.cfg)

    def write(res, r):
        """Deterministic value and accumulator rows of the looked-up keys."""
        u = res.uids.to(torch.float32)[..., None]
        table.scatter_update(st, res.slot_ix, (u % 997) * 1e-3 + col * 1e-4 + r,
                             mask=res.valid, seed=r)
        ok = (res.slot_ix >= 0) & res.valid
        apply_rows_sr(st.slots["accum"], torch.where(ok, res.slot_ix, -1),
                      (u % 89) * 1e-2 + 0.1 + col * 0.0)

    def stamp():
        occ = st.keys[0] != sent
        st.meta[0, META_FREQ] = torch.where(
            occ, perm[st.keys[0].clamp(0, vocab - 1).long()], 0)

    def tier_keys():
        return np.sort(np.asarray(list(_store_rows(mt.host)) + list(_disk_rows(mt.disk)),
                                  np.int64))

    reports, trace = [], []  # per round the device keys and tier keys
    for r, (kind, n, back) in enumerate(cfg["rounds"]):
        tk = tier_keys()
        n_back = min(int(n * back), len(tk))
        ids = np.concatenate([rng.choice(tk, n_back, replace=False),
                              rng.choice(vocab, n - n_back, replace=False)])
        ids = torch.as_tensor(np.unique(ids).astype(np.int32), device=dev)
        write(table.lookup_unique(st, ids[None], step=r), r)
        stamp()
        trace.append((r, "looked up", st.keys[0][st.keys[0] != sent].cpu().numpy(),
                      int(st.insert_fails.sum())))
        if kind == "sync":
            st, s = mt.sync(st, step=r)
            reports.append(("sync", dataclasses.asdict(s)))
        else:
            st, s = mt.sync_async(st, step=r)
            reports.append(("sync_async", dataclasses.asdict(s)))
            st, s = mt.drain(st)
            reports.append(("drain", dataclasses.asdict(s)))
        trace.append((r, kind, st.keys[0][st.keys[0] != sent].cpu().numpy(), tier_keys()))
    dev_keys = np.sort(st.keys[0][st.keys[0] != sent].cpu().numpy().astype(np.int64))
    picks = np.concatenate([tier_keys()[:cfg["picks"]], dev_keys[:50],
                            np.arange(vocab, vocab + 50)])
    cand = mt.probe_rows(picks)
    again = torch.as_tensor(cand["keys"][::3].astype(np.int32), device=dev)
    res = table.lookup_unique(st, again[None], step=len(cfg["rounds"]))
    write(res, len(cfg["rounds"]))
    past = res.slot_ix[0, ::4].long()  # trained past their tier copy
    st.meta[0, META_FREQ, past[past >= 0]] = vocab + 100
    st, folded, dropped = mt.fold_candidates(st, cand, chunk=256)
    everything = torch.arange(-1, vocab + 50, device=dev, dtype=torch.int32)
    lfb = mt.lookup_with_fallback(st, everything).float().cpu().numpy()
    out = dict(reports=reports, fold=(folded, dropped, sorted(mt._retry_keys)),
               probe=(cand["keys"].tolist(), cand["rows"], cand["freqs"], cand["vers"],
                      cand["from_disk"]),
               rows=_member_rows(st, 0), host=_store_rows(mt.host), disk=_disk_rows(mt.disk),
               lfb=lfb, vocab=vocab, trace=trace)
    if mt.disk is not None:
        mt.disk.close()
    return out


def tier_ops_agreement(dev, seed, dim, cfg, tmp):
    """Phase 15 (a), the tier operations card against CPU, bit for bit per
    key, on hbm_dram f32, hbm_dram bf16 and hbm_dram_ssd (host_capacity
    small enough to spill). Returns (lines, the card's launches of #3, #5,
    #1, #2)."""
    from deeprec_tpu_torch.config import EmbeddingVariableOption, StorageOption, TableConfig
    from deeprec_tpu_torch.embedding.table import EmbeddingTable
    from deeprec_tpu_torch.optim import Adagrad
    from deeprec_tpu_torch.optim.apply import ensure_slots

    lines, launches = [], np.zeros(4, np.int64)
    for kind, dtype in (("hbm_dram", "float32"), ("hbm_dram", "bfloat16"),
                        ("hbm_dram_ssd", "float32")):
        storage = StorageOption(storage_type=kind, host_capacity=(
            cfg["host_capacity"] if kind == "hbm_dram_ssd" else 0))
        table = EmbeddingTable(TableConfig(name="tier", dim=dim, capacity=cfg["capacity"],
                                           value_dtype=dtype,
                                           ev=EmbeddingVariableOption(storage=storage)))
        state0 = ensure_slots(table, table.create(1, "cpu"), Adagrad(lr=0.05))
        outs = {}
        for d in ("cpu", dev):
            _zero_row_counts()
            path = os.path.join(tmp, f"{kind}_{dtype}_{torch.device(d).type}")
            outs[torch.device(d).type] = tier_ops(torch.device(d), table, state0, cfg, seed,
                                                  path if kind == "hbm_dram_ssd" else None)
            if torch.device(d).type == "cuda":
                launches += _tier_launches()
                _row_counts()
        a, b = outs["cpu"], outs[dev.type]
        for (r, what, dk, extra), (_, _, dk2, extra2) in zip(a["trace"], b["trace"]):
            # the first step where the device keys, the tier keys or the
            # failed inserts part
            parts = [set(dk.tolist()) ^ set(dk2.tolist())]
            if isinstance(extra, np.ndarray):
                parts.append(set(extra.tolist()) ^ set(extra2.tolist()))
            if any(parts) or (not isinstance(extra, np.ndarray) and extra != extra2):
                raise AssertionError(
                    f"{kind} {dtype}: after round {r} ({what}) cpu and {dev.type} part: "
                    f"{[sorted(d)[:8] for d in parts]} ({[len(d) for d in parts]} keys), "
                    f"{'' if isinstance(extra, np.ndarray) else (extra, extra2)}")
        if a["reports"] != b["reports"]:
            raise AssertionError(f"{kind} {dtype}: reports differ: {a['reports']} vs "
                                 f"{b['reports']}")
        if a["fold"] != b["fold"]:
            raise AssertionError(f"{kind} {dtype}: fold outcomes differ")
        for x, y in zip(a["probe"], b["probe"]):
            if not np.array_equal(np.asarray(x), np.asarray(y)):
                raise AssertionError(f"{kind} {dtype}: probe_rows packages differ")
        n_dev = _same_map(b["rows"], a["rows"], f"{kind} {dtype} device rows")
        n_host = _same_map(b["host"], a["host"], f"{kind} {dtype} host store")
        n_disk = _same_map(b["disk"], a["disk"], f"{kind} {dtype} disk log")
        resident = np.zeros(len(a["lfb"]), bool)
        ix = np.asarray(sorted(set(a["rows"]) | set(a["host"]) | set(a["disk"]))) + 1
        resident[ix] = True
        resident[0] = True  # the pad id -1 serves zeros
        if not np.array_equal(a["lfb"][resident], b["lfb"][resident]):
            raise AssertionError(f"{kind} {dtype}: lookup_with_fallback rows differ")
        # initializer rows of absent ids: torch.erfinv differs by a few f32
        # ulps between the devices, so within 1e-5; a bf16 row's rounding
        # can then fall either side, so within one bf16 ulp (2^-7 relative)
        x, y = a["lfb"][~resident], b["lfb"][~resident]
        init_diff = float(np.abs(x - y).max())
        tol = 1e-5 if dtype == "float32" else np.maximum(1e-5, np.abs(x) * 2.0 ** -7)
        if not np.all(np.abs(x - y) <= tol):
            raise AssertionError(f"{kind} {dtype}: initializer rows differ by {init_diff}")
        demoted = sum(r["demoted"] for _, r in a["reports"])
        promoted = sum(r["promoted"] for _, r in a["reports"])
        spilled = sum(r["spilled"] for _, r in a["reports"])
        if not (demoted and promoted and a["fold"][0] and a["fold"][1]) or (
                kind == "hbm_dram_ssd" and not spilled):
            raise AssertionError(f"{kind} {dtype}: the sequence missed a path: {a['reports']}"
                                 f", fold {a['fold'][:2]}")
        lines.append(
            f"{kind} {dtype}: {len(a['reports'])} reports equal (demoted {demoted}, promoted "
            f"{promoted}, spilled {spilled}); probe_rows packages, fold (folded "
            f"{a['fold'][0]}, dropped {a['fold'][1]}, {len(a['fold'][2])} retry keys) equal; "
            f"{n_dev} device rows, {n_host} host rows, {n_disk} disk rows and "
            f"{int(resident.sum())} lookup_with_fallback rows bit for bit per key "
            f"(initializer rows of {int((~resident).sum())} absent ids within {init_diff:.3g})")
    return lines, launches


def _prefill(trainer, state, host):
    """Train-mode table lookups (no dense step) of the ids of `host`
    batches, into every bundle of `state`."""
    for b in host:
        batch = trainer.device_batch(b)
        trainer._resolve_all(state.tables, trainer._route_all(batch), 0)
    return state


def tier_budget_agreement(dev, seed, small, cfg):
    """Phase 15 (a), maintain(hbm_budget_bytes=) on HBM storage card
    against CPU: one state filled past the growth threshold on the CPU,
    copied to the card; a budget that admits the growth (grew_to) and one
    that does not (auto_tiered: a forced sync per member); the reports,
    every member's rows and host store per key bit for bit."""
    from deeprec_tpu_torch.data import SyntheticCriteo
    from deeprec_tpu_torch.optim import Adagrad, adam
    from deeprec_tpu_torch.training.trainer import Trainer

    model = _dlrm_dcn(seed, **small)  # a template only: maintain never reads it

    def trainer(d):
        return Trainer(model, Adagrad(lr=cfg["lr"]), adam(cfg["dense_lr"]), device=d)

    gen = SyntheticCriteo(batch_size=2048, vocab=cfg["vocab"], seed=seed + 85)
    cpu = trainer("cpu")
    state0 = _prefill(cpu, cpu.init(), [gen.batch() for _ in range(7)])
    (bname, b), = cpu.bundles.items()
    total = cpu._state_bytes(state0.tables[bname])
    lines = []
    for label, budget in (("grows", 10 * total), ("auto-tiers", total + 1)):
        out = {}
        for d in ("cpu", dev):
            t = trainer(d)
            st = _copy_state(state0, torch.device(d))
            st, rep = t.maintain(st, hbm_budget_bytes=budget)
            ts = st.tables[bname]
            out[torch.device(d).type] = (
                rep, [_tier_member_arrays(ts, k) for k in range(ts.keys.shape[0])],
                [_tier_store_arrays(t._tiers[(bname, (k,))].host if t._tiers else None)
                 for k in range(ts.keys.shape[0])])
        (ra, ma, ha), (rb, mb, hb) = out["cpu"], out[dev.type]
        if ra != rb:
            raise AssertionError(f"maintain(hbm_budget_bytes) {label}: reports differ: "
                                 f"{ra} vs {rb}")
        want = "grew_to" if label == "grows" else "auto_tiered"
        if want not in ra[bname] or (label != "grows" and not ra[bname]["demoted"]):
            raise AssertionError(f"maintain(hbm_budget_bytes={budget}) did not act: {ra}")
        n = sum(_same_tier_arrays(x, y, f"budget {label} member {k}")
                for k, (x, y) in enumerate(zip(mb, ma)))
        n += sum(_same_tier_arrays(x, y, f"budget {label} host {k}")
                 for k, (x, y) in enumerate(zip(hb, ha)))
        lines.append(f"maintain(hbm_budget_bytes={budget}) {label}: report "
                     f"{ {k: v for k, v in ra[bname].items() if k in ('occupancy', 'insert_fails', 'grew_to', 'auto_tiered', 'demoted', 'promoted')} } "
                     f"equal; {n} device and host rows bit for bit per key")
    return lines


def _tiers_by_key(trainer, state, bname, t):
    """(device rows, host rows) of member t of a tiered bundle, as arrays
    sorted by key (`_tier_member_arrays`, `_tier_store_arrays`)."""
    mt = trainer._tiers.get((bname, (t,)))
    return (_tier_member_arrays(state.tables[bname], t),
            _tier_store_arrays(mt.host if mt else None))


def tier_train_agreement(dev, seed, small, cfg):
    """Phase 15 (a), training: one state (tables filled by lookups of the
    prefill batches) made on the CPU and copied to the card; on each,
    `rounds` rounds of: the pager observes the window's batches, drain,
    fold_tier_prefetch, train_steps(K), maintain(). Losses within
    TRAIN_RTOL, the demoted counts and folds equal, every key in exactly
    one tier on each device, value rows of keys in the same tier within
    steps x lr x TRAIN_RTOL (ROW_ATOL's per-step reasoning over 12 steps),
    accumulators within TRAIN_RTOL relative."""
    from deeprec_tpu_torch.config import EmbeddingVariableOption, StorageOption
    from deeprec_tpu_torch.data import SyntheticCriteo
    from deeprec_tpu_torch.models import DLRMDCN
    from deeprec_tpu_torch.optim import Adagrad, adam
    from deeprec_tpu_torch.training.trainer import Trainer

    tc = cfg["train"]
    ev = EmbeddingVariableOption(storage=StorageOption(storage_type="hbm_dram"))
    model = DLRMDCN(**small, ev=ev, seed=seed)  # one template for both devices
    trainers = {d: Trainer(model, Adagrad(lr=cfg["lr"]), adam(cfg["dense_lr"]), device=d)
                for d in ("cpu", dev)}
    pre = SyntheticCriteo(batch_size=2048, vocab=cfg["vocab"], seed=seed + 86)
    state0 = _prefill(trainers["cpu"], trainers["cpu"].init(),
                      [pre.batch() for _ in range(tc["prefill"])])
    gen = SyntheticCriteo(batch_size=tc["batch"], vocab=cfg["vocab"], seed=seed + 87)
    host = [gen.batch() for _ in range(tc["rounds"] * tc["K"])]
    runs = {}
    for d, t in trainers.items():
        st = _copy_state(state0, torch.device(d))
        pager = t.enable_tier_paging(depth=tc["depth"], chunk=cfg["chunk"])
        losses, reps, folds = [], [], []
        try:
            for r in range(tc["rounds"]):
                window = host[r * tc["K"]:(r + 1) * tc["K"]]
                for b in window:
                    pager.observe(b)
                if not pager.drain(30.0):
                    raise AssertionError("the tier pager did not drain in 30 s")
                st, frep = t.fold_tier_prefetch(st)
                folds.append(sum(v["folded"] for v in frep.values()))
                st, mets = t.train_steps(st, window)
                losses.extend(mets["loss"].tolist())
                st, rep = t.maintain(st)
                reps.append({k: (v["demoted"], v["promoted"]) for k, v in rep.items()})
        finally:
            t.close_tier_paging()
        runs[torch.device(d).type] = (st, losses, reps, folds)
    (sa, la, ra, fa), (sb, lb, rb, fb) = runs["cpu"], runs[dev.type]
    loss_d = max(abs(x - y) / abs(x) for x, y in zip(la, lb))
    if loss_d > TRAIN_RTOL:
        raise AssertionError(f"tiered training: losses differ by {loss_d} relative")
    if [{k: v[0] for k, v in r.items()} for r in ra] != [{k: v[0] for k, v in r.items()}
                                                          for r in rb]:
        raise AssertionError(f"tiered training: demoted counts differ: {ra} vs {rb}")
    if not sum(v[0] for r in ra for v in r.values()) or not sum(fa):
        raise AssertionError(f"tiered training demoted or folded nothing: {ra}, {fa}")
    (bname, b), = trainers["cpu"].bundles.items()
    row_d, acc_d, same, moved = 0.0, 0.0, 0, 0
    for t in range(b.num_tables):
        tiers = {}
        for d, st in (("cpu", sa), (dev.type, sb)):
            dev_rows, host_rows = _tiers_by_key(trainers[d if d == "cpu" else dev], st,
                                                bname, t)
            if np.intersect1d(dev_rows[0], host_rows[0]).size:
                raise AssertionError(f"{d} member {t}: keys in both tiers")
            tiers[d] = (dev_rows, host_rows)
        for i in range(2):
            x, y = tiers["cpu"][i], tiers[dev.type][i]
            moved += len(np.setxor1d(x[0], y[0]))
            _, ix, iy = np.intersect1d(x[0], y[0], assume_unique=True, return_indices=True)
            if not ix.size:
                continue
            same += ix.size
            D = small["emb_dim"]
            v, w = x[1][ix][:, :D], y[1][iy][:, :D]
            # the accumulator (a device slot row, or the host row's tail)
            a, c = (x[2][ix], y[2][iy]) if i == 0 else (x[1][ix][:, D:], y[1][iy][:, D:])
            row_d = max(row_d, float(np.abs(v - w).max()))
            acc_d = max(acc_d, float((np.abs(a - c) / np.abs(a)).max()))
    # ROW_ATOL is phase 7's bound for 3 steps, from the reasoning beside
    # it: a step moves a row by at most lr per element, so a 1e-3 relative
    # gradient difference moves it by at most lr x TRAIN_RTOL. Over this
    # check's rounds x K steps the same reasoning gives that bound summed
    # over the steps. An Adagrad accumulator sums squared gradients:
    # within TRAIN_RTOL relative.
    steps = tc["rounds"] * tc["K"]
    row_tol = steps * cfg["lr"] * TRAIN_RTOL
    if row_d > row_tol or acc_d > TRAIN_RTOL:
        raise AssertionError(f"tiered training: value rows differ by {row_d} (bound "
                             f"{row_tol}), accumulators by {acc_d} relative")
    return [f"tiered training, {tc['rounds']} rounds of train_steps(K={tc['K']}) at batch "
            f"{tc['batch']} + fold_tier_prefetch + maintain(), {dev.type} vs cpu: losses "
            f"{la[0]:.6f} .. {la[-1]:.6f} within {loss_d:.3g} relative (tolerance "
            f"{TRAIN_RTOL}); demoted per maintain {[sum(v[0] for v in r.values()) for r in ra]}"
            f" equal, promoted {[sum(v[1] for v in r.values()) for r in ra]} / "
            f"{[sum(v[1] for v in r.values()) for r in rb]}, folded {fa} / {fb}; every key "
            f"in one tier on each device; {same} keys in the same tier, value rows within "
            f"{row_d:.3g} (bound {row_tol:.3g} = {steps} steps x lr x {TRAIN_RTOL}; phase 7's "
            f"3-step ROW_ATOL {ROW_ATOL}), accumulators within {acc_d:.3g} relative "
            f"(tolerance {TRAIN_RTOL}); {moved} keys in another tier"]


class _TierTally:
    """The rows each MultiTierTable demoted and promoted through its sync
    rounds, added up from the TierStats every round publishes (`_publish`,
    wrapped from the tally's making to its `close`)."""

    def __init__(self):
        from deeprec_tpu_torch.embedding.multi_tier import MultiTierTable

        self.rows = {}
        self._cls, orig = MultiTierTable, MultiTierTable._publish

        def publish(mt, stats):
            d, p = self.rows.get(id(mt), (0, 0))
            self.rows[id(mt)] = (d + stats.demoted, p + stats.promoted)
            return orig(mt, stats)

        self._orig = orig
        MultiTierTable._publish = publish

    def close(self):
        self._cls._publish = self._orig

    def demoted(self, mt):
        return self.rows.get(id(mt), (0, 0))[0]

    def member_events(self, trainer, before):
        """Per-member tier events since `before` (a snapshot of this
        method's counts): members that demoted, that promoted through a
        sync, and fold chunks that wrote rows. Returns (events, new
        snapshot)."""
        now = {k: (*self.rows.get(id(mt), (0, 0)), mt.fold_writes)
               for k, mt in trainer._tiers.items()}
        ev = np.zeros(3, np.int64)
        for k, (d, p, w) in now.items():
            d0, p0, w0 = before.get(k, (0, 0, 0))
            ev += [d > d0, p > p0, w - w0]
        return ev, now


def tier_phase(dev, seed, full, cfg):
    """Phase 15 (b): the tiered loop at MLPerf DLRM-DCN widths (see TIER).
    Returns stats."""
    from deeprec_tpu_torch.config import EmbeddingVariableOption, StorageOption
    from deeprec_tpu_torch.data import SyntheticCriteo
    from deeprec_tpu_torch.models import DLRMDCN
    from deeprec_tpu_torch.ops.fused_lookup import fused_gather_combine
    from deeprec_tpu_torch.optim import Adagrad, adam
    from deeprec_tpu_torch.embedding.table import member_view
    from deeprec_tpu_torch.training.trainer import Trainer

    K, W, B, C = cfg["K"], cfg["windows"], cfg["batch"], cfg["capacity"]
    t0 = time.perf_counter()
    gen = SyntheticCriteo(batch_size=B, vocab=cfg["vocab"], seed=seed + 80)
    host = [gen.batch() for _ in range(W * K)]
    held_out = SyntheticCriteo(batch_size=B, vocab=cfg["vocab"], seed=seed + 81)
    evals = [held_out.batch() for _ in range(cfg["eval_batches"])]
    cats = [k for k in host[0] if k.startswith("C")]
    distinct = [np.unique(np.concatenate([h[c] for h in host])) for c in cats]
    data_s = time.perf_counter() - t0
    ev = EmbeddingVariableOption(storage=StorageOption(storage_type="hbm_dram",
                                                       cache_strategy=cfg["strategy"]))
    trainer = Trainer(DLRMDCN(**dict(full, capacity=C), ev=ev, seed=seed),
                      Adagrad(lr=cfg["lr"]), adam(cfg["dense_lr"]), device=dev,
                      pipeline_mode="lookahead")
    state = trainer.init()
    (bname, b), = trainer.bundles.items()
    T = b.num_tables
    nslots = sum(1 for n in trainer.sparse_opt.slot_specs(1) if not n.startswith("scalar/"))
    pager = trainer.enable_tier_paging(depth=cfg["depth"], chunk=cfg["chunk"])
    trainer.warm_tier_folds(state)
    staged = trainer.stage(iter(host), depth=2)
    windows, maint, losses, events, occ_after = [], [], [], np.zeros(3, np.int64), []
    lost = np.zeros(T, np.int64)  # failed inserts counted per member
    prof, snap = None, {}
    W_row = full["emb_dim"] * (1 + nslots) * 4  # bytes of one packed tier row

    def do_maintain(w, sync):
        nonlocal state, snap, events
        fails = state.tables[bname].insert_fails.tolist()
        before = {k: tally.demoted(mt) for k, mt in trainer._tiers.items()}
        _sync(dev)
        t1 = time.perf_counter()
        state, rep = trainer.maintain(state, tier_async=not sync)
        _sync(dev)
        sec = time.perf_counter() - t1
        ev_, snap = tally.member_events(trainer, snap)
        events += ev_
        for k in range(T):  # insert_fails of the members this maintain rebuilt
            mt = trainer._tiers.get((bname, (k,)))
            if mt is not None and tally.demoted(mt) > before.get((bname, (k,)), 0):
                lost[k] += fails[k]
        r = rep[bname]
        if sync:
            occ_after.append(int(b.table.size(state.tables[bname]).max()))
        maint.append((w, "sync" if sync else "async", sec, r["demoted"], r["promoted"],
                      r["occupancy"]))

    def one_window(w, profiled=False):
        nonlocal state, events, snap
        _sync(dev)
        t1 = time.perf_counter()
        state, mets = trainer.train_steps(state, [next(staged) for _ in range(K)])
        _sync(dev)
        t2 = time.perf_counter()
        state, frep = trainer.fold_tier_prefetch(state)
        _sync(dev)
        t3 = time.perf_counter()
        ev_, snap = tally.member_events(trainer, snap)
        events += ev_
        folded = sum(v["folded"] for v in frep.values())
        windows.append((w, "profiled" if profiled else "lookahead", t2 - t1, t3 - t2, folded,
                        sum(v["dropped"] for v in frep.values())))
        losses.extend(mets["loss"].tolist())
        do_maintain(w, (w + 1) % cfg["every"] == 0)

    _zero_row_counts()  # the main path starts here
    fused_gather_combine.launches = 0
    tally = _TierTally()
    try:
        w = 0
        while w < W:
            if dev.type == "cuda" and w == cfg["profiled"]:
                ws = iter((w, w + 1))
                prof = profile_device(lambda: one_window(next(ws), True), 1)
                w += 2
            else:
                one_window(w)
                w += 1
        do_maintain(W, True)  # settles the last round
    finally:
        tally.close()
    ts = state.tables[bname]
    lost += np.asarray(ts.insert_fails.tolist())
    # every key in one tier; the union is what was trained, less failed inserts
    tiers, n_lost, lfb_rows = [], [], 0
    for k in range(T):
        mt = trainer._tiers[(bname, (k,))]
        keys = ts.keys[k].cpu().numpy()
        dev_keys = set(keys[keys != np.iinfo(keys.dtype).min].tolist())
        hk, hv, _, _ = mt.host.export()
        host_keys = set(hk.tolist())
        if dev_keys & host_keys:
            raise AssertionError(f"member {k}: {len(dev_keys & host_keys)} keys in both tiers")
        trained = set(distinct[k].tolist())
        if not (dev_keys | host_keys) <= trained:
            raise AssertionError(f"member {k}: tiers hold keys never trained")
        n_lost.append(len(trained - dev_keys - host_keys))
        ids = torch.as_tensor(distinct[k].astype(np.int32), device=dev)
        got = mt.lookup_with_fallback(member_view(ts, k), ids).float().cpu().numpy()
        # the rows each id must read: the table's, else the host store's
        live = keys != np.iinfo(keys.dtype).min
        have = np.concatenate([keys[live].astype(np.int64), hk])
        rows = np.concatenate([ts.values[k].float().cpu().numpy()[live],
                               hv[:, :full["emb_dim"]]])
        order = np.argsort(have)
        at = np.clip(np.searchsorted(have[order], distinct[k]), 0, len(have) - 1)
        hit = have[order][at] == distinct[k]
        if not np.array_equal(got[hit], rows[order][at[hit]]):
            raise AssertionError(f"member {k}: lookup_with_fallback rows differ")
        lfb_rows += int(hit.sum())
        tiers.append((len(dev_keys), len(host_keys), len(trained)))
    _sync(dev)
    t1 = time.perf_counter()
    auc = trainer.evaluate(state, evals)["auc"]
    eval_s = time.perf_counter() - t1
    launches = _tier_launches()
    fused = fused_gather_combine.launches
    _row_counts()  # ... and ends here
    stats_pager = trainer.tier_paging_stats()
    trainer.close_tier_paging()
    staged.close()
    # the launches the path implies: per train step a forward gather and a
    # gather per per-row slot, an initializer scatter, a value write and a
    # write per slot (f32 tables: all #3 / #5); per demoting member the
    # packed gather (values + slots), per promoting member and per fold
    # chunk that wrote the packed write; a gather per lookup_with_fallback
    # and per evaluate batch, #4 per evaluate batch
    steps = W * K
    per_req = _per_request(trainer)
    step_g, step_s = 1 + nslots, 2 + nslots
    want = np.array([steps * step_g + events[0] * (1 + nslots) + T
                     + cfg["eval_batches"] * per_req[0],
                     steps * step_s + (events[1] + events[2]) * (1 + nslots), 0, 0])
    st = dict(distinct=[len(x) for x in distinct], data_s=data_s, windows=windows,
              maint=maint, losses=losses, tiers=tiers, n_lost=n_lost, lost=lost.tolist(),
              auc=auc, eval_s=eval_s, launches=launches, want=want, fused=fused,
              want_fused=cfg["eval_batches"] * per_req[1], profile=prof, events=events,
              occ_after=occ_after, stall_ms=trainer.tier_stall_ms(), pager=stats_pager,
              lfb_rows=lfb_rows, row_bytes=W_row, T=T, C=C)
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss in the tiered loop: {losses}")
    demoted = sum(m[3] for m in maint)
    promoted = sum(m[4] for m in maint) + stats_pager["folded_rows"]
    if not demoted or not promoted:
        raise AssertionError(f"the tiered loop demoted {demoted} and brought back {promoted}")
    if max(occ_after) > int(cfg["high"] * C):
        raise AssertionError(f"occupancy {max(occ_after)} after a synchronous maintain, "
                             f"high watermark {int(cfg['high'] * C)}")
    if any(n > c for n, c in zip(n_lost, lost)):
        raise AssertionError(f"keys lost {n_lost}, more than the failed inserts counted "
                             f"{lost.tolist()}")
    if dev.type == "cuda" and not (np.array_equal(launches, want) and fused == st["want_fused"]):
        raise AssertionError(f"the tiered loop launched (#3, #5, #1, #2) {launches.tolist()}, "
                             f"#4 {fused}; the path implies {want.tolist()}, "
                             f"#4 {st['want_fused']}")
    if not auc >= cfg["auc_floor"]:
        raise AssertionError(f"held-out AUC {auc} (floor {cfg['auc_floor']})")
    return st


def budget_path_phase(dev, seed, full, cfg):
    """Phase 15 (c): modelzoo/common.py `run()` with --maintain_every K
    --hbm_budget_mb B on HBM storage at full widths from cfg capacity
    slots: B holds `budget_tables` x the starting tables' bytes, so one
    growth is admitted and the next is refused, which auto-tiers (a forced
    sync per member, demoted > 0). Returns stats."""
    from deeprec_tpu_torch.data import SyntheticCriteo
    from deeprec_tpu_torch.models import DLRMDCN
    from deeprec_tpu_torch.optim import Adagrad, adam
    from deeprec_tpu_torch.training.trainer import Trainer

    bc = cfg["budget"]
    K = cfg["K"]
    gen = SyntheticCriteo(batch_size=cfg["batch"], vocab=cfg["vocab"], seed=seed + 82)
    trainer = Trainer(DLRMDCN(**dict(full, capacity=bc["capacity"]), seed=seed),
                      Adagrad(lr=cfg["lr"]), adam(cfg["dense_lr"]), device=dev)
    state = trainer.init()
    (bname, b), = trainer.bundles.items()
    T = b.num_tables
    nslots = sum(1 for n in trainer.sparse_opt.slot_specs(1) if not n.startswith("scalar/"))
    start = trainer._state_bytes(state.tables[bname])
    budget_mb = -(-bc["budget_tables"] * start // (1 << 20))
    host = [gen.batch() for _ in range(bc["windows"] * K)]
    reports, snap, events = [], {}, np.zeros(3, np.int64)
    _zero_row_counts()
    t0 = time.perf_counter()
    tally = _TierTally()
    try:
        for w in range(bc["windows"]):
            state, mets = trainer.train_steps(state, host[w * K:(w + 1) * K])
            _sync(dev)
            t1 = time.perf_counter()
            state, rep = trainer.maintain(state, hbm_budget_bytes=budget_mb << 20)
            _sync(dev)
            ev_, snap = tally.member_events(trainer, snap)
            events += ev_
            r = rep[bname]
            reports.append((w, time.perf_counter() - t1, r))
    finally:
        tally.close()
    seconds = time.perf_counter() - t0
    launches = _tier_launches()
    _row_counts()
    steps = bc["windows"] * K
    want = np.array([steps * (1 + nslots) + events[0] * (1 + nslots),
                     steps * (2 + nslots) + (events[1] + events[2]) * (1 + nslots), 0, 0])
    grew = [w for w, _, r in reports if "grew_to" in r]
    tiered = [(w, r["demoted"]) for w, _, r in reports if r.get("auto_tiered")]
    st = dict(budget_mb=budget_mb, start=start, reports=reports, grew=grew, tiered=tiered,
              launches=launches, want=want, seconds=seconds,
              caps=state.tables[bname].keys.shape[1], losses=mets["loss"].tolist(), T=T)
    if len(grew) != 1 or not tiered or min(w for w, _ in tiered) <= grew[0] \
            or not all(d > 0 for _, d in tiered):
        raise AssertionError(f"the budget path grew at windows {grew} and auto-tiered "
                             f"{tiered}: want one growth, then auto-tiering that demotes")
    if dev.type == "cuda" and not np.array_equal(launches, want):
        raise AssertionError(f"the budget path launched (#3, #5, #1, #2) {launches.tolist()}, "
                             f"the path implies {want.tolist()}")
    return st


def run_tier(dev, seed, full, small, cfg, ckroot):
    """Phase 15: (a), (b) and (c), printed. Returns the launches of (#3, #5,
    #1, #2, #4) over the phase's paths."""
    from deeprec_tpu_torch.ops.fused_lookup import fused_gather_combine

    t0 = time.perf_counter()
    tmp = os.path.join(ckroot, "tier")
    os.makedirs(tmp, exist_ok=True)
    lines, a_launches = tier_ops_agreement(dev, seed, full["emb_dim"], cfg["ops"], tmp)
    for line in lines:
        print(f"tier agreement at capacity {cfg['ops']['capacity']}, D {full['emb_dim']}, "
              f"{dev.type} vs cpu: {line}")
    if dev.type == "cuda" and not a_launches[2:].all():
        raise AssertionError(f"the bf16 tiered table launched #1 / #2 {a_launches[2:]}")
    print(f"tier agreement: the card's tier operations launched (#3, #5, #1, #2) "
          f"{a_launches.tolist()}")
    for line in tier_budget_agreement(dev, seed, small, cfg):
        print(f"tier agreement at capacity {small['capacity']}, {dev.type} vs cpu: {line}")
    for line in tier_train_agreement(dev, seed, small, cfg):
        print(f"tier agreement at capacity {small['capacity']}: {line}")
    a_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    st = tier_phase(dev, seed, full, cfg)
    K, B = cfg["K"], cfg["batch"]
    print(f"tier loop: DLRM-DCN {dict(full, capacity=st['C'])} hbm_dram (LFU, watermarks "
          f"0.8 / 0.6), {st['T']} tables; distinct ids per table over the run "
          f"{min(st['distinct'])}-{max(st['distinct'])} (data made in {st['data_s']:.1f} s)")
    ex = [K * B / sec for _, mode, sec, _, _, _ in st["windows"] if mode == "lookahead"]
    print(f"tier loop: {len(ex)} lookahead windows examples/s: median {np.median(ex):.1f}, "
          f"min {min(ex):.1f}, max {max(ex):.1f}")
    print(f"tier loop: per window (examples/s, fold ms, folded, dropped): "
          f"{[(w, round(K * B / s, 1), round(f * 1e3, 3), n, d) for w, _, s, f, n, d in st['windows']]}")
    rb = st["row_bytes"]
    for w, kind, sec, dem, pro, occ in st["maint"]:
        print(f"tier loop: maintain after window {w - 1} ({kind}) {sec:.3f} s: demoted {dem} "
              f"rows ({dem * rb / 1e6:.1f} MB to the host), promoted {pro} "
              f"({pro * rb / 1e6:.1f} MB back), occupancy {occ:.4f} of {st['C']}")
    pg = st["pager"]
    print(f"tier loop: tier_stall_ms {st['stall_ms']:.1f}; tier_paging_stats "
          f"{ {k: (round(v, 3) if isinstance(v, float) else v) for k, v in pg.items()} }; "
          f"folded rows {pg['folded_rows']} ({pg['fold_bytes'] / 1e6:.1f} MB back)")
    share = [n / d for n, d in zip(st["n_lost"], st["distinct"])]
    print(f"tier loop: after the final maintain, per table (device keys, host keys, distinct "
          f"trained) {st['tiers']}; keys in no tier {st['n_lost']} (share of the distinct ids "
          f"{min(share):.5f}-{max(share):.5f}), failed inserts counted {st['lost']}; "
          f"{st['lfb_rows']} lookup_with_fallback rows bit for bit; "
          f"occupancy after every synchronous maintain at most {max(st['occ_after'])} "
          f"(high watermark {int(cfg['high'] * st['C'])})")
    print(f"tier loop: losses {st['losses'][0]:.6f} .. {st['losses'][-1]:.6f}; held-out AUC "
          f"over {cfg['eval_batches']} batches {st['auc']:.6f} (floor {cfg['auc_floor']}) in "
          f"{st['eval_s']:.2f} s")
    print(f"tier loop: launched (#3, #5, #1, #2) {st['launches'].tolist()}, #4 {st['fused']}; "
          f"the path implies {st['want'].tolist()}, #4 {st['want_fused']} (tier events: "
          f"demoting members {st['events'][0]}, promoting members {st['events'][1]}, fold "
          f"chunks written {st['events'][2]})")
    if st["profile"] is not None:
        # one profiled window (of the two profile_device runs), per step
        wall, busy, kernels, rows, phases = st["profile"]
        print_train_profile(f"tiered loop steps (one profiled window of K = {K}, with its "
                            f"fold and maintain)", K,
                            (wall / K, busy / K, round(kernels / K),
                             [(dt / K, key, count // K) for dt, key, count in rows],
                             {k: (h / K, d / K) for k, (h, d) in phases.items()}),
                            float(np.median([s for _, m, s, _, _, _ in st["windows"]
                                             if m == "lookahead"])) / K * 1e3)
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    bp = budget_path_phase(dev, seed, full, cfg)
    for w, sec, r in bp["reports"]:
        acted = {k: r[k] for k in ("grew_to", "auto_tiered", "demoted", "promoted") if k in r}
        print(f"budget path: maintain after window {w} ({sec:.3f} s): occupancy "
              f"{r['occupancy']:.4f} of {r['capacity']}, insert_fails {r['insert_fails']}"
              + (f", {acted}" if acted else ""))
    print(f"budget path: --hbm_budget_mb {bp['budget_mb']} (the start's tables take "
          f"{bp['start'] / 2 ** 20:.1f} MB): grew once (window {bp['grew'][0]}, to "
          f"{bp['caps']} slots), then auto-tiered {bp['tiered']} (window, demoted); "
          f"launched (#3, #5, #1, #2) {bp['launches'].tolist()}, the path implies "
          f"{bp['want'].tolist()}; {bp['seconds']:.1f} s")
    print(f"phase 15 (multi-tier storage) took {time.perf_counter() - t0:.1f} s "
          f"(agreement {a_s:.1f} s)")
    total = a_launches + st["launches"] + bp["launches"]
    return np.concatenate([total, [st["fused"]]])


# ------------------------------------------------------------ phase 16

# Phase 16, the checkpoint lifecycle of modelzoo/common.py `run()` with
# --data criteo_stats --bf16 --filter_freq 2 --steps_to_live 32
# --evict_every 16 --save_steps 32 --incremental_save_steps 8 --steps 64:
# deltas synchronous up to `async_after` and save_incremental_async after
# it; after the delta at `restore_at` a second trainer restores the chain.
# (a) holds the same operations card vs CPU at `small` capacity.
CKPT = dict(batch=2048, steps=64, save_steps=32, incr_steps=8, evict_every=16,
            steps_to_live=32, filter_freq=2, lr=0.05, dense_lr=1e-3, eval_batches=8,
            requests=2, async_after=32, timeline=(10, 20), log_every=8, keep=3,
            restore_at=56, auc_floor=0.55,
            agree=dict(batch=256, cardinality_cap=1500, steps_to_live=2))


def _jax_gc_listing(saves, keep):
    """What the JAX package's retention (`_gc` after every save) leaves of
    `saves` [(kind, step)]: the newest `keep` full saves and the deltas
    newer than the oldest of them."""
    fulls, incrs = set(), set()
    for kind, step in saves:
        (fulls if kind == "full" else incrs).add(step)
        fulls = set(sorted(fulls)[-keep:])
        if fulls:
            incrs = {i for i in incrs if i > min(fulls)}
    return sorted([f"full-{s}" for s in fulls] + [f"incr-{s}" for s in incrs])


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def _flip_byte(path):
    """XOR one bit of the byte in the middle of `path` (inside an array's
    payload, past the zip headers)."""
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0x10]))


def _member_arrays(ts, t):
    """(keys, value rows, accumulator rows, meta [3, n]) of member t's live
    slots, sorted by key, where the state lives."""
    keys = ts.keys[t]
    live = torch.nonzero(keys != torch.iinfo(keys.dtype).min).flatten()
    sel = live[torch.argsort(keys[live])]  # keys are unique: the order is total
    return keys[sel], ts.values[t, sel], ts.slots["accum"][t, sel], ts.meta[t][:, sel]


def _same_state(a, b, what, meta=3):
    """Per key bit for bit, compared on a's device (b's live rows are moved
    there when it lies elsewhere): every member's rows, accumulators and
    first `meta` metadata rows; the dense leaves, the Adam state and the
    step. Returns the keys compared."""
    n = 0
    for bname, x in a.tables.items():
        y = b.tables[bname]
        for t in range(x.keys.shape[0]):
            ka, va, aa, ma = _member_arrays(x, t)
            kb, vb, ab, mb = (v.to(ka.device) for v in _member_arrays(y, t))
            if not torch.equal(ka, kb):
                raise AssertionError(f"{what}, {bname}[{t}]: {len(ka)} keys, want {len(kb)}")
            if not (torch.equal(va, vb) and torch.equal(aa, ab)
                    and torch.equal(ma[:meta], mb[:meta])):
                raise AssertionError(f"{what}, {bname}[{t}]: rows differ")
            n += len(ka)
    eq = lambda u, v: torch.equal(u, v.to(u.device))  # noqa: E731
    oa, ob = a.opt_state, b.opt_state
    bad = [k for k in a.dense if not eq(a.dense[k], b.dense[k])]
    bad += [] if eq(oa.count, ob.count) else ["count"]
    bad += [f"mu.{k}" for k in oa.mu if not eq(oa.mu[k], ob.mu[k])]
    bad += [f"nu.{k}" for k in oa.nu if not eq(oa.nu[k], ob.nu[k])]
    if bad or a.step != b.step:
        raise AssertionError(f"{what}: steps {a.step} / {b.step}, differing {bad[:8]}")
    return n


def _link_bundles(path, chunk=None):
    """Import launches per array of one checkpoint directory: a restore
    imports a bundle's members together (`import_members`), writing them
    through #2 (bf16 values) and #5 (the accumulators) once per bundle with
    rows, or once per `chunk` rows of its largest member where the import
    is chunked (Predictor's `restore_chunk`)."""
    most = {}
    for f in os.listdir(path):
        if f.startswith("table_"):
            with np.load(os.path.join(path, f)) as z:
                b = re.sub(r"_t\d*\.npz$", "", f)
                most[b] = max(most.get(b, 0), z["keys"].shape[0])
    return sum(1 if chunk is None else -(-n // chunk) for n in most.values() if n > 0)


def _ckpt_model(full, seed, cfg, steps_to_live=None, capacity=None):
    """DLRM-DCN at `full` (at `capacity` slots where given) with bf16 tables,
    CounterFilter and, where `steps_to_live` is given, a TTL: the options
    the driver's `ev_option` builds under --bf16 --filter_freq
    [--steps_to_live]."""
    from deeprec_tpu_torch.modelzoo.common import ev_option
    from deeprec_tpu_torch.models import DLRMDCN

    args = _zoo_args("--filter_freq", cfg["filter_freq"], "--steps_to_live",
                     steps_to_live or 0)
    kw = full if capacity is None else dict(full, capacity=capacity)
    return _retable(DLRMDCN(**kw, ev=ev_option(args), seed=seed), value_dtype="bfloat16")


def _files_equal(a, b, what):
    """The npz files of two checkpoint directories hold the same arrays."""
    names = sorted(f for f in os.listdir(a) if f.endswith(".npz"))
    if names != sorted(f for f in os.listdir(b) if f.endswith(".npz")):
        raise AssertionError(f"{what}: other files")
    n = 0
    for f in names:
        with np.load(os.path.join(a, f)) as za, np.load(os.path.join(b, f)) as zb:
            if za.files != zb.files:
                raise AssertionError(f"{what}: {f} holds other arrays")
            for k in za.files:
                if za[k].dtype != zb[k].dtype or not np.array_equal(za[k], zb[k]):
                    raise AssertionError(f"{what}: {f}:{k} differs")
                n += za[k].size if k == "keys" else 0
    return n


def ckpt_agreement(dev, seed, small, cfg, tmp):
    """Phase 16 (a): one state at the full widths and `small` capacity made
    on the CPU and trained on `dev`: a full save, 3 steps, a TTL eviction, a
    synchronous delta, 3 steps, save_incremental_async with 3 more steps
    issued before wait(); the chain restored on `dev` and on the CPU, equal
    per key to each other and to the live state at the last delta; the async
    delta's files equal to a synchronous delta's of a copy; a flipped byte in
    the middle delta quarantined alike on both devices and the next save a
    full one. Returns report lines."""
    from deeprec_tpu_torch.data import CriteoStats
    from deeprec_tpu_torch.optim import Adagrad, adam
    from deeprec_tpu_torch.training.checkpoint import CheckpointManager
    from deeprec_tpu_torch.training.trainer import Trainer

    a = cfg["agree"]
    model = _ckpt_model(small, seed, cfg, a["steps_to_live"])
    cpu = torch.device("cpu")

    def trainer(d):
        return Trainer(model, Adagrad(lr=cfg["lr"]), adam(cfg["dense_lr"]), device=d)

    t0 = time.perf_counter()
    tr = trainer(dev)
    st = _copy_state(trainer(cpu).init(), dev)
    gen = CriteoStats(batch_size=a["batch"], seed=seed + 91,
                      cardinality_cap=a["cardinality_cap"])
    d_chain, d_sync = os.path.join(tmp, "chain"), os.path.join(tmp, "sync")
    ck = CheckpointManager(d_chain, tr, keep=cfg["keep"])

    def steps(n):
        nonlocal st
        for _ in range(n):
            st, _ = tr.train_step(st, gen.batch())

    steps(2)
    st, _ = ck.save(st)                                  # full-2
    steps(3)
    size0 = int(sum(b.table.size(st.tables[n]).sum() for n, b in tr.bundles.items()))
    st = tr.evict_tables(st)
    size1 = int(sum(b.table.size(st.tables[n]).sum() for n, b in tr.bundles.items()))
    if size1 >= size0:
        raise AssertionError(f"the TTL eviction dropped no key ({size0} -> {size1})")
    st, _ = ck.save_incremental(st)                      # incr-5
    steps(3)
    live = _copy_state(st, dev)                          # the state at the last delta
    st, apath = ck.save_incremental_async(st)            # incr-8
    steps(3)                                             # in place, before wait()
    ck.wait()
    shutil.copytree(d_chain, d_sync)
    shutil.rmtree(os.path.join(d_sync, "incr-8"))
    ck_sync = CheckpointManager(d_sync, tr, keep=cfg["keep"])
    _, spath = ck_sync.save_incremental(live)
    n_files = _files_equal(spath, apath, "async delta against a synchronous one")
    t_chain = time.perf_counter() - t0
    t0 = time.perf_counter()
    lines = [f"full save, 3 steps, evict_tables ({size0} -> {size1} keys), a delta, 3 steps, "
             f"save_incremental_async + 3 steps before wait(): the async delta's files equal "
             f"a synchronous delta's of a copy ({n_files} rows)"]

    r_dev, r_cpu = (CheckpointManager(d_chain, trainer(d)).restore() for d in (dev, cpu))
    n = _same_state(r_dev, r_cpu, f"chain restored on {dev.type} vs cpu")
    _same_state(r_dev, live, "restored chain vs the live state at the last delta", meta=2)
    lines.append(f"the chain full-2 + incr-5 + incr-8 restored on {dev.type} and on the cpu: "
                 f"{n} keys bit for bit (rows, accumulators, freq, version, dirty), dense and "
                 f"Adam equal, and equal to the live state at step 8")
    del r_dev, r_cpu
    t_restore = time.perf_counter() - t0
    t0 = time.perf_counter()

    out = []
    for i, d in enumerate((dev, cpu)):
        dd = os.path.join(tmp, f"corrupt-{i}")
        shutil.copytree(d_chain, dd)
        link = os.path.join(dd, "incr-5")
        _flip_byte(os.path.join(link, sorted(f for f in os.listdir(link)
                                             if f.startswith("table_"))[0]))
        c = CheckpointManager(dd, trainer(d))
        out.append((c.restore(), sorted(os.listdir(dd)), c.chain_dirs()))
    (ra, la, ca), (rb, lb, cb) = out
    if not (la == lb and ca == cb == ["full-2"] and "incr-5.quarantined" in la
            and ra.step == rb.step == 2):
        raise AssertionError(f"corrupt middle delta: {dev.type} {la} {ca} step {ra.step}, "
                             f"cpu {lb} {cb} step {rb.step}")
    _same_state(ra, rb, "the prefix restored on both devices")
    _, nxt = CheckpointManager(os.path.join(tmp, "corrupt-0"), tr).save_incremental(st)
    if not os.path.basename(nxt).startswith("full-"):
        raise AssertionError(f"the save after a quarantine was {nxt}, not a full one")
    lines.append(f"a flipped byte in incr-5: both devices restored full-2 and listed {la}; "
                 f"the next save_incremental wrote {os.path.basename(nxt)}")
    lines.append(f"seconds: the chain and the sync copy {t_chain:.2f}, the restores on both "
                 f"devices {t_restore:.2f}, the corruption {time.perf_counter() - t0:.2f}")
    return lines


def ckpt_loop_phase(dev, seed, full, cfg, ckdir):
    """Phase 16 (b): the driver's `run()` (deeprec_tpu_torch/modelzoo/
    common.py) with CKPT's flags, in this process, observed through the
    Trainer and CheckpointManager methods it calls (see CKPT). Returns
    stats."""
    from deeprec_tpu_torch.data import CriteoStats
    from deeprec_tpu_torch.modelzoo import common as zoo
    from deeprec_tpu_torch.models import DLRMDCN
    from deeprec_tpu_torch.ops.fused_lookup import (
        apply_rows_sr, fused_gather_combine, gather_rows)
    from deeprec_tpu_torch.training.profiler import TRACE_FILE
    from deeprec_tpu_torch.training.trainer import Trainer

    B, S = cfg["batch"], cfg["steps"]
    trace_dir = os.path.join(os.path.dirname(ckdir), "timeline")
    mfile = os.path.join(os.path.dirname(ckdir), "metrics.jsonl")
    args = _zoo_args("--data", "criteo_stats", "--bf16", "--filter_freq", cfg["filter_freq"],
                     "--steps_to_live", cfg["steps_to_live"], "--evict_every",
                     cfg["evict_every"], "--save_steps", cfg["save_steps"],
                     "--incremental_save_steps", cfg["incr_steps"], "--steps", S,
                     "--batch_size", B, "--learning_rate", cfg["lr"], "--dense_lr",
                     cfg["dense_lr"], "--eval_batches", cfg["eval_batches"], "--log_every",
                     cfg["log_every"], "--checkpoint", ckdir, "--timeline", cfg["timeline"][0],
                     "--timeline_dir", trace_dir, "--metrics_file", mfile, "--seed", seed + 90,
                     "--emb_dim", full["emb_dim"], "--capacity", full["capacity"])
    args.device = dev
    evals = CriteoStats(batch_size=B, seed=seed + 90, split="eval")

    def counts():
        return np.array([gather_rows.launches_bf16,
                         gather_rows.launches - gather_rows.launches_bf16,
                         apply_rows_sr.launches_bf16,
                         apply_rows_sr.launches - apply_rows_sr.launches_bf16])

    spent = collections.Counter()  # seconds by part, printed
    st = dict(saves=[], step_s={}, losses={}, written=[], logged=0, resumed=None, rs={},
              launch_save=np.zeros(4, np.int64), launch_restore=np.zeros(4, np.int64),
              want_save=0, want_restore=0)

    # run() is observed from outside: for the length of the call the
    # class methods below are wrapped (and put back after), and each
    # wrapper acts only for the trainer and manager run() builds. That
    # trainer is the first to stage its data (once, right after its
    # restore: the main path starts there); run() is done with step n when
    # it calls train_step for step n + 1, and with the last step when it
    # returns.
    from deeprec_tpu_torch.training.checkpoint import CheckpointManager

    orig = dict(stage=Trainer.stage, train_step=Trainer.train_step,
                save=CheckpointManager.save, incr=CheckpointManager.save_incremental)
    main = dict(trainer=None, ck=None, twin=None, twin_losses={}, final=None)

    def stage(tr, *a, **kw):
        if main["trainer"] is None:
            main["trainer"] = tr
            _zero_row_counts()  # the main path starts here
            fused_gather_combine.launches = 0
        return orig["stage"](tr, *a, **kw)

    def train_step(tr, s, b, **kw):
        if tr is not main["trainer"]:
            return orig["train_step"](tr, s, b, **kw)
        if int(s.step):
            after_step(int(s.step), s)
        _sync(dev)
        t0 = time.perf_counter()
        out = orig["train_step"](tr, s, b, **kw)
        _sync(dev)
        step = int(s.step) + 1
        st["step_s"][step] = time.perf_counter() - t0
        spent["train steps"] += st["step_s"][step]
        st["losses"][step] = float(out[1]["loss"])
        return out

    def timed_save(fn, ck, state):
        main["ck"] = ck
        c0 = counts()
        _sync(dev)
        t0 = time.perf_counter()
        state, path = fn(ck, state)
        _sync(dev)
        sec = time.perf_counter() - t0
        st["launch_save"][:] += counts() - c0
        st["want_save"] += sum(b.num_tables for b in ck.trainer.bundles.values())
        spent["saves"] += sec
        rec = ck.last_save  # an async writer stamps write_ms into it when done
        rec.update(seconds=sec, step=int(state.step))
        st["written"].append((rec["kind"], int(state.step)))
        st["saves"].append(rec)
        if int(state.step) == S:  # no step follows: no stale state is kept
            main["final"] = state
        return state, path

    def save(ck, state):
        if ck.trainer is not main["trainer"]:
            return orig["save"](ck, state)
        return timed_save(orig["save"], ck, state)

    def save_incremental(ck, state):
        # the deltas after `async_after` go to the async writer
        if ck.trainer is not main["trainer"]:
            return orig["incr"](ck, state)
        return timed_save(CheckpointManager.save_incremental_async
                          if int(state.step) > cfg["async_after"] else orig["incr"], ck, state)

    def after_step(step, state):
        """run() is done with step `step` (its eval, eviction and saves)."""
        if step % cfg["log_every"] == 0:
            st["logged"] += 1
        if main["twin"] is not None:  # the restored trainer takes the same step
            tr2, st2, gen2 = main["twin"]
            st2, m2 = tr2.train_step(st2, gen2.batch())
            if step % cfg["evict_every"] == 0:  # run() evicted the live state
                st2 = tr2.evict_tables(st2)
            main["twin"] = (tr2, st2, gen2)
            main["twin_losses"][step] = float(m2["loss"])
            if step == S:
                t0 = time.perf_counter()
                st["resumed"] = _compare_resumed(state, st2, st["losses"],
                                                 main["twin_losses"], S - cfg["restore_at"])
                spent["resumed comparison"] += time.perf_counter() - t0
                main["twin"] = None
        if step == cfg["restore_at"]:
            t0 = time.perf_counter()
            tr = main["trainer"]
            rs = _ckpt_restore_gates(
                dev, cfg, tr, state, main["ck"],
                lambda: Trainer(tr.model, *zoo.make_optimizers(args), device=dev),
                tr.model, args._datasets["criteo_stats"], evals, ckdir, counts)
            st["launch_restore"][:] += rs.pop("launches")
            st["want_restore"] += rs.pop("want")
            main["twin"] = rs.pop("twin")
            st["rs"] = rs
            spent["restore gates"] += time.perf_counter() - t0

    t_loop = time.perf_counter()
    # the MLPerf model at `full` widths (model_fn("mlperf") at FULL), the
    # flags' admission and TTL options; run() makes its tables bf16
    model = DLRMDCN(**full, ev=zoo.ev_option(args), seed=seed)
    Trainer.stage, Trainer.train_step = stage, train_step
    CheckpointManager.save, CheckpointManager.save_incremental = save, save_incremental
    try:
        auc = zoo.run(model, args, "criteo")["auc"]
    finally:
        Trainer.stage, Trainer.train_step = orig["stage"], orig["train_step"]
        CheckpointManager.save, CheckpointManager.save_incremental = orig["save"], orig["incr"]
    # the last step: the state of run()'s final save is the state after it
    after_step(S, main["final"])
    st["launches"] = _launch_counts()
    _row_counts()  # ... and ends here (adds the bf16 launches to PAIR_LAUNCHES)
    loop_s = time.perf_counter() - t_loop
    spent["the rest of run()"] = loop_s - sum(spent.values())
    saves, losses, rs = st["saves"], st["losses"], st["rs"]
    for s_ in saves:  # what is still on disk after the final save
        s_["disk_mb"] = _dir_bytes(s_["path"]) / 1e6 if os.path.isdir(s_["path"]) else None
    listing = sorted(d for d in os.listdir(ckdir))
    want_listing = _jax_gc_listing(st["written"], cfg["keep"])
    with open(mfile) as f:
        mlines = [json.loads(line) for line in f]
    with open(os.path.join(trace_dir, TRACE_FILE)) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    n_lookup = sum(1 for n in names if n == "phase_lookup")
    members = st["want_save"] // max(len(saves), 1)
    stats = dict(saves=saves, step_s=st["step_s"], losses=losses, auc=auc,
                 launches=st["launches"], launch_save=st["launch_save"],
                 want_save=st["want_save"], launch_restore=st["launch_restore"],
                 want_restore=st["want_restore"], listing=listing, want_listing=want_listing,
                 metrics_lines=len(mlines), logged=st["logged"], trace_lookups=n_lookup,
                 members=members, loop_s=loop_s, resumed=st["resumed"],
                 spent={k: round(v, 2) for k, v in spent.items()}, **rs)
    if not np.all(np.isfinite(list(losses.values()))) or len(losses) != S:
        raise AssertionError(f"losses of {len(losses)} steps: {losses}")
    if st["resumed"] is None:
        raise AssertionError("the restored trainer never resumed")
    if listing != want_listing:
        raise AssertionError(f"retention left {listing}; the JAX _gc leaves {want_listing}")
    if len(mlines) != st["logged"] or [r["step"] for r in mlines] != list(
            range(cfg["log_every"], S + 1, cfg["log_every"])):
        raise AssertionError(f"metrics file: {mlines}")
    if n_lookup < 1:
        raise AssertionError("the timeline holds no phase_lookup range")
    if dev.type == "cuda":
        # #1 (values) and #3 (accumulators) once per member per save; #2 and
        # #5 once per bundle with rows per restored link
        wsave = np.array([st["want_save"], st["want_save"], 0, 0])
        wrest = np.array([0, 0, st["want_restore"], st["want_restore"]])
        if not (np.array_equal(st["launch_save"], wsave)
                and np.array_equal(st["launch_restore"], wrest)):
            raise AssertionError(f"checkpoint launches: saves {st['launch_save'].tolist()} "
                                 f"(want {wsave.tolist()}), restores "
                                 f"{st['launch_restore'].tolist()} (want {wrest.tolist()})")
    if not auc >= cfg["auc_floor"]:
        raise AssertionError(f"held-out AUC {auc} (floor {cfg['auc_floor']})")
    return stats


def _ckpt_restore_gates(dev, cfg, trainer, state, ck, make, model, gen, evals, ckdir,
                        counts):
    """Phase 16 (b) at `restore_at`, right after its delta: Predictor on the
    chain answers as eval_step on the live state; a second trainer, manager
    and CriteoStats restore the chain (equal to the live state per key bit
    for bit, the stream at the consumed index); then both trainers take the
    next steps (the first on its own loop's batches, this one here, each
    from its own stream) and are compared after each. Returns stats with
    the restore launches and the launches the restored links imply."""
    from deeprec_tpu_torch.data import CriteoStats
    from deeprec_tpu_torch.serving import Predictor
    from deeprec_tpu_torch.training.checkpoint import CheckpointManager

    ck.wait()
    batches = [evals.batch_at(100 + i) for i in range(cfg["requests"])]
    want_probs = [trainer.eval_step(state, b)[1].cpu().numpy() for b in batches]
    _sync(dev)
    t0 = time.perf_counter()
    p = Predictor(model, ckdir, device=dev)
    _sync(dev)
    reload_s = time.perf_counter() - t0
    for b, w in zip(batches, want_probs):
        got = p.predict(b)
        if got.shape != w.shape or not np.array_equal(got, w):
            raise AssertionError("Predictor on the chain differs from eval_step on the live "
                                 f"state by {np.abs(got - w).max()}")
    del p
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    gen2 = CriteoStats(batch_size=gen.B, seed=gen.seed, split="train")
    tr2 = make()
    c0 = counts()
    _sync(dev)
    t0 = time.perf_counter()
    ck2 = CheckpointManager(ckdir, tr2, keep=cfg["keep"], datasets={"criteo_stats": gen2})
    st2 = ck2.restore()
    _sync(dev)
    restore_s = time.perf_counter() - t0
    launches = counts() - c0
    chain = ck2.chain_dirs()  # verified already: no file is read again
    paths = [os.path.join(ckdir, c) for c in chain]
    t0 = time.perf_counter()
    n_keys = _same_state(st2, state, f"the chain {chain} against the live state")
    compare_s = time.perf_counter() - t0
    if gen2.save() != {"index": cfg["restore_at"]}:
        raise AssertionError(f"the restored stream is at {gen2.save()}")
    return dict(chain=chain, chain_mb=sum(_dir_bytes(p) for p in paths) / 1e6,
                reload_s=reload_s, restore_s=restore_s, compare_s=compare_s, restored_keys=n_keys, launches=launches,
                want=sum(_link_bundles(p) for p in paths), twin=(tr2, st2, gen2))


def _compare_resumed(a, b, losses, twin_losses, steps):
    """Two trainers that took the same `steps` steps from one state (the
    live one and its restored twin): losses within TRAIN_RTOL, accumulators
    within TRAIN_RTOL relative per step, bf16 rows within one bf16 ulp per
    step, per key. Returns (bit for bit, max loss difference, max row
    difference in ulps, max accumulator difference relative, keys)."""
    dl = max(abs(twin_losses[s] - losses[s]) / abs(losses[s]) for s in twin_losses)
    if dl > TRAIN_RTOL:
        raise AssertionError(f"resumed losses differ by {dl} relative")
    ulps, rel, n, exact = 0.0, 0.0, 0, True
    top = lambda x: float(x.max()) if x.numel() else 0.0  # noqa: E731
    for bname, x in a.tables.items():
        y = b.tables[bname]
        for t in range(x.keys.shape[0]):
            (ka, va, aa, ma), (kb, vb, ab, mb) = _member_arrays(x, t), _member_arrays(y, t)
            if not (torch.equal(ka, kb) and torch.equal(ma[:2], mb[:2])):
                raise AssertionError(f"resumed {bname}[{t}]: other keys or metadata")
            exact = exact and torch.equal(va, vb) and torch.equal(aa, ab)
            va, vb = va.double(), vb.double()
            u = _bf16_ulp(va)
            ulps = max(ulps, top((vb - va).abs() / torch.where(u > 0, u, torch.ones_like(u))))
            rel = max(rel, top((ab - aa).abs() / aa.abs().clamp_min(1e-30)))
            n += len(ka)
    dd = max(float((a.dense[k] - b.dense[k]).abs().max()) for k in a.dense)
    exact = exact and dl == 0 and dd == 0
    if ulps > steps or rel > steps * TRAIN_RTOL:
        raise AssertionError(f"resumed rows differ by {ulps} bf16 ulps, accumulators by "
                             f"{rel} relative ({steps} steps)")
    return dict(exact=exact, loss_diff=dl, row_ulps=ulps, accum_rel=rel, dense_diff=dd, keys=n)


def run_ckpt(dev, seed, full, small, cfg, ckroot):
    """Phase 16: (a) then (b), printed. Returns the launches of (#1, #3, #2,
    #5, #4) over (b)'s path."""
    t0 = time.perf_counter()
    tmp = os.path.join(ckroot, "ckpt")
    os.makedirs(tmp, exist_ok=True)
    for line in ckpt_agreement(dev, seed, small, cfg, os.path.join(tmp, "agree")):
        print(f"checkpoint agreement at capacity {small['capacity']}, {dev.type} vs cpu: {line}")
    a_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    st = ckpt_loop_phase(dev, seed, full, cfg, os.path.join(tmp, "run", "ck"))
    B = cfg["batch"]
    print(f"checkpoint loop: DLRM-DCN {full} with bf16 tables, CounterFilter("
          f"{cfg['filter_freq']}), GlobalStepEvict({cfg['steps_to_live']}), CriteoStats "
          f"batch {B}, {cfg['steps']} steps in {st['loop_s']:.1f} s; keep {cfg['keep']}")
    for s in st["saves"]:
        what = (f"async: caller stall {s['stall_ms']:.1f} ms, write_ms {s.get('write_ms')}"
                if s["async"] else f"{s['seconds']:.3f} s")
        disk = "gone (retention)" if s["disk_mb"] is None else f"{s['disk_mb']:.1f} MB on disk"
        print(f"checkpoint loop: step {s['step']} {s['kind']} save, {what}; "
              f"transfer_bytes {s['transfer_bytes']}, rows {s['rows']}, {disk}")
    print(f"checkpoint loop: chain {st['chain']} ({st['chain_mb']:.1f} MB) restored by a second "
          f"trainer in {st['restore_s']:.3f} s, {st['restored_keys']} keys equal to the live "
          f"state at step {cfg['restore_at']} bit for bit (rows, accumulators, freq, version, "
          f"dirty; dense and Adam), the stream at index {cfg['restore_at']}; Predictor reloaded "
          f"the chain in {st['reload_s']:.3f} s and answered {cfg['requests']} batches equal to "
          f"eval_step bit for bit")
    r = st["resumed"]
    print(f"checkpoint loop: both trainers took steps {cfg['restore_at'] + 1}-{cfg['steps']}: "
          f"bit for bit {r['exact']}; losses within {r['loss_diff']:.3g} relative, rows within "
          f"{r['row_ulps']:.3g} bf16 ulps, accumulators within {r['accum_rel']:.3g} relative, "
          f"dense within {r['dense_diff']:.3g} ({r['keys']} keys)")
    win = {}
    tl = cfg["timeline"]
    for w0 in range(0, cfg["steps"], cfg["incr_steps"]):
        ws = range(w0 + 1, w0 + cfg["incr_steps"] + 1)
        if w0 == 0 or w0 >= cfg["restore_at"] or any(tl[0] < s <= tl[1] for s in ws):
            continue  # warm-up, the resumed twin's window, traced steps
        kind = "async delta in flight" if w0 > cfg["async_after"] else "none in flight"
        win.setdefault(kind, []).append(
            (w0 + 1, round(len(ws) * B / sum(st["step_s"][s] for s in ws), 1)))
    print(f"checkpoint loop: examples/s per window of {cfg['incr_steps']} steps (first step, "
          f"examples/s) {win}")
    print(f"checkpoint loop: saves launched (#1, #3, #2, #5) {st['launch_save'].tolist()} "
          f"({st['members']} members x {st['want_save'] // st['members']} saves); the restore "
          f"{st['launch_restore'].tolist()} ({st['want_restore']} bundles with rows over the "
          f"chain's links); the whole path (#1, #3, #2, #5, #4) {st['launches'].tolist()}")
    print(f"checkpoint loop: retention left {st['listing']} (the JAX _gc: "
          f"{st['want_listing']}); metrics file {st['metrics_lines']} lines for {st['logged']} "
          f"logs; timeline steps {cfg['timeline'][0]}-{cfg['timeline'][1] - 1}: "
          f"{st['trace_lookups']} phase_lookup ranges")
    losses = st["losses"]
    print(f"checkpoint loop: losses {losses[1]:.6f} .. {losses[cfg['steps']]:.6f}; held-out AUC "
          f"over {cfg['eval_batches']} batches {st['auc']:.6f} (floor {cfg['auc_floor']})")
    print(f"checkpoint loop: seconds by part {st['spent']}; the per-key comparison at step "
          f"{cfg['restore_at']} {st['compare_s']:.2f} s")
    print(f"phase 16 (the checkpoint lifecycle) took {time.perf_counter() - t0:.1f} s "
          f"(agreement {a_s:.1f} s)")
    return st["launches"]


# ------------------------------------------------------------ phase 17

INGEST = dict(batch=2048, K=8, files=4, rows=49_152 + 848, eval_batches=8, shard_batches=8,
              workers=4, worker_counts=(1, 2, 4), save_after=4, stop_after=6, keep=3,
              lr=0.05, dense_lr=1e-3, filter_freq=2, auc_floor=0.55,
              drain=dict(k_stack=2, shard_batches=2),
              compose=dict(capacity=1 << 12, dim=16, steps=4, ids=3000, static=1 << 10),
              wq=dict(slices=2, steps=16, save_at=8, capacity=1 << 17),
              stream=dict(steps=8, save_at=4))

# Multi-hash gradients, card vs CPU: index backward sums each bucket's
# rows in another order; 1024 ids into 64 buckets of |2 e| < 1 per row.
COMPOSE_GRAD_ATOL = 1e-5
# Table rows of the composite lookups, card vs CPU: the initializer's
# torch.erfinv differs between the two in the last bits (rows of N(0, 0.05²)
# scale, well under 1; the masks and the routing are compared exactly).
COMPOSE_ROW_ATOL = 1e-6

_HEX = np.frombuffer(b"0123456789abcdef", np.uint8)


def _digits(vals, base):
    """Left-aligned ASCII digits of non-negative ints [n, f] in `base`:
    ([n, f, width] uint8, lengths [n, f])."""
    vals = np.asarray(vals, np.int64)
    nd = np.ones(vals.shape, np.int64)
    x = vals // base
    while (x > 0).any():
        nd += x > 0
        x //= base
    exp = nd[..., None] - 1 - np.arange(int(nd.max()))
    chars = _HEX[(vals[..., None] // base ** np.clip(exp, 0, None)) % base]
    chars[exp < 0] = 0
    return chars, nd


def criteo_tsv_bytes(batch, num_dense=13, num_cat=26):
    """Criteo TSV text of a generator batch, built without a loop over
    rows: the label, each dense value as the integer floor(10 x) (an empty
    field where it is 0, as a missing Criteo count) and each id as a hex
    token, tab-separated, one line per row."""
    n = len(batch["label"])
    dense = np.floor(np.concatenate([batch[f"I{i + 1}"] for i in range(num_dense)], 1)
                     * 10).astype(np.int64)
    parts = [_digits(batch["label"].astype(np.int64)[:, None], 10),
             _digits(dense, 10),
             _digits(np.stack([batch[f"C{c + 1}"] for c in range(num_cat)], 1), 16)]
    parts[1][1][dense == 0] = 0  # missing
    W = max(p[0].shape[2] for p in parts) + 1
    cube = np.zeros((n, 1 + num_dense + num_cat, W), np.uint8)
    lens = np.concatenate([p[1] for p in parts], 1)
    col = 0
    for chars, nd in parts:
        cube[:, col:col + nd.shape[1], :chars.shape[2]] = chars
        col += nd.shape[1]
    sep = np.full(lens.shape, 9, np.uint8)
    sep[:, -1] = 10
    np.put_along_axis(cube, lens[..., None], sep[..., None], 2)
    return cube[np.arange(W) <= lens[..., None]].tobytes()


def ingest_files(root, seed, cfg):
    """The training files (`files` x `rows` rows of CriteoStats(seed + 170),
    one stream batch each) and the held-out file (eval_batches x batch rows
    of the eval split). Returns (paths, eval path, seconds, MB)."""
    from deeprec_tpu_torch.data import CriteoStats

    t0 = time.perf_counter()
    os.makedirs(root, exist_ok=True)
    gen = CriteoStats(batch_size=cfg["rows"], seed=seed + 170, split="train")
    paths, nbytes = [], 0
    for i in range(cfg["files"]):
        paths.append(os.path.join(root, f"day{i}.tsv"))
        data = criteo_tsv_bytes(gen.batch_at(i))
        with open(paths[-1], "wb") as f:
            f.write(data)
        nbytes += len(data)
    held = CriteoStats(batch_size=cfg["eval_batches"] * cfg["batch"], seed=seed + 170,
                       split="eval")
    eval_path = os.path.join(root, "eval.tsv")
    with open(eval_path, "wb") as f:
        f.write(criteo_tsv_bytes(held.batch_at(0)))
    return paths, eval_path, time.perf_counter() - t0, nbytes / 1e6


def _digest(item):
    """sha1 of a batch or unit: its keys, dtypes, shapes and bytes."""
    import hashlib

    h = hashlib.sha1()
    for k in sorted(item):
        a = np.ascontiguousarray(item[k])
        h.update(f"{k}:{a.dtype}:{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def serial_units(paths, cfg, ks):
    """The serial stream (`CriteoCSVReader` over the native parser, file by
    file) grouped into the pipeline's units of K batches within a file, for
    each K in `ks`: {K: [unit digests]}."""
    from deeprec_tpu_torch.data import CriteoCSVReader
    from deeprec_tpu_torch.training.trainer import stack_batches

    out = {K: [] for K in ks}
    for p in paths:
        batches = list(CriteoCSVReader([p], batch_size=cfg["batch"]))
        for K in ks:
            out[K] += [_digest(stack_batches(batches[u * K:(u + 1) * K]))
                       for u in range(len(batches) // K)]
    return out


def parse_agreement(paths, cfg):
    """The native parser, multi- and single-threaded, against
    `criteo_block_parse` on every file, bit for bit. Returns per file
    (rows, MB, native mt s, native st s, block s)."""
    from deeprec_tpu_torch.data import criteo_block_parse
    from deeprec_tpu_torch.native import criteo_parse_native

    out = []
    for p in paths:
        with open(p, "rb") as f:
            data = f.read()
        t0 = time.perf_counter()
        want = criteo_block_parse(data)
        tb = time.perf_counter() - t0
        n = len(want["label"])
        times = []
        for threads in (0, 1):
            t0 = time.perf_counter()
            rows, labels, dense, cats, consumed = criteo_parse_native(data, n + 1, threads=threads)
            times.append(time.perf_counter() - t0)
            got = {"label": labels[:rows]}
            got.update({f"I{i + 1}": dense[:rows, i:i + 1] for i in range(dense.shape[1])})
            got.update({f"C{c + 1}": cats[:rows, c] for c in range(cats.shape[1])})
            if rows != n or consumed != len(data) or _digest(got) != _digest(want):
                raise AssertionError(f"{p}: the native parser (threads={threads}) differs "
                                     f"from criteo_block_parse ({rows} of {n} rows)")
        out.append((n, len(data) / 1e6, times[0], times[1], tb))
    return out


def pipeline_agreement(paths, cfg, serial):
    """ParallelInputPipeline at each worker count, drained alone at the
    `drain` shape (k_stack, shard_batches: small shards, so that every
    worker count gets several waves of them), against the serial stream's
    units bit for bit. Returns {workers: (shards, units, records/s, MB/s,
    stats)}."""
    from deeprec_tpu_torch.data import ParallelInputPipeline, plan_shards

    out = {}
    K, sb = cfg["drain"]["k_stack"], cfg["drain"]["shard_batches"]
    shards = len(plan_shards(paths, cfg["batch"], K, sb))
    for w in cfg["worker_counts"]:
        pl = ParallelInputPipeline(paths, batch_size=cfg["batch"], num_workers=w,
                                   k_stack=K, shard_batches=sb)
        t0 = time.perf_counter()
        got = [_digest(u) for u in pl]
        sec = time.perf_counter() - t0
        pl.close()
        st = pl.stats()
        if got != serial:
            bad = [i for i, (a, b) in enumerate(zip(got, serial)) if a != b]
            raise AssertionError(f"the pipeline at {w} workers emitted {len(got)} units, the "
                                 f"serial stream {len(serial)}; differing units {bad[:8]}")
        out[w] = (shards, len(got), st["records"] / sec, st["bytes"] / 1e6 / sec, st)
    return out


def compose_agreement(dev, seed, cfg):
    """MultiHashTable, DynamicDimEmbedding and AdaptiveEmbedding on `dev`
    and on the CPU from one generator, per key over `steps` train lookups:
    the uids, the masked dims, the static routing and the multi-hash lookup
    bit for bit; the table rows within COMPOSE_ROW_ATOL and the multi-hash
    gradients within COMPOSE_GRAD_ATOL. Returns (keys compared, the largest
    row difference)."""
    from deeprec_tpu_torch.config import CounterFilter, EmbeddingVariableOption, TableConfig
    from deeprec_tpu_torch.embedding import EmbeddingTable
    from deeprec_tpu_torch.embedding.compose import (
        AdaptiveEmbedding, DynamicDimEmbedding, MultiHashConfig, MultiHashTable)

    from deeprec_tpu_torch.data.synthetic import zipf_ids

    rng = np.random.default_rng(seed + 171)
    ids = [torch.from_numpy(zipf_ids(rng, cfg["ids"], 1.2, (2, 512)).astype(np.int32))
           for _ in range(cfg["steps"])]
    runs, grads = {}, {}
    for d in (dev, torch.device("cpu")):
        out = []
        mh = MultiHashTable(MultiHashConfig("mh", cfg["dim"], 64, 64))
        params = tuple(p.requires_grad_() for p in mh.create(
            torch.Generator().manual_seed(seed), device=d))
        (mh.lookup(params, ids[0].to(d)) ** 2).sum().backward()
        out.append(("multihash", (ids[0].numpy(),), mh.lookup(params, ids[0].to(d)).detach().cpu()))
        grads[d.type] = torch.cat([params[0].grad, params[1].grad]).cpu()
        ev = EmbeddingVariableOption(counter_filter=CounterFilter(filter_freq=3))
        for kind in ("dyndim", "adaptive"):
            table = EmbeddingTable(TableConfig(name=kind, dim=cfg["dim"],
                                               capacity=cfg["capacity"], ev=ev))
            state = table.create(2, device=d)
            if kind == "dyndim":
                mod = DynamicDimEmbedding(table, (4, 8, cfg["dim"]), (2, 4))
            else:
                mod = AdaptiveEmbedding(table, static_buckets=cfg["static"])
                static = mod.create_static(torch.Generator().manual_seed(seed), device=d)
            for step, x in enumerate(ids):
                if kind == "dyndim":
                    res = mod.lookup_unique(state, x.to(d), step=step)
                else:
                    res, use = mod.lookup_unique(state, static, x.to(d), step=step)
                for t in range(2):
                    u = res.uids[t].cpu().numpy()
                    order = np.argsort(u)
                    emb = res.embeddings[t].float().cpu().numpy()[order]
                    route = (emb == 0) if kind == "dyndim" else use[t].cpu().numpy()[order]
                    out.append((f"{kind} step {step} table {t}", (u[order], route), emb))
        runs[d.type] = out
    n, row_err = 0, 0.0
    for (what, a, b), (_, c, e) in zip(runs[dev.type], runs["cpu"]):
        b, e = np.asarray(b), np.asarray(e)
        diff = float(np.abs(b - e).max(initial=0))
        if not all(np.array_equal(x, y) for x, y in zip(a, c)):
            raise AssertionError(f"compose {what}: the keys or the routing differ "
                                 f"({dev.type} vs cpu)")
        if what == "multihash" and diff != 0 or diff > COMPOSE_ROW_ATOL:
            raise AssertionError(f"compose {what}: rows differ by {diff} ({dev.type} vs cpu)")
        row_err = max(row_err, diff)
        n += int((a[0] != np.iinfo(a[0].dtype).min).sum())
    err = float((grads[dev.type] - grads["cpu"]).abs().max())
    if err > COMPOSE_GRAD_ATOL:
        raise AssertionError(f"multi-hash gradients differ by {err} ({dev.type} vs cpu)")
    return n, row_err


class _Tapped:
    """A pipeline seen through a digest tap: iterating it records each
    emitted unit's digest in order (in the staging thread); the
    exactly-once hooks pass through, so `Trainer.stage` wires them."""

    def __init__(self, pl):
        self.pl, self.digests = pl, []

    def __iter__(self):
        for unit in self.pl:
            self.digests.append(_digest(unit))
            yield unit

    def attach_consumer(self):
        self.pl.attach_consumer()

    def mark_consumed(self):
        self.pl.mark_consumed()


def _stall_total():
    """The registry's `deeprec_input_stall_seconds_total{site="staged"}`."""
    from deeprec_tpu_torch.obs import metrics as obs_metrics

    return obs_metrics.default_registry().counter(
        "deeprec_input_stall_seconds_total", "cumulative consumer wait for input",
        {"site": "staged"}).value


def ingest_loop(dev, seed, full, paths, evals, cfg, ckdir, serial):
    """Phase 17 (b) and (e): the file-fed loop — an uninterrupted run (the
    oracle), the same number of windows fed by CriteoStats on a fresh
    trainer (units of K batches stacked as the pipeline stacks them) and
    on another with the same units made beforehand, a run
    saved after window `save_after` and stopped after `stop_after`, and a
    second trainer and pipeline restoring the save and running to the end
    of the data. Returns stats."""
    from deeprec_tpu_torch.data import CriteoStats, ParallelInputPipeline
    from deeprec_tpu_torch.optim import Adagrad, adam
    from deeprec_tpu_torch.training.checkpoint import CheckpointManager
    from deeprec_tpu_torch.training.trainer import Trainer, stack_batches

    K, B = cfg["K"], cfg["batch"]
    model = _ckpt_model(full, seed, cfg)
    units = len(serial)

    def make():
        return Trainer(model, Adagrad(lr=cfg["lr"]), adam(cfg["dense_lr"]), device=dev,
                       pipeline_mode="lookahead")

    def pipeline():
        return _Tapped(ParallelInputPipeline(paths, batch_size=B, num_workers=cfg["workers"],
                                             k_stack=K, shard_batches=cfg["shard_batches"]))

    def windows(trainer, state, src, n, log):
        """Up to n windows from the staged source, each timed and with the
        training thread's stall, read from the registry and held against
        the Prefetcher's own total; stops at the end of the data."""
        losses = []
        for _ in range(n):
            s0, p0 = _stall_total(), src.stall_seconds
            _sync(dev)
            t0 = time.perf_counter()
            try:
                unit = next(src)
            except StopIteration:
                break
            state, mets = trainer.train_steps(state, unit)
            _sync(dev)
            log.append((time.perf_counter() - t0, _stall_total() - s0))
            if abs(log[-1][1] - (src.stall_seconds - p0)) > 1e-6:
                raise AssertionError(f"the registry's staged stall {log[-1][1]} s, the "
                                     f"Prefetcher's {src.stall_seconds - p0} s")
            losses.extend(mets["loss"].tolist())
        return state, losses

    stats = {}
    # the uninterrupted run: the oracle
    oracle = make()
    per_step = _loop_launches(oracle)
    per_req = _per_request(oracle)
    st_o = oracle.init()
    tap_o = pipeline()
    src = oracle.stage(tap_o, depth=2)
    stats["oracle_windows"] = []
    st_o, losses_o = windows(oracle, st_o, src, units + 1, stats["oracle_windows"])
    src.close()
    tap_o.pl.close()
    stats["auc_oracle"] = oracle.evaluate(st_o, evals)["auc"]
    if tap_o.digests != serial:
        raise AssertionError("the oracle's pipeline stream differs from the serial stream")

    # the same windows from CriteoStats on a fresh trainer: the generator's
    # cost. One unit made first with no other thread at work. Then the same
    # units, all made before the windows, on another fresh trainer: the
    # same work with no generator running beside the training thread.
    def generated(gen):
        for _ in range(units):
            yield stack_batches([gen.batch() for _ in range(K)])

    for arm in ("gen", "made"):
        src = generated(CriteoStats(batch_size=B, seed=seed + 170, split="train"))
        t0 = time.perf_counter()
        made = [next(src)] if arm == "gen" else list(src)
        stats[f"{arm}_s"] = (time.perf_counter() - t0) / len(made)
        fresh = make()
        st_g = fresh.init()
        staged = fresh.stage(itertools.chain(made, src), depth=2)
        stats[f"{arm}_windows"] = []
        st_g, stats[f"{arm}_losses"] = windows(fresh, st_g, staged, units,
                                               stats[f"{arm}_windows"])
        staged.close()
        del fresh, st_g, staged, made
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if stats["gen_losses"] != stats["made_losses"]:
        raise AssertionError("the CriteoStats-fed runs, live and made before, lost differently")

    # the interrupted run
    run1 = make()
    st1 = run1.init()
    tap1 = pipeline()
    ck = CheckpointManager(ckdir, run1, keep=cfg["keep"], datasets={"pipeline": tap1.pl})
    src = run1.stage(tap1, depth=2)
    stats["run1_windows"] = []
    st1, _ = windows(run1, st1, src, cfg["save_after"], stats["run1_windows"])
    saved_pos = tap1.pl.save()
    _sync(dev)
    t0 = time.perf_counter()
    st1, path = ck.save(st1)
    _sync(dev)
    stats["save_s"] = time.perf_counter() - t0
    st1, _ = windows(run1, st1, src, cfg["stop_after"] - cfg["save_after"], stats["run1_windows"])
    consumed1 = tap1.digests[:cfg["stop_after"]]  # the stream is in order
    src.close()
    tap1.pl.close()
    ck.close()
    del run1, st1, src, ck
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the resumed run: a second trainer and a new pipeline
    run2 = make()
    tap2 = pipeline()
    ck2 = CheckpointManager(ckdir, run2, keep=cfg["keep"], datasets={"pipeline": tap2.pl})
    _sync(dev)
    t0 = time.perf_counter()
    st2 = ck2.restore()
    _sync(dev)
    stats["restore_s"] = time.perf_counter() - t0
    if tap2.pl.save() != saved_pos:
        raise AssertionError(f"the restored pipeline is at {tap2.pl.save()}, saved {saved_pos}")
    src = run2.stage(tap2, depth=2)
    stats["run2_windows"] = []
    st2, losses2 = windows(run2, st2, src, units + 1, stats["run2_windows"])
    src.close()
    tap2.pl.close()
    ck2.close()
    # exactly once: the units before the save from run 1, the rest from run 2
    got = consumed1[:cfg["save_after"]] + tap2.digests
    if got != serial:
        raise AssertionError(f"across the two runs the units consumed were {len(got)}, not "
                             f"each of the {units} serial units exactly once")
    if consumed1[cfg["save_after"]:] != tap2.digests[:cfg["stop_after"] - cfg["save_after"]]:
        raise AssertionError("the replayed units differ from the first run's")
    _sync(dev)
    t0 = time.perf_counter()
    stats["keys"] = _same_state(st2, st_o, "the resumed run against the uninterrupted one",
                                meta=2)
    _sync(dev)
    stats["compare_s"] = time.perf_counter() - t0
    stats["auc"] = run2.evaluate(st2, evals)["auc"]
    del oracle, st_o
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    losses = losses_o + stats["gen_losses"] + losses2
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss in the file-fed loop: {losses}")
    if not stats["auc"] >= cfg["auc_floor"]:
        raise AssertionError(f"held-out AUC {stats['auc']} (floor {cfg['auc_floor']})")
    members = sum(b.num_tables for b in run2.bundles.values())
    steps = (3 * units + cfg["stop_after"] + units - cfg["save_after"]) * K
    want = np.concatenate([steps * per_step, [0]])
    want[0] += 2 * len(evals) * per_req[0] + members  # 2 evaluations; the save's #1
    want[1] += members  # the save's #3 (accumulators)
    want[2] += _link_bundles(path)  # the restore's #2 and #5
    want[3] += _link_bundles(path)
    want[4] = 2 * len(evals) * per_req[1]
    stats.update(want=want, units=units, losses=losses_o + losses2, saved_pos=saved_pos,
                 trainer=run2, state=st2, model=model)
    return stats


def workqueue_leg(dev, seed, full, paths, cfg, ckdir):
    """Phase 17 (c): run()'s --workqueue leg at `full` widths and
    wq["capacity"] slots: WorkQueue(num_slices=2, num_epochs=1) ->
    input_dataset(batch, drop_remainder=True) -> stage -> train_step; a full
    save after `save_at` steps carries the queue's position, which a second
    manager, trainer and queue restore (the state per key, the position,
    the remaining items); then the first run takes the rest of its steps.
    Returns stats."""
    from deeprec_tpu_torch.data import WorkQueue, parse_slice
    from deeprec_tpu_torch.optim import Adagrad, adam
    from deeprec_tpu_torch.training.checkpoint import CheckpointManager
    from deeprec_tpu_torch.training.trainer import Trainer

    wq, B = cfg["wq"], cfg["batch"]
    model = _ckpt_model(full, seed, cfg, capacity=wq["capacity"])

    def make():
        return Trainer(model, Adagrad(lr=cfg["lr"]), adam(cfg["dense_lr"]), device=dev)

    tr = make()
    st = tr.init()
    q = WorkQueue(paths, num_epochs=1, num_slices=wq["slices"])
    items = list(q.save()["items"])
    ck = CheckpointManager(ckdir, tr, datasets={"workqueue": q})
    staged = tr.stage(q.input_dataset(B, drop_remainder=True), depth=2)
    losses, consumed = [], 0
    for batch in staged:
        st, mets = tr.train_step(st, batch)
        losses.append(float(mets["loss"]))
        consumed += 1
        if consumed == wq["save_at"]:
            st, path = ck.save(st)
            with open(os.path.join(path, "datasets.part00000.json")) as f:
                pos = json.load(f)["workqueue"]
            links = _link_bundles(path)
            tr2 = make()
            q2 = WorkQueue(paths, num_epochs=1, num_slices=wq["slices"])
            ck2 = CheckpointManager(ckdir, tr2, datasets={"workqueue": q2})
            st_r = ck2.restore()
            keys = _same_state(st_r, st, "the work-queue leg's restore", meta=2)
            if q2.save() != pos:
                raise AssertionError(f"the restored queue is at {q2.save()['cursor']}, saved "
                                     f"{pos['cursor']}")
            cursor = pos["cursor"]
            rest = list(q2)
            del tr2, st_r, ck2
        if consumed == wq["steps"]:
            break
    staged.close()
    ck.close()
    # the records of the items taken before the save that the loop had not
    # consumed: the reference records its cursor at take time
    rows = 0
    for item in items[:cursor]:
        path, k, n = parse_slice(item)
        lo, hi = WorkQueue._slice_range(path, k, n)
        with open(path, "rb") as f:
            f.seek(lo)
            rows += f.read(hi - lo).count(b"\n") // B * B
    if rest != items[cursor:]:
        raise AssertionError(f"the restored queue yields {rest}, want {items[cursor:]}")
    if not np.all(np.isfinite(losses)) or consumed != wq["steps"]:
        raise AssertionError(f"work-queue leg: {consumed} steps, losses {losses}")
    return dict(items=len(items), cursor=cursor, keys=keys, losses=losses, links=links,
                skipped=rows - wq["save_at"] * B, steps=consumed, trainer=tr, state=st)


def stream_leg(dev, paths, cfg, trainer, state):
    """Phase 17 (d): FileStreamServer over the first training file ->
    TCPStreamReader -> train_step, `steps` steps; the reader is saved after
    `save_at` and a new reader restored from the position serves the rest.
    Every record the loop received is the file's next one: the batch
    digests equal the serial stream's first ones. Returns stats."""
    from deeprec_tpu_torch.data import CriteoCSVReader, FileStreamServer, TCPStreamReader

    sc, B = cfg["stream"], cfg["batch"]
    want = [_digest(b) for b, _ in zip(CriteoCSVReader([paths[0]], batch_size=B),
                                       range(sc["steps"]))]
    srv = FileStreamServer(paths[0]).start()
    got, losses = [], []
    try:
        r1 = TCPStreamReader("127.0.0.1", srv.port, batch_size=B, stop_at_eof=True)
        it = iter(r1)
        for _ in range(sc["save_at"]):
            batch = next(it)
            got.append(_digest(batch))
            state, mets = trainer.train_step(state, batch)
            losses.append(float(mets["loss"]))
        pos = r1.save()
        it.close()
        r2 = TCPStreamReader("127.0.0.1", srv.port, batch_size=B, stop_at_eof=True)
        r2.restore(pos)
        it = iter(r2)
        for _ in range(sc["steps"] - sc["save_at"]):
            batch = next(it)
            got.append(_digest(batch))
            state, mets = trainer.train_step(state, batch)
            losses.append(float(mets["loss"]))
        it.close()
    finally:
        srv.stop()
    if got != want:
        bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        raise AssertionError(f"the stream leg's batches {bad} are not the file's records")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"stream leg losses {losses}")
    return dict(offset=pos["offset"], losses=losses, state=state)


def run_ingest(dev, seed, full, cfg, ckroot):
    """Phase 17: (a) to (e), printed. Returns the launches of (#1, #3, #2,
    #5, #4) over (b)-(d)'s path."""
    from deeprec_tpu_torch.data import CriteoCSVReader
    from deeprec_tpu_torch.obs import metrics as obs_metrics

    if not obs_metrics.metrics_enabled():
        raise AssertionError("phase 17 reads deeprec_input_stall_seconds: the metrics are off "
                             "(DEEPREC_OBS)")
    t0 = time.perf_counter()
    root = os.path.join(ckroot, "ingest")
    paths, eval_path, write_s, mb = ingest_files(os.path.join(root, "data"), seed, cfg)
    print(f"ingest: {len(paths)} Criteo TSV files of {cfg['rows']} rows and a held-out file "
          f"of {cfg['eval_batches']} x {cfg['batch']} rows from CriteoStats, {mb:.1f} MB "
          f"written in {write_s:.2f} s")
    t1 = time.perf_counter()
    for p, (n, m, tmt, tst, tb) in zip(paths, parse_agreement(paths, cfg)):
        print(f"ingest (a): {os.path.basename(p)} {n} rows, {m:.2f} MB: the native parser "
              f"(multi-threaded {tmt * 1e3:.1f} ms, single {tst * 1e3:.1f} ms) equal to "
              f"criteo_block_parse ({tb * 1e3:.1f} ms) bit for bit")
    dk = cfg["drain"]["k_stack"]
    serial = serial_units(paths, cfg, sorted({dk, cfg["K"]}))
    for w, (sh, u, rps, mbps, st) in pipeline_agreement(paths, cfg, serial[dk]).items():
        print(f"ingest (a): ParallelInputPipeline at {w} workers (k_stack {dk}, shard_batches "
              f"{cfg['drain']['shard_batches']}: {sh} shards): {u} units equal to the serial "
              f"CriteoCSVReader stream bit for bit; {rps:.1f} records/s, {mbps:.2f} MB/s; worker "
              f"seconds read {st['read_s']:.3f}, parse {st['parse_s']:.3f}, pack "
              f"{st['pack_s']:.3f}; consumer stall {st['stall_s']:.3f} s")
    keys, row_err = compose_agreement(dev, seed, cfg["compose"])
    print(f"ingest (a): MultiHashTable, DynamicDimEmbedding and AdaptiveEmbedding at capacity "
          f"{cfg['compose']['capacity']}: {dev.type} vs cpu, {keys} keys, routing and masks bit "
          f"for bit, rows within {row_err:.3g} (tolerance {COMPOSE_ROW_ATOL})")
    a_s = time.perf_counter() - t1
    evals = list(CriteoCSVReader([eval_path], batch_size=cfg["batch"]))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    _zero_row_counts()  # the main path starts here
    from deeprec_tpu_torch.ops.fused_lookup import fused_gather_combine

    fused_gather_combine.launches = 0
    st = ingest_loop(dev, seed, full, paths, evals, cfg, os.path.join(root, "ck"),
                     serial[cfg["K"]])
    B, K = cfg["batch"], cfg["K"]

    def eps(log):
        return [round(K * B / s, 1) for s, _ in log]

    print(f"ingest (b): DLRM-DCN {full} with bf16 tables, CounterFilter({cfg['filter_freq']}) "
          f"fed by ParallelInputPipeline(num_workers={cfg['workers']}, k_stack={K}) through "
          f"Trainer.stage into train_steps(K={K}, lookahead): {st['units']} units; the "
          f"uninterrupted run's windows (examples/s) {eps(st['oracle_windows'])}")
    print(f"ingest (b): training-thread stall per window (deeprec_input_stall_seconds"
          f"{{site=staged}}, s) {[round(s, 6) for _, s in st['oracle_windows']]}")
    print(f"ingest (b): a full save after window {cfg['save_after']} at {st['saved_pos']} in "
          f"{st['save_s']:.3f} s; stopped after window {cfg['stop_after']}; a second trainer "
          f"and pipeline restored in {st['restore_s']:.3f} s and ran windows "
          f"{eps(st['run2_windows'])}; every unit consumed exactly once across the two runs, "
          f"each equal to the serial stream's; the final state equal to the uninterrupted "
          f"run's per key bit for bit ({st['keys']} keys, compared on the card in "
          f"{st['compare_s']:.3f} s)")
    def spread(log):
        e = [K * B / s for s, _ in log[1:]]
        return (f"median {np.median(e):.1f}, {min(e):.1f}-{max(e):.1f} (n {len(e)}); stalls "
                f"{[round(s, 6) for _, s in log]} s")

    print(f"ingest (e): examples/s of windows 2-{st['units']}, each run on a fresh trainer; fed "
          f"by the pipeline: {spread(st['oracle_windows'])}")
    print(f"ingest (e): fed by CriteoStats through Trainer.stage in units of {K} stacked "
          f"batches, made while training: {spread(st['gen_windows'])}; the same units made "
          f"before the windows: {spread(st['made_windows'])}; the two runs' losses equal; "
          f"CriteoStats made a unit in {st['gen_s']:.3f} s alone, {st['made_s']:.3f} s a unit "
          f"over all {st['units']}")
    print(f"ingest (b): losses {st['losses'][0]:.6f} .. {st['losses'][-1]:.6f}; held-out AUC "
          f"{st['auc']:.6f} (uninterrupted {st['auc_oracle']:.6f}, floor {cfg['auc_floor']})")
    trainer, model = st.pop("trainer"), st.pop("model")
    del trainer, model
    st.pop("state")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    wq = workqueue_leg(dev, seed, full, paths, cfg, os.path.join(root, "wq"))
    print(f"ingest (c): WorkQueue({len(paths)} files, num_slices={cfg['wq']['slices']}) "
          f"{wq['items']} items -> input_dataset -> stage -> {wq['steps']} train_steps at "
          f"capacity {cfg['wq']['capacity']}; the save after step {cfg['wq']['save_at']} held "
          f"cursor {wq['cursor']}, restored with the state ({wq['keys']} keys bit for bit) "
          f"and the remaining items; the in-flight item's {wq['skipped']} unconsumed records "
          f"are skipped on restore (the reference records its cursor at take time)")
    sl = stream_leg(dev, paths, cfg, wq["trainer"], wq["state"])
    print(f"ingest (d): FileStreamServer -> TCPStreamReader -> {cfg['stream']['steps']} "
          f"train_steps, saved at offset {sl['offset']} after {cfg['stream']['save_at']} and "
          f"restored into a new reader: every record once, in the file's order; losses "
          f"{sl['losses'][0]:.6f} .. {sl['losses'][-1]:.6f}")
    launches = _launch_counts()
    _row_counts()  # ... and ends here (adds the bf16 launches to PAIR_LAUNCHES)
    per_step = _loop_launches(wq["trainer"])
    want = st["want"] + np.concatenate([(cfg["wq"]["steps"] + cfg["stream"]["steps"])
                                        * per_step, [0]])
    want[:2] += sum(b.num_tables for b in wq["trainer"].bundles.values())  # its save
    want[2:4] += wq["links"]  # its restore
    del wq, sl
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        if not np.array_equal(launches, want):
            raise AssertionError(f"phase 17 launched (#1, #3, #2, #5, #4) {launches.tolist()}, "
                                 f"the path implies {want.tolist()}")
    print(f"ingest: the path launched (#1, #3, #2, #5, #4) {launches.tolist()} (implied "
          f"{want.tolist()})")
    print(f"phase 17 (training from files and streams) took {time.perf_counter() - t0:.1f} s "
          f"(agreement {a_s:.1f} s)")
    shutil.rmtree(root, ignore_errors=True)
    return launches


# ------------------------------------------------------------ phase 18

# The serving stack under load while the chain grows: MLPerf DLRM-DCN at
# full width from empty f32 tables (phase 6's trainer: Adagrad 0.05, Adam
# 1e-3, batch 2048 of SyntheticCriteo(vocab=10^6)), a full save after
# `steps` steps, then `deltas` deltas of `steps` steps each written while
# `clients` HTTP clients send about `requests` requests of 1-`max_rows`
# rows (3 in 4 JSON, 1 in 4 protobuf) to HttpServer(ModelServer(
# Predictor(quality_gate=), max_batch, poll_updates_secs)).
SERVE = dict(batch=2048, vocab=1_000_000, lr=0.05, dense_lr=1e-3, steps=8, deltas=2,
             clients=8, requests=400, payloads=100, max_rows=256, max_batch=2048,
             poll_secs=0.5, probe=2048, timed=10, max_shift=0.5, boot_share=0.1)
# Coalesced answers against solo Predictor.predict of the same rows: a
# request padded into a larger bucket changes the GEMMs' M, and cuBLAS may
# pick another algorithm (TF32 stays off); the CPU tests hold 1e-6.
COALESCE_ATOL = 1e-5
# Quantized residencies against f32 on one batch (the JAX
# tests/test_serving_quantized.py bounds): int8's per-row scale bounds an
# element's error by max|row| / 254, bf16 by its 8-bit mantissa.
BF16_ATOL, INT8_ATOL, INT8_SHARE = 2e-2, 5e-3, 0.55


def _serve_requests(model, seed, cfg):
    """`payloads` request payloads (label-free numpy dicts) of 1 to
    `max_rows` rows cut from SyntheticCriteo batches of another seed, and a
    fixed probe batch of `probe` rows."""
    from deeprec_tpu_torch.data import SyntheticCriteo

    gen = SyntheticCriteo(batch_size=cfg["batch"], vocab=cfg["vocab"], seed=seed + 18,
                          num_cat=model.num_cat, num_dense=model.num_dense)
    pool = [{k: v for k, v in gen.batch().items() if not k.startswith("label")}
            for _ in range(4)]
    rng = np.random.default_rng(seed + 18)
    reqs = []
    for _ in range(cfg["payloads"]):
        b = pool[int(rng.integers(len(pool)))]
        n = int(rng.integers(1, cfg["max_rows"] + 1))
        a = int(rng.integers(0, cfg["batch"] - n + 1))
        reqs.append({k: v[a:a + n] for k, v in b.items()})
    probe = {k: v[:cfg["probe"]] for k, v in pool[0].items()}
    return reqs, probe


def _http(port, path, body=None, ctype="application/json"):
    """(status, body bytes) of one request to the local server."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers={"Content-Type": ctype} if body is not None else {})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _bodies(req):
    """(JSON body, protobuf PredictRequest body) of one request, encoded
    once before the load: a client encodes in its own process, so its
    encoding does not belong to the server's interpreter."""
    from deeprec_tpu_torch.serving import predict_pb as pb

    return (json.dumps({"features": {k: v.tolist() for k, v in req.items()}}).encode(),
            pb.PredictRequest(inputs={k: pb.ArrayProto.from_numpy(np.asarray(v))
                                      for k, v in req.items()}).serialize())


def _predict_http(port, bodies, proto):
    """(probabilities, stamped version or None) of one /v1/predict, as JSON
    or as a protobuf PredictRequest (whose response carries no version)."""
    from deeprec_tpu_torch.serving import predict_pb as pb

    if proto:
        code, data = _http(port, "/v1/predict", bodies[1], "application/x-protobuf")
        if code != 200:
            raise AssertionError(f"protobuf /v1/predict answered {code}: {data[:200]}")
        return pb.PredictResponse.parse(data).outputs["probabilities"].to_numpy(), None
    code, data = _http(port, "/v1/predict", bodies[0])
    if code != 200:
        raise AssertionError(f"JSON /v1/predict answered {code}: {data[:200]}")
    d = json.loads(data)
    return np.asarray(d["predictions"], np.float32), d["model_version"]


def _wait_for(cond, what, timeout=120.0, phase=18):
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"phase {phase}: timed out waiting for {what}")
        time.sleep(0.01)


def _launch_delta(before):
    return _launch_counts() - before


def _read_launches(p):
    """(#1, #3, #2, #5, #4) of one read-only forward of Predictor `p`: a
    gather per lookup group (#1 on a bf16 residency, #3 on f32, plain
    indexing on int8) and the #4 launches of its pooled groups."""
    g, c = _per_request(p._trainer)
    return np.array([g * (p.quantize == "bfloat16"), g * (p.quantize == "float32"), 0, 0, c])


def _import_launches(p, paths, boot=False):
    """(#1, #3, #2, #5, #4) of Predictor `p` importing the links `paths`
    (`_link_bundles` at its restore chunk), and at boot its warm replay's
    one import of sentinel rows per bundle: #2 into a bf16 residency, #5
    into f32, plain stores into int8."""
    n = sum(_link_bundles(path, p._restore_chunk) for path in paths)
    n += len(p._trainer.bundles) if boot else 0
    return np.array([0, 0, n * (p.quantize == "bfloat16"), n * (p.quantize == "float32"), 0])


def _train_launches(trainer):
    """(#1, #3, #2, #5, #4) of one train step on f32 tables (`_loop_launches`
    with the bf16 gathers and scatters on the f32 kernels) and of one save:
    a gather per member of its values and of each per-row slot, at the
    member's static budget, so a delta with no dirty row gathers too."""
    from deeprec_tpu_torch.optim.sparse import SCALAR_PREFIX

    a, b, c, d = _loop_launches(trainer)
    nslots = sum(1 for name in trainer.sparse_opt.slot_specs(1)
                 if not name.startswith(SCALAR_PREFIX))
    members = sum(bd.num_tables for bd in trainer.bundles.values())
    return (np.array([0, a + b, 0, c + d, 0]),
            np.array([0, members * (1 + nslots), 0, 0, 0]))


def serve_load(dev, seed, full, cfg, ckdir):
    """Phase 18 (a), (b), (d): the chain, the HTTP server under load while
    the deltas land, the quality gate. Returns (stats, the live predictor,
    the probe batch)."""
    import threading

    from deeprec_tpu_torch.data import SyntheticCriteo
    from deeprec_tpu_torch.guard import QualityGate
    from deeprec_tpu_torch.obs import metrics as obs_metrics
    from deeprec_tpu_torch.optim import Adagrad, adam
    from deeprec_tpu_torch.serving import HttpServer, ModelServer, Predictor
    from deeprec_tpu_torch.training.checkpoint import CheckpointManager
    from deeprec_tpu_torch.training.trainer import Trainer

    st = {}
    model = _dlrm_dcn(seed, **full)
    trainer = Trainer(model, Adagrad(lr=cfg["lr"]), adam(cfg["dense_lr"]), device=dev)
    state = trainer.init()
    gen = SyntheticCriteo(batch_size=cfg["batch"], vocab=cfg["vocab"], seed=seed,
                          num_cat=model.num_cat, num_dense=model.num_dense)
    staged = [trainer.device_batch(gen.batch())
              for _ in range(cfg["steps"] * (1 + cfg["deltas"]))]
    reqs, probe = _serve_requests(model, seed, cfg)
    ck = CheckpointManager(ckdir, trainer)
    losses, paths = [], []
    # the launches the path implies, summed as it runs (see run_serving)
    step_l, save_l = _train_launches(trainer)
    want = cfg["steps"] * (1 + cfg["deltas"]) * step_l + (1 + cfg["deltas"]) * save_l
    # the trainer on a CUDA stream of its own, as a trainer process beside
    # the server would be: the requests' kernels do not queue behind its steps
    _sync(dev)
    train_stream = (torch.cuda.stream(torch.cuda.Stream(dev)) if dev.type == "cuda"
                    else contextlib.nullcontext())

    def train(i0):
        nonlocal state
        with train_stream:
            for i in range(i0, i0 + cfg["steps"]):
                state, m = trainer.train_step(state, staged[i])
                losses.append(float(m["loss"]))

    def save(delta):
        nonlocal state
        with train_stream:
            state, path = (ck.save_incremental if delta else ck.save)(state)
        paths.append(path)

    t0 = time.perf_counter()
    train(0)
    save(False)
    st["chain_s"] = [time.perf_counter() - t0]
    st["t_setup"] = time.perf_counter()

    # (b) the server on the full save, the gate armed on the probe batch
    gate = QualityGate(probe=probe, max_shift=cfg["max_shift"])
    t0 = time.perf_counter()
    p = Predictor(model, ckdir, device=dev, quality_gate=gate)
    _sync(dev)
    st["boot_s"] = time.perf_counter() - t0
    read = _read_launches(p)
    want += _import_launches(p, paths, boot=True) + read  # the gate's first reference
    ms = ModelServer(p, max_batch=cfg["max_batch"], poll_updates_secs=cfg["poll_secs"])
    t0 = time.perf_counter()
    st["buckets"] = ms.warmup({k: v[:1] for k, v in probe.items()})
    st["warmup_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    solo = [p.predict(r) for r in reqs]  # the boot version, request by request
    st["solo_s"] = time.perf_counter() - t0
    bodies = [_bodies(r) for r in reqs]
    http = HttpServer(ms, port=0, host="127.0.0.1").start()
    swaps, commits = [], []
    p._pre_swap = lambda: swaps.append(time.monotonic())
    stop = threading.Event()
    logs = [[] for _ in range(cfg["clients"])]
    errors = []
    done = [0]
    lock = threading.Lock()

    def client(c):
        rng = np.random.default_rng(seed + 100 + c)
        try:
            while not stop.is_set():
                j = int(rng.integers(len(reqs)))
                proto = j % 4 == 3
                t1 = time.monotonic()
                probs, ver = _predict_http(http.port, bodies[j], proto)
                logs[c].append((j, proto, ver, t1, time.monotonic(), probs))
                with lock:
                    done[0] += 1
        except BaseException as e:  # reported by the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(cfg["clients"])]
    t_load = time.monotonic()
    for th in threads:
        th.start()
    try:
        boot = int(cfg["requests"] * cfg["boot_share"])
        _wait_for(lambda: done[0] >= boot or errors, "the boot-version requests")
        # each delta's steps run while the previous delta replays; a delta
        # is written only after the previous one is served (one bump each)
        t0 = time.perf_counter()
        for d in range(cfg["deltas"]):
            train(cfg["steps"] * (1 + d))
            _wait_for(lambda: p.version >= d or errors, f"delta {d}'s swap")
            save(True)
            commits.append(time.monotonic())
            st["chain_s"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
        _wait_for(lambda: p.version >= cfg["deltas"] or errors, "the last delta's swap")
        _wait_for(lambda: done[0] >= cfg["requests"] or errors, "the requests")
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=120)
    load_s = time.monotonic() - t_load
    if errors:
        raise errors[0]
    # warmup, the solo predicts, the device batches; per delta its replay,
    # the gate's pass and the warm batches
    want += (len(p._warm_batches) * (1 + cfg["deltas"]) + len(reqs) + cfg["deltas"]) * read
    want += _import_launches(p, paths[1:])
    if p.version != cfg["deltas"] or p.update_count != cfg["deltas"] or len(swaps) != cfg["deltas"]:
        raise AssertionError(f"version {p.version}, {p.update_count} updates, {len(swaps)} swaps "
                             f"for {cfg['deltas']} deltas: the version must bump once per delta")
    # the gates of (b)
    entries = [e for log in logs for e in log]
    boot_err, boot_n = 0.0, 0
    for c, log in enumerate(logs):
        vers = [e[2] for e in log if e[2] is not None]
        if vers != sorted(vers):
            raise AssertionError(f"client {c}: stamped versions decreased: {vers}")
    for j, proto, ver, t1, t2, probs in entries:
        n = len(next(iter(reqs[j].values())))
        if probs.shape != (n,) or not np.all(np.isfinite(probs)) or not (
                np.all(probs > 0) and np.all(probs < 1)):
            raise AssertionError(f"an answer of {n} rows is not finite in (0, 1)")
        # protobuf answers carry no version: those that ended before the
        # first swap are the boot version's
        if ver == 0 or (ver is None and t2 < swaps[0]):
            boot_err = max(boot_err, float(np.abs(probs - solo[j]).max()))
            boot_n += 1
    if boot_err > COALESCE_ATOL:
        raise AssertionError(f"coalesced answers differ from solo predicts by {boot_err} "
                             f"(tolerance {COALESCE_ATOL})")
    code, body = _http(http.port, "/healthz")
    if code != 200 or json.loads(body)["status"] != "ok":
        raise AssertionError(f"/healthz answered {code}: {body[:200]}")
    code, body = _http(http.port, "/v1/model_info")
    info = json.loads(body)
    if code != 200 or info["step"] != state.step or info["model_version"] != cfg["deltas"]:
        raise AssertionError(f"/v1/model_info {info}, the trainer is at step {state.step}")
    code, body = _http(http.port, "/v1/stats")
    snap = json.loads(body)
    if code != 200 or snap["stages"]["device"]["count"] == 0:
        raise AssertionError(f"/v1/stats answered {code}")
    want += snap["batches"] * read
    code, text = _http(http.port, "/metrics")
    if code != 200 or (obs_metrics.metrics_enabled()
                       and b"deeprec_serving_requests" not in text):
        raise AssertionError(f"/metrics answered {code}")
    http.stop()
    ms.close()

    lat = np.array([(e[4] - e[3]) * 1e3 for e in entries])
    windows = list(zip(commits, swaps))

    def during(e, w):
        return e[3] <= w[1] and e[4] >= w[0]

    steady = [x for x, e in zip(lat, entries) if not any(during(e, w) for w in windows)]
    st.update(
        requests=len(entries), rows=sum(len(next(iter(reqs[e[0]].values()))) for e in entries),
        proto=sum(e[1] for e in entries), load_s=load_s, rps=len(entries) / load_s,
        p50=float(np.percentile(lat, 50)), p90=float(np.percentile(lat, 90)),
        p99=float(np.percentile(lat, 99)),
        steady_p99=float(np.percentile(steady, 99)) if steady else None,
        worst_during=[max([float(x) for x, e in zip(lat, entries) if during(e, w)],
                          default=None) for w in windows],
        replay_s=[b - a for a, b in windows], boot_err=boot_err, boot_n=boot_n,
        stages={s: snap["stages"][s] for s in ("queue", "pad", "device", "post", "e2e")},
        batch_rows=snap["batch_rows"], batches=snap["batches"],
        lag=p.last_apply_lag_seconds, last_update_ms=p.last_update_ms, step=state.step,
        losses=losses)

    # (d) the quality gate: a delta whose dense leaves are NaN
    t_gate = time.perf_counter()
    before = p.predict(probe)
    v = p.version
    counter = (obs_metrics.default_registry().counter("deeprec_quality_gate_rejections")
               if obs_metrics.metrics_enabled() else None)
    c0 = counter.value if counter is not None else None
    _sync(dev)
    for t in state.dense.values():
        t.fill_(float("nan"))
    # one step on: a delta of its own, with no dirty row and NaN dense leaves
    state, path = ck.save_incremental(dataclasses.replace(state, step=state.step + 1))
    # before, the gate's pass and after; the poisoned delta's save and replay
    want += 3 * read + save_l + _import_launches(p, [path])
    if p.poll_updates():
        raise AssertionError("the poisoned delta was published")
    if os.path.exists(path) or not os.path.exists(path + ".quarantined"):
        raise AssertionError(f"the poisoned delta {path} was not quarantined")
    if p.version != v or not np.array_equal(p.predict(probe), before):
        raise AssertionError("the old version stopped answering bit for bit")
    h = p.health()
    if h["status"] != "degraded" or h.get("degraded_reason") != "quality_gate":
        raise AssertionError(f"health after a gated update: {h}")
    if counter is not None and counter.value - c0 != 1:
        raise AssertionError(f"deeprec_quality_gate_rejections moved by {counter.value - c0}")
    st["gate"] = dict(gate.last_rejection or {}, counter=None if counter is None
                      else counter.value)
    st["gate_s"] = time.perf_counter() - t_gate
    st.update(want=want, paths=paths)
    _sync(dev)
    del trainer, state, staged, ck
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return st, p, probe, model


def serve_residency(dev, p, probe, model, cfg, ckdir, paths):
    """Phase 18 (b)'s last gate, (c) and (e): a fresh Predictor on the same
    chain (the links `paths`) bit for bit, bf16 and int8 residencies,
    ServerGroup. Returns stats, with the launches the path implies under
    `want`."""
    from deeprec_tpu_torch.serving import Predictor, ServerGroup

    st = {}
    ref = p.predict(probe)
    t0 = time.perf_counter()
    fresh = Predictor(model, ckdir, device=dev)
    st["restore_fresh"] = time.perf_counter() - t0
    if not np.array_equal(fresh.predict(probe), ref):
        raise AssertionError("the served model differs from a fresh Predictor on the chain")
    want = 2 * _read_launches(p) + _import_launches(fresh, paths, boot=True)
    del fresh
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # (e)'s ServerGroup(replicas=2) on one device: one member, here an int8
    # Predictor of the final chain, which (c) measures
    t0 = time.perf_counter()
    g = ServerGroup(model, ckdir, replicas=2, device=dev, max_batch=cfg["max_batch"],
                    quantize="int8")
    _sync(dev)
    st["restore_int8"] = time.perf_counter() - t0
    try:
        p8 = g.members[0].predictor
        want += _import_launches(p8, paths, boot=True)
        want += _residencies(dev, p, p8, probe, model, cfg, ckdir, st, paths)
        sub = {k: v[:16] for k, v in probe.items()}
        got = g.request(sub)
        st["group"] = len(g.members)
        if len(g.members) != 1 or not np.array_equal(
                got, g.members[0].predictor.predict(sub)):
            raise AssertionError(f"ServerGroup(replicas=2): {len(g.members)} members")
        want += 2 * _read_launches(p8)
    finally:
        g.close()
    st["want"] = want
    return st


def _residencies(dev, p, p8, probe, model, cfg, ckdir, st, paths):
    """Phase 18 (c) on the f32 predictor `p`, a bf16 one built here and the
    int8 one `p8`: the answers' distance from f32, the resident bytes, the
    launches of one predict and p50/p90 at the probe batch, into `st`.
    Returns the launches this part implies."""
    from deeprec_tpu_torch.serving import Predictor

    groups, combines = _per_request(p._trainer)
    t0 = time.perf_counter()
    res = {"float32": p, "bf16": Predictor(model, ckdir, device=dev, quantize="bf16"),
           "int8": p8}
    _sync(dev)
    st["restore_bf16"] = time.perf_counter() - t0
    implied = _import_launches(res["bf16"], paths, boot=True)
    implied += sum((1 + cfg["timed"]) * _read_launches(pq) for pq in res.values())
    out = {}
    for q, pq in res.items():
        before = _launch_counts()
        out[q] = pq.predict(probe)
        n1, n3, _, _, n4 = _launch_delta(before)
        want = {"float32": (0, groups), "bf16": (groups, 0), "int8": (0, 0)}[q]
        if dev.type == "cuda" and ((n1, n3) != want or n4 != combines):
            raise AssertionError(f"a {q} predict launched (#1, #3, #4) {(n1, n3, n4)}, the "
                                 f"path implies {(*want, combines)}")
        lat = []
        for _ in range(cfg["timed"]):
            t0 = time.perf_counter()
            pq.predict(probe)
            lat.append((time.perf_counter() - t0) * 1e3)
        st[q] = dict(p50=float(np.percentile(lat, 50)), p90=float(np.percentile(lat, 90)),
                     residency=pq.residency_info()["measured_bytes"])
        ri = pq.residency_info()
        if ri["measured_bytes"] != ri["modeled_bytes"]:
            raise AssertionError(f"{q}: measured {ri['measured_bytes']} B, modelled "
                                 f"{ri['modeled_bytes']} B")
    st["dp"] = {q: float(np.abs(out[q] - out["float32"]).max()) for q in ("bf16", "int8")}
    if st["dp"]["bf16"] >= BF16_ATOL or st["dp"]["int8"] >= INT8_ATOL:
        raise AssertionError(f"quantized answers moved {st['dp']} (bounds {BF16_ATOL}, "
                             f"{INT8_ATOL})")
    f32 = st["float32"]["residency"]
    if st["int8"]["residency"] > INT8_SHARE * f32 or st["bf16"]["residency"] != f32 // 2:
        raise AssertionError("the quantized residencies are not the bytes they should be")
    del res
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return implied


def run_serving(dev, seed, full, cfg, ckroot):
    """Phase 18, printed. Returns the launches of (#1, #3, #2, #5, #4) over
    its path."""
    from deeprec_tpu_torch.ops.fused_lookup import fused_gather_combine

    t0 = time.perf_counter()
    ckdir = os.path.join(ckroot, "serve")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    _zero_row_counts()  # the main path starts here
    fused_gather_combine.launches = 0
    st, p, probe, model = serve_load(dev, seed, full, cfg, ckdir)
    print(f"serving stack (a): DLRM-DCN {full}, f32 tables: a full save after {cfg['steps']} "
          f"steps and {cfg['deltas']} deltas of {cfg['steps']} (steps, the wait for the "
          f"previous swap and the save, s) "
          f"{[round(s, 3) for s in st['chain_s']]}; losses {st['losses'][0]:.6f} .. "
          f"{st['losses'][-1]:.6f}; Predictor booted in {st['boot_s']:.3f} s, warmup of "
          f"{st['buckets']} buckets {st['warmup_s']:.3f} s, {cfg['payloads']} solo predicts "
          f"{st['solo_s']:.3f} s")
    print(f"serving stack (b): {st['requests']} requests ({st['proto']} protobuf; "
          f"{cfg['payloads']} payloads encoded beforehand) of "
          f"1-{cfg['max_rows']} rows, {st['rows']} rows, from {cfg['clients']} clients in "
          f"{st['load_s']:.3f} s: {st['rps']:.1f} requests/s; e2e p50 {st['p50']:.3f}, p90 "
          f"{st['p90']:.3f}, p99 {st['p99']:.3f} ms; the worst request during each update "
          f"{[None if w is None else round(w, 3) for w in st['worst_during']]} ms against "
          f"the steady p99 {st['steady_p99']} ms; delta available to swap "
          f"{[round(s, 3) for s in st['replay_s']]} s; last_apply_lag_seconds {st['lag']}, "
          f"last_update_ms {st['last_update_ms']}")
    print(f"serving stack (b): stages (ms) " + "; ".join(
        f"{s} p50 {v['p50_ms']} p90 {v['p90_ms']} p99 {v['p99_ms']} mean {v['mean_ms']}"
        for s, v in st["stages"].items())
          + f"; {st['batches']} device batches, mean rows per batch "
          f"{st['batch_rows']['mean']}")
    print(f"serving stack (b): {st['boot_n']} boot-version answers equal solo predicts within "
          f"{st['boot_err']:.3g} (tolerance {COALESCE_ATOL}); stamped versions never "
          f"decreased; version bumped once per delta; /healthz 200, /v1/model_info step "
          f"{st['step']}, /v1/stats and /metrics answered")
    print(f"serving stack (d): a delta with NaN dense leaves rejected by the quality gate "
          f"({st['gate']}), quarantined, the old version answering bit for bit, health "
          f"degraded: quality_gate ({st['gate_s']:.3f} s with its save)")
    rs = serve_residency(dev, p, probe, model, cfg, ckdir, st["paths"])
    del p
    print(f"serving stack (b): after the last swap the served model equals a fresh "
          f"Predictor on the chain bit for bit ({cfg['probe']} probe rows)")
    print(f"serving stack (c): restore s (3 links) fresh f32 {rs['restore_fresh']:.3f}, bf16 "
          f"{rs['restore_bf16']:.3f}, int8 (ServerGroup's member) {rs['restore_int8']:.3f}; "
          f"predict at batch {cfg['probe']}, p50 / p90 ms: " +
          ", ".join(f"{q} {rs[q]['p50']:.3f} / {rs[q]['p90']:.3f}"
                    for q in ("float32", "bf16", "int8")) +
          f"; max |dp| against f32 {rs['dp']} (bounds {BF16_ATOL}, {INT8_ATOL}); value "
          f"bytes f32 {rs['float32']['residency']}, bf16 {rs['bf16']['residency']}, int8 "
          f"{rs['int8']['residency']} ({rs['int8']['residency'] / rs['float32']['residency']:.4f}"
          f" of f32), each equal to the model")
    print(f"serving stack (e): ServerGroup(replicas=2, quantize='int8') on one {dev.type} "
          f"device: {rs['group']} member, answering as its Predictor")
    launches = _launch_counts()
    _row_counts()  # ... and ends here (adds the bf16 launches to PAIR_LAUNCHES)
    want = st["want"] + rs["want"]
    if dev.type == "cuda" and not np.array_equal(launches, want):
        raise AssertionError(f"phase 18 launched (#1, #3, #2, #5, #4) {launches.tolist()}, the "
                             f"path implies {want.tolist()}")
    peak = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else None
    print(f"serving stack: the path launched (#1, #3, #2, #5, #4) {launches.tolist()} (implied "
          f"{want.tolist()}); peak device memory {peak} GB")
    print(f"phase 18 (the serving stack) took {time.perf_counter() - t0:.1f} s")
    shutil.rmtree(ckdir, ignore_errors=True)
    return launches


# ------------------------------------------------------------ phase 19

# The rest of serving: full-corpus retrieval, the socket frontend and its
# fleet, the feature stores and the C ABI. DSSM at the modelzoo's widths
# (emb 16, 2^20 slots a table, 4 user and 4 item features, hidden
# 256-128-64): phase 13's saved state where it is on disk, else `steps`
# steps of SyntheticTwoTower(vocab 100,000) at batch 2048 (Adagrad 0.2, Adam
# 1e-3) and a full save. (b) int8, bf16 and f32 RetrievalEngines over
# `items` items (the first corpus size of RETRIEVAL_BENCH.json's protocol;
# item i's features drawn from the item features' id ranges) at block_rows
# 4096, `chunk` rows an encode and ops.topk.SWEEP_ROWS rows a sweep step, queries
# of `query` rows at k; an int8 engine over `big_items` (the protocol's
# second size) timed alone. (d) two in-process fp32 shards behind a
# Frontend, one backend process. (c) `fold_steps` steps with the dense half
# frozen (Adam at lr 0, the sparse-only online-update regime) on
# `fold_items` items of the corpus, one delta, one poll. (e) the remote and
# in-process stores and the C ABI. #3 and #4 are held against their plain
# versions at (b)'s own shapes: an encode chunk, a query, a coalesced batch.
RETR = dict(emb_dim=16, capacity=1 << 20, vocab=100_000, lr=0.2, dense_lr=1e-3,
            batch=2048, steps=20, items=1_000_000, big_items=10_000_000, block_rows=4096,
            chunk=32768, k=100, query=8, clients=8, rounds=4, timed=20,
            big_timed=10, fold_steps=8, fold_items=64, pred_rows=64, fleet_requests=40,
            recall_batches=16)
# The f32 engine's answer against an exact scan of its own vectors in f64
# on the host: a score's f32 sum over 64 products in another order (and a
# product's order may depend on a column's place in the tile) is off by a
# few ulps of 1. So at every position the exact score of the item returned
# equals the exact k-th best score within this, and ids are compared where
# both neighbours in the exact order are further apart than this.
RETR_ATOL = 2e-6
# int8 against the exact scan, tie-aware (tests/test_retrieval.py's floor),
# over `recall_batches` query batches
RECALL_FLOOR = 0.95


def _dssm_ckpt(dev, seed, cfg, ckroot):
    """(checkpoint dir, model, steps or None): phase 13's DSSM where it is on
    disk, else a fresh one trained `steps` steps and saved."""
    from deeprec_tpu_torch.optim import Adagrad, adam
    from deeprec_tpu_torch.training.checkpoint import CheckpointManager
    from deeprec_tpu_torch.training.trainer import Trainer

    zoo = os.path.join(ckroot, "zoo-DSSM")
    model, gen, _ = zoo_model("DSSM", seed, dict(
        ZOO, emb_dim=cfg["emb_dim"], capacity=cfg["capacity"], batch=cfg["batch"],
        two_tower=dict(vocab=cfg["vocab"], lr=cfg["lr"])))
    if os.path.isdir(zoo) and any(d.startswith("full-") for d in os.listdir(zoo)):
        return zoo, model, None
    ckdir = os.path.join(ckroot, "retrieval")
    trainer = Trainer(model, Adagrad(lr=cfg["lr"]), adam(cfg["dense_lr"]), device=dev)
    state = trainer.init()
    g = gen(seed)
    for _ in range(cfg["steps"]):
        state, _ = trainer.train_step(state, g.batch())
    CheckpointManager(ckdir, trainer).save(state)
    return ckdir, model, cfg["steps"]


def _corpus_items(n, model, vocab, seed):
    """Item ids 1..n and their item features, each feature in its own id
    range as SyntheticTwoTower draws them (V_j in [(j+1) vocab, (j+2) vocab))."""
    rng = np.random.default_rng(seed)
    return (np.arange(1, n + 1, dtype=np.int64),
            {f: ((j + 1) * vocab + rng.integers(0, vocab, n)).astype(np.int32)
             for j, f in enumerate(model.item_feats)})


def _user_queries(p, model, cfg, seed, n):
    """`n` parsed retrieval queries of `query` rows (user features of
    SyntheticTwoTower, item features pad-filled)."""
    from deeprec_tpu_torch.data import SyntheticTwoTower
    from deeprec_tpu_torch.serving.predictor import parse_features
    from deeprec_tpu_torch.serving.retrieval import fill_missing_item_features

    g = SyntheticTwoTower(batch_size=cfg["query"] * n, num_user=len(model.user_feats),
                          num_item=len(model.item_feats), vocab=cfg["vocab"], seed=seed)
    b = g.batch()
    q = cfg["query"]
    return [parse_features(p, fill_missing_item_features(
        p, {f: b[f][i * q:(i + 1) * q] for f in model.user_feats})) for i in range(n)]


def _counted(engine, box):
    """Count `engine.retrieve` calls in box[0] (each one user-tower forward)."""
    inner = engine.retrieve

    def retrieve(batch, k):
        box[0] += 1
        return inner(batch, k)

    engine.retrieve = retrieve
    return engine


def _encodes(n, chunk):
    """Item-tower forwards of an engine that ingests n items: the pad chunk
    at construction and one per chunk."""
    return 1 + -(-n // chunk)


def _exact(uvec, hv, k):
    """(scores f64, column indices, all scores) of the exact top-k of users x
    vectors, ties to the lowest column (every column tied with the k-th is
    a candidate)."""
    s = uvec.astype(np.float64) @ hv.astype(np.float64).T
    kth = -np.partition(-s, k - 1, axis=1)[:, k - 1]
    cols = np.zeros((s.shape[0], k), np.int64)
    for r in range(s.shape[0]):
        c = np.nonzero(s[r] >= kth[r])[0]
        cols[r] = c[np.lexsort((c, -s[r, c]))[:k]]
    return np.take_along_axis(s, cols, 1), cols, s


def _sweep_times(dev, eng, uvec, k, reps):
    """(p50 ms, p90 ms, device operations) of one blocked sweep alone over
    the engine's corpus (the user vectors given)."""
    from deeprec_tpu_torch.ops.topk import blocked_topk

    c = eng._corpus

    def sweep():
        return blocked_topk(uvec, c.vecs, c.valid, k, block_rows=eng.block_rows,
                            scale=c.scale, query_rows=eng.query_rows)

    sweep()
    ms = []
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        sweep()
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    ops = device_ops(sweep, calls=3) if dev.type == "cuda" else None
    return float(np.percentile(ms, 50)), float(np.percentile(ms, 90)), ops


def _path_kernels_vs_plain(dev, fn):
    """Run fn() (one read-only forward of phase 19's path) with every call
    of #3 (the table lookups) and of #4 (the grouped pooling) recorded, and
    hold each recorded kernel output against the plain version on the same
    inputs, bit for bit: the ids and pooling layout are the path's own.
    The launches of this forward are a comparison, not the main path's:
    the counts are put back after it. Returns (#3 calls, #4 calls, the
    shapes seen, the max abs error)."""
    from deeprec_tpu_torch.embedding import combiners, table
    from deeprec_tpu_torch.ops import fused_lookup as fl

    counts = [(k, a, getattr(k, a)) for k in (fl.gather_rows, fl.apply_rows_sr)
              for a in ("launches", "launches_bf16")]
    counts.append((fl.fused_gather_combine, "launches", fl.fused_gather_combine.launches))
    gathers, combines = [], []
    g0, c0 = table.gather_rows, combiners.fused_gather_combine_grouped

    def gather(values, ix):
        out = g0(values, ix)
        gathers.append((values, ix, out))
        return out

    def combine(values, row_ix, w):
        out = c0(values, row_ix, w)
        combines.append((list(values), list(row_ix), list(w), out))
        return out

    table.gather_rows, combiners.fused_gather_combine_grouped = gather, combine
    try:
        fn()
        _sync(dev)
    finally:
        table.gather_rows, combiners.fused_gather_combine_grouped = g0, c0
        for k, a, v in counts:
            setattr(k, a, v)
    if not gathers or not combines:
        raise AssertionError(f"the forward called #3 {len(gathers)} and #4 "
                             f"{len(combines)} times")
    err, shapes = 0.0, set()
    for values, ix, out in gathers:
        want = fl.gather_rows_plain(values, ix)
        if not torch.equal(out, want):
            raise AssertionError(f"gather_rows at {tuple(values.shape)} x {tuple(ix.shape)} "
                                 "on the path differs from the plain version")
        err = max(err, float((out.float() - want.float()).abs().max()) if out.numel() else 0.0)
        shapes.add(("gather_rows", tuple(values.shape), tuple(ix.shape), str(values.dtype)))
    for values, row_ix, w, outs in combines:
        for v, ix, ww, out in zip(values, row_ix, w, outs):
            want = fl.fused_gather_combine_plain(v, ix, ww)
            if not torch.equal(out, want):
                raise AssertionError(f"fused_gather_combine at {tuple(v.shape)} x "
                                     f"{tuple(ix.shape)} on the path differs from the "
                                     "plain version")
            err = max(err, float((out - want).abs().max()) if out.numel() else 0.0)
            shapes.add(("fused_gather_combine", tuple(v.shape), tuple(ix.shape),
                        str(v.dtype)))
    return len(gathers), len(combines), sorted(shapes), err


def retrieval_engines(dev, p, ms, model, cfg, seed, st):
    """Phase 19 (b). Returns ({residency: engine}, items, queries, the
    engines' retrieve count (a box), and the other read-only forwards it
    ran: the encodes and the user towers run alone)."""
    import threading

    from deeprec_tpu_torch.ops import traffic
    from deeprec_tpu_torch.serving import RetrievalEngine

    ids, feats = _corpus_items(cfg["items"], model, cfg["vocab"], seed + 19)
    queries = _user_queries(p, model, cfg, seed + 190, cfg["clients"] * cfg["rounds"])
    box = [0]
    engines, fwd = {}, 0
    for q in ("bf16", "fp32", "int8"):  # int8 last: it is the one updates fold into
        eng = _counted(RetrievalEngine(p, quantize=q, block_rows=cfg["block_rows"],
                                       chunk=cfg["chunk"]),
                       box)
        _sync(dev)
        t0 = time.perf_counter()
        eng.upsert_items(ids, feats)
        _sync(dev)
        ingest = time.perf_counter() - t0
        fwd += _encodes(cfg["items"], cfg["chunk"])
        si = eng.sweep_info()
        if si["measured_bytes"] != si["modeled_bytes"] or si["corpus_rows"] != cfg["items"]:
            raise AssertionError(f"{q} corpus: {si}")
        rs = ms.attach_retrieval(eng)
        t0 = time.perf_counter()
        rs.warmup(queries[0], k=cfg["k"])
        lat = []
        for i in range(cfg["timed"]):
            t1 = time.perf_counter()
            res = ms.retrieve_versioned(queries[i % len(queries)], cfg["k"])
            lat.append((time.perf_counter() - t1) * 1e3)
            if res.ids.shape != (cfg["query"], cfg["k"]) or not (res.ids >= 1).all() or \
                    not np.all(np.isfinite(res.scores)):
                raise AssertionError(f"{q}: a retrieval answer is not {cfg['k']} items")
        uvec = eng._user(p._snap.state, queries[0])[:cfg["query"]]
        fwd += 1
        sw50, sw90, ops = _sweep_times(dev, eng, uvec, eng._bucket(cfg["k"], lo=1),
                                       cfg["timed"])
        bound = traffic.retrieval_sweep_bytes(
            corpus_rows=eng.capacity, dim=eng.dim, value_dtype=eng.quantize,
            block_rows=eng.block_rows) / HBM_BYTES_PER_S * 1e3
        st[q] = dict(ingest_s=ingest, p50=float(np.percentile(lat, 50)),
                     p90=float(np.percentile(lat, 90)), sweep_p50=sw50, sweep_p90=sw90,
                     ops=ops, bound_ms=bound, bytes=si["measured_bytes"],
                     capacity=eng.capacity)
        engines[q] = eng
        if q != "int8":
            rs.close()
            ms.retrieval = None

    # the f32 engine against an exact scan of its own vectors; int8 recall
    hids, hv = engines["fp32"].host_vectors()
    if not np.array_equal(hids, ids):
        raise AssertionError("the f32 engine's host ids are not the ingested ids")
    k = cfg["k"]
    hits = {10: [], 100: []}
    st["exact"] = dict(apart=0, total=0, err=0.0)
    for q0 in queries[:cfg["recall_batches"]]:
        uvec = engines["fp32"]._user(p._snap.state, q0).cpu().numpy()[:cfg["query"]]
        ref_s, ref_c, full = _exact(uvec, hv, k + 1)  # the (k+1)-th: the last gap
        res = engines["fp32"].retrieve(q0, k)
        gap = np.abs(np.diff(ref_s, axis=1))
        ref_s, ref_c = ref_s[:, :k], ref_c[:, :k]
        apart = np.ones(ref_s.shape, bool)
        apart[:, 1:] &= gap[:, :-1] > RETR_ATOL
        apart &= gap > RETR_ATOL
        mine = np.take_along_axis(full, np.searchsorted(hids, res.ids), 1)
        err = max(float(np.abs(res.scores - ref_s).max()), float(np.abs(mine - ref_s).max()))
        if not np.array_equal(res.ids[apart], hids[ref_c][apart]) or err > RETR_ATOL:
            raise AssertionError(f"the f32 engine's top-{k} differs from the exact scan "
                                 f"(max |score diff| {err})")
        st["exact"]["apart"] += int(apart.sum())
        st["exact"]["total"] += apart.size
        st["exact"]["err"] = max(st["exact"]["err"], err)
        res8 = engines["int8"].retrieve(q0, k)
        got = np.take_along_axis(full, np.searchsorted(hids, res8.ids), 1)
        for kk in hits:
            kth = -np.partition(-full, kk - 1, axis=1)[:, kk - 1]
            hits[kk].append((got[:, :kk] >= kth[:, None] - 1e-6).mean(axis=1))
        fwd += 1
    st["recall"] = {kk: float(np.concatenate(v).mean()) for kk, v in hits.items()}
    for kk, r in st["recall"].items():
        if r < RECALL_FLOOR:
            raise AssertionError(f"int8 tie-aware recall@{kk} {r} (floor {RECALL_FLOOR})")

    # #3 and #4 at this path's shapes against their plain versions: one
    # encode chunk of the corpus's own items, a solo query and a coalesced
    # batch of the lane's most rows
    eng, state = engines["int8"], p._snap.state
    chunk = {n: (eng._h_feats[n][:cfg["chunk"]] if n in eng._h_feats
                 else np.repeat(t, cfg["chunk"], axis=0))
             for n, t in eng._templates.items()}
    most = min(ms.retrieval.max_batch // cfg["query"], len(queries))
    coalesced = {n: np.concatenate([qq[n] for qq in queries[:most]]) for n in queries[0]}
    st["path_kernels"] = dict(gathers=0, combines=0, shapes=[], err=0.0,
                              coalesced_rows=most * cfg["query"])
    for what in (lambda: eng._encode(state, chunk), lambda: eng._user(state, queries[0]),
                 lambda: eng._user(state, coalesced)):
        ng, nc, shapes, err = _path_kernels_vs_plain(dev, what)
        pk = st["path_kernels"]
        pk["gathers"] += ng
        pk["combines"] += nc
        pk["shapes"] += [sh for sh in shapes if sh not in pk["shapes"]]
        pk["err"] = max(pk["err"], err)

    # coalesced answers (clients threads through ModelServer.retrieve_versioned
    # into the int8 engine) against solo ones, bit for bit
    solo = [engines["int8"].retrieve(qq, k) for qq in queries]
    outs = [None] * len(queries)
    errors = []

    def client(c):
        try:
            for r in range(cfg["rounds"]):
                i = c * cfg["rounds"] + r
                outs[i] = ms.retrieve_versioned(queries[i], k)
        except BaseException as e:
            errors.append(e)

    before = box[0]
    threads = [threading.Thread(target=client, args=(c,)) for c in range(cfg["clients"])]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    if errors:
        raise errors[0]
    st["coalesced_sweeps"] = box[0] - before
    for o, s in zip(outs, solo):
        if not (np.array_equal(o.ids, s.ids) and np.array_equal(o.scores, s.scores)):
            raise AssertionError("a coalesced retrieval answer differs from its solo answer")
    snap = ms.stats_snapshot()
    if snap["retrieval_corpus"]["measured_bytes"] != snap["retrieval_corpus"]["modeled_bytes"]:
        raise AssertionError(f"/v1/stats retrieval_corpus {snap['retrieval_corpus']}")
    st["stats_requests"] = snap["retrieval"]["requests"]
    return engines, (ids, feats), queries, box, fwd


def retrieval_big(dev, p, model, cfg, seed, queries, keep, st):
    """Phase 19 (b)'s last part: one int8 engine over `big_items`, its sweep
    timed alone; `keep` is attached to the Predictor again afterwards.
    Returns the read-only forwards it ran."""
    from deeprec_tpu_torch.ops import traffic
    from deeprec_tpu_torch.serving import RetrievalEngine

    n = cfg["big_items"]
    ids, feats = _corpus_items(n, model, cfg["vocab"], seed + 191)
    eng = RetrievalEngine(p, quantize="int8", block_rows=cfg["block_rows"],
                          chunk=cfg["chunk"])
    t0 = time.perf_counter()
    eng.upsert_items(ids, feats)
    _sync(dev)
    ingest = time.perf_counter() - t0
    del ids, feats
    si = eng.sweep_info()
    uvec = eng._user(p._snap.state, queries[0])[:cfg["query"]]
    sw50, sw90, ops = _sweep_times(dev, eng, uvec, eng._bucket(cfg["k"], lo=1),
                                   cfg["big_timed"])
    res = eng.retrieve(queries[0], cfg["k"])
    if not (res.ids >= 1).all() or si["measured_bytes"] != si["modeled_bytes"]:
        raise AssertionError(f"the {n}-item engine: {si}")
    st["big"] = dict(items=n, capacity=eng.capacity, ingest_s=ingest, sweep_p50=sw50,
                     sweep_p90=sw90, ops=ops, bytes=si["measured_bytes"],
                     bound_ms=si["modeled_bytes"] / HBM_BYTES_PER_S * 1e3)
    p.attach_retrieval(keep)  # the engine updates fold into
    del eng
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return _encodes(n, cfg["chunk"]) + 2  # its encodes, its user tower, one retrieve


def retrieval_fleet(dev, p, model, cfg, ckdir, seed, items, queries, fp32, st, spawn):
    """Phase 19 (d): two in-process fp32 shards behind a Frontend (merged
    top-k against the single f32 engine's, bit for bit; a stopped member:
    partial, degraded), then the spawned backend process answering PRED
    through a Frontend beside an in-process sibling and killed mid-load.
    Returns the launches of (#1, #3, #2, #5, #4) of its in-process path."""
    import signal
    import threading

    from deeprec_tpu_torch.data import SyntheticTwoTower
    from deeprec_tpu_torch.serving import (BackendServer, Frontend, ModelServer, Predictor,
                                           RetrievalEngine)

    ids, feats = items
    read = _read_launches(p)
    want = np.zeros(5, np.int64)
    backends, boxes = [], []
    paths = [os.path.join(ckdir, d) for d in p._dirs()]
    for i in range(2):
        bp = Predictor(model, ckdir, device=dev)
        want += _import_launches(bp, paths, boot=True)
        bms = ModelServer(bp, max_batch=cfg["batch"])
        box = [0]
        bms.attach_retrieval(_counted(RetrievalEngine(
            bp, quantize="fp32", block_rows=cfg["block_rows"], chunk=cfg["chunk"],
            shard_index=i, num_shards=2), box))
        boxes.append(box)
        backends.append(BackendServer(bms, port=0).start())
    fe = Frontend([("127.0.0.1", b.port) for b in backends], model, reprobe_secs=0.0)
    try:
        t0 = time.perf_counter()
        acc = fe.ingest_items(ids, feats)
        st["fleet_ingest_s"] = time.perf_counter() - t0
        if sorted(acc.values()) != sorted(
                b.server.retrieval.engine.corpus_rows() for b in backends) or \
                sum(acc.values()) != len(ids) or min(acc.values()) == 0:
            raise AssertionError(f"the broadcast ingest did not partition itself: {acc}")
        nfwd = sum(_encodes(n, cfg["chunk"]) for n in acc.values())
        q = queries[2]
        t0 = time.perf_counter()
        merged = fe.retrieve_versioned(q, cfg["k"])
        st["fleet_retr_ms"] = (time.perf_counter() - t0) * 1e3
        single = fp32.retrieve(q, cfg["k"])
        if merged.partial or not (np.array_equal(merged.ids, single.ids)
                                  and np.array_equal(merged.scores, single.scores)):
            raise AssertionError("the two shards' merged top-k differs from the single "
                                 "f32 engine's")
        backends[0].stop(unregister=False)  # the death of a member
        part = fe.retrieve_versioned(q, cfg["k"])
        h = fe.predictor.health()
        left = set(backends[1].server.retrieval.engine.host_vectors()[0].tolist())
        if not part.partial or h["status"] == "ok" or h["reachable"] != 1 or \
                not set(part.ids.ravel().tolist()) <= left:
            raise AssertionError(f"after a member stopped: partial {part.partial}, health {h}")
        st["fleet"] = dict(shards=sorted(acc.values()), partial_health=h["status"],
                           partials=h.get("retrieval_partials"))
        nfwd += sum(b[0] for b in boxes)  # the shards' sweeps
    finally:
        fe.close()
    # the backend process beside the surviving in-process member, killed mid-load
    procs, addrs = spawn.result()
    g = SyntheticTwoTower(batch_size=cfg["pred_rows"] * 4, num_user=len(model.user_feats),
                          num_item=len(model.item_feats), vocab=cfg["vocab"], seed=seed + 192)
    b = g.batch()
    reqs = [{k: v[i * cfg["pred_rows"]:(i + 1) * cfg["pred_rows"]] for k, v in b.items()
             if k != "label"} for i in range(4)]
    expect = [p.predict(r) for r in reqs]
    nfwd += len(reqs)
    live = backends[1]
    fe2 = Frontend([addrs[0], ("127.0.0.1", live.port)], model, reprobe_secs=0.0)
    errors, killed, answered, worst = [], threading.Event(), [0], [0.0]
    spawned = next(m for m in fe2._members if m.addr.endswith(f":{addrs[0][1]}"))
    try:
        fe2.warmup(reqs[0])

        def driver():
            # requests until the kill, then `fleet_requests` // 2 more: the
            # round robin sends one of the first two of them to the dead
            # backend, whose failed call is retried on the sibling
            try:
                i, after = 0, 0
                while after < cfg["fleet_requests"] // 2:
                    after += killed.is_set()
                    got = fe2.request(reqs[i % 4])
                    worst[0] = max(worst[0], float(np.abs(got - expect[i % 4]).max()))
                    answered[0] += 1
                    i += 1
            except BaseException as e:
                errors.append(e)

        th = threading.Thread(target=driver)
        th.start()
        _wait_for(lambda: answered[0] >= cfg["fleet_requests"] // 2 or errors,
                  "requests through the spawned backend", phase=19)
        before = spawned.snapshot()
        if before["requests"] == 0 or before["errors"]:
            raise AssertionError(f"before the SIGKILL the spawned backend had {before}")
        os.kill(procs[0].pid, signal.SIGKILL)
        procs[0].wait()
        killed.set()
        th.join(timeout=120)
        if errors:
            raise errors[0]
        if worst[0] > COALESCE_ATOL:
            raise AssertionError(f"PRED answers through the frontend differ by {worst[0]}")
        # read before any health sweep: a failed routed call marked it down
        after = spawned.snapshot()
        if after["errors"] == 0 or after["fails"] == 0:
            raise AssertionError(f"no routed request failed over from the killed backend: "
                                 f"{after}")
        h = fe2.predictor.health()
        if h["status"] == "ok" or h["reachable"] != 1:
            raise AssertionError(f"health after the SIGKILL: {h}")
        st["sigkill"] = dict(requests=answered[0], failed=0, worst=worst[0],
                             health=h["status"], spawned_requests=before["requests"],
                             failovers=after["errors"])
    finally:
        fe2.close()
        for pr in procs:
            pr.kill()
            pr.wait()
    nfwd += live.server.stats.snapshot()["batches"]
    for bk in backends:
        bk.stop()
    want[1] += nfwd * read[1]
    want[4] += nfwd * read[4]
    del backends
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return want


def retrieval_fold(dev, p, model, cfg, ckdir, seed, items, engine, st):
    """Phase 19 (c): `fold_steps` steps with the dense half frozen on
    `fold_items` items of the corpus, one delta, one poll: the fold's rows
    equal the corpus rows whose item features the steps trained, the rest
    unchanged, the re-encoded rows equal a fresh engine's. Returns the
    launches of (#1, #3, #2, #5, #4) of its path."""
    from deeprec_tpu_torch.data import SyntheticTwoTower
    from deeprec_tpu_torch.optim import Adagrad, adam
    from deeprec_tpu_torch.serving import RetrievalEngine
    from deeprec_tpu_torch.training.checkpoint import CheckpointManager
    from deeprec_tpu_torch.training.trainer import Trainer

    ids, feats = items
    trainer = Trainer(model, Adagrad(lr=cfg["lr"]), adam(0.0), device=dev)
    ck = CheckpointManager(ckdir, trainer)
    chain = [os.path.join(ckdir, d) for d in ck.chain_dirs()]
    t0 = time.perf_counter()
    state = ck.restore()
    step_l, save_l = _train_launches(trainer)
    want = step_l * cfg["fold_steps"] + save_l
    want[3] += 2 * sum(_link_bundles(c) for c in chain)  # values and accumulators
    rng = np.random.default_rng(seed + 193)
    pick = rng.choice(len(ids), cfg["fold_items"], replace=False)
    g = SyntheticTwoTower(batch_size=cfg["batch"], num_user=len(model.user_feats),
                          num_item=len(model.item_feats), vocab=cfg["vocab"], seed=seed + 194)
    for _ in range(cfg["fold_steps"]):
        b = g.batch()
        rows = pick[rng.integers(0, len(pick), cfg["batch"])]
        for f in model.item_feats:
            b[f] = feats[f][rows]
        state, m = trainer.train_step(state, b)
    state, path = ck.save_incremental(state)
    train_s = time.perf_counter() - t0
    before = engine._corpus.vecs.clone()
    sbefore = engine._corpus.scale.clone()
    trained = {f: np.unique(feats[f][pick]) for f in model.item_feats}
    expect = np.nonzero(np.any([np.isin(feats[f], trained[f]) for f in model.item_feats],
                               axis=0))[0]
    t0 = time.perf_counter()
    if not p.poll_updates():
        raise AssertionError("the delta was not applied")
    poll_s = time.perf_counter() - t0
    lf = engine.last_fold
    if lf is None or lf["full"] or lf["dense_drift"] or lf["rows"] != expect.size:
        raise AssertionError(f"the fold {lf}; the steps trained the features of "
                             f"{expect.size} corpus rows")
    after = engine._corpus.vecs
    moved = np.nonzero(((after != before).any(dim=1)
                        | (engine._corpus.scale != sbefore)).cpu().numpy())[0]
    if not set(moved.tolist()) <= set(expect.tolist()):
        raise AssertionError("the fold changed rows outside the trained items")
    fresh = RetrievalEngine(p, quantize="int8", block_rows=cfg["block_rows"],
                            chunk=cfg["chunk"])
    fresh.upsert_items(ids[expect], {f: v[expect] for f, v in feats.items()})
    n = expect.size
    if not (torch.equal(fresh._corpus.vecs[:n], after[expect])
            and torch.equal(fresh._corpus.scale[:n], engine._corpus.scale[expect])):
        raise AssertionError("a re-encoded item's vector differs from a fresh engine's")
    st["fold"] = dict(rows=lf["rows"], moved=len(moved), seconds=lf["seconds"],
                      poll_s=poll_s, train_s=train_s, version=p.version,
                      lag=p.last_apply_lag_seconds)
    read = _read_launches(p)
    nfwd = -(-n // cfg["chunk"]) + _encodes(n, cfg["chunk"])  # the fold; the fresh engine
    want += _import_launches(p, [path]) + nfwd * read
    del trainer, state, fresh, before
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return want


def retrieval_stores_cabi(dev, p, model, cfg, seed, ckdir, lib_ready, st):
    """Phase 19 (e): Predictor(stores={table: RemoteKVClient}) over a
    RemoteKVServer serves the store's rows for keys missing from the table,
    equal bit for bit to a Predictor over an in-process HostKV holding the
    same rows; the processor library loaded with ctypes answers JSON and
    protobuf process() calls equal to Predictor.predict bit for bit.
    Returns the launches of (#1, #3, #2, #5, #4) of its path."""
    import ctypes

    from deeprec_tpu_torch import native
    from deeprec_tpu_torch.data import SyntheticTwoTower
    from deeprec_tpu_torch.serving import Predictor, RemoteKVClient, RemoteKVServer
    from deeprec_tpu_torch.serving import predict_pb as pb

    read = _read_launches(p)
    paths = [os.path.join(ckdir, d) for d in p._dirs()]
    g = SyntheticTwoTower(batch_size=cfg["pred_rows"], num_user=len(model.user_feats),
                          num_item=len(model.item_feats), vocab=cfg["vocab"], seed=seed + 195)
    req = {k: v for k, v in g.batch().items() if k != "label"}
    table = model.user_feats[0]
    novel = np.arange(50_000_000, 50_000_000 + cfg["pred_rows"] // 2, dtype=np.int64)
    missing = dict(req)
    missing[table] = req[table].copy()
    missing[table][::2] = novel.astype(req[table].dtype)
    rows = np.random.default_rng(seed + 196).normal(
        0, 0.1, (len(novel), cfg["emb_dim"])).astype(np.float32)
    kv_remote, kv_local = native.HostKV(cfg["emb_dim"]), native.HostKV(cfg["emb_dim"])
    kv_local.put(novel, rows)
    srv = RemoteKVServer(kv_remote, dim=cfg["emb_dim"]).start()
    try:
        client = RemoteKVClient("127.0.0.1", srv.port, dim=cfg["emb_dim"])
        client.put(novel, rows)
        t0 = time.perf_counter()
        pr = Predictor(model, ckdir, device=dev, stores={table: client})
        st["store_boot_s"] = time.perf_counter() - t0
        pl = Predictor(model, ckdir, device=dev, stores={table: kv_local})
        got, loc, plain = pr.predict(missing), pl.predict(missing), p.predict(missing)
        if not np.array_equal(got, loc) or float(np.abs(got - plain).max()) == 0.0:
            raise AssertionError("the remote store's rows were not served as the "
                                 "in-process store's")
        st["store"] = dict(keys=len(novel), shift=float(np.abs(got - plain).max()))
        client.close()
    finally:
        srv.stop()
    want = 2 * _import_launches(p, paths, boot=True) + 3 * read
    del pr, pl

    # the C ABI, loaded into this process
    lib = native.load_processor_library() if lib_ready.result() else None
    cfg_json = json.dumps({"model": "dssm", "ckpt_dir": ckdir, "device": dev.type,
                           "model_args": {"emb_dim": cfg["emb_dim"],
                                          "capacity": cfg["capacity"]},
                           "max_wait_ms": 1.0, "poll_secs": 0.0}).encode()
    state = ctypes.c_int(-1)
    handle = lib.initialize(b"", cfg_json, ctypes.byref(state))
    if state.value != 0 or not handle:
        raise AssertionError(f"initialize() failed: state {state.value}")
    try:
        want += _import_launches(p, paths, boot=True)
        feats = {k: v.tolist() for k, v in req.items()}
        wire = pb.PredictRequest(inputs={k: pb.ArrayProto.from_numpy(v)
                                         for k, v in req.items()}).serialize()
        ref = p.predict(req)
        answers = []
        for payload in (json.dumps({"features": feats}).encode(), wire):
            out, n = ctypes.c_void_p(), ctypes.c_int()
            rc = lib.process(handle, payload, len(payload), ctypes.byref(out), ctypes.byref(n))
            body = ctypes.string_at(out, n.value)
            lib.free_buffer(out)
            if rc != 200:
                raise AssertionError(f"process() answered {rc}: {body[:200]}")
            answers.append(np.asarray(json.loads(body)["predictions"], np.float32)
                           if payload is not wire else
                           pb.PredictResponse.parse(body).outputs["probabilities"].to_numpy())
        if not all(np.array_equal(a, ref) for a in answers):
            raise AssertionError("process() answers differ from Predictor.predict")
        want += 3 * read
        st["cabi"] = dict(lib=os.path.basename(str(native.processor_library_path())),
                          rows=cfg["pred_rows"])
    finally:
        lib.shutdown_processor(handle)
    return want


def run_retrieval(dev, seed, cfg, ckroot):
    """Phase 19, printed. Returns the launches of (#1, #3, #2, #5, #4) over
    its path and the max abs error of #3 and #4 against their plain versions
    at its shapes."""
    import concurrent.futures

    from deeprec_tpu_torch import native
    from deeprec_tpu_torch.ops.fused_lookup import fused_gather_combine
    from deeprec_tpu_torch.ops.topk import SWEEP_ROWS
    from deeprec_tpu_torch.serving import ModelServer, Predictor, spawn_backends

    t0 = time.perf_counter()
    pool = concurrent.futures.ThreadPoolExecutor(2)
    # the processor library's g++ build, beside the phase
    lib_ready = pool.submit(lambda: bool(native.processor_library_path()))
    ckdir, model, trained = _dssm_ckpt(dev, seed, cfg, ckroot)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    _zero_row_counts()  # the main path starts here
    fused_gather_combine.launches = 0
    st = {}
    t1 = time.perf_counter()
    p = Predictor(model, ckdir, device=dev)
    _sync(dev)
    st["boot_s"] = time.perf_counter() - t1
    paths = [os.path.join(ckdir, d) for d in p._dirs()]
    want = _import_launches(p, paths, boot=True)
    read = _read_launches(p)
    ms = ModelServer(p, max_batch=cfg["batch"])
    spawn = None
    try:
        engines, items, queries, box, fwd = retrieval_engines(dev, p, ms, model, cfg, seed, st)
        fwd += retrieval_big(dev, p, model, cfg, seed, queries, engines["int8"], st)
        # (d)'s backend process, started now: its boot overlaps the fleet's
        spawn = pool.submit(
            spawn_backends, 1, ckpt=ckdir, model="dssm", device=dev.type, poll_secs=0.0,
            model_json=json.dumps({"emb_dim": cfg["emb_dim"], "capacity": cfg["capacity"]}),
            max_batch=cfg["batch"], ready_timeout=300.0)
        want += retrieval_fleet(dev, p, model, cfg, ckdir, seed, items, queries,
                                engines["fp32"], st, spawn)
        fwd += box[0]  # every retrieve of the three engines, (d)'s included
        want += fwd * read
        want += retrieval_fold(dev, p, model, cfg, ckdir, seed, items, engines["int8"], st)
        engines.clear()
        want += retrieval_stores_cabi(dev, p, model, cfg, seed, ckdir, lib_ready, st)
    finally:
        ms.close()
        if spawn is not None and spawn.done() and spawn.exception() is None:
            for pr in spawn.result()[0]:
                pr.kill()
                pr.wait()
        pool.shutdown(wait=True)
    launches = _launch_counts()
    _row_counts()  # ... and ends here (adds the bf16 launches to PAIR_LAUNCHES)
    print(f"retrieval: DSSM emb {cfg['emb_dim']}, {cfg['capacity']} slots a table, "
          f"{'phase 13' + chr(39) + 's state' if trained is None else f'{trained} steps'} "
          f"from {os.path.basename(ckdir)}; Predictor booted in {st['boot_s']:.3f} s")
    for q in ("int8", "bf16", "fp32"):
        s = st[q]
        print(f"retrieval (b) {q}: {cfg['items']} items (capacity {s['capacity']}, block_rows "
              f"{cfg['block_rows']}, {min(SWEEP_ROWS, s['capacity'])} rows a sweep step) "
              f"ingested in "
              f"{s['ingest_s']:.3f} s; retrieve_versioned of {cfg['query']} rows at k "
              f"{cfg['k']}: p50 {s['p50']:.3f} ms, p90 {s['p90']:.3f} ms; the sweep alone p50 "
              f"{s['sweep_p50']:.3f} ms, p90 {s['sweep_p90']:.3f} ms, {s['ops']} device "
              f"operations a sweep; byte bound {s['bound_ms']:.5f} ms; resident "
              f"{s['bytes']} bytes (= the model)")
    b = st["big"]
    print(f"retrieval (b) int8 at {b['items']} items (capacity {b['capacity']}): ingested in "
          f"{b['ingest_s']:.3f} s; the sweep alone p50 {b['sweep_p50']:.3f} ms, p90 "
          f"{b['sweep_p90']:.3f} ms, {b['ops']} device operations; byte bound "
          f"{b['bound_ms']:.5f} ms; resident {b['bytes']} bytes")
    e = st["exact"]
    print(f"retrieval (b) gates, {cfg['recall_batches']} queries of {cfg['query']} rows: the "
          f"f32 top-{cfg['k']}'s items equal to an exact f64 scan of its vectors at "
          f"{e['apart']} of {e['total']} positions (the rest within {RETR_ATOL} of a "
          f"neighbour), their exact scores and the f32 scores within {e['err']:.3g} of the "
          f"exact k best at every position; int8 tie-aware recall@10 "
          f"{st['recall'][10]:.4f}, @100 {st['recall'][100]:.4f} (floor "
          f"{RECALL_FLOOR}); {len(queries)} requests from {cfg['clients']} client threads "
          f"in {st['coalesced_sweeps']} sweeps, each equal to its solo answer bit for bit; "
          f"sweep_info measured = modeled bytes")
    f = st["fleet"]
    print(f"retrieval (d): two fp32 shards of {f['shards']} items (broadcast ingest "
          f"{st['fleet_ingest_s']:.3f} s) merged at the frontend equal the single engine's "
          f"top-{cfg['k']} bit for bit ({st['fleet_retr_ms']:.3f} ms); one member stopped: "
          f"partial answer from the survivor, health {f['partial_health']}, "
          f"retrieval_partials {f['partials']}")
    s = st["sigkill"]
    print(f"retrieval (d): a backend process (spawn_backends --device {dev.type}) answered "
          f"{s['spawned_requests']} PRED requests through the frontend, SIGKILLed mid-load: "
          f"{s['failovers']} routed calls to it failed and were retried on the sibling; "
          f"{s['requests']} requests, {s['failed']} failed, answers within {s['worst']:.3g} "
          f"of Predictor.predict, health {s['health']}")
    fo = st["fold"]
    print(f"retrieval (c): {cfg['fold_steps']} steps (dense frozen) on {cfg['fold_items']} "
          f"corpus items and a delta ({fo['train_s']:.3f} s with the restore), one poll "
          f"({fo['poll_s']:.3f} s): the fold re-encoded {fo['rows']} rows (the rows whose "
          f"item features the steps trained) in {fo['seconds']:.3f} s, {fo['moved']} rows "
          f"moved, none outside them, each equal to a fresh engine's bit for bit; "
          f"version {fo['version']}, last_apply_lag_seconds {fo['lag']}")
    print(f"retrieval (e): Predictor(stores={{RemoteKVClient}}) served {st['store']['keys']} "
          f"missing keys' rows (max |dp| {st['store']['shift']:.4g} against no store) equal to "
          f"an in-process HostKV store's bit for bit; {st['cabi']['lib']} loaded with ctypes: "
          f"JSON and protobuf process() answers of {st['cabi']['rows']} rows equal to "
          f"Predictor.predict bit for bit")
    if dev.type == "cuda" and not np.array_equal(launches, want):
        raise AssertionError(f"phase 19 launched (#1, #3, #2, #5, #4) {launches.tolist()}, the "
                             f"path implies {want.tolist()}")
    peak = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else None
    pk = st["path_kernels"]
    print(f"retrieval (b) kernels on the path: {pk['gathers']} gather_rows and "
          f"{pk['combines']} grouped fused_gather_combine calls of one {cfg['chunk']}-row "
          f"encode chunk, one {cfg['query']}-row query and one {pk['coalesced_rows']}-row coalesced "
          f"batch each equal to the plain version bit for bit (max_abs_err {pk['err']}) at "
          f"(kernel, values, ids, dtype) {pk['shapes']}")
    print(f"retrieval: the path launched (#1, #3, #2, #5, #4) {launches.tolist()} (implied "
          f"{want.tolist()}); peak device memory {peak} GB")
    print(f"phase 19 (retrieval, the fleet, the stores and the C ABI) took "
          f"{time.perf_counter() - t0:.1f} s")
    del p
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return launches, pk["err"]


# ------------------------------------------------------------ phase 20

# Phase 20, the guarded online train-to-serve loop. WDL at the modelzoo's
# widths (`modelzoo/wide_and_deep/train.py` through the port's driver: 26
# categorical and 13 dense features, emb 16, 2^20 slots, hidden
# 1024-512-256, `ev_option` defaults) and the step sentinel of GUARD_BENCH's
# protocol (`tools/bench_guard.py:60-63`), fed Criteo-shaped batches of 2048
# over 1,000 ids a feature whose labels are sharpened (x4, the bench's
# generator) so a clean loss floor exists: after 70 steps a flipped batch
# spikes to 1.85x the clean EMA (about 1.3x over 10^6 ids a feature, under
# the 1.5 spike ratio). Adagrad 0.1 (the bench's) and Adam 1e-3 (the
# modelzoo's default: at these widths the bench's 5e-3 sends clean losses
# to 2-2.5x their neighbours', which the spike check would trip on).
# (a) agreement at 2^12 slots, card against CPU (grad_norm_max cut to 10 so
#     the extreme batch trips the grad-norm bit); (b) the driver from the
#     command line; (c) the guarded loop: `warmup` clean steps (80 in
#     GUARD_BENCH), then `stream` deliveries (90) with nan at 6, its repeats
#     at 10 and 14, extreme at 18, label_flip at 26 and one exploding-lr
#     step `lr_after` steps in, under ServeLoop + QualityGate and a scorer
#     thread, then a NaN delta from a sentinel-less shadow trainer; (d)
#     FRESHNESS_BENCH's protocol with the port's worker process at the
#     modelzoo widths (40 steady steps, 80 in the bench; the broker outage
#     is held on the CPU only, tests/test_torch_online_loop.py).
GUARD = dict(batch=2048, capacity=1 << 20, vocab=1000, sharp=4.0, lr=0.1, dense_lr=1e-3,
             sentinel=dict(spike_ratio=1.5, ema_decay=0.9, grad_norm_max=5e3,
                           row_norm_max=50.0, row_evict_quantile=0.9),
             warmup=40, stream=40, plan={6: "nan", 18: "extreme", 26: "label_flip"},
             repeats=(10, 14), lr_after=30, lr_factor=1e5, warm_save_every=10,
             save_every=8, full_every=3, max_batch_trips=2, replay_window=128,
             poll=0.2, auc_margin=0.05, max_shift=0.2, eval_batches=2, timed=16,
             agree=dict(capacity=1 << 12, batch=128, K=4, grad_norm_max=10.0,
                        rollback=10, poison_at=5),
             zoo=dict(steps=20, eval_every=10, log_every=10, timeout=300, flags=()),
             fresh=dict(batch=128, save_every=8, full_every=40, per_s=4.0, rps=25.0,
                        poll=0.25, steps=40, lease=120.0, recovery=120.0, emb_dim=16,
                        capacity=1 << 20, num_cat=26, num_dense=13, hidden=(16,)))


def _wdl(args):
    """The driver's wide_and_deep model at `args`, built once per capacity."""
    from deeprec_tpu_torch.modelzoo import common as zoo

    return _built(lambda: zoo.model_fn("wide_and_deep", args), "WDL", args.capacity)


def _guard_args(cfg, capacity):
    """The driver's flags of phase 20's model (wide_and_deep)."""
    return _zoo_args("--capacity", capacity, "--learning_rate", cfg["lr"], "--dense_lr",
                     cfg["dense_lr"], "--vocab", cfg["vocab"], model="wide_and_deep")


def _guard_batches(seed, n, B, vocab, sharp):
    """`tools/bench_guard.py` `batch_source` at the modelzoo's 26 + 13
    features: SyntheticCriteo batches whose labels are drawn again from
    the generator's hidden logit scaled by `sharp`."""
    from deeprec_tpu_torch.data import SyntheticCriteo

    gen = SyntheticCriteo(batch_size=B, vocab=vocab, seed=seed)
    rng = np.random.default_rng(seed ^ 0xA5)
    out = []
    for _ in range(n):
        b = gen.batch()
        logit = np.zeros(B, np.float32)
        for c in range(gen.num_cat):
            logit += gen.id_weight[c, b[f"C{c + 1}"] - c * gen.vocab] * 0.3
        dense = np.concatenate([b[f"I{i + 1}"] for i in range(gen.num_dense)], axis=1)
        logit += (np.log1p(dense) @ gen.dense_weight) * 0.3
        logit = (logit - logit.mean()) * sharp
        b["label"] = (rng.random(B) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
        out.append(b)
    return out


def guard_agreement(dev, seed, cfg, tmp):
    """Phase 20 (a) at 2^12 slots, one state made on the CPU and copied to
    the card. Per device: the sentinel off and on (untripped) over 3
    train_steps and one K = 4 lookahead window, bit for bit; each poison
    from one state (clean, nan, extreme, a flipped label against a seeded
    EMA, an exploding lr); a TrainLoop rollback against a clean run minus
    the poisoned batch, per key and dense leaf bit for bit; maintain()'s
    anomaly eviction of one exploded row. Card against CPU: every flag
    equal, the loss and the EMA of step k within max(1, k / 3) x
    TRAIN_RTOL relative (and, the same steps with the MLPs' operands in
    f32, the losses within TRAIN_RTOL / 10), the trip ledgers and the
    evicted keys equal. Returns the lines."""
    from deeprec_tpu_torch.guard import GuardPolicy, SentinelConfig
    from deeprec_tpu_torch.guard.sentinel import flag_kinds, guard_carry
    from deeprec_tpu_torch.modelzoo import common as zoo
    from deeprec_tpu_torch.online import faults
    from deeprec_tpu_torch.online.loop import TrainLoop
    from deeprec_tpu_torch.training.checkpoint import CheckpointManager
    from deeprec_tpu_torch.training.trainer import Trainer

    a = cfg["agree"]
    args = _guard_args(cfg, a["capacity"])
    sen = SentinelConfig(**dict(cfg["sentinel"], grad_norm_max=a["grad_norm_max"]))

    def trainer(d, on=True):
        return Trainer(_wdl(args), *zoo.make_optimizers(args),
                       device=d, sentinel=sen if on else None, pipeline_mode="lookahead")

    bs = _guard_batches(seed + 200, 12 + a["rollback"], a["batch"], cfg["vocab"],
                        cfg["sharp"])
    state0 = trainer("cpu").init(seed)
    cases = [("clean", bs[7], None, None), ("nan", faults.poison_batch(bs[7], "nan"), None,
                                           None),
             ("extreme", faults.poison_batch(bs[7], "extreme", seed=18), None, None),
             ("label_flip", faults.poison_batch(bs[7], "label_flip"), 0.3, None),
             ("exploding_lr", bs[7], None, cfg["lr"] * cfg["lr_factor"])]
    out = {}
    for i, d in enumerate(("cpu", dev.type)):
        d = torch.device(d)
        on, off = trainer(d), trainer(d, on=False)
        s_on, s_off = _copy_state(state0, d), _copy_state(state0, d)
        g, flags, losses, emas = None, [], [], []
        for b in bs[:3]:
            s_on, m = on.train_step(s_on, b, guard=g)
            g = guard_carry(m)
            s_off, _ = off.train_step(s_off, b)
            flags.append(int(m["guard_flags"]))
            losses.append(float(m["loss"]))
            emas.append(float(m["guard_ema"]))
        s_on, m = on.train_steps(s_on, bs[3:3 + a["K"]], guard=g)
        s_off, _ = off.train_steps(s_off, bs[3:3 + a["K"]])
        flags += m["guard_flags"].tolist()
        losses += m["loss"].tolist()
        emas += m["guard_ema"].tolist()
        diff = _state_diff(s_on, s_off)
        if diff or any(flags):
            raise AssertionError(f"{d.type}: sentinel on and off differ in {diff[:6]} "
                                 f"(flags {flags})")
        g = guard_carry(m)
        # the witness: the same 7 steps with the MLPs' operands in f32
        with _f32_dense_operands():
            tr_w, s_w, g_w, f32_losses = trainer(d), _copy_state(state0, d), None, []
            for b in bs[:3]:
                s_w, m_w = tr_w.train_step(s_w, b, guard=g_w)
                g_w = guard_carry(m_w)
                f32_losses.append(float(m_w["loss"]))
            s_w, m_w = tr_w.train_steps(s_w, bs[3:3 + a["K"]], guard=g_w)
            f32_losses += m_w["loss"].tolist()
            del tr_w, s_w
        trips = {}
        for name, batch, ema, lr in cases:
            st = _copy_state(s_on, d)
            gg = g if ema is None else {"ema": torch.tensor(ema, device=d)}
            _, mm = on.train_step(st, batch, lr=lr, guard=gg)
            trips[name] = int(mm["guard_flags"])
            del st
        # the rollback: a guarded loop over a stream with one NaN batch
        # against the sentinel-less loop over the same stream without it
        clean = bs[12:12 + a["rollback"]]
        poisoned = list(clean)
        poisoned[a["poison_at"]] = faults.poison_batch(clean[a["poison_at"]], "nan")
        root = os.path.join(tmp, f"{i}-{d.type}")
        tr_a, tr_b = trainer(d), trainer(d, on=False)
        ck_a = CheckpointManager(os.path.join(root, "ckA"), tr_a)
        ck_a.save(_copy_state(state0, d))
        loop = TrainLoop(tr_a, ck_a, iter(poisoned), save_every=3, full_every=2,
                         guard=GuardPolicy(os.path.join(root, "dl"), max_batch_trips=2),
                         max_steps=len(clean))
        st_a, _ = loop.run()
        ck_b = CheckpointManager(os.path.join(root, "ckB"), tr_b)
        ck_b.save(_copy_state(state0, d))
        st_b, _ = TrainLoop(tr_b, ck_b, iter(clean[:a["poison_at"]] + clean[a["poison_at"] + 1:]),
                            save_every=3, full_every=2, max_steps=len(clean) - 1).run()
        n_keys = _same_state(st_a, st_b, f"{d.type}: the rollback against the clean run "
                             "minus the poisoned batch", meta=2)
        # row hygiene: one occupied row of member 0 blown up
        st = _copy_state(s_on, d)
        bname, ts = next(iter(st.tables.items()))
        slot = int(torch.nonzero(ts.keys[0] != torch.iinfo(ts.keys.dtype).min)[0, 0])
        blown = int(ts.keys[0, slot])
        ts.values[0, slot] = 1e9
        before = _member_arrays(ts, 1)
        st, rep = on.maintain(st)
        ka = _member_arrays(st.tables[bname], 0)[0]
        after = _member_arrays(st.tables[bname], 1)
        if blown in ka.tolist() or not all(torch.equal(x, y) for x, y in zip(before, after)):
            raise AssertionError(f"{d.type}: maintain kept the exploded key {blown} or moved "
                                 "another member's rows")
        out[i] = dict(flags=flags, losses=losses, emas=emas, trips=trips, f32=f32_losses,
                           trip_log=[t[:4] for t in loop.trip_log], rollbacks=loop.rollbacks,
                           keys=n_keys, reinit=rep[bname].get("rows_reinit", 0),
                           live=sorted(ka.tolist()))
    x, y = out[0], out[1]
    rel = lambda u, v: [abs(p - q) / abs(p) for p, q in zip(u, v)]  # noqa: E731
    # TRAIN_RTOL is phase 7's bound for 3 steps. A step's loss moves with
    # the parameters, whose card-vs-CPU difference grows by about the same
    # amount each step (a bf16 operand flip moves an Adam step by up to
    # 2 lr), so step k is held within max(1, k / 3) x TRAIN_RTOL, as phase
    # 15 sums its per-step row bound over the steps. The witness runs the
    # same steps with the MLPs' operands in f32 on both devices: without
    # the flips every step is held within TRAIN_RTOL / 10.
    bound = [max(1.0, k / 3) * TRAIN_RTOL for k in range(1, len(x["losses"]) + 1)]
    loss_r, ema_r, f32_r = (rel(x[k], y[k]) for k in ("losses", "emas", "f32"))
    if any(r > b for r, b in zip(loss_r + ema_r, bound + bound)):
        raise AssertionError(f"losses differ by {loss_r}, EMAs by {ema_r} relative, "
                             f"bounds {bound}")
    if max(f32_r) > TRAIN_RTOL / 10:
        raise AssertionError(f"with f32 operands the losses differ by {f32_r} relative")
    if x["trips"] != y["trips"] or x["trip_log"] != y["trip_log"]:
        raise AssertionError(f"flags differ: {x['trips']} {x['trip_log']} against "
                             f"{y['trips']} {y['trip_log']}")
    if x["trips"]["clean"] or not all(x["trips"][n] for n, *_ in cases[1:]):
        raise AssertionError(f"the poisons tripped {x['trips']}")
    every = 0
    for v in x["trips"].values():
        every |= v
    if every != 31:
        raise AssertionError(f"the poisons tripped only {flag_kinds(every)}")
    if x["reinit"] != y["reinit"] or not x["reinit"] or x["live"] != y["live"]:
        raise AssertionError(f"row hygiene: {x['reinit']} / {y['reinit']} rows re-initialized")
    if y["rollbacks"] != 1:
        raise AssertionError(f"the poisoned stream rolled back {y['rollbacks']} times")
    fmt = lambda v: "[" + ", ".join(f"{u:.3g}" for u in v) + "]"  # noqa: E731
    return [f"sentinel off and on over 3 train_steps and one K = {a['K']} lookahead window: "
            f"every tensor bit for bit on each device, flags 0; card vs CPU per step, "
            f"relative: losses {fmt(loss_r)}, EMAs {fmt(ema_r)} (bounds {fmt(bound)} = "
            f"max(1, k / 3) x {TRAIN_RTOL}); with the MLPs' operands in f32 the losses "
            f"{fmt(f32_r)} (bound {TRAIN_RTOL / 10:.3g})",
            "flags by poison (card = cpu): " + ", ".join(
                f"{n} {v} {flag_kinds(v)}" for n, v in y["trips"].items()),
            f"rollback: tripped {y['trip_log']}, {y['rollbacks']} rollback; {y['keys']} keys, "
            f"dense and Adam equal to the clean run minus the poisoned batch bit for bit on "
            f"each device (cpu {x['keys']} keys)",
            f"maintain: {y['reinit']} exploded row re-initialized on each device, the same "
            f"{len(y['live'])} keys left in member 0, member 1 untouched bit for bit"]


class _Ledger:
    """The launches of (#1, #3, #2, #5, #4) a path implies, added up from the
    events it is made of as they happen: a train step (`_train_launches`,
    plus the sentinel's touched-row gather per lookup group), a save (a
    gather per member and array), a checkpoint directory imported
    (`_link_bundles` of its files, read just before the import, per array:
    values and each per-row slot of a trainer's manager, values alone for a
    Predictor's), a Predictor's read-only forward (`_read_launches`), and
    the launches a comparison itself makes. f32 tables only."""

    def __init__(self):
        self.want = np.zeros(5, np.int64)
        self._lock = threading.Lock()

    def add(self, v):
        with self._lock:
            self.want += np.asarray(v, np.int64)

    @staticmethod
    def _wrap(obj, name, before):
        fn = getattr(obj, name)

        def wrapped(*a, **kw):
            before(*a, **kw)
            return fn(*a, **kw)

        setattr(obj, name, wrapped)

    def trainer(self, tr):
        """Count every train step of `tr` (with the sentinel it has at the
        time: the touched-row gather, and a gather and a scatter more per
        group where it clamps)."""
        base, _ = _train_launches(tr)
        groups = sum(1 if b.stacked else len(b.features) for b in tr.bundles.values())

        def step(*a, **kw):
            sen = tr.sentinel
            rows = sen is not None and (sen.row_norm_max is not None
                                        or sen.row_clamp_norm is not None)
            clamp = sen is not None and sen.row_clamp_norm is not None
            self.add(base + groups * np.array([0, rows + clamp, 0, clamp, 0]))

        self._wrap(tr, "_step", step)

    @staticmethod
    def _arrays(ck):
        from deeprec_tpu_torch.optim.sparse import SCALAR_PREFIX

        opt = ck.trainer.sparse_opt
        return 1 + (0 if opt is None else sum(
            1 for n in opt.slot_specs(1) if not n.startswith(SCALAR_PREFIX)))

    def manager(self, ck):
        """Count every save and every directory import of manager `ck`."""
        if ck.trainer.sparse_opt is not None:
            save_l = _train_launches(ck.trainer)[1]
            self._wrap(ck, "_stage", lambda *a, **kw: self.add(save_l))
        arrays = self._arrays(ck)

        def imported(state, path, load_dense, chunk=None, copy=False):
            self.add([0, 0, 0, arrays * _link_bundles(path, chunk), 0])

        self._wrap(ck, "_apply_ckpt", imported)

    def serve_loop(self, make):
        """make() -> a ServeLoop, counted from its Predictor's boot on: the
        boot's imports and reads are counted at the class methods while it
        is made, the warm replay adds a sentinel-row import per bundle; then
        every import and read-only forward of that Predictor."""
        from deeprec_tpu_torch.serving.predictor import Predictor
        from deeprec_tpu_torch.training.checkpoint import CheckpointManager

        a0, r0 = CheckpointManager._apply_ckpt, Predictor._predict_impl
        reads = []

        def apply(ck, state, path, load_dense, chunk=None, copy=False):
            self.add([0, 0, 0, self._arrays(ck) * _link_bundles(path, chunk), 0])
            return a0(ck, state, path, load_dense, chunk=chunk, copy=copy)

        def predict(p, state, batch):
            reads.append(p)
            return r0(p, state, batch)

        CheckpointManager._apply_ckpt, Predictor._predict_impl = apply, predict
        try:
            serve = make()
            p = serve.predictor
            p._predict_impl = r0.__get__(p)
            p._ck._apply_ckpt = a0.__get__(p._ck)
            read = _read_launches(p)
            self._wrap(p, "_predict_impl", lambda *a, **kw: self.add(read))
            self.manager(p._ck)
        finally:
            CheckpointManager._apply_ckpt, Predictor._predict_impl = a0, r0
        self.add(len(reads) * read + np.array([0, 0, 0, len(p._trainer.bundles), 0]))
        return serve


class _Scorer(threading.Thread):
    """`tools/bench_guard.py` `Scorer`: score the held-out set against the
    served model in a closed loop, request by request; any failure counts."""

    def __init__(self, serve, feats, labels, rows):
        super().__init__(daemon=True, name="guard-scorer")
        self.serve, self.feats, self.labels, self.rows = serve, feats, labels, rows
        self.requests = self.failed = 0
        self.errors, self.aucs = [], []
        self._halt = threading.Event()

    def round(self):
        from deeprec_tpu_torch.guard import np_auc

        probs, ver = [], None
        for off in range(0, len(self.labels), self.rows):
            req = {k: v[off:off + self.rows] for k, v in self.feats.items()}
            self.requests += 1
            try:
                p, ver = self.serve.request_versioned(req, timeout=60.0)
            except Exception as e:
                self.failed += 1
                self.errors.append(repr(e))
                return None
            probs.append(np.asarray(p))
        auc = np_auc(np.concatenate(probs), self.labels)
        self.aucs.append((time.monotonic(), auc, ver))
        return auc

    def run(self):
        while not self._halt.is_set():
            self.round()
            self._halt.wait(0.1)

    def stop(self):
        self._halt.set()


def _no_host_sync(fn):
    """fn under torch.cuda's sync debug mode "error": an operation inside
    it that synchronises the host with the card raises."""
    def wrapped(*a, **kw):
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(prev)

    return wrapped


def _record_row_kernels(dev, st):
    """Patch guard/rows.py's gather so that its FIRST call on the card holds
    the #3 gather of the touched rows against `gather_rows_plain`, and runs
    one clamp_rows at the same rows on a copy of the table (the bound at the
    rows' median norm, so about half of them are rewritten), its #5 scatter
    held against `apply_rows_sr_plain` on a second copy. Bit for bit.
    Returns the function that puts the module back."""
    from deeprec_tpu_torch.guard import rows as guard_rows
    from deeprec_tpu_torch.ops import fused_lookup as fl

    g0 = guard_rows.gather_rows

    def gather(values, ix):
        out = g0(values, ix)
        if "gather" in st or values.device.type != "cuda":
            return out
        if not torch.equal(out, fl.gather_rows_plain(values, ix)):
            raise AssertionError(f"touched_row_norms' gather at {tuple(values.shape)} x "
                                 f"{tuple(ix.shape)} differs from the plain version")
        st["gather"] = (tuple(values.shape), tuple(ix.shape), 0.0)
        norms = out.float().square().sum(-1).sqrt()
        valid = ix >= 0
        bound = float(norms.median())
        v, want_v = values.clone(), values.clone()
        seen = {}
        s0 = guard_rows.apply_rows_sr

        def scatter(vals, six, rows, seed=0):
            seen.update(six=six.clone(), rows=rows.clone())
            return s0(vals, six, rows, seed=seed)

        guard_rows.apply_rows_sr = scatter
        try:
            guard_rows.clamp_rows(v, ix, torch.where(valid, norms, 0.0), bound, 0)
        finally:
            guard_rows.apply_rows_sr = s0
        fl.apply_rows_sr_plain(want_v, seen["six"], seen["rows"])
        n = int((seen["six"] >= 0).sum())
        if not torch.equal(v, want_v) or not n:
            raise AssertionError(f"clamp_rows' scatter at {tuple(values.shape)} x "
                                 f"{tuple(ix.shape)} ({n} rows) differs from the plain version")
        st["scatter"] = (tuple(values.shape), tuple(seen["six"].shape), n, 0.0)
        del v, want_v
        return out

    guard_rows.gather_rows = gather
    return lambda: setattr(guard_rows, "gather_rows", g0)


def _served_kernels_vs_plain(dev, fn):
    """One served forward with every #3 and #4 call recorded and held
    against its plain version, bit for bit (the launches stay counted: they
    are a read of the path). Returns (#3 calls, #4 calls, max abs err)."""
    from deeprec_tpu_torch.embedding import combiners, table
    from deeprec_tpu_torch.ops import fused_lookup as fl

    gathers, combines = [], []
    g0, c0 = table.gather_rows, combiners.fused_gather_combine_grouped

    def gather(values, ix):
        out = g0(values, ix)
        gathers.append((values, ix, out))
        return out

    def combine(values, row_ix, w):
        out = c0(values, row_ix, w)
        combines.append((list(values), list(row_ix), list(w), out))
        return out

    table.gather_rows, combiners.fused_gather_combine_grouped = gather, combine
    try:
        fn()
        _sync(dev)
    finally:
        table.gather_rows, combiners.fused_gather_combine_grouped = g0, c0
    err = 0.0
    for values, ix, out in gathers:
        if not torch.equal(out, fl.gather_rows_plain(values, ix)):
            raise AssertionError("a served gather differs from the plain version")
    for values, row_ix, w, outs in combines:
        for v, ix, ww, out in zip(values, row_ix, w, outs):
            want = fl.fused_gather_combine_plain(v, ix, ww)
            if not torch.equal(out, want):
                raise AssertionError("a served fused_gather_combine differs from the plain "
                                     "version")
            err = max(err, float((out - want).abs().max()) if out.numel() else 0.0)
    if not gathers or not combines:
        raise AssertionError(f"the served forward called #3 {len(gathers)} and #4 "
                             f"{len(combines)} times")
    return len(gathers), len(combines), err


def guard_loop(dev, seed, cfg, tmp, ledger):
    """Phase 20 (c) (see GUARD). Returns stats."""
    from deeprec_tpu_torch.guard import GuardPolicy, QualityGate, SentinelConfig
    from deeprec_tpu_torch.guard.sentinel import guard_carry
    from deeprec_tpu_torch.modelzoo import common as zoo
    from deeprec_tpu_torch.online import faults
    from deeprec_tpu_torch.online.loop import ServeLoop, TrainLoop
    from deeprec_tpu_torch.training.checkpoint import CheckpointManager
    from deeprec_tpu_torch.training.trainer import Trainer

    B = cfg["batch"]
    args = _guard_args(cfg, cfg["capacity"])
    ck_dir, dl_dir = os.path.join(tmp, "ck"), os.path.join(tmp, "deadletter")
    trainer = Trainer(_wdl(args), *zoo.make_optimizers(args),
                      device=dev, sentinel=SentinelConfig(**cfg["sentinel"]))
    ck = CheckpointManager(ck_dir, trainer)
    ledger.trainer(trainer)
    ledger.manager(ck)
    st = {}
    t0 = time.perf_counter()
    warm = _guard_batches(seed + 1, cfg["warmup"], B, cfg["vocab"], cfg["sharp"])
    stream = _guard_batches(seed + 2, cfg["stream"], B, cfg["vocab"], cfg["sharp"])
    hold = _guard_batches(seed + 99, cfg["eval_batches"], B, cfg["vocab"], cfg["sharp"])
    timed = _guard_batches(seed + 3, cfg["timed"] * 2, B, cfg["vocab"], cfg["sharp"])
    st["data_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    state, _ = TrainLoop(trainer, ck, iter(warm), save_every=cfg["warm_save_every"],
                         full_every=2, max_steps=cfg["warmup"],
                         guard=GuardPolicy(dl_dir, max_batch_trips=cfg["max_batch_trips"])
                         ).run()
    _sync(dev)
    st["warmup_s"] = time.perf_counter() - t0
    # the step with the sentinel on and off, in turns (off, on, on, off) on
    # the warmup's state; the poisoned stream restores the chain after. On
    # the card the sentinel's two halves run under the sync debug mode
    # "error": a host synchronisation inside them fails the phase.
    ms = {"off": [], "on": []}
    g = None
    sentinel = trainer.sentinel
    if dev.type == "cuda":
        for name in ("_sentinel_observe", "_sentinel_fold"):
            setattr(trainer, name, _no_host_sync(getattr(trainer, name)))
    for i, mode in enumerate(("off", "on", "on", "off")):
        trainer.sentinel = sentinel if mode == "on" else None
        n = cfg["timed"] // 2
        _sync(dev)
        t1 = time.perf_counter()
        for b in timed[i * n:(i + 1) * n]:
            state, m = trainer.train_step(state, b, **({"guard": g} if mode == "on" else {}))
            g = guard_carry(m) if mode == "on" else g
        _sync(dev)
        ms[mode].append((time.perf_counter() - t1) * 1e3 / n)
    trainer.sentinel = sentinel
    for name in ("_sentinel_observe", "_sentinel_fold"):
        trainer.__dict__.pop(name, None)
    st["step_ms"] = ms
    del state

    feats = {k: np.concatenate([b[k] for b in hold]) for k in hold[0] if k != "label"}
    labels = np.concatenate([b["label"] for b in hold])
    probe = {k: v[:B] for k, v in feats.items()}
    gate = QualityGate(probe=probe, labels=labels[:B], auc_floor=0.5,
                       max_shift=cfg["max_shift"])
    t0 = time.perf_counter()
    serve = ledger.serve_loop(lambda: ServeLoop(
        _wdl(args), ck_dir, poll_secs=cfg["poll"], quality_gate=gate,
        device=dev, max_batch=B))
    st["serve_boot_s"] = time.perf_counter() - t0
    scorer = _Scorer(serve, feats, labels, B)
    baseline = scorer.round()
    if baseline is None:
        raise AssertionError(f"the baseline scoring failed: {scorer.errors[:3]}")
    floor = round(max(0.5, baseline - cfg["auc_margin"]), 4)
    scorer.start()

    injector = faults.PoisonInjector(iter(stream), cfg["plan"], repeat_at=cfg["repeats"])
    boom = {"fn": None, "at": None}

    def lr_fn(step):
        return boom["fn"](step) if boom["fn"] is not None else cfg["lr"]

    def on_step(step):
        # one exploding-lr step `lr_after` steps in; disarmed once it ran,
        # so the rollback's replay trains at the base lr (a pushed config
        # that was reverted)
        if boom["at"] is None and step >= cfg["warmup"] + cfg["lr_after"]:
            boom["at"] = step + 1
            boom["fn"] = faults.exploding_lr(cfg["lr"], step + 1, 1, cfg["lr_factor"])
        elif boom["fn"] is not None and step >= boom["at"]:
            boom["fn"] = None

    loop = TrainLoop(trainer, ck, injector, save_every=cfg["save_every"],
                     full_every=cfg["full_every"],
                     guard=GuardPolicy(dl_dir, max_batch_trips=cfg["max_batch_trips"],
                                       replay_window=cfg["replay_window"]),
                     lr_fn=lr_fn, on_step=on_step, log_every=0)
    rollback_ms = []
    rollback = loop._guard_rollback

    def timed_rollback(*a, **kw):
        out = rollback(*a, **kw)
        rollback_ms.append(loop.last_rollback_ms)
        return out

    loop._guard_rollback = timed_rollback
    kern = {}
    put_back = _record_row_kernels(dev, kern)
    if dev.type == "cuda":  # the comparison's own clamp_rows: a gather and a scatter
        ledger.add([0, 1, 0, 1, 0])
    t0 = time.perf_counter()
    try:
        state, _ = loop.run()
    finally:
        put_back()
    _sync(dev)
    st["stream_s"] = time.perf_counter() - t0

    # a poisoned delta that slips past the trainer: a sentinel-less shadow
    # trainer restores the chain and saves one NaN step; the gate rejects it
    t0 = time.perf_counter()
    shadow = Trainer(_wdl(args), *zoo.make_optimizers(args),
                     device=dev)
    ck_shadow = CheckpointManager(ck_dir, shadow)
    ledger.trainer(shadow)
    ledger.manager(ck_shadow)
    s2 = ck_shadow.restore()
    s2, _ = shadow.train_step(s2, faults.poison_batch(stream[-1], "nan"))
    ck_shadow.save_incremental(s2)
    del s2
    # the gate counts its rejection before the poller quarantines the delta
    # and marks the health: wait for the health
    _wait_for(lambda: serve.health().get("degraded_reason") == "quality_gate",
              "the quality gate's rejection", 60.0, phase=20)
    st["gate_s"] = time.perf_counter() - t0
    health = serve.health()
    time.sleep(1.0)  # the scorer keeps requesting past the rejection
    scorer.stop()
    scorer.join(timeout=60)
    serve.pause()
    time.sleep(2 * cfg["poll"])
    n3, n4, err4 = _served_kernels_vs_plain(dev, lambda: serve.predictor.predict(probe))
    serve.close()

    trips_by_fp = {}
    for bad, detect, flags, kinds, fp in loop.trip_log:
        trips_by_fp.setdefault(fp, []).append((detect - bad, kinds))
    events = []
    for idx, mode, fp in injector.injected:
        hits = trips_by_fp.get(fp, [])
        events.append(dict(delivery=idx, mode=mode, fp=fp,
                           detected=bool(hits) or loop.dead_letter.is_quarantined(fp),
                           lag=max((h[0] for h in hits), default=0), trips=len(hits),
                           kinds=sorted({k for h in hits for k in h[1]})))
    injected = {fp for _, _, fp in injector.injected}
    lr_trips = [(s, k) for s, _, _, k, fp in loop.trip_log if fp not in injected]
    min_auc = min(a for _, a, _ in scorer.aucs)
    st["last_auc"], st["versions"] = scorer.aucs[-1][1], len({v for *_, v in scorer.aucs})
    st.update(events=events, lr_trips=lr_trips, rollback_ms=rollback_ms,
              trips=loop.guard_trips, rollbacks=loop.rollbacks, skipped=loop.batches_skipped,
              quarantined=loop.dead_letter.permanent_count, gaps=loop.replay_gaps,
              baseline=baseline, floor=floor, min_auc=min_auc, rounds=len(scorer.aucs),
              requests=scorer.requests, failed=scorer.failed, gate=gate.last_rejection,
              rejections=gate.rejections, health=health, kern=kern, served=(n3, n4, err4),
              step=int(state.step))
    nan_fp = next(fp for idx, mode, fp in injector.injected if idx == min(cfg["plan"]))
    if scorer.failed:
        raise AssertionError(f"{scorer.failed} failed requests: {scorer.errors[:3]}")
    if [e for e in events if not e["detected"] or e["lag"] > 1]:
        raise AssertionError(f"undetected or late poison: {events}")
    if not loop.dead_letter.is_quarantined(nan_fp):
        raise AssertionError(f"delivery {min(cfg['plan'])}'s batch was not quarantined")
    if not lr_trips:
        raise AssertionError("the exploding-lr step tripped nothing")
    if min_auc < floor:
        raise AssertionError(f"served AUC {min_auc} crossed the floor {floor}")
    if gate.rejections < 1 or health.get("degraded_reason") != "quality_gate":
        raise AssertionError(f"the quality gate: {gate.rejections} rejections, health {health}")
    if dev.type == "cuda" and ("gather" not in kern or "scatter" not in kern):
        raise AssertionError(f"the row kernels were not recorded: {kern}")
    return st


class _LineGen:
    """`tools/bench_freshness.py` `LineGen`: Criteo-shaped TSV lines."""

    def __init__(self, num_cat, num_dense, seed=0):
        self.rng = np.random.default_rng(seed)
        self.num_cat, self.num_dense = num_cat, num_dense

    def lines(self, n):
        out = []
        for _ in range(n):
            label = int(self.rng.random() < 0.4)
            dense = [f"{self.rng.lognormal(0.0, 1.0):.3f}" for _ in range(self.num_dense)]
            cats = [f"tok{int(self.rng.integers(0, 400))}" for _ in range(self.num_cat)]
            out.append("\t".join([str(label)] + dense + cats))
        return out


class _Ingestor(threading.Thread):
    """Append `batch` lines to the stream file `per_sec` times a second and
    note (total lines, time) after each durable append."""

    def __init__(self, path, batch, per_sec, gen):
        super().__init__(daemon=True, name="ingestor")
        self.path, self.batch, self.period, self.gen = path, batch, 1.0 / per_sec, gen
        self.marks, self.total = [], 0
        self._halt = threading.Event()

    def run(self):
        nxt = time.monotonic()
        while not self._halt.is_set():
            data = "\n".join(self.gen.lines(self.batch)) + "\n"
            with open(self.path, "a") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            self.total += self.batch
            self.marks.append((self.total, time.monotonic()))
            nxt += self.period
            delay = nxt - time.monotonic()
            if delay > 0:
                self._halt.wait(delay)

    def stop(self):
        self._halt.set()

    def first_step_after(self, t, B):
        for total, tm in self.marks:
            if tm > t:
                return total // B + (1 if total % B else 0)
        return None


class _VersionSampler(threading.Thread):
    """Model version -> (train step, first seen), sampled every 20 ms."""

    def __init__(self, predictor):
        super().__init__(daemon=True, name="version-sampler")
        self.predictor, self.seen = predictor, {}
        self._halt = threading.Event()

    def run(self):
        while not self._halt.wait(0.02):
            v = self.predictor.version
            if v not in self.seen:
                self.seen[v] = (self.predictor.step, time.monotonic())

    def stop(self):
        self._halt.set()


class _LoadGen(threading.Thread):
    """`rps` requests a second from 2 paced clients; (done, version) of
    every answer, (time, error) of every failure."""

    def __init__(self, serve, features, rps, clients=2):
        super().__init__(daemon=True, name="loadgen")
        self.serve, self.features, self.rps, self.clients = serve, features, rps, clients
        self.records, self.failures = [], []
        self._halt = threading.Event()

    def _client(self, idx):
        period = self.clients / self.rps
        nxt = time.monotonic() + idx * period / self.clients
        while not self._halt.is_set():
            delay = nxt - time.monotonic()
            if delay > 0 and self._halt.wait(delay):
                return
            nxt += period
            try:
                _, version = self.serve.request_versioned(self.features, timeout=30)
                self.records.append((time.monotonic(), version))
            except Exception as e:
                self.failures.append((time.monotonic(), repr(e)))

    def run(self):
        threads = [threading.Thread(target=self._client, args=(i,), daemon=True)
                   for i in range(self.clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    def stop(self):
        self._halt.set()


def _first_served(records, seen, step):
    best = None
    for t_done, v in records:
        info = seen.get(v)
        if info is not None and info[0] >= step and (best is None or t_done < best):
            best = t_done
    return best


def _lags(ingest, load, sampler, B, t0, t1):
    """Freshness of every step fully ingested in [t0, t1]: the time from its
    last line's append to the first answer of a model trained past it."""
    lags, steps = [], 0
    for total, t_in in ingest.marks:
        if not (t0 <= t_in <= t1) or total % B:
            continue
        steps += 1
        t_served = _first_served(load.records, sampler.seen, total // B)
        if t_served is not None and t_served >= t_in:
            lags.append(t_served - t_in)
    lags.sort()
    out = dict(steps_ingested=steps, steps_reflected=len(lags))
    if lags:
        out.update(p50_s=round(lags[len(lags) // 2], 3),
                   p95_s=round(lags[min(len(lags) - 1, int(len(lags) * 0.95))], 3),
                   max_s=round(lags[-1], 3))
    return out


def _recovery(t_fault, ingest, load, sampler, B, timeout):
    """Seconds from a fault to the first answer of a model trained on data
    ingested after it (None: none within `timeout`)."""
    deadline = time.monotonic() + 30
    s_f = None
    while s_f is None and time.monotonic() < deadline:
        s_f = ingest.first_step_after(t_fault, B)
        time.sleep(0.05)
    if s_f is None:
        return None
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        t = _first_served(load.records, sampler.seen, s_f)
        if t is not None:
            return round(t - t_fault, 3)
        time.sleep(0.05)
    return None


def freshness_start(dev, cfg, tmp):
    """Phase 20 (d)'s broker (an empty stream file) and the port's worker
    (`python -m deeprec_tpu_torch.online.loop --device <dev>`) under the
    Supervisor, started before (a) so the worker's start overlaps (a)-(c):
    it connects and waits for data. Returns (broker, supervisor, stream
    path, checkpoint dir)."""
    from deeprec_tpu_torch.data.stream import FileStreamServer
    from deeprec_tpu_torch.online import faults
    from deeprec_tpu_torch.online.supervisor import ProcessSpec, Supervisor

    f = cfg["fresh"]
    stream, ckpt = os.path.join(tmp, "stream.txt"), os.path.join(tmp, "ckpt")
    os.makedirs(tmp, exist_ok=True)
    open(stream, "w").close()
    broker = FileStreamServer(stream, follow=True, poll_secs=0.02).start()
    hb_path = os.path.join(tmp, "trainer.hb")
    argv = faults.worker_argv(
        "--ckpt", ckpt, "--source", f"tcp://127.0.0.1:{broker.port}", "--batch-size",
        f["batch"], "--save-every", f["save_every"], "--full-every", f["full_every"],
        "--steps", 1_000_000_000, "--heartbeat", hb_path, "--log-every", 0, "--num-cat",
        f["num_cat"], "--num-dense", f["num_dense"], "--emb-dim", f["emb_dim"],
        "--capacity", f["capacity"], "--device", dev.type)
    spec = ProcessSpec(name="trainer", argv=argv, heartbeat_path=hb_path,
                       lease_secs=f["lease"], grace_secs=180, max_restarts=3,
                       backoff_base_secs=0.2, env={"PYTHONPATH": ROOT}, cwd=ROOT,
                       stdout=os.path.join(tmp, "trainer.log"))
    sup = Supervisor([spec], poll_secs=0.2, on_event=lambda m: None).start()
    return broker, sup, stream, ckpt


def freshness_phase(dev, seed, cfg, tmp, ledger, rig):
    """Phase 20 (d): FRESHNESS_BENCH's protocol (`tools/bench_freshness.py`)
    with the worker `rig` (freshness_start) fed over TCP and the ServeLoop
    in this process: steady freshness, then the worker SIGKILLed, then the
    newest delta corrupted. Returns stats."""
    import signal

    from deeprec_tpu_torch.data.stream import criteo_line_parser
    from deeprec_tpu_torch.models import WDL
    from deeprec_tpu_torch.online import faults
    from deeprec_tpu_torch.online.loop import ServeLoop
    from deeprec_tpu_torch.online.supervisor import Heartbeat

    f = cfg["fresh"]
    B, nc, nd = f["batch"], f["num_cat"], f["num_dense"]
    broker, sup, stream, ckpt = rig
    gen = _LineGen(nc, nd, seed)
    ingest = _Ingestor(stream, B, f["per_s"], gen)
    st, serve, sampler, load = {}, None, None, None
    try:
        t0 = time.perf_counter()
        ingest.start()
        model = WDL(emb_dim=f["emb_dim"], capacity=f["capacity"], hidden=f["hidden"],
                    num_cat=nc, num_dense=nd)
        serve = ledger.serve_loop(lambda: ServeLoop(
            model, ckpt, poll_secs=f["poll"], device=dev, max_batch=64,
            heartbeat=Heartbeat(os.path.join(tmp, "serve.hb")), wait_for_checkpoint_secs=300))
        st["boot_s"] = time.perf_counter() - t0
        req = criteo_line_parser(nd, nc)(_LineGen(nc, nd, seed + 7).lines(4))
        req.pop("label")
        serve.warmup(req)
        sampler = _VersionSampler(serve.predictor)
        sampler.start()
        load = _LoadGen(serve, req, rps=f["rps"])
        load.start()
        # steady: `steps` steps ingested, then until the last is served
        t0 = time.monotonic()
        time.sleep(f["steps"] / f["per_s"])
        t1 = time.monotonic()
        last = max((n // B for n, tm in ingest.marks if tm <= t1), default=0)
        _wait_for(lambda: _first_served(load.records, sampler.seen, last) is not None,
                  "the steady window to be served", 60.0, phase=20)
        steady = _lags(ingest, load, sampler, B, t0, t1)
        steady["failed"] = len([x for x in load.failures if t0 <= x[0] <= t1])
        steady["requests"] = len([r for r in load.records if t0 <= r[0] <= t1])
        st["steady"] = steady
        # the worker SIGKILLed
        tf = time.monotonic()
        r0 = sup.stats()["trainer"]["restarts"]
        if not sup.kill("trainer", signal.SIGKILL):
            raise AssertionError("the supervisor could not kill its worker")
        st["kill_recovery_s"] = _recovery(tf, ingest, load, sampler, B, f["recovery"])
        st["restarts"] = sup.stats()["trainer"]["restarts"] - r0
        # the newest committed delta corrupted before serving applies it
        serve.pause()
        time.sleep(2 * f["poll"] + 0.2)

        def fresh_delta():
            applied = set(serve.predictor._applied)
            names = [d for d in os.listdir(ckpt) if d.startswith("incr-") and "." not in d
                     and d not in applied
                     and os.path.exists(os.path.join(ckpt, d, "manifest.json"))]
            return max(names, key=lambda d: int(d.split("-")[1])) if names else None

        _wait_for(fresh_delta, "a fresh delta to corrupt", 60.0, phase=20)
        delta = fresh_delta()
        tf = time.monotonic()
        q0 = serve.health()["quarantined"]
        corrupted = faults.corrupt_latest_delta(ckpt, mode="bitflip")
        serve.resume()
        with contextlib.suppress(Exception):
            serve.poll_now()
        _wait_for(lambda: serve.health()["quarantined"] > q0, "the quarantine", 60.0, phase=20)
        st["corrupt_recovery_s"] = _recovery(tf, ingest, load, sampler, B, f["recovery"])
        _wait_for(lambda: any(d.startswith("full-") and "." not in d
                              and int(d.split("-")[1]) > int(delta.split("-")[1])
                              for d in os.listdir(ckpt)), "the self-healing full save",
                  60.0, phase=20)
        st.update(corrupted=os.path.basename(os.path.dirname(corrupted)), delta=delta,
                  quarantined=serve.health()["quarantined"] - q0,
                  failed=len(load.failures), requests=len(load.records),
                  health=serve.health(), worker=sup.stats()["trainer"],
                  lag_gauge=serve.predictor.last_apply_lag_seconds)
    finally:
        ingest.stop()
        if load is not None:
            load.stop()
        if sampler is not None:
            sampler.stop()
        if serve is not None:
            serve.close()
    s = st["steady"]
    if s["steps_ingested"] == 0 or s["steps_reflected"] != s["steps_ingested"]:
        raise AssertionError(f"steady freshness: {s}")
    if st["restarts"] != 1 or st["kill_recovery_s"] is None:
        raise AssertionError(f"after the SIGKILL: {st['restarts']} restarts, recovery "
                             f"{st['kill_recovery_s']}")
    if st["corrupt_recovery_s"] is None or st["quarantined"] < 1:
        raise AssertionError(f"the corrupt delta: {st}")
    if st["failed"]:
        raise AssertionError(f"{st['failed']} failed requests: {load.failures[:3]}")
    return st


def zoo_cli(dev, cfg):
    """Phase 20 (b)'s command line, started: `python -m
    deeprec_tpu_torch.modelzoo --model wide_and_deep` on the card (and
    --log_every so its 20 steps print the rate line)."""
    z = cfg["zoo"]
    cmd = [sys.executable, "-m", "deeprec_tpu_torch.modelzoo", "--model", "wide_and_deep",
           "--steps", str(z["steps"]), "--eval_every", str(z["eval_every"]), "--log_every",
           str(z["log_every"]), "--device", dev.type, *map(str, z["flags"])]
    return cmd, subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True,
                                 env={**os.environ, "PYTHONPATH": ROOT})


def zoo_cli_result(proc, cmd, timeout):
    """(exit code, lines, seconds) of zoo_cli's process; fails without its
    `global_step/sec:` and `Eval AUC:` lines or with another code than 0."""
    t0 = time.perf_counter()
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        raise AssertionError(f"{' '.join(cmd[1:])} ran past {timeout} s: {out[-2000:]}")
    lines = out.splitlines()
    rate = [ln for ln in lines if "global_step/sec:" in ln]
    auc = [ln for ln in lines if ln.startswith("Eval AUC:")]
    if proc.returncode != 0 or not rate or not auc:
        raise AssertionError(f"{' '.join(cmd[1:])} exited {proc.returncode}: {out[-3000:]}")
    return rate, auc, time.perf_counter() - t0


def run_guard(dev, seed, cfg, ckroot):
    """Phase 20: (d)'s worker and (b)'s command line started, (a), (b)
    collected, (c), (d), printed. Returns the launches of (#1, #3, #2, #5,
    #4) over (c) and (d)'s in-process path, the kernel comparisons' shapes
    and the served request's (#3 calls, #4 calls, max abs err)."""
    t0 = time.perf_counter()
    tmp = os.path.join(ckroot, "guard")
    os.makedirs(tmp, exist_ok=True)
    rig = freshness_start(dev, cfg, os.path.join(tmp, "fresh"))
    try:
        return _run_guard(dev, seed, cfg, tmp, rig, t0)
    finally:
        rig[1].stop()
        rig[0].stop()
        shutil.rmtree(tmp, ignore_errors=True)


def _run_guard(dev, seed, cfg, tmp, rig, t0):
    """run_guard's phases, with (d)'s worker `rig` running."""
    from deeprec_tpu_torch.ops.fused_lookup import fused_gather_combine

    cmd, proc = zoo_cli(dev, cfg)
    try:
        for line in guard_agreement(dev, seed, cfg, os.path.join(tmp, "agree")):
            print(f"guard agreement at capacity {cfg['agree']['capacity']}, {dev.type} vs "
                  f"cpu: {line}")
        a_s = time.perf_counter() - t0
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        ledger = _Ledger()
        _zero_row_counts()  # the main path starts here
        fused_gather_combine.launches = 0
        t1 = time.perf_counter()
        st = guard_loop(dev, seed, cfg, os.path.join(tmp, "loop"), ledger)
        c_s = time.perf_counter() - t1
        rate, auc, wait_s = zoo_cli_result(proc, cmd, cfg["zoo"]["timeout"])
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    print(f"driver: `{' '.join(cmd[1:])}` exited 0 ({wait_s:.1f} s after (c)): "
          f"{rate[-1].strip()}; {auc[-1].strip()}")
    ms = st["step_ms"]
    print(f"guarded loop: WDL at the modelzoo widths (26 + 13 features, emb 16, "
          f"{cfg['capacity']} slots), batch {cfg['batch']}: warmup {cfg['warmup']} steps in "
          f"{st['warmup_s']:.1f} s; ms/step sentinel off {[round(x, 3) for x in ms['off']]}, "
          f"on {[round(x, 3) for x in ms["on"]]} (in turns, {cfg["timed"] // 2} steps each; "
          f"on the card no host sync inside the sentinel)")
    print(f"guarded loop: {cfg['stream']} deliveries in {st['stream_s']:.1f} s, "
          f"{st['trips']} trips, {st['rollbacks']} rollbacks (rollback_ms "
          f"{st['rollback_ms']}), {st['skipped']} skipped, {st['quarantined']} quarantined, "
          f"{st['gaps']} replay gaps, final step {st['step']}")
    for e in st["events"]:
        print(f"guarded loop: delivery {e['delivery']} {e['mode']} ({e['fp']}): detected "
              f"{e['detected']} within {e['lag']} dispatch, {e['trips']} trips {e['kinds']}")
    print(f"guarded loop: the exploding-lr step tripped {st['lr_trips']}")
    print(f"guarded loop: served AUC baseline {st['baseline']:.4f}, lowest "
          f"{st['min_auc']:.4f} (floor {st['floor']}), last {st['last_auc']:.4f} over "
          f"{st['rounds']} rounds of {st['versions']} model versions; "
          f"{st['requests']} requests of {cfg['batch']} rows, {st['failed']} failed; "
          f"the NaN delta rejected by the gate ({st['gate']}, {st['rejections']} "
          f"rejections, health {st['health'].get('status')}: "
          f"{st['health'].get('degraded_reason')}) in {st['gate_s']:.1f} s")
    k = st["kern"]
    n3, n4, err4 = st["served"]
    print(f"guarded loop: kernels against their plain versions, bit for bit: #3 "
          f"touched_row_norms' gather {k.get('gather')}, #5 clamp_rows' scatter "
          f"{k.get('scatter')} (on a copy of the table), #4 on one served request "
          f"({n3} #3 and {n4} #4 calls, max abs err {err4})")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    fr = freshness_phase(dev, seed, cfg, os.path.join(tmp, "fresh"), ledger, rig)
    d_s = time.perf_counter() - t1
    s = fr["steady"]
    print(f"freshness: the worker `python -m deeprec_tpu_torch.online.loop --device "
          f"{dev.type}` under the Supervisor, batch {cfg['fresh']['batch']}, a save every "
          f"{cfg['fresh']['save_every']} steps, {cfg['fresh']['per_s']} batches/s, "
          f"{cfg['fresh']['rps']} requests/s, poll {cfg['fresh']['poll']} s; serving booted "
          f"in {fr['boot_s']:.1f} s")
    print(f"freshness: steady {s['steps_reflected']} of {s['steps_ingested']} steps "
          f"reflected, p50 {s.get('p50_s')} s, p95 {s.get('p95_s')} s, max {s.get('max_s')} "
          f"s; {s['requests']} requests, {s['failed']} failed")
    print(f"freshness: SIGKILL: {fr['restarts']} restart, recovered in "
          f"{fr['kill_recovery_s']} s; corrupt delta {fr['corrupted']}: quarantined "
          f"{fr['quarantined']}, a full save past it, recovered in "
          f"{fr['corrupt_recovery_s']} s; {fr['requests']} requests, {fr['failed']} failed; "
          f"last_apply_lag_seconds {fr['lag_gauge']}")
    launches = _launch_counts()
    _row_counts()  # ... and ends here
    want = ledger.want
    peak = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else None
    if dev.type == "cuda" and (not np.array_equal(launches, want) or not launches[[1, 3, 4]].all()):
        raise AssertionError(f"phase 20 launched (#1, #3, #2, #5, #4) {launches.tolist()}, the "
                             f"path implies {want.tolist()}")
    print(f"guard phase: the path (c, d) launched (#1, #3, #2, #5, #4) {launches.tolist()} "
          f"(implied {want.tolist()}); peak device memory {peak} GB")
    print(f"phase 20 (the guarded online loop) took {time.perf_counter() - t0:.1f} s "
          f"(agreement {a_s:.1f} s, the guarded loop {c_s:.1f} s, freshness {d_s:.1f} s)")
    return launches, st["kern"], st["served"]


# ------------------------------------------------------------ phase 21

# Phase 21, the sharded engine (deeprec_tpu_torch/parallel/): MLPerf
# DLRM-DCN at FULL's widths (26 f32 tables of 128, 2^20 slots in all),
# Adagrad 0.05 + Adam 1e-3, a global batch of 2048 from
# SyntheticCriteo(vocab=10^6). Every rank is a process started through
# `python -m deeprec_tpu_torch.launch` running this file with
# --sharded-rank. (a) world 1 over NCCL; (b) world 4 over gloo with every
# rank on the one card (host-staged); (c) the world-4 part files restored
# at world 2 and world 1.
SHARD = dict(batch=2048, vocab=1_000_000, lr=0.05, dense_lr=1e-3, steps_a=4, steps_b=3,
             bf16_steps=2, world=4, loss_rtol=1e-4, bf16_wire_rtol=1e-3,
             bf16_wire_atol=1e-3, update_rtol=0.1, timeout=900)


def _shard_model(cfg, seed, value_dtype=None, exchange=None):
    model = _dlrm_dcn(seed, **cfg["model"])
    over = {k: v for k, v in (("value_dtype", value_dtype), ("exchange_dtype", exchange)) if v}
    return _retable(model, **over) if over else model


def _shard_batches(cfg, seed, n):
    from deeprec_tpu_torch.data import SyntheticCriteo

    gen = SyntheticCriteo(batch_size=cfg["batch"], vocab=cfg["vocab"], seed=seed + 210)
    return [gen.batch() for _ in range(n)]


def _shard_rows(trainer, state):
    """The live rows of this position's shard, sorted by (member, key):
    member, key, value (f32), accumulator, freq, version, and init, the
    table's initializer row of the key (value - init is what training
    wrote)."""
    from deeprec_tpu_torch.embedding.table import empty_key

    out = {}
    for bname, b in trainer.bundles.items():
        ts = state.tables[bname]
        # the live slots picked on the device: only their rows cross
        t_ix, c_ix = torch.nonzero(ts.keys != empty_key(b.table.cfg), as_tuple=True)
        keys = ts.keys[t_ix, c_ix].cpu().numpy().astype(np.int64)
        order = torch.as_tensor(np.lexsort((keys, t_ix.cpu().numpy())), device=t_ix.device)
        t_ix, c_ix = t_ix[order], c_ix[order]
        init = torch.empty_like(ts.values[t_ix, c_ix], dtype=torch.float32)
        for m in torch.unique(t_ix).tolist():
            at = t_ix == m
            init[at] = b.table._init_rows(ts.keys[m, c_ix[at]][None],
                                          [b.salts[m]])[0].float()
        out[bname] = dict(member=t_ix.cpu().numpy(), key=keys[order.cpu().numpy()],
                          value=ts.values[t_ix, c_ix].float().cpu().numpy(),
                          accum=ts.slots["accum"][t_ix, c_ix].cpu().numpy(),
                          freq=ts.meta[t_ix, 0, c_ix].cpu().numpy(),
                          version=ts.meta[t_ix, 1, c_ix].cpu().numpy(),
                          init=init.cpu().numpy())
    return out


def _same_updates(a, b, what, rtol=None):
    """Rows maps of the same keys (`_same_shard_rows`): every row's update
    value - init in `a` within rtol of `b`'s largest update in its bundle
    (rtol None: not held). Returns the largest difference over that
    scale."""
    worst = 0.0
    for bname in a:
        da = a[bname]["value"] - a[bname]["init"]
        db = b[bname]["value"] - b[bname]["init"]
        scale = float(np.abs(db).max()) if db.size else 0.0
        d = float(np.abs(da - db).max()) / scale if scale else 0.0
        if rtol is not None and d > rtol:
            raise AssertionError(f"{what}: {bname} updates differ by {d:.3g} of the largest "
                                 f"({scale:.3g}); bound {rtol}")
        worst = max(worst, d)
    return worst


def _rows_digest(rows) -> str:
    import hashlib

    h = hashlib.sha1()
    for bname in sorted(rows):
        for k in ("member", "key", "value", "accum", "freq", "version"):
            h.update(np.ascontiguousarray(rows[bname][k]).tobytes())
    return h.hexdigest()


def _save_rows(path, rows):
    np.savez(path, **{f"{b}:{k}": v for b, r in rows.items() for k, v in r.items()})


def _load_rows(paths):
    """Rows files of every position merged and sorted by (member, key)."""
    merged = collections.defaultdict(lambda: collections.defaultdict(list))
    for p in paths:
        with np.load(p) as z:
            for name in z.files:
                b, k = name.split(":")
                merged[b][k].append(z[name])
    out = {}
    for b, cols in merged.items():
        r = {k: np.concatenate(v) for k, v in cols.items()}
        order = np.lexsort((r["key"], r["member"]))
        out[b] = {k: v[order] for k, v in r.items()}
    return out


def _part_rows(path, bundles):
    """The rows of a part-file save, merged like `_load_rows`."""
    import glob as _glob

    merged = collections.defaultdict(lambda: collections.defaultdict(list))
    for b in bundles:
        for f in sorted(_glob.glob(os.path.join(path, f"table_{b}_t*.part*.npz"))):
            m = re.search(rf"table_{b}_t(\d*)\.part", f)
            with np.load(f) as z:
                n = z["keys"].shape[0]
                merged[b]["member"].append(np.full(n, int(m.group(1) or 0)))
                merged[b]["key"].append(z["keys"].astype(np.int64))
                merged[b]["value"].append(np.asarray(z["values"], np.float32))
                merged[b]["accum"].append(z["slot:accum"])
                merged[b]["freq"].append(z["freqs"])
                merged[b]["version"].append(z["versions"])
    out = {}
    for b, cols in merged.items():
        r = {k: np.concatenate(v) for k, v in cols.items()}
        order = np.lexsort((r["key"], r["member"]))
        out[b] = {k: v[order] for k, v in r.items()}
    return out


def _same_shard_rows(a, b, what, rtol=0.0, atol=0.0):
    """Rows maps with the same keys, freqs and versions; values and
    accumulators equal (bit for bit by default). Returns the largest
    value difference and the row count."""
    if a.keys() != b.keys():
        raise AssertionError(f"{what}: bundles {sorted(a)} against {sorted(b)}")
    worst, n = 0.0, 0
    for bname in a:
        x, y = a[bname], b[bname]
        for k in ("member", "key", "freq", "version"):
            if x[k].shape != y[k].shape or not np.array_equal(x[k], y[k]):
                raise AssertionError(f"{what}: {bname} {k} differ "
                                     f"({x[k].shape} against {y[k].shape} rows)")
        for k in ("value", "accum"):
            d = float(np.abs(x[k] - y[k]).max()) if x[k].size else 0.0
            worst = max(worst, d) if k == "value" else worst
            if rtol == 0.0 and atol == 0.0:
                if not np.array_equal(x[k], y[k]):
                    raise AssertionError(f"{what}: {bname} {k} not bit for bit (max |diff| {d})")
            elif not np.allclose(x[k], y[k], rtol=rtol, atol=atol):
                raise AssertionError(f"{what}: {bname} {k} past rtol {rtol}, atol {atol} "
                                     f"(max |diff| {d})")
        n += x["key"].size
    return worst, n


def _rank_launches():
    """(#1 bf16 gathers, #3 f32 gathers, #2 bf16 scatters, #5 f32 scatters)
    since the counts were zeroed."""
    from deeprec_tpu_torch.ops.fused_lookup import apply_rows_sr, gather_rows

    return [gather_rows.launches_bf16, gather_rows.launches - gather_rows.launches_bf16,
            apply_rows_sr.launches_bf16, apply_rows_sr.launches - apply_rows_sr.launches_bf16]


def _leg_launches(trainer, steps):
    """(#1, #3, #2, #5) launches `steps` train steps imply on one position:
    `_path_launches` per step, the value gather and the initializer and
    value writes on the bf16 branches where the values are bf16."""
    apply_n, gather_n = _path_launches(trainer)
    bf16 = [b for b in trainer.bundles.values() if b.table.cfg.value_dtype == "bfloat16"]
    g16 = sum(1 if b.stacked else len(b.features) for b in bf16)
    return [steps * g16, steps * (gather_n - g16), steps * 2 * g16,
            steps * (apply_n - 2 * g16)]


def sharded_rank(spec_path):
    """One rank of phase 21 (this process was started by the launcher):
    runs the spec's legs in order and writes each leg's record (and rows
    files) under the spec's directory."""
    import torch.distributed as dist

    from deeprec_tpu_torch.optim import Adagrad, adam
    from deeprec_tpu_torch.parallel import (
        ShardedTrainer, make_mesh, make_mesh_2d, plan_mesh_after_rescale)
    from deeprec_tpu_torch.training.checkpoint import CheckpointManager
    from deeprec_tpu_torch.training.trainer import Trainer

    torch.set_num_threads(1)  # up to 4 ranks share the host's cores
    with open(spec_path) as f:
        spec = json.load(f)
    cfg, seed, out_dir = spec["cfg"], spec["seed"], spec["dir"]
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device(os.environ["DEEPREC_DEVICE"])
    batches = _shard_batches(cfg, seed, spec["batches"])
    if spec.get("wait_for"):  # started early: run once the parent says so
        deadline = time.time() + cfg["timeout"]
        while not os.path.exists(spec["wait_for"]):
            if time.time() > deadline:
                raise TimeoutError(f"no {spec['wait_for']} within {cfg['timeout']} s")
            time.sleep(0.05)

    def timed_steps(trainer, state, first, steps, snap=None):
        """`steps` timed train steps; with snap = (ks, fn), fn(state, k)
        after each step k in ks, outside the timing."""
        losses, t = [], []
        for i in range(steps):
            _sync(dev)
            t0 = time.perf_counter()
            state, m = trainer.train_step(state, batches[first + i])
            losses.append(float(m["loss"]))  # a host read: the step is done
            t.append(time.perf_counter() - t0)
            if snap and i + 1 in snap[0]:
                snap[1](state, i + 1)
        return state, losses, (float(np.mean(t[1:])) * 1e3 if len(t) > 1 else None)

    for leg in spec["legs"]:
        t_leg = time.perf_counter()
        rec = {"name": leg["name"], "rank": rank, "world": world}
        opt = (Adagrad(lr=cfg["lr"]), adam(cfg["dense_lr"]))
        model = _shard_model(cfg, seed, leg.get("value_dtype"), leg.get("exchange"))
        if leg.get("plain"):
            trainer = Trainer(model, *opt, device=dev)
        else:
            if leg.get("rescale_from"):
                intra, inter = leg["rescale_from"]
                old = type("OldMesh", (), dict(axis_names=("inter", "intra"),
                                               shape={"inter": inter, "intra": intra}))
                mesh = plan_mesh_after_rescale(world, old, device=dev)
            elif leg.get("mesh") == "2x2":
                mesh = make_mesh_2d(2, 2, device=dev)
            else:
                mesh = make_mesh(device=dev)
            rec["mesh"] = list(mesh.axis_names)
            trainer = ShardedTrainer(model, *opt, mesh=mesh, comm=leg.get("comm", "allgather"))
        # the model's own parameters: it was built from the seed (once per
        # process), so every leg starts from the same dense state
        state = (CheckpointManager(leg["restore"], trainer).restore() if leg.get("restore")
                 else trainer.init())
        _sync(dev)
        rec["init_s"] = time.perf_counter() - t_leg
        # rows_at = [k, ...]: this position's rows after each step k too
        # (held per key across legs of other step counts and worlds)
        snap = leg.get("rows_at") and (leg["rows_at"], lambda st, k: _save_rows(
            os.path.join(out_dir, f"{leg['name']}-rows{k}-{rank}.npz"),
            _shard_rows(trainer, st)))
        _zero_row_counts()
        state, rec["losses"], rec["step_ms"] = timed_steps(
            trainer, state, leg.get("first", 0), leg.get("steps", 0), snap)
        rec["launches"] = _rank_launches()
        rec["implied"] = _leg_launches(trainer, leg.get("steps", 0))
        if not leg.get("plain"):
            rec["a2a_overflow"] = trainer.a2a_overflow(state)
            rec["insert_fails"] = sum(int(ts.insert_fails.sum()) for ts in state.tables.values())
        rows = _shard_rows(trainer, state)
        rec["digest"] = _rows_digest(rows)
        if leg.get("rows"):
            _save_rows(os.path.join(out_dir, f"{leg['name']}-rows-{rank}.npz"), rows)
        if leg.get("save"):
            state, _ = CheckpointManager(leg["save"], trainer, sharded_io=True).save(state)
        if leg.get("after") is not None:
            state, m = trainer.train_step(state, batches[leg["after"]])
            rec["after_loss"] = float(m["loss"])
        rec["peak_gb"] = (round(torch.cuda.max_memory_allocated(dev) / 2 ** 30, 2)
                          if dev.type == "cuda" else None)
        rec["seconds"] = time.perf_counter() - t_leg
        with open(os.path.join(out_dir, f"{leg['name']}-{rank}.json"), "w") as f:
            json.dump(rec, f)
        del trainer, state, rows
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        dist.barrier()
    return 0


def _start_ranks(dev, world, backend, tmp, tag, legs, cfg, seed, nbatches, wait_for=None):
    """Start `world` processes of `legs` through the launcher (with
    `wait_for`, they start up and then wait for that file before their
    legs); returns (procs, the spec's directory)."""
    d = os.path.join(tmp, tag)
    os.makedirs(d, exist_ok=True)
    spec = os.path.join(d, "spec.json")
    with open(spec, "w") as f:
        json.dump(dict(cfg=cfg, seed=seed, dir=d, legs=legs, batches=nbatches,
                       wait_for=wait_for), f)
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = []
    for r in range(world):
        cmd = [sys.executable, "-m", "deeprec_tpu_torch.launch",
               "--init_method", f"file://{d}/rendezvous", "--num_processes", str(world),
               "--process_id", str(r), "--backend", backend, "--device", dev.type, "--",
               os.path.join(ROOT, "chip_smoke.py"), "--sharded-rank", spec]
        procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    return procs, d


def _wait_ranks(procs, d, legs, timeout, what):
    """Wait for every rank; raise with their output when one fails. Returns
    {leg: [rank records]}."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        raise AssertionError(f"phase 21 {what}: ranks did not finish in {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        tails = "\n".join(f"--- rank {i} (rc {p.returncode}):\n{o[-3000:]}"
                          for i, (p, o) in enumerate(zip(procs, outs)))
        raise AssertionError(f"phase 21 {what}: a rank failed\n{tails}")
    res = {}
    for leg in legs:
        res[leg["name"]] = []
        for r in range(len(procs)):
            with open(os.path.join(d, f"{leg['name']}-{r}.json")) as f:
                res[leg["name"]].append(json.load(f))
    return res


def run_sharded(dev, seed, cfg, ckroot):
    """Phase 21 on `dev` (cuda: world 1 over NCCL, the rest over gloo; cpu:
    gloo throughout). (b) runs first; then its part files restore at world 2
    beside one world-1 process that restores them too and then runs (a)
    (both process sets start with (b) and wait for it). Returns the
    launches of (#1, #3, #2, #5) summed over every rank's main-path legs."""
    t0 = time.perf_counter()
    tmp = os.path.join(ckroot, "sharded")
    shutil.rmtree(tmp, ignore_errors=True)
    parts = os.path.join(tmp, "parts")
    W, A, Bs = cfg["world"], cfg["steps_a"], cfg["steps_b"]
    label = _smi() if dev.type == "cuda" else "cpu"
    host_label = f"{label}; gloo, host-staged, one card: not a multi-GPU figure"
    total = np.zeros(4, np.int64)

    def counted(res, names):
        for name in names:
            for r in res[name]:
                if dev.type == "cuda" and r["launches"] != r["implied"]:
                    raise AssertionError(f"phase 21 {name} rank {r['rank']}: launched "
                                         f"(#1, #3, #2, #5) {r['launches']}, the steps imply "
                                         f"{r['implied']}")
                total[:] += r["launches"]

    # (b) world 4 over gloo, every rank on the one card, host-staged
    legs_b = [dict(name="ag_1d", comm="allgather", steps=Bs, rows=True, rows_at=[1]),
              dict(name="ag_2x2", comm="allgather", mesh="2x2", steps=Bs, save=parts,
                   after=Bs, rows=True),
              dict(name="restored_4", comm="allgather", mesh="2x2", restore=parts, steps=1,
                   first=Bs),
              dict(name="a2a_1d", comm="a2a", steps=Bs, rows=True, rows_at=[1]),
              dict(name="a2a_2x2", comm="a2a", mesh="2x2", steps=Bs),
              dict(name="hier_2x2", comm="hier", mesh="2x2", steps=Bs, rows=True, rows_at=[1]),
              dict(name="bf16_tables", comm="a2a", value_dtype="bfloat16",
                   steps=cfg["bf16_steps"])]
    # (c) the part files restored at world 2 (the 1-D mesh of the 2x2
    # rescale) over gloo, beside one world-1 process over NCCL that restores
    # them too and then runs (a): the port's Trainer, then
    # ShardedTrainer(allgather) with the f32 wire and with the default bf16
    # wire, each from the seeded model's parameters (the bf16 wire's rows
    # kept after step 1 and (b)'s step count too). Both start with (b)
    # and wait for it.
    go = os.path.join(tmp, "b-done")
    legs_c = [dict(name="restored", restore=parts, rescale_from=[2, 2], rows=True, after=Bs)]
    legs_a = [dict(name="plain", plain=True, steps=A, rows=True),
              dict(name="f32_wire", exchange="float32", steps=A, rows=True),
              dict(name="bf16_wire", steps=A, rows=True, rows_at=[1, Bs])]
    procs, db = _start_ranks(dev, W, "gloo", tmp, "b", legs_b, cfg, seed, Bs + 1)
    runs = {2: _start_ranks(dev, 2, "gloo", tmp, "c2", legs_c, cfg, seed, Bs + 1, go),
            1: _start_ranks(dev, 1, "nccl" if dev.type == "cuda" else "gloo", tmp, "c1",
                            legs_c + legs_a, cfg, seed, max(A, Bs + 1), go)}
    try:
        rb = _wait_ranks(procs, db, legs_b, cfg["timeout"], "(b)")
    except BaseException:
        for later, _ in runs.values():
            for p in later:
                p.kill()
                p.wait()
        raise
    seconds = {"b": round(time.perf_counter() - t0, 1)}
    t1 = time.perf_counter()
    with open(go, "w"):
        pass
    rc = {m: _wait_ranks(procs, d, legs_c + (legs_a if m == 1 else []), cfg["timeout"],
                         f"(c) world {m}") for m, (procs, d) in runs.items()}
    seconds["c+a"] = round(time.perf_counter() - t1, 1)
    counted(rb, [leg["name"] for leg in legs_b if leg["name"] != "restored_4"])
    ra, da = rc[1], runs[1][1]
    counted(ra, ["f32_wire", "bf16_wire"])

    plain, f32w, bf16w = (ra[n][0] for n in ("plain", "f32_wire", "bf16_wire"))
    rows = {n: _load_rows([os.path.join(da, f"{n}-rows-0.npz")]) for n in
            ("plain", "f32_wire", "bf16_wire")}
    if f32w["losses"] != plain["losses"]:
        raise AssertionError(f"phase 21 (a): f32-wire losses {f32w['losses']} against the "
                             f"Trainer's {plain['losses']}")
    _, n_rows = _same_shard_rows(rows["f32_wire"], rows["plain"], "phase 21 (a) f32 wire")
    rel = max(abs(x - y) / abs(y) for x, y in zip(bf16w["losses"], plain["losses"]))
    if rel > cfg["bf16_wire_rtol"]:
        raise AssertionError(f"phase 21 (a): bf16-wire losses {bf16w['losses']} against "
                             f"{plain['losses']}: relative {rel}")
    wrow, _ = _same_shard_rows(rows["bf16_wire"], rows["plain"], "phase 21 (a) bf16 wire",
                         rtol=cfg["bf16_wire_rtol"], atol=cfg["bf16_wire_atol"])
    print(f"sharded (a): world 1 over {'NCCL' if dev.type == 'cuda' else 'gloo'}, "
          f"DLRM-DCN {cfg['model']}, batch {cfg['batch']}, {A} steps from seed {seed}: "
          f"ShardedTrainer(allgather) with the f32 wire equals the Trainer bit for bit (losses "
          f"{plain['losses']}; {n_rows} rows of the touched keys); with the default bf16 "
          f"wire the embeddings and gradients round to bf16 on the wire: losses within "
          f"{rel:.3g} relative, rows within {wrow:.3g} (bounds {cfg['bf16_wire_rtol']}, "
          f"{cfg['bf16_wire_atol']})")
    print(f"sharded (a): step ms Trainer {plain['step_ms']:.3f}, sharded f32 wire "
          f"{f32w['step_ms']:.3f}, bf16 wire {bf16w['step_ms']:.3f} ({label})")

    first = {n: rb[n][0]["losses"][0] for n in ("ag_1d", "ag_2x2", "a2a_1d", "a2a_2x2",
                                                 "hier_2x2")}
    if len(set(first.values())) != 1:
        raise AssertionError(f"phase 21 (b): first-step losses differ across comms {first}")
    for x, y in (("ag_1d", "ag_2x2"), ("a2a_1d", "a2a_2x2")):
        for rx, ry in zip(rb[x], rb[y]):
            if rx["losses"] != ry["losses"] or rx["digest"] != ry["digest"]:
                raise AssertionError(f"phase 21 (b): {x} and {y} differ on rank "
                                     f"{rx['rank']}")
    ovf = sum(r["a2a_overflow"] for n in ("a2a_1d", "a2a_2x2", "hier_2x2", "bf16_tables")
              for r in rb[n])
    if ovf:
        raise AssertionError(f"phase 21 (b): summed a2a_overflow {ovf}")
    fails = sum(r["insert_fails"] for n in rb for r in rb[n])
    if fails:
        raise AssertionError(f"phase 21 (b): {fails} failed inserts")
    # against (a)'s bf16-wire world 1 over the same steps: the batch split
    # sums in another order and rounds each rank's share to bf16 on the
    # wire. Every loss within loss_rtol; the merged shards' rows per key:
    # keys, freqs and versions exact, values and accumulators within the
    # bf16 wire's bounds, and each row's update (value - init) within
    # update_rtol of the largest update. That last bound catches a source
    # left out of the owner sums, which the values' bound does not: it
    # moved the updates by 0.29-0.78 of the largest in a CPU rehearsal
    # (1.3e-3-1.8e-3 with every source). On the card with every source:
    # 0.0047 after step 1 (each rank's share rounds to bf16, 2^-9
    # relative), 0.0228 after step 2 and 0.0218 after step 3, once the
    # dense layers' first update has moved them apart. Step 1's updates
    # are reported beside step 3's.
    rel4 = {n: [abs(x - y) / abs(y) for x, y in zip(rb[n][0]["losses"], bf16w["losses"])]
            for n in ("ag_1d", "a2a_1d", "hier_2x2")}
    for n, v in rel4.items():
        if max(v) > cfg["loss_rtol"]:
            raise AssertionError(f"phase 21 (b): {n}'s losses against (a)'s world 1 {v}")
    rows4 = {}
    for n in rel4:
        what = f"phase 21 (b) {n} against (a)'s world 1"
        one, got = (_load_rows([os.path.join(da, f"bf16_wire-rows{Bs}-0.npz")]),
                    _load_rows([os.path.join(db, f"{n}-rows-{r}.npz") for r in range(W)]))
        w, k = _same_shard_rows(got, one, what, rtol=cfg["bf16_wire_rtol"],
                                atol=cfg["bf16_wire_atol"])
        late = _same_updates(got, one, what, cfg["update_rtol"])
        one, got = (_load_rows([os.path.join(da, "bf16_wire-rows1-0.npz")]),
                    _load_rows([os.path.join(db, f"{n}-rows1-{r}.npz") for r in range(W)]))
        _same_shard_rows(got, one, f"{what} after step 1", rtol=cfg["bf16_wire_rtol"],
                         atol=cfg["bf16_wire_atol"])
        rows4[n] = (w, k, _same_updates(got, one, f"{what} after step 1"), late)
    if dev.type == "cuda" and not all(r["launches"][0] and r["launches"][2]
                                      for r in rb["bf16_tables"]):
        raise AssertionError("phase 21 (b): the bf16 tables did not launch #1 and #2")
    cont = rb["ag_2x2"][0]["after_loss"]
    if rb["restored_4"][0]["losses"][0] != cont:
        raise AssertionError(f"phase 21 (b): restored at 4, the next loss "
                             f"{rb['restored_4'][0]['losses'][0]} against {cont}")
    print(f"sharded (b): world {W} over gloo on one card (host-staged), {Bs} steps from "
          f"seed {seed}: first-step loss {first['ag_1d']!r} bit for bit across allgather, "
          f"a2a (1-D and 2x2) and hier (2x2); allgather and a2a bit for bit between the 1-D "
          f"and the 2x2 mesh (losses and every shard's rows); summed a2a_overflow 0; "
          f"per-step losses against (a)'s bf16-wire world 1 {rel4} (bound "
          f"{cfg['loss_rtol']}); the 4 shards' rows merged against world 1's after {Bs} "
          f"steps, keys, freqs and versions exact, (max |value diff|, rows; max update diff "
          f"over the largest update after step 1, after step {Bs}) "
          f"{ {n: (float(f'{w:.3g}'), k, float(f'{u:.3g}'), float(f'{x:.3g}')) for n, (w, k, u, x) in rows4.items()} } "
          f"(bounds {cfg['bf16_wire_rtol']}, {cfg['bf16_wire_atol']}; step 1 not held, "
          f"{cfg['update_rtol']} after step {Bs}); restored from its part files "
          f"at 4, the next loss equals the uninterrupted run's bit for bit ({cont!r})")
    for n in ("ag_1d", "ag_2x2", "a2a_1d", "a2a_2x2", "hier_2x2", "bf16_tables"):
        ms = [r["step_ms"] for r in rb[n]]
        print(f"sharded (b): {n} step ms per rank {[round(x, 3) for x in ms]} "
              f"(launches per rank (#1, #3, #2, #5) {rb[n][0]['launches']}; peak "
              f"{rb[n][0]['peak_gb']} GB on rank 0) ({host_label})")

    saved = _part_rows(os.path.join(parts, f"full-{Bs}"), ["group0"])
    _same_shard_rows(saved, _load_rows([os.path.join(db, f"ag_2x2-rows-{r}.npz")
                                  for r in range(W)]),
               "phase 21 (c): part files against the saved state")
    for m, (_, d) in runs.items():
        got = _load_rows([os.path.join(d, f"restored-rows-{r}.npz") for r in range(m)])
        _, n = _same_shard_rows(got, saved, f"phase 21 (c) world {m}")
        loss = rc[m]["restored"][0]["after_loss"]
        rel = abs(loss - cont) / abs(cont)
        if rel > cfg["loss_rtol"]:
            raise AssertionError(f"phase 21 (c) world {m}: resumed loss {loss} against "
                                 f"{cont} at world {W}")
        print(f"sharded (c): part files saved at world {W} (2x2) restored at world {m} "
              f"(mesh {rc[m]['restored'][0]['mesh']}): {n} rows equal per key bit for bit; "
              f"the resumed step's loss {loss!r}, {rel:.3g} relative from world {W}'s "
              f"(another world sums the batch in another order)")
    legs = {n: (round(r[0]["init_s"], 1), round(r[0]["seconds"], 1))
            for res in (rb, ra) for n, r in res.items()}
    print(f"phase 21 (sharded engine) took {time.perf_counter() - t0:.1f} s (process sets "
          f"{seconds}; rank 0's (init, leg) seconds {legs}); launches (#1, #3, #2, #5) over "
          f"every rank's legs {total.tolist()}")
    return total


def _add_sharded(sh, gather, scatter):
    """Phase 21's rank launches (#1, #3, #2, #5) into the records: the
    ranks are other processes, so their bf16 launches go to PAIR_LAUNCHES
    here."""
    gather["launches"] += int(sh[0] + sh[1])
    scatter["launches"] += int(sh[2] + sh[3])
    PAIR_LAUNCHES["gather_rows"] += int(sh[0])
    PAIR_LAUNCHES["apply_rows_sr"] += int(sh[2])


def run(dev, seed, full, small, kernel_shapes, batches, timed, train=TRAIN,
        fused=FUSED, flash_shapes=FLASH_SHAPES, bst=BST_RUN, combine=COMBINE,
        combine_edges=COMBINE_EDGES, combine_group_edges=COMBINE_GROUP_EDGES,
        multi=MULTI, zoo=ZOO, loop=LOOP, tier=TIER, ckpt=CKPT, ingest=INGEST,
        serve=SERVE, retrieval=RETR, guard=GUARD, sharded=SHARD):
    """Phases 3-21 on `dev`. Returns the kernel records, in the order of the
    TPU kernels they replace (#1-#9)."""
    t0 = time.perf_counter()
    phase_s, lap = {}, [t0]

    def done(name):
        """The seconds since the previous phase ended, as phase `name`'s."""
        now = time.perf_counter()
        phase_s[name] = round(now - lap[0], 1)
        lap[0] = now
    PAIR_LAUNCHES.update(gather_rows=0, apply_rows_sr=0)
    gathers = kernel_phase(dev, kernel_shapes[0], kernel_shapes[1:], seed)
    scatters = scatter_phase(dev, kernel_shapes[0], kernel_shapes[1:], seed)
    rec = {"gather_rows_pair": gathers[torch.bfloat16],
           "apply_rows_sr_pair": scatters[torch.bfloat16],
           "gather_rows": gathers[torch.float32],
           "fused_gather_combine": combine_phase(dev, seed, combine, combine_edges,
                                                 combine_group_edges),
           "apply_rows_sr": scatters[torch.float32]}
    gather, scatter, pooled = (rec[k] for k in ("gather_rows", "apply_rows_sr",
                                                "fused_gather_combine"))
    print(f"phase 3 (kernels against their plain versions) took "
          f"{time.perf_counter() - t0:.1f} s")
    done("3")

    ckroot = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(ckroot, ignore_errors=True)
    try:
        p, batch, st, host = serve_phase(dev, full, LIVE_KEYS,
                                         os.path.join(ckroot, "full"), seed, batches,
                                         timed)
        gather["launches"] = st["launches"]
        pooled["launches"] = st["combine_launches"]
        print(f"serving: DLRM-DCN {full} restored in {st['restore_s']:.2f} s "
              f"(checkpoint written in {st['write_s']:.2f} s), "
              f"{st['requests']} requests, gather_rows launches {st['launches']} "
              f"({st['launches_per_request']} per request), fused_gather_combine "
              f"launches {st['combine_launches']} ({st['combine_per_request']} per "
              f"request), "
              f"{st['live_ids_checked']} looked-up ids checked row for row, "
              f"probe loop {st['probe_syncs']:.1f} host syncs per request")
        print(f"serving: predict latency at batch {batches[0]}: "
              f"p50 {st['p50_ms']} ms, p90 {st['p90_ms']} ms over {timed}; "
              f"peak device memory {st['peak_gb']} GB")
        if dev.type == "cuda":
            try:
                profile_predict(p, batch, st["p50_ms"])
            except Exception as e:  # a measurement, not a phase of the contract
                print(f"profile: not measured ({type(e).__name__}: {e})")

        mh = multi_hot_phase(dev, p, host, seed, multi)
        gather["launches"] += mh["launches"][0]
        pooled["launches"] += mh["launches"][1]
        pooled["max_abs_err"] = max(pooled["max_abs_err"], mh["err"])
        print(f"multi-hot serving: {mh['requests']} requests (bags of the MLPerf "
              f"multi-hot sizes padded to L = {max(MULTI_HOT)}; {mh['ids']} real ids in "
              f"the L = {max(MULTI_HOT)} feature of batch {multi['batch']}) launched "
              f"(gather_rows, fused_gather_combine) {mh['launches']} "
              f"({mh['per_request']} per request); probabilities finite in (0, 1); "
              f"{mh['bags_checked']} pooled bags bit-exact against numpy; p50 "
              f"{mh['p50_ms']:.3f} ms, p90 {mh['p90_ms']:.3f} ms at batch "
              f"{multi['batch']} over {multi['timed']}; {mh['seconds']:.1f} s")
        if "profile" in mh:
            wall, busy, kernels, rows, combine_us = mh["profile"]
            print(f"profile: {multi['profiled']} multi-hot predicts of batch "
                  f"{multi['batch']}: wall {wall / 1e3:.3f} ms/request, device busy "
                  f"{busy / 1e3:.3f} ms/request, idle share {1 - busy / wall:.3f} (of "
                  f"the p50 {1 - busy / 1e3 / mh['p50_ms']:.3f}), {kernels} "
                  f"kernels/request; fused_gather_combine {combine_us / 1e3:.3f} "
                  f"ms/request ({combine_us / busy:.3f} of the device time)")
            for dt, key, count in rows[:12]:
                print(f"profile:   {dt:10.1f} us/request  x{count:<4d} {key[:100]}")
        del p
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        done("4")

        probs, multi_probs = {}, {}
        for d in (dev, torch.device("cpu")):
            path = os.path.join(ckroot, f"small-{d.type}")
            q, b, _, small_host = serve_phase(d, small, SMALL_LIVE, path, seed, [256], 0)
            probs[d.type] = q.predict(b)
            multi_probs[d.type] = q.predict(make_multi_hot(
                q.model, small_host, 256, np.random.default_rng(seed + 43)))
            del q
        diff = float(np.abs(probs[dev.type] - probs["cpu"]).max())
        multi_diff = float(np.abs(multi_probs[dev.type] - multi_probs["cpu"]).max())
        print(f"agreement: capacity {small['capacity']} on {dev.type} vs cpu, "
              f"max |prob diff| {diff:.3g} one-hot, {multi_diff:.3g} multi-hot "
              f"(tolerance {PROB_ATOL})")
        if diff > PROB_ATOL or multi_diff > PROB_ATOL:
            raise AssertionError("card and CPU probabilities disagree")
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        done("5")

        tst = run_training(dev, full, small, ckroot, seed, train)
        gather["launches"] += tst["launches"][1]
        scatter["launches"] = tst["launches"][0]
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        done("6-7")

        fst, f_rec, b_rec = fused_phase(dev, seed, fused)
        rec["fused_sparse_forward"], rec["fused_sparse_backward"] = f_rec, b_rec
        gather["launches"] += fst["launches"][2]
        scatter["launches"] += fst["launches"][3]
        print(f"fused bag step: {fst['groups']} bag-length groups of the MLPerf "
              f"multi-hot sizes, {fused['checked']} checked steps launched "
              f"(fused_sparse_forward, fused_sparse_backward, gather_rows, "
              f"apply_rows_sr) {fst['launches']} times; {fst['rows_compared']} "
              f"rows compared bit for bit")
        print(f"fused bag step: {fst['step_ms']:.3f} ms/step over {fused['timed']} "
              f"timed steps ({fst['examples_per_s']:.1f} examples/s); byte bound "
              f"forward {fst['bytes'][0] / HBM_BYTES_PER_S * 1e3:.5f} ms, backward "
              f"{fst['bytes'][1] / HBM_BYTES_PER_S * 1e3:.5f} ms per step; peak "
              f"device memory {fst['peak_gb']} GB on the main path, "
              f"{fst.get('peak_gb_checks')} GB with the checks' copies")
        if "profile" in fst:
            wall, busy, kernels, rows, _ = fst["profile"]
            print(f"profile: 2 fused steps: wall {wall / 1e3:.3f} ms/step, device "
                  f"busy {busy / 1e3:.3f} ms/step, idle share {1 - busy / wall:.3f} "
                  f"(of the timed step {1 - busy / 1e3 / fst['step_ms']:.3f}), "
                  f"{kernels} kernels/step")
            for dt, key, count in rows[:16]:
                print(f"profile:   {dt:10.1f} us/step  x{count:<4d} {key[:100]}")
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        done("8")

        bud = budget_phase(dev, full, seed, train)
        gather["launches"] += bud["launches"][1]
        scatter["launches"] += bud["launches"][0]
        fr = {b: r.get("unique_budget_fraction") for b, r in bud["report"].items()}
        print(f"budgeted training: DLRM-DCN {full}, Trainer(unique_budget='auto'), "
              f"batch {train['batch']}: unique fraction "
              f"{ {b: r.get('unique_fraction') for b, r in bud['report'].items()} }, "
              f"budget fraction {fr}, unique size (before, after update_budgets) "
              f"{bud['sizes']}; dedup_overflow 0; losses {bud['losses'][0]:.6f} .. "
              f"{bud['losses'][-1]:.6f}; launched (apply_rows_sr, gather_rows) "
              f"{bud['launches']}; hash-dedup probe loop "
              f"{bud['probe_syncs_per_step']:.1f} host syncs per step")
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        done("9")

        f_rec, b_rec = flash_phase(dev, seed, bst, flash_shapes)
        rec["flash_attention_fwd"], rec["flash_attention_bwd"] = f_rec, b_rec
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        done("10")
        st, sv = run_bst(dev, seed, bst, ckroot)
        f_rec["launches"] = st["flash"][0] + sv["launches"][0]
        b_rec["launches"] = st["flash"][1]
        gather["launches"] += st["rows"][1] + sv["launches"][1]
        scatter["launches"] += st["rows"][0]
        pooled["launches"] += sv["launches"][2]
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        done("11-12")

        t0 = time.perf_counter()
        for zs in zoo_phase(dev, seed, zoo, ckroot).values():
            gather["launches"] += zs["rows"][1] + zs["served"][0]
            scatter["launches"] += zs["rows"][0]
            pooled["launches"] += zs["served"][1]
            pooled["max_abs_err"] = max(pooled["max_abs_err"], zs["err"])
        print(f"phase 13 (the modelzoo) took {time.perf_counter() - t0:.1f} s")
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        done("13")

        lst = run_loop(dev, seed, full, small, loop, ckroot)
        # #1 and #2 reach the records through PAIR_LAUNCHES below
        gather["launches"] += int(lst["launches"][:2].sum())
        scatter["launches"] += int(lst["launches"][2:4].sum())
        pooled["launches"] += int(lst["launches"][4])
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        done("14")

        tl = run_tier(dev, seed, full, small, tier, ckroot)
        # (#3, #5, #1, #2, #4); #1 and #2 reach the records through PAIR_LAUNCHES
        gather["launches"] += int(tl[0] + tl[2])
        scatter["launches"] += int(tl[1] + tl[3])
        pooled["launches"] += int(tl[4])
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        done("15")

        cl = run_ckpt(dev, seed, full, small, ckpt, ckroot)
        # (#1, #3, #2, #5, #4); #1 and #2 reach the records through PAIR_LAUNCHES
        gather["launches"] += int(cl[0] + cl[1])
        scatter["launches"] += int(cl[2] + cl[3])
        pooled["launches"] += int(cl[4])
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        done("16")

        il = run_ingest(dev, seed, full, ingest, ckroot)
        # (#1, #3, #2, #5, #4); #1 and #2 reach the records through PAIR_LAUNCHES
        gather["launches"] += int(il[0] + il[1])
        scatter["launches"] += int(il[2] + il[3])
        pooled["launches"] += int(il[4])
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        done("17")

        sl = run_serving(dev, seed, full, serve, ckroot)
        # (#1, #3, #2, #5, #4); #1 and #2 reach the records through PAIR_LAUNCHES
        gather["launches"] += int(sl[0] + sl[1])
        scatter["launches"] += int(sl[2] + sl[3])
        pooled["launches"] += int(sl[4])
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        done("18")

        rl, rerr = run_retrieval(dev, seed, retrieval, ckroot)
        gather["max_abs_err"] = max(gather["max_abs_err"], rerr)
        pooled["max_abs_err"] = max(pooled["max_abs_err"], rerr)
        # (#1, #3, #2, #5, #4); #1 and #2 reach the records through PAIR_LAUNCHES
        gather["launches"] += int(rl[0] + rl[1])
        scatter["launches"] += int(rl[2] + rl[3])
        pooled["launches"] += int(rl[4])
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        done("19")

        gl, _, served = run_guard(dev, seed, guard, ckroot)
        pooled["max_abs_err"] = max(pooled["max_abs_err"], served[2])
        # (#1, #3, #2, #5, #4); #1 and #2 reach the records through PAIR_LAUNCHES
        gather["launches"] += int(gl[0] + gl[1])
        scatter["launches"] += int(gl[2] + gl[3])
        pooled["launches"] += int(gl[4])
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        done("20")

        _add_sharded(run_sharded(dev, seed, dict(sharded, model=full), ckroot),
                     gather, scatter)
        done("21")
    finally:
        shutil.rmtree(ckroot, ignore_errors=True)
    # the bf16 launches of #3 and #5 on the main paths are #1's and #2's
    for pair, k in (("gather_rows_pair", gather), ("apply_rows_sr_pair", scatter)):
        rec[pair]["launches"] = PAIR_LAUNCHES[k["name"]]
        k["launches"] -= PAIR_LAUNCHES[k["name"]]
    print(f"main paths: bf16 launches (gather_rows, apply_rows_sr) "
          f"{(PAIR_LAUNCHES['gather_rows'], PAIR_LAUNCHES['apply_rows_sr'])}")
    print(f"seconds by phase {phase_s}")
    return list(rec.values())


def _smi() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def _process_seconds():
    """Seconds since this process started (from /proc), or None where
    there is no /proc."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return None
    return up - start / os.sysconf("SC_CLK_TCK")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sharded-rank", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.sharded_rank:  # one rank of phase 21, started by the launcher
        sys.path.insert(0, ROOT)
        return sharded_rank(args.sharded_rank)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import deeprec_tpu_torch  # noqa: F401
        from deeprec_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the deeprec_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 3
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    try:
        smi = _smi()
        print(smi)
        t1 = time.perf_counter()
        names = _build.build_all()
        print(f"build: {names} in {time.perf_counter() - t1:.1f} s")
        kernels = run(
            dev, args.seed,
            full=FULL, small=dict(FULL, capacity=SMALL_CAPACITY,
                                  cross_depth=SMALL_CROSS_DEPTH),
            kernel_shapes=[(26, 1 << 20, 128, 2048), (26, 1 << 20, 128, 1),
                           (26, 1 << 20, 128, 37), (4, 4096, 16, 2048),
                           (4, 4096, 3, 37)],
            batches=[2048] * 5 + [1, 37], timed=30,
        )
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    proc = _process_seconds()
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t0:.1f} s (the process "
          f"has run {'an unknown time' if proc is None else f'{proc:.1f} s'})")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
