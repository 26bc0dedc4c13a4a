"""The modelzoo training driver on the port — the counterpart of
`modelzoo/common.py`: the `train.py` argument surface of every model
directory (the same 32 flags and defaults, plus `--model` and `--device`),
synthetic data or Criteo TSV / parquet files (`--workqueue` shards them),
full + incremental checkpoints, periodic eval with AUC, and the log lines
`global_step/sec: <v>` and `Eval AUC: <v>` that the benchmark scrapers
read.

    python -m deeprec_tpu_torch.modelzoo --model mlperf --steps 200 \\
        --checkpoint DIR [--device cpu]

Models resolve through `models/registry` (all 18 names); each name takes
the per-model defaults and constructor of its `modelzoo/<model>/train.py`
(`MODELS`). It runs on the CUDA card unless `--device cpu`. `--sharded`
(and so `--comm`) waits for ROADMAP queue A item 6 (multi-GPU).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Dict, Optional

# name -> (data kind, argparse default overrides): each modelzoo/<model>/
# train.py's `main(name, model_fn, kind, defaults=...)`
MODELS = {
    "wdl": ("criteo", {}),
    "wide_and_deep": ("criteo", {}),
    "dlrm": ("criteo", {}),
    "dlrm_dcn": ("criteo", {}),
    "mlperf": ("criteo", {}),
    "deepfm": ("criteo", {}),
    "dcn": ("criteo", {}),
    "dcnv2": ("criteo", {}),
    "masknet": ("criteo", {}),
    "din": ("behavior", {"vocab": 100_000, "learning_rate": 0.2}),
    "dien": ("behavior", {"vocab": 100_000, "learning_rate": 0.2}),
    "bst": ("behavior", {"vocab": 100_000, "learning_rate": 0.2}),
    "dssm": ("twotower", {"vocab": 100_000, "learning_rate": 0.2}),
    "mmoe": ("multitask", {}),
    "ple": ("multitask", {}),
    "esmm": ("multitask", {}),
    "dbmtl": ("multitask", {}),
    "simple_multitask": ("multitask", {}),
}


def build_argparser(name: str = "a model") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=f"Train {name} (deeprec_tpu_torch)")
    p.add_argument("--model", default=None, help="a models/registry name")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) | cpu: without CUDA, pass --device cpu")
    p.add_argument("--batch_size", type=int, default=2048)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--emb_dim", type=int, default=16)
    p.add_argument("--capacity", type=int, default=1 << 20)
    p.add_argument("--vocab", type=int, default=1_000_000,
                   help="synthetic id vocabulary per feature")
    p.add_argument("--learning_rate", type=float, default=0.05)
    p.add_argument("--dense_lr", type=float, default=1e-3)
    p.add_argument("--optimizer", default="adagrad",
                   choices=["sgd", "adagrad", "adagrad_decay", "adam",
                            "adam_async", "adamw", "ftrl"])
    p.add_argument("--data", default="synthetic",
                   help="'synthetic', 'criteo_stats' (pinned Criteo-marginal stream), "
                        "a criteo .tsv glob, or a .parquet glob")
    p.add_argument("--sharded", action="store_true",
                   help="shard tables + batch over all local devices (ROADMAP queue A "
                        "item 6: not ported)")
    p.add_argument("--comm", default="allgather", choices=["allgather", "a2a"],
                   help="sharded embedding exchange (with --sharded)")
    p.add_argument("--checkpoint", default="",
                   help="checkpoint directory (enables save/restore)")
    p.add_argument("--save_steps", type=int, default=1000)
    p.add_argument("--incremental_save_steps", type=int, default=0)
    p.add_argument("--eval_every", type=int, default=500)
    p.add_argument("--eval_batches", type=int, default=8)
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--filter_freq", type=int, default=0,
                   help="counter-filter admission threshold")
    p.add_argument("--steps_to_live", type=int, default=0,
                   help="TTL eviction in steps (0 = off)")
    p.add_argument("--evict_every", type=int, default=0,
                   help="run eviction policies every N steps (0 = only with checkpoints)")
    p.add_argument("--bf16", action="store_true", default=False,
                   help="bfloat16 embedding tables (updates use stochastic rounding)")
    p.add_argument("--kernel", default="auto", choices=["auto", "xla", "pallas"],
                   help="TableConfig.kernel (kept for config parity: the port always "
                        "launches its CUDA kernels on the card)")
    p.add_argument("--micro_batch", type=int, default=0,
                   help="split each batch into N micro-batches (sparse applies per "
                        "micro, dense grads accumulated)")
    p.add_argument("--workqueue", action="store_true",
                   help="shard --data files through a WorkQueue. Requires --data.")
    p.add_argument("--num_slices", type=int, default=1,
                   help="with --workqueue: split each file into N slices")
    p.add_argument("--epochs", type=int, default=1,
                   help="with --workqueue: dataset epochs in the queue")
    p.add_argument("--maintain_every", type=int, default=0,
                   help="run capacity management (auto-grow / tiering) every N steps")
    p.add_argument("--hbm_budget_mb", type=int, default=0,
                   help="with --maintain_every: total table-bytes budget; growth beyond "
                        "it auto-tiers to the host store")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--timeline", type=int, default=0,
                   help="trace steps [N, N+10) to --timeline_dir")
    p.add_argument("--timeline_dir",
                   default=os.path.join(tempfile.gettempdir(), "deeprec_tpu_torch_trace"))
    p.add_argument("--metrics_file", default="",
                   help="append JSONL metrics records here")
    return p


def ev_option(args):
    from deeprec_tpu_torch.config import (
        CounterFilter, EmbeddingVariableOption, GlobalStepEvict)

    return EmbeddingVariableOption(
        counter_filter=CounterFilter(args.filter_freq) if args.filter_freq else None,
        global_step_evict=(GlobalStepEvict(args.steps_to_live)
                           if args.steps_to_live else None),
    )


def model_fn(name: str, args):
    """The model of `modelzoo/<name>/train.py` at `args`' widths, through the
    registry (MLPerf's DLRM-DCN takes its bottom MLP 512-256-emb_dim)."""
    from deeprec_tpu_torch.models.registry import build_model

    kw = dict(emb_dim=args.emb_dim, capacity=args.capacity, ev=ev_option(args))
    if name.lower() in ("mlperf", "dlrm_dcn"):
        kw["bottom"] = (512, 256, args.emb_dim)
    return build_model(name, **kw)


def make_optimizers(args):
    from deeprec_tpu_torch.optim import adam, make

    return make(args.optimizer, lr=args.learning_rate), adam(args.dense_lr)


def make_data(args, kind: str):
    """kind: 'criteo' | 'multitask' | 'behavior' | 'twotower'."""
    import glob

    from deeprec_tpu_torch import data as D

    if args.data == "criteo_stats":
        if kind != "criteo":
            raise ValueError(
                "criteo_stats generates Criteo-shaped batches; model kind "
                f"{kind!r} wants a different schema")
        # train and eval are disjoint splits of one fixed task, so eval AUC
        # is held out; the stream position checkpoints with the model
        # (run() wires mark_consumed through the staging ring)
        gen = D.CriteoStats(args.batch_size, seed=args.seed, split="train")
        args._eval_iter = iter(D.CriteoStats(args.batch_size, seed=args.seed, split="eval"))
        args._datasets = {"criteo_stats": gen}
        return iter(gen)
    if args.data != "synthetic":
        paths = sorted(glob.glob(args.data))
        if not paths:
            raise FileNotFoundError(f"--data glob matched nothing: {args.data}")
        if getattr(args, "workqueue", False):
            parquet = paths[0].endswith(".parquet")
            if parquet and args.num_slices > 1:
                raise ValueError(
                    "--num_slices applies to TSV files only (parquet has no "
                    "byte-range slicing; shard by file instead)")
            q = D.WorkQueue(paths, num_epochs=args.epochs, shuffle=True,
                            seed=args.seed, num_slices=args.num_slices)
            # registered with the CheckpointManager in run(): the queue
            # position checkpoints with the model
            args._datasets = {"workqueue": q}
            return q.input_dataset(args.batch_size, drop_remainder=True,
                                   reader_cls=D.ParquetReader if parquet else None)
        if paths[0].endswith(".parquet"):
            return iter(D.ParquetReader(paths, args.batch_size))
        return iter(D.CriteoCSVReader(paths, args.batch_size))
    if kind == "criteo":
        gen = D.SyntheticCriteo(args.batch_size, vocab=args.vocab, seed=args.seed)
    elif kind == "multitask":
        gen = D.SyntheticMultiTask(args.batch_size, num_cat=8, num_dense=4,
                                   vocab=args.vocab, seed=args.seed)
    elif kind == "behavior":
        gen = D.SyntheticBehaviorSequence(args.batch_size, vocab=args.vocab, seed=args.seed)
    elif kind == "twotower":
        gen = D.SyntheticTwoTower(args.batch_size, vocab=args.vocab, seed=args.seed)
    else:
        raise ValueError(kind)
    return iter(gen)


def _retable(model, **cfg_overrides):
    """Rewrite every sparse feature's TableConfig (bf16 values, kernel
    choice) — one hook instead of plumbing flags through every model."""
    from deeprec_tpu_torch.features import SparseFeature

    model.features = [
        dataclasses.replace(f, table=dataclasses.replace(f.table, **cfg_overrides))
        if isinstance(f, SparseFeature) and f.table is not None else f
        for f in model.features
    ]
    return model


def run(model, args, data_kind: str) -> Dict[str, float]:
    """The MonitoredTrainingSession loop: train, log steps/sec, eval AUC,
    checkpoint (full + incremental). Returns the final eval metrics."""
    from deeprec_tpu_torch.training.checkpoint import CheckpointManager
    from deeprec_tpu_torch.training.trainer import Trainer

    if args.sharded:
        raise NotImplementedError(
            "--sharded: the sharded trainer waits for ROADMAP queue A item 6 (multi-GPU)")
    overrides = {}
    if args.bf16:
        overrides["value_dtype"] = "bfloat16"
    if args.kernel != "auto":
        overrides["kernel"] = args.kernel
    if overrides:
        model = _retable(model, **overrides)

    sparse_opt, dense_opt = make_optimizers(args)
    trainer = Trainer(model, sparse_opt, dense_opt, device=getattr(args, "device", None))
    state = trainer.init(args.seed)
    # data FIRST: make_data registers the input-state carriers (WorkQueue,
    # CriteoStats) in args._datasets, which the CheckpointManager must know
    # before restore() so stream positions rewind with the model. Staging
    # starts strictly AFTER restore: the ring pulls ahead the moment it
    # exists.
    raw_data = make_data(args, data_kind)
    ck = None
    if args.checkpoint:
        ck = CheckpointManager(args.checkpoint, trainer,
                               datasets=getattr(args, "_datasets", None))
        try:
            state = ck.restore()
            print(f"restored from step {int(state.step)}")
        except FileNotFoundError:
            pass
    # stream-position carriers track the CONSUMED index through the ring
    marks = []
    for d in getattr(args, "_datasets", {}).values():
        if hasattr(d, "mark_consumed"):
            marks.append(d.mark_consumed)
            if hasattr(d, "attach_consumer"):
                d.attach_consumer()
    on_consume = (lambda: [m() for m in marks]) if marks else None
    data = trainer.stage(raw_data, on_consume=on_consume)
    eval_src = getattr(args, "_eval_iter", None)
    eval_batches = [trainer.stage_batch(next(eval_src)) if eval_src else next(iter(data))
                    for _ in range(args.eval_batches)]

    tracer = None
    if args.timeline:
        from deeprec_tpu_torch.training.profiler import StepWindowTracer

        tracer = StepWindowTracer(args.timeline, args.timeline + 10, args.timeline_dir)
    mlog = None
    if args.metrics_file:
        from deeprec_tpu_torch.training.logging import MetricsLogger

        mlog = MetricsLogger(args.metrics_file)

    t0 = time.perf_counter()
    window_start = int(state.step)
    for batch in data:
        step = int(state.step)
        if step >= args.steps:
            break
        if tracer:
            tracer.on_step(step)
        if args.micro_batch > 1:
            state, mets = trainer.train_step_accum(state, batch, args.micro_batch)
        else:
            state, mets = trainer.train_step(state, batch)
        step += 1
        if step % args.log_every == 0:
            loss = float(mets["loss"])  # waits for the step: the rate is honest
            dt = time.perf_counter() - t0
            sps = (step - window_start) / max(dt, 1e-9)
            print(f"step {step} loss {loss:.5f} global_step/sec: {sps:.2f}", flush=True)
            if mlog:
                mlog.log(step, loss=loss, steps_per_sec=sps)
            t0 = time.perf_counter()
            window_start = step
        if args.eval_every and step % args.eval_every == 0:
            ev = trainer.evaluate(state, eval_batches)
            for k, v in ev.items():
                if k.startswith("auc"):
                    print(f"Eval AUC: {v:.6f} ({k})", flush=True)
            t0 = time.perf_counter()
            window_start = step
        if args.evict_every and step % args.evict_every == 0:
            state = trainer.evict_tables(state)
        if args.maintain_every and step % args.maintain_every == 0:
            state, report = trainer.maintain(
                state, hbm_budget_bytes=args.hbm_budget_mb << 20 or None)
            acted = {bn: r for bn, r in report.items()
                     if "grew_to" in r or r.get("demoted") or r.get("auto_tiered")}
            if acted:
                print(f"maintain: {acted}", flush=True)
        if ck and args.save_steps and step % args.save_steps == 0:
            state = trainer.evict_tables(state)  # evict at ckpt time (ref cadence)
            state, path = ck.save(state)
            print(f"saved full checkpoint: {path}", flush=True)
        elif ck and args.incremental_save_steps and step % args.incremental_save_steps == 0:
            state, path = ck.save_incremental(state)
            print(f"saved incremental checkpoint: {path}", flush=True)

    if tracer:
        tracer.close()
    if hasattr(data, "close"):
        data.close()  # stop the staging ring's thread
    ev = trainer.evaluate(state, eval_batches)
    for k, v in ev.items():
        if k.startswith("auc"):
            print(f"Eval AUC: {v:.6f} ({k})", flush=True)
    if ck:
        state, path = ck.save(state)
        ck.close()
        print(f"saved final checkpoint: {path}", flush=True)
    if mlog:
        mlog.close()
    return ev


def main(argv=None, name: Optional[str] = None) -> Dict[str, float]:
    """Parse the flags (with the per-model defaults of `name` or
    `--model`) and run."""
    if name is None:
        pre = argparse.ArgumentParser(add_help=False)
        pre.add_argument("--model", required=True)
        name = pre.parse_known_args(argv)[0].model
    name = name.lower()
    if name not in MODELS:
        raise SystemExit(f"unknown model {name!r}; choose from {sorted(MODELS)}")
    kind, defaults = MODELS[name]
    p = build_argparser(name)
    p.set_defaults(model=name, **defaults)
    args = p.parse_args(argv)
    from deeprec_tpu_torch import resolve_device

    args.device = resolve_device(args.device)  # raises without CUDA unless cpu
    return run(model_fn(name, args), args, kind)
