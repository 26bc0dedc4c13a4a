"""Time small and grouped serving requests of several checkouts of the port
side by side on one card: what the read-only forward costs at the rows a
request really has, where a checkout pads the dense model's input to a
fixed row count (`nn.fixed_rows`).

    python3 tools/torch_serving_rows_ab.py ROOT_A ROOT_B [...] [--rounds 2]

Each ROOT is a checkout holding `deeprec_tpu_torch/` (its kernels build
into ROOT/build/ at first use). The checkouts are timed in turn, A B ...
then in reverse, for `--rounds` rounds, each in a process of its own that
imports the package from its ROOT and prints one JSON line. In each:

  * DLRM-DCN at MLPerf widths (chip_smoke.FULL) with f32 tables of 2^16
    slots (the capacity cut: a request's work does not grow with it),
    trained 2 steps at batch 2048 of SyntheticCriteo(vocab=10^6), saved
    and restored by Predictor: `predict` of 1, 256 and 2048 rows, and
    `Trainer.eval_step` of 1 and 256 rows on the trained state;
  * DSSM at the modelzoo's widths (emb 16, 4 user and 4 item features)
    with 2^16 slots, trained 2 steps at batch 2048 of SyntheticTwoTower
    (vocab 10^5) and restored likewise: a 256-row request of 8 distinct
    users served plainly and with `group_users=True`.

Per case it reports the device ms per call (the kernels one call launches,
torch.profiler) and the call ms (CUDA events around back-to-back calls:
each predict ends in its device-to-host copy, so this is the request's
latency on an idle card). Prints the card's name and power limit first,
then one line per checkout and round, then the medians. Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 0  # as chip_smoke.py
CAPACITY = 1 << 16
USERS = 8


def _served(model, gen, lr, dev, tmp):
    """(trainer, trained state, Predictor on its checkpoint)."""
    from deeprec_tpu_torch.optim import Adagrad, adam
    from deeprec_tpu_torch.serving import Predictor
    from deeprec_tpu_torch.training.checkpoint import CheckpointManager
    from deeprec_tpu_torch.training.trainer import Trainer

    trainer = Trainer(model, Adagrad(lr=lr), adam(1e-3), device=dev)
    state = trainer.init()
    for _ in range(2):
        state, _ = trainer.train_step(state, gen.batch())
    state, _ = CheckpointManager(tmp, trainer).save(state)
    return trainer, state, Predictor(model, tmp, device=dev)


def time_checkout(root):
    """Time one checkout (see the module docstring); returns a dict."""
    sys.path.insert(0, HERE)  # chip_smoke's timers and widths
    import chip_smoke as cs

    sys.path.insert(0, root)  # the package under test
    from deeprec_tpu_torch import data, models

    dev = torch.device("cuda")
    out = {"root": root}

    def case(name, fn):
        device_ms, call_ms = cs._ms(fn, dev, reps=30)
        out[name] = {"device_ms": device_ms, "call_ms": call_ms}

    tmp = tempfile.mkdtemp(prefix="rows_ab_")
    try:
        model = models.DLRMDCN(**dict(cs.FULL, capacity=CAPACITY), seed=SEED)
        gen = data.SyntheticCriteo(batch_size=2048, vocab=1_000_000, seed=SEED,
                                   num_cat=model.num_cat, num_dense=model.num_dense)
        trainer, state, p = _served(model, gen, 0.05, dev, os.path.join(tmp, "dlrm"))
        batch = gen.batch()
        req = {k: v for k, v in batch.items() if not k.startswith("label")}
        for n in (1, 256, 2048):
            case(f"dlrm_predict_{n}", lambda n=n: p.predict({k: v[:n] for k, v in req.items()}))
        for n in (1, 256):
            case(f"dlrm_eval_step_{n}", lambda n=n: trainer.eval_step(
                state, {k: v[:n] for k, v in batch.items()})[1].cpu())
        del trainer, state, p
        torch.cuda.empty_cache()

        model = models.DSSM(emb_dim=16, capacity=CAPACITY, seed=SEED)
        gen = data.SyntheticTwoTower(batch_size=2048, num_user=len(model.user_feats),
                                     num_item=len(model.item_feats), vocab=100_000,
                                     seed=SEED)
        trainer, state, p = _served(model, gen, 0.2, dev, os.path.join(tmp, "dssm"))
        b = {k: v[:256] for k, v in gen.batch().items() if not k.startswith("label")}
        for u in model.user_feats:  # 8 users, 32 candidate items each
            b[u] = b[u][:USERS][[i % USERS for i in range(256)]]
        case("dssm_predict_256", lambda: p.predict(b))
        case("dssm_grouped_256", lambda: p.predict(b, group_users=True))
        del trainer, state, p
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_serving_rows_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.one:
        print(json.dumps(time_checkout(os.path.abspath(args.one))))
        return 0
    print(_smi("name,power.limit"))
    roots = [os.path.abspath(r) for r in args.roots]
    results = {r: [] for r in roots}
    for k in range(args.rounds):
        for r in (roots if k % 2 == 0 else roots[::-1]):
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", r],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                return 1
            line = json.loads(proc.stdout.strip().splitlines()[-1])
            results[r].append(line)
            print(json.dumps(line))
    for r, lines in results.items():
        med = {name: {key: statistics.median(x[name][key] for x in lines)
                      for key in ("device_ms", "call_ms")}
               for name in lines[0] if isinstance(lines[0][name], dict)}
        print(f"median over {len(lines)} runs: {r}: {json.dumps(med)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
