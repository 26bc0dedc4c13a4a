"""The async embedding stage: stale-by-one decoupling of the embedding
exchange from the dense compute — the port of
`deeprec_tpu/parallel/async_stage.py`.

DeepRec's AsyncEmbeddingStage (do_async_embedding) runs the lookup of batch
t+1 in a pipeline stage while batch t's dense compute runs, so the model
consumes embeddings one step stale. Each async step here, in order:

  1. the dense forward and backward on the CARRIED views of batch t-1;
  2. route, resolve and finish of batch t against the step-start tables
     (no data dependency on 1: on the card it is the exchange the dense
     compute could hide);
  3. the stale apply of batch t-1's sparse gradients, after batch t's
     inserts (they claim only empty slots, so the carried slot indices stay
     valid), re-gathering the rows (#3, #1 on bf16 tables) before the write
     (#5 / #2) and re-stamping the metadata;
  4. the dense update.

The step is built on the trainer's own split phases (`_route_all`,
`_resolve_all`, `_finish_all`, `_fwd_bwd`, `_apply_all`); the metrics at
step t are of batch t-1. After `maintain()` or `evict_tables()` (which
rebuild the tables and so invalidate the carried slot indices) call
`bootstrap()` again.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from deeprec_tpu_torch.parallel.trainer import ShardedTrainer
from deeprec_tpu_torch.training.trainer import TrainState


@dataclasses.dataclass
class AsyncState:
    """TrainState plus the batch whose lookup was finished one step early:
    its local rows, per-feature views and per-bundle lookup results."""

    inner: TrainState
    batch: Dict[str, torch.Tensor]
    views: Dict[str, Any]
    bundle_res: Dict[str, Any]


class AsyncShardedTrainer(ShardedTrainer):
    """ShardedTrainer with the stale-by-one async embedding stage:

        astate = trainer.bootstrap(trainer.init(0), first_batch)
        for batch in batches:                 # feed batch t
            astate, mets = trainer.train_step_async(astate, batch)
        # mets at step t are of batch t-1
    """

    def _apply_one(self, b, ts, res, grad, step, lr, reuse):
        # the carried lookup predates writes to the same rows (the previous
        # apply, and this step's lookup): re-gather, and re-stamp the
        # version and dirty bits, whose lookup-time stamps are a step old
        self.sharded[b.name].apply_gradients(
            ts, self.sparse_opt, res, grad, step=step, lr=lr,
            grad_averaging=self.grad_averaging, reuse_rows=False, stamp_meta=True)

    @torch.no_grad()
    def _lookup_train(self, tables, batch, step: int):
        routes = self._route_all(batch, True)
        return self._finish_all(tables, self._resolve_all(tables, routes, step, True))

    def bootstrap(self, state: TrainState, first_batch) -> AsyncState:
        """Fill the pipeline: the train lookup of `first_batch` (a global
        batch) with no dense compute. The first `train_step_async` consumes
        it."""
        batch = self.device_batch(first_batch)
        views, res = self._lookup_train(state.tables, batch, int(state.step))
        return AsyncState(inner=state, batch=batch, views=views, bundle_res=res)

    def _async_step(self, astate: AsyncState, batch_t, lr: float):
        state = astate.inner
        step = int(state.step)
        prev = astate.batch
        loss, logits, g_dense, g_embs = self._fwd_bwd(state.dense, astate.views,
                                                      astate.bundle_res, prev)
        views_t, res_t = self._lookup_train(state.tables, batch_t, step)
        self._apply_all(state.tables, astate.bundle_res, g_embs, step, lr)
        opt_state = self._dense_apply(state.dense, state.opt_state, g_dense)
        mets = self._metrics(loss, logits, prev)
        inner = TrainState(step=step + 1, tables=state.tables, dense=state.dense,
                           opt_state=opt_state)
        return AsyncState(inner=inner, batch=batch_t, views=views_t, bundle_res=res_t), mets

    def train_step_async(self, astate: AsyncState, batch, lr=None):
        """One async step on a global batch, IN PLACE on the carried state's
        tensors. Returns (the next AsyncState, {"loss", "accuracy"} of the
        batch before)."""
        lr = self._train_lr("train_step_async", lr)
        return self._async_step(astate, self.device_batch(batch), lr)

    def train_steps_async(self, astate: AsyncState, batches, lr=None):
        """K async steps in one call: `batches` is a list of K global
        batches or one stacked [K, ...] dict. Exactly K `train_step_async`
        calls; returns (the AsyncState, metrics as [K] tensors), the
        metrics of inner step t of batch t-1."""
        lr = self._train_lr("train_steps_async", lr)
        mets = []
        for batch in self._window(batches):
            astate, m = self._async_step(astate, batch, lr)
            mets.append(m)
        return astate, {k: torch.stack([m[k] for m in mets]) for k in mets[0]}
