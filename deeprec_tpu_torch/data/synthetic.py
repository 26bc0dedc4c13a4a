"""Synthetic click logs — the port's copy of `deeprec_tpu/data/synthetic.py`
(`zipf_ids`, `SyntheticCriteo`, `SyntheticMultiTask`, `SyntheticTwoTower`,
`SyntheticBehaviorSequence`), numpy only: batches are bit-identical to the
JAX package's for a seed.

Ids are zipf-distributed (recommendation workloads are heavy-tailed), and
the label is a noisy logistic function of hidden per-id weights, so a
correct trainer lifts AUC above 0.5.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np


def zipf_ids(rng: np.random.Generator, vocab: int, a: float, shape):
    """Bounded zipf(a) via inverse-CDF over a fixed vocab: a=1 is the
    log-uniform limit; larger a concentrates mass on head ids."""
    u = rng.random(shape)
    if abs(a - 1.0) < 1e-6:
        ranks = np.floor(np.exp(u * np.log(vocab))).astype(np.int64)
    else:
        v = vocab ** (1.0 - a)
        ranks = np.floor((u * (v - 1.0) + 1.0) ** (1.0 / (1.0 - a))).astype(
            np.int64
        )
    return np.clip(ranks, 1, vocab) - 1


class SyntheticCriteo:
    """Batches shaped like Criteo: I1-I13 floats [B,1], C1-C26 int ids [B],
    label [B].

    `zipf_a` is either ONE exponent covering every categorical column
    (legacy, bit-identical draw stream) or a per-table sequence of
    `num_cat` exponents — real workloads have wide variance in per-table
    skew/unique fractions (ROADMAP), and the placement bench needs tables
    whose heads differ to show hot-key balancing.

    `zipf_rotate_every=N` is the DRIFTING-skew mode (flash sales,
    diurnal cycles — the workload Placement v2's replanner exists for):
    after every N batches the hot-key set rotates to a different region
    of the id space (rank r maps to id (r + k·stride) % vocab for
    rotation k = batches_drawn // N), so a placement plan tuned on one
    window becomes stale mid-stream. Deterministic — the rotation is a
    pure function of the batch index, the RNG draw stream is untouched —
    and the labels follow the rotated ids (a newly-hot id brings its own
    hidden weight, like a new product going viral). Off (None, the
    default) the generator is stream-identical to before the knob
    existed."""

    def __init__(
        self,
        batch_size: int = 2048,
        num_cat: int = 26,
        num_dense: int = 13,
        vocab: int = 100_000,
        zipf_a=1.2,
        seed: int = 0,
        dtype=np.int32,
        offset_ids: bool = True,
        zipf_rotate_every: Optional[int] = None,
        zipf_rotate_stride: Optional[int] = None,
    ):
        self.B = batch_size
        self.num_cat = num_cat
        self.num_dense = num_dense
        self.vocab = vocab
        self.zipf_a = zipf_a
        if np.ndim(zipf_a) != 0:
            if len(zipf_a) != num_cat:
                raise ValueError(
                    f"per-table zipf_a needs {num_cat} exponents, "
                    f"got {len(zipf_a)}"
                )
            self._zipf_per_table = np.asarray(zipf_a, np.float64)
        else:
            self._zipf_per_table = None
        # offset_ids=False keeps every column in ONE raw id space (hashed
        # shared-vocab features): each table's zipf head is the SAME raw
        # ids, so under uniform hash_shard every table hammers the same
        # owner shards — the correlated-head case the placement plan's
        # owner-offset rotation exists for.
        self.offset_ids = offset_ids
        if zipf_rotate_every is not None and zipf_rotate_every <= 0:
            raise ValueError(
                f"zipf_rotate_every must be positive, got {zipf_rotate_every}"
            )
        self.zipf_rotate_every = zipf_rotate_every
        # Default stride lands each rotation's head deep inside the
        # previous tail (≈ a third of the vocab, offset so consecutive
        # rotations never re-overlap a small head region); any stride
        # coprime-ish with vocab works, it only has to MOVE the head.
        self.zipf_rotate_stride = (
            zipf_rotate_stride
            if zipf_rotate_stride is not None
            else vocab // 3 + 1
        )
        self._batches_drawn = 0
        self.rng = np.random.default_rng(seed)
        self.dtype = dtype
        # hidden ground-truth weights giving the label structure
        wrng = np.random.default_rng(12345)
        self.id_weight = wrng.normal(0, 1.0, size=(num_cat, vocab)).astype(np.float32)
        self.dense_weight = wrng.normal(0, 0.5, size=(num_dense,)).astype(np.float32)

    def _zipf_ids(self, shape):
        return zipf_ids(self.rng, self.vocab, self.zipf_a, shape)

    def _cat_ids(self) -> np.ndarray:
        """[num_cat, B] categorical draw: one shared-exponent call on the
        legacy scalar path (stream-identical to before per-table knobs
        existed), else one bounded-zipf draw per column at its own a."""
        if self._zipf_per_table is None:
            return self._zipf_ids((self.num_cat, self.B))
        return np.stack([
            zipf_ids(self.rng, self.vocab, float(a), (self.B,))
            for a in self._zipf_per_table
        ])

    def rotation_at(self, batch_index: int) -> int:
        """Hot-set rotation index in force for batch `batch_index` (0
        when rotation is off) — pure, so tests and the bench can locate
        the drift boundary without consuming the stream."""
        if not self.zipf_rotate_every:
            return 0
        return batch_index // self.zipf_rotate_every

    def batch(self) -> Dict[str, np.ndarray]:
        cats = self._cat_ids()
        if self.zipf_rotate_every:
            # Drifting skew: shift the rank->id mapping so the zipf head
            # occupies a different id region each rotation. Applied
            # BEFORE the label logit, so the task rotates with the ids.
            k = self.rotation_at(self._batches_drawn)
            if k:
                cats = (cats + k * self.zipf_rotate_stride) % self.vocab
        self._batches_drawn += 1
        dense = self.rng.lognormal(0.0, 1.0, size=(self.B, self.num_dense)).astype(
            np.float32
        )
        logit = np.zeros((self.B,), np.float32)
        for c in range(self.num_cat):
            logit += self.id_weight[c, cats[c]] * 0.3
        logit += np.log1p(dense) @ self.dense_weight * 0.3
        prob = 1.0 / (1.0 + np.exp(-(logit - logit.mean())))
        label = (self.rng.random(self.B) < prob).astype(np.float32)
        out: Dict[str, np.ndarray] = {"label": label}
        for i in range(self.num_dense):
            out[f"I{i+1}"] = dense[:, i : i + 1]
        for c in range(self.num_cat):
            # offset ids per-feature so tables see disjoint key spaces
            # (offset_ids=False: shared raw space, correlated zipf heads)
            off = c * self.vocab if self.offset_ids else 0
            out[f"C{c+1}"] = (cats[c] + off).astype(self.dtype)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch()


class SyntheticMultiTask(SyntheticCriteo):
    """SyntheticCriteo with correlated ctr/cvr/ctcvr labels (and no
    `label`) for the multi-task models. A conversion is observable only
    given a click: the entire-space structure ESMM exploits."""

    def batch(self) -> Dict[str, np.ndarray]:
        out = super().batch()
        click = out.pop("label")
        conv_given_click = (self.rng.random(self.B) < 0.3).astype(np.float32)
        out["label_ctr"] = click
        out["label_cvr"] = click * conv_given_click
        out["label_ctcvr"] = click * conv_given_click
        return out


class SyntheticTwoTower:
    """User and item id features U0.. and V0.. (each item feature in its own
    id range) with a label from a hidden user-item affinity plus per-id
    propensities, for DSSM."""

    def __init__(self, batch_size=512, num_user=4, num_item=4, vocab=10_000,
                 zipf_a: float = 1.2, seed=0, dtype=np.int32):
        self.B = batch_size
        self.num_user = num_user
        self.num_item = num_item
        self.vocab = vocab
        self.zipf_a = zipf_a
        self.rng = np.random.default_rng(seed)
        self.dtype = dtype
        wrng = np.random.default_rng(4242)
        self.vec = wrng.normal(0, 1, size=(num_user + num_item, vocab, 4)).astype(
            np.float32
        )
        self.bias = wrng.normal(0, 1.0, size=(num_user + num_item, vocab)).astype(
            np.float32
        )

    def batch(self) -> Dict[str, np.ndarray]:
        ids = zipf_ids(self.rng, self.vocab, self.zipf_a,
                       (self.num_user + self.num_item, self.B))
        u = sum(self.vec[i, ids[i]] for i in range(self.num_user))
        v = sum(
            self.vec[self.num_user + i, ids[self.num_user + i]]
            for i in range(self.num_item)
        )
        pop = sum(
            self.bias[i, ids[i]] for i in range(self.num_user + self.num_item)
        )
        logit = (u * v).sum(1) * 0.5 + pop * 0.5
        prob = 1.0 / (1.0 + np.exp(-(logit - logit.mean())))
        label = (self.rng.random(self.B) < prob).astype(np.float32)
        out = {"label": label}
        for i in range(self.num_user):
            out[f"U{i}"] = ids[i].astype(self.dtype)
        for i in range(self.num_item):
            out[f"V{i}"] = (ids[self.num_user + i] + (i + 1) * self.vocab).astype(
                self.dtype
            )
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch()


class SyntheticBehaviorSequence:
    """Taobao user-behavior layout for DIN/DIEN/BST (matches
    models/taobao.behavior_features): user, target_item/target_cat,
    variable-length hist_items/hist_cats (pad -1), label.

    A click is more likely when the target item's hidden embedding aligns
    with the user's history, plus first-order item and category
    propensities, so attention models can learn."""

    def __init__(
        self,
        batch_size: int = 512,
        vocab: int = 50_000,
        num_cats: int = 1000,
        seq_len: int = 50,
        seed: int = 0,
        dtype=np.int32,
    ):
        self.B = batch_size
        self.vocab = vocab
        self.num_cats = num_cats
        self.seq_len = seq_len
        self.rng = np.random.default_rng(seed)
        self.dtype = dtype
        wrng = np.random.default_rng(777)
        self.item_vec = wrng.normal(0, 1, size=(vocab, 8)).astype(np.float32)
        self.item_cat = wrng.integers(0, num_cats, size=(vocab,))
        self.item_bias = wrng.normal(0, 1.0, size=(vocab,)).astype(np.float32)
        self.cat_bias = wrng.normal(0, 1.0, size=(num_cats,)).astype(np.float32)

    def _zipf_ids(self, shape):
        return zipf_ids(self.rng, self.vocab, 1.0, shape)

    def batch(self) -> Dict[str, np.ndarray]:
        B, L = self.B, self.seq_len
        hist = self._zipf_ids((B, L))
        lengths = self.rng.integers(1, L + 1, size=(B,))
        mask = np.arange(L)[None, :] < lengths[:, None]
        target = self._zipf_ids((B,))
        user = self._zipf_ids((B,))
        # label: affinity of target with mean history vector
        hvec = (self.item_vec[hist] * mask[..., None]).sum(1) / np.maximum(
            lengths[:, None], 1
        )
        logit = (
            (hvec * self.item_vec[target]).sum(1) * 1.5
            + self.item_bias[target]
            + self.cat_bias[self.item_cat[target]] * 0.5
        )
        prob = 1.0 / (1.0 + np.exp(-(logit - logit.mean())))
        label = (self.rng.random(B) < prob).astype(np.float32)
        return {
            "label": label,
            "user": user.astype(self.dtype),
            "target_item": target.astype(self.dtype),
            "target_cat": self.item_cat[target].astype(self.dtype),
            "hist_items": np.where(mask, hist, -1).astype(self.dtype),
            "hist_cats": np.where(mask, self.item_cat[hist], -1).astype(self.dtype),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch()
