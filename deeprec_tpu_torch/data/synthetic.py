"""Synthetic click logs — the port's copy of `deeprec_tpu/data/synthetic.py`
(`zipf_ids`, `SyntheticCriteo`, `SyntheticMultiTask`, `SyntheticTwoTower`,
`SyntheticBehaviorSequence`, and `CriteoStats`, the Criteo-marginal stream
with its stream position and Bayes AUC), numpy only: batches are
bit-identical to the JAX package's for a seed.

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


# ---------------------------------------------------------------------------
# Criteo-statistics-matched deterministic generator
#
# Public summary statistics of the Kaggle Criteo display-advertising dataset
# (the dataset behind the reference's modelzoo AUC tables): per-column
# categorical cardinalities (as published with the DLRM reference
# implementation's preprocessing), overall CTR ~= 0.2562, and approximate
# per-column missing-value rates for the 13 integer features. The generator
# matches these MARGINALS; the label function is a synthetic logistic model
# whose Bayes-optimal AUC is computable (`bayes_auc`), so trained-AUC results
# can be reported as "x of the achievable ceiling" with explicit provenance
# instead of dressing synthetic numbers up as real-Criteo parity.

CRITEO_KAGGLE_CARDINALITIES = (
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18,
    15, 286181, 105, 142572,
)
CRITEO_KAGGLE_CTR = 0.2562
# Fraction of empty values per integer column I1-I13 (approximate public
# summary; empties are imputed to 0, the common Criteo convention).
CRITEO_DENSE_MISSING = (
    0.45, 0.00, 0.21, 0.21, 0.03, 0.22, 0.04, 0.00, 0.04,
    0.45, 0.04, 0.77, 0.21,
)

_U64 = np.uint64
_MASK = _U64(0xFFFFFFFFFFFFFFFF)


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer — a vectorized stateless uint64 mixer."""
    with np.errstate(over="ignore"):
        x = (x + _U64(0x9E3779B97F4A7C15)) & _MASK
        x = ((x ^ (x >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)) & _MASK
        x = ((x ^ (x >> _U64(27))) * _U64(0x94D049BB133111EB)) & _MASK
        return x ^ (x >> _U64(31))


def _hash_normal(key: np.ndarray, salt: int) -> np.ndarray:
    """Deterministic standard normal per uint64 key (Box-Muller on two
    hash-derived uniforms). O(1) memory — the weight 'tables' for 33M
    Criteo-scale ids are never materialized."""
    key = key.astype(_U64)
    h1 = _mix64(key ^ _U64(salt * 2 + 1))
    h2 = _mix64(key ^ _U64(salt * 2 + 2))
    u1 = (h1 >> _U64(11)).astype(np.float64) * (2.0 ** -53) + 1e-300
    u2 = (h2 >> _U64(11)).astype(np.float64) * (2.0 ** -53)
    return (np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)).astype(
        np.float32
    )


class CriteoStats:
    """Deterministic Criteo-marginal-matched click-log stream.

    * **Cardinalities**: column c draws ids from the published Kaggle
      cardinality (capped by `cardinality_cap` for bounded-table runs —
      the hashed-vocab convention every Criteo trainer applies anyway).
    * **Frequency spectra**: per-column bounded zipf; exponents spread
      deterministically over [1.05, 1.30] (real columns vary in skew).
    * **CTR**: intercept calibrated at init so mean(label) matches 0.2562.
    * **Determinism**: `batch_at(i)` is a pure function of
      (seed, split, i) — any worker can generate any batch, streams
      restart exactly, and train/"eval" splits are disjoint by salt.
    * **Ceiling**: labels are Bernoulli(sigmoid(hidden logit)); the hidden
      per-id weights come from a stateless hash, so `bayes_auc()` scores
      the TRUE click probability on a held-out sample — the AUC no model
      can beat, the honest comparison point for trained AUC.
    """

    def __init__(self, batch_size: int = 2048, seed: int = 0,
                 split: str = "train", num_cat: int = 26,
                 num_dense: int = 13, cardinality_cap: int = 1 << 22,
                 dtype=np.int32):
        if num_cat > len(CRITEO_KAGGLE_CARDINALITIES):
            raise ValueError(f"num_cat <= {len(CRITEO_KAGGLE_CARDINALITIES)}")
        self.B = batch_size
        self.seed = seed
        self.split = split
        self.num_cat = num_cat
        self.num_dense = num_dense
        self.dtype = dtype
        self.cards = tuple(
            min(c, cardinality_cap)
            for c in CRITEO_KAGGLE_CARDINALITIES[:num_cat]
        )
        # Per-column zipf exponents and signal strengths, deterministic in
        # the column index alone (shared by every split/seed: the TASK is
        # fixed, only the sampled stream varies). A few strong columns +
        # a long weak tail mirrors real CTR feature importance.
        idx = np.arange(num_cat)
        self.zipf_a = 1.05 + 0.25 * (
            (_mix64(idx.astype(_U64) ^ _U64(0xC0FFEE)) >> _U64(40)).astype(
                np.float64
            )
            / 2.0 ** 24
        )
        order = (_mix64(idx.astype(_U64) ^ _U64(0xBEEF)) >> _U64(40)).argsort()
        rank = np.empty(num_cat, np.int64)
        rank[order] = idx
        # 0.62 puts the Bayes ceiling at ~0.80 — the regime real Criteo
        # models live in (reference WDL 0.774, Kaggle-winning ~0.81).
        self.strength = (0.62 / np.sqrt(1.0 + rank)).astype(np.float32)
        self.dense_missing = np.asarray(
            CRITEO_DENSE_MISSING[:num_dense], np.float64
        )
        dseed = np.arange(num_dense).astype(_U64)
        self.dense_sigma = 0.5 + 1.5 * (
            (_mix64(dseed ^ _U64(0xD00D)) >> _U64(40)).astype(np.float64)
            / 2.0 ** 24
        )
        self.dense_weight = 0.25 * _hash_normal(dseed, salt=0xDA7A)
        self._index = 0  # producer position: next batch batch() will emit
        # Consumer position: next batch the TRAIN LOOP has yet to receive.
        # Under a prefetch ring the producer runs `depth` batches ahead, so
        # checkpointing `_index` would silently skip the in-flight batches
        # on restore; once a staging layer wires `mark_consumed`, save()
        # reports this counter instead (exactly-once replay).
        self._consumed = 0
        self._consumer_attached = False
        self.intercept = self._calibrate_intercept()

    # ------------------------------------------------------------ internals

    def _stream_rng(self, index: int,
                    split: Optional[str] = None) -> np.random.Generator:
        """Stream generator for batch `index` of `split` (default: this
        instance's split). The split rides as a PARAMETER — never mutated
        on the instance — so `_calibrate_intercept`/`bayes_auc` can draw
        from the calib/eval streams while a concurrent prefetch thread
        keeps generating train batches from the train salt."""
        salt = {"train": 1, "eval": 2, "calib": 3}.get(split or self.split, 99)
        return np.random.default_rng((self.seed, salt, index))

    def _raw_logit(self, rng: np.random.Generator, n: int):
        """Sample (cats [num_cat, n], dense [n, num_dense], centered logit)."""
        cats = np.empty((self.num_cat, n), np.int64)
        logit = np.zeros(n, np.float32)
        for c in range(self.num_cat):
            ids = zipf_ids(rng, self.cards[c], float(self.zipf_a[c]), (n,))
            cats[c] = ids
            # weight of (column, id): stateless hash -> N(0, strength_c^2)
            key = ids.astype(_U64) | (_U64(c) << _U64(40))
            logit += self.strength[c] * _hash_normal(key, salt=0x5EED)
        missing = rng.random((n, self.num_dense)) < self.dense_missing
        dense = rng.lognormal(
            0.0, 1.0, (n, self.num_dense)
        ) * self.dense_sigma
        dense = np.where(missing, 0.0, dense).astype(np.float32)
        logit += np.log1p(dense) @ self.dense_weight
        return cats, dense, logit

    def _calibrate_intercept(self) -> float:
        """Solve sigmoid-intercept so mean click prob == the Kaggle CTR
        (deterministic: fixed calib stream, bisection on the sample)."""
        rng = self._stream_rng(0, split="calib")
        _, _, logit = self._raw_logit(rng, 100_000)
        lo, hi = -12.0, 12.0
        for _ in range(50):
            mid = (lo + hi) / 2
            if np.mean(1.0 / (1.0 + np.exp(-(logit + mid)))) < CRITEO_KAGGLE_CTR:
                lo = mid
            else:
                hi = mid
        return float((lo + hi) / 2)

    # -------------------------------------------------------------- public

    def probs_at(self, index: int, n: Optional[int] = None,
                 split: Optional[str] = None):
        """(batch dict, true click probs) — the generator's oracle view,
        used by bayes_auc and the generator's own tests. `split` overrides
        this instance's stream (thread-safe: no instance mutation)."""
        n = n or self.B
        rng = self._stream_rng(index, split=split)
        cats, dense, logit = self._raw_logit(rng, n)
        prob = 1.0 / (1.0 + np.exp(-(logit + self.intercept)))
        label = (rng.random(n) < prob).astype(np.float32)
        out: Dict[str, np.ndarray] = {"label": label}
        for i in range(self.num_dense):
            out[f"I{i + 1}"] = dense[:, i:i + 1]
        for c in range(self.num_cat):
            out[f"C{c + 1}"] = cats[c].astype(self.dtype)
        return out, prob.astype(np.float32)

    def batch_at(self, index: int) -> Dict[str, np.ndarray]:
        """Batch `index` of this (seed, split) stream — pure function."""
        return self.probs_at(index)[0]

    def batch(self) -> Dict[str, np.ndarray]:
        out = self.batch_at(self._index)
        self._index += 1
        return out

    def attach_consumer(self) -> None:
        """Declare that a staging ring decouples production from
        consumption (call at WIRING time, before the ring's producer runs
        ahead): from here on save() reports the consumed position. Without
        this, a save taken after staging but before the first delivery —
        e.g. immediately after a restore — would still report the
        ran-ahead producer index and skip the in-flight batches."""
        self._consumer_attached = True

    def mark_consumed(self) -> None:
        """One batch DELIVERED to the train loop (call from the staging
        layer's consumer side — Prefetcher(on_consume=...))."""
        self._consumer_attached = True
        self._consumed += 1

    def save(self) -> Dict:
        # Unstaged iteration (produce == consume) keeps the legacy producer
        # index so direct batch() users checkpoint exactly as before.
        return {
            "index": self._consumed if self._consumer_attached else self._index
        }

    def restore(self, state: Dict) -> None:
        self._index = int(state["index"])
        self._consumed = int(state["index"])
        self._consumer_attached = False

    def bayes_auc(self, n: int = 500_000) -> float:
        """AUC of the TRUE click probability on a held-out sample — the
        ceiling no trained model can exceed (up to sampling noise)."""
        out, prob = self.probs_at(10_000_000, n, split="eval")
        return float(_auc(out["label"], prob))

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch()


def _auc(label: np.ndarray, score: np.ndarray) -> float:
    """Exact rank AUC; tied scores get their midrank (without it the
    result is input-order-dependent for discrete scores)."""
    _, inv, cnt = np.unique(score, return_inverse=True, return_counts=True)
    starts = np.concatenate([[0], np.cumsum(cnt)[:-1]]) + 1.0
    ranks = (starts + (cnt - 1) / 2.0)[inv]
    npos = float(label.sum())
    nneg = float(len(label) - npos)
    if npos == 0 or nneg == 0:
        return 0.5
    return (ranks[label > 0.5].sum() - npos * (npos + 1) / 2) / (npos * nneg)
