"""Typed configuration tree — the port's own copy of `deeprec_tpu/config.py`.

Same fields, defaults and validation as the JAX package, so one set of
arguments builds equal configs in both packages. Frozen and hashable.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional


class StorageType(enum.Enum):
    """Where a table's payload lives (device memory, host DRAM, or tiers
    of both)."""

    HBM = "hbm"
    DRAM = "dram"
    HBM_DRAM = "hbm_dram"
    # device working set, bounded host DRAM tier, log-structured disk tier
    HBM_DRAM_SSD = "hbm_dram_ssd"

    @classmethod
    def from_reference(cls, name) -> "StorageType":
        """Map any of the reference's 13 StorageType values — proto names or
        field numbers (DeepRec embedding/config.proto) — onto these tiers:
        PMEM tiers are host DRAM, SSDHASH and LEVELDB the disk log, and a
        multi-level combination keeps its levels. This package's own values
        ("hbm_dram", ...) pass too."""
        if isinstance(name, cls):
            return name
        by_number = {
            0: "DEFAULT", 1: "DRAM", 2: "PMEM_MEMKIND", 3: "PMEM_LIBPMEM",
            4: "SSDHASH", 5: "LEVELDB", 6: "HBM", 11: "DRAM_PMEM",
            12: "DRAM_SSDHASH", 13: "HBM_DRAM", 14: "DRAM_LEVELDB",
            101: "DRAM_PMEM_SSDHASH", 102: "HBM_DRAM_SSDHASH",
        }
        if isinstance(name, int) and not isinstance(name, bool):
            if name not in by_number:
                raise ValueError(
                    f"unknown reference StorageType number {name}; known "
                    f"field numbers: {sorted(by_number)}")
            name = by_number[name]
        table = {
            "DEFAULT": cls.HBM, "HBM": cls.HBM, "DRAM": cls.DRAM,
            "PMEM_MEMKIND": cls.DRAM, "PMEM_LIBPMEM": cls.DRAM,
            "SSDHASH": cls.HBM_DRAM_SSD, "LEVELDB": cls.HBM_DRAM_SSD,
            "DRAM_PMEM": cls.HBM_DRAM, "DRAM_SSDHASH": cls.HBM_DRAM_SSD,
            "HBM_DRAM": cls.HBM_DRAM, "DRAM_LEVELDB": cls.HBM_DRAM_SSD,
            "DRAM_PMEM_SSDHASH": cls.HBM_DRAM_SSD,
            "HBM_DRAM_SSDHASH": cls.HBM_DRAM_SSD,
        }
        key = str(name).strip().upper()
        if key in table:
            return table[key]
        try:
            return cls(str(name).lower())
        except ValueError:
            raise ValueError(
                f"unknown storage type {name!r}; reference names "
                f"{sorted(table)} and native values "
                f"{[m.value for m in cls]} are accepted") from None


@dataclasses.dataclass(frozen=True)
class InitializerOption:
    """EV initializer semantics (kind, normal parameters), and the value
    served for keys blocked by admission or absent from a serving table."""

    kind: str = "stateless_normal"  # stateless_normal | matrix_normal | constant
    stddev: float = 0.05
    mean: float = 0.0
    constant: float = 0.0
    default_value_dim: int = 4096
    default_value_no_permission: float = 0.0


@dataclasses.dataclass(frozen=True)
class CounterFilter:
    """Admit a feature only after it has been seen `filter_freq` times."""

    filter_freq: int = 0


@dataclasses.dataclass(frozen=True)
class CBFFilter:
    """Counting-Bloom-filter admission (keys below threshold never occupy
    a slot)."""

    filter_freq: int = 0
    max_element_size: int = 1 << 20
    false_positive_probability: float = 0.01
    counter_bits: int = 16  # sketch counters saturate at 2^bits - 1

    def num_cells(self) -> int:
        """Sketch cells: the Bloom sizing m = -n ln p / (ln 2)^2, rounded
        up to a power of two, at least 1024."""
        m = -self.max_element_size * math.log(self.false_positive_probability) / (
            math.log(2.0) ** 2)
        return max(1024, 1 << int(math.ceil(math.log2(max(m, 1.0)))))

    def num_hashes(self) -> int:
        """Hash functions per key: (m / n) ln 2, clamped to [1, 8]."""
        k = (self.num_cells() / max(self.max_element_size, 1)) * math.log(2.0)
        return max(1, min(8, int(round(k))))


@dataclasses.dataclass(frozen=True)
class GlobalStepEvict:
    """TTL eviction: drop keys not updated in the last `steps_to_live`."""

    steps_to_live: int = 0


@dataclasses.dataclass(frozen=True)
class L2WeightEvict:
    """Drop keys whose embedding L2 norm is below threshold."""

    l2_weight_threshold: float = -1.0


@dataclasses.dataclass(frozen=True)
class StorageOption:
    """Multi-tier storage placement for one table. `storage_type` also
    takes a reference StorageType name or field number."""

    storage_type: StorageType = StorageType.HBM
    storage_path: Optional[str] = None
    cache_strategy: str = "lfu"  # lfu | lru
    # HBM_DRAM_SSD: rows the host tier holds before the coldest spill to
    # the disk tier (0 = unbounded, disk tier unused)
    host_capacity: int = 0

    def __post_init__(self):
        if not isinstance(self.storage_type, StorageType):
            object.__setattr__(
                self, "storage_type",
                StorageType.from_reference(self.storage_type),
            )


@dataclasses.dataclass(frozen=True)
class CheckpointOption:
    """Per-table checkpoint behaviour (keep filter-blocked keys or not)."""

    save_filtered_features: bool = True


@dataclasses.dataclass(frozen=True)
class EmbeddingVariableOption:
    """Per-table feature bundle (initializer, admission, eviction,
    storage, checkpoint options)."""

    init: InitializerOption = InitializerOption()
    counter_filter: Optional[CounterFilter] = None
    cbf_filter: Optional[CBFFilter] = None
    global_step_evict: Optional[GlobalStepEvict] = None
    l2_weight_evict: Optional[L2WeightEvict] = None
    storage: StorageOption = StorageOption()
    ckpt: CheckpointOption = CheckpointOption()

    def __post_init__(self):
        if self.counter_filter is not None and self.cbf_filter is not None:
            raise ValueError("at most one admission filter per table")


def validate_unique_budget(ub, where: str) -> None:
    """None | "auto" | "off" | positive int."""
    if not (
        ub is None
        or ub in ("auto", "off")
        or (isinstance(ub, int) and not isinstance(ub, bool) and ub > 0)
    ):
        raise ValueError(
            f"{where}: unique_budget must be None, 'auto', 'off' or a "
            f"positive int, got {ub!r}"
        )


@dataclasses.dataclass(frozen=True)
class TableConfig:
    """Static configuration of one hash-embedding table: `dim` is the
    embedding width, `capacity` the fixed slot count (a power of two).

    `kernel` is kept for config parity with the JAX package; in the port
    it never switches a CUDA tensor away from the hand-written kernel.
    `packed` is accepted and ignored: rows are always stored unpacked."""

    name: str
    dim: int
    capacity: int = 1 << 16
    key_dtype: str = "int32"  # int32 | int64
    value_dtype: str = "float32"  # float32 | bfloat16 | int8 (serve-only)
    combiner: str = "mean"  # mean | sum | sqrtn
    max_probes: int = 64
    kernel: str = "auto"  # auto | xla | pallas
    packed: str = "auto"  # auto | on | off
    unique_budget: Optional[object] = None  # None | "off" | "auto" | int
    exchange_dtype: str = "bfloat16"  # bfloat16 | float32
    ev: EmbeddingVariableOption = EmbeddingVariableOption()

    def __post_init__(self):
        if self.capacity & (self.capacity - 1):
            raise ValueError(f"capacity must be a power of two, got {self.capacity}")
        if self.dim <= 0:
            raise ValueError("dim must be positive")
        if self.kernel not in ("auto", "xla", "pallas"):
            raise ValueError(f"unknown kernel {self.kernel!r}")
        if self.packed not in ("auto", "on", "off"):
            raise ValueError(f"unknown packed mode {self.packed!r}")
        if self.value_dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(
                f"table {self.name}: value_dtype must be 'float32', "
                f"'bfloat16' or 'int8', got {self.value_dtype!r}"
            )
        if self.exchange_dtype not in ("bfloat16", "float32"):
            raise ValueError(
                f"table {self.name}: exchange_dtype must be 'bfloat16' or "
                f"'float32', got {self.exchange_dtype!r}"
            )
        validate_unique_budget(self.unique_budget, f"table {self.name}")


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    """Full + incremental checkpoint cadence — parity with
    MonitoredTrainingSession(save_checkpoint_secs=, save_incremental_checkpoint_secs=)
    (docs/docs_en/Incremental-Checkpoint.md)."""

    directory: str = "ckpt"
    save_steps: int = 1000
    incremental_save_steps: int = 0  # 0 disables incremental saves
    keep: int = 3
