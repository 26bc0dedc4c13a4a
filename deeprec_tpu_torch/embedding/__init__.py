"""Hash-embedding tables, combiners and the storage tiers."""
from deeprec_tpu_torch.embedding.table import EmbeddingTable, TableState, UniqueLookup
from deeprec_tpu_torch.embedding.compose import (
    AdaptiveEmbedding, DynamicDimEmbedding, MultiHashConfig, MultiHashTable)
from deeprec_tpu_torch.embedding.multi_tier import MultiTierTable, TierStats
