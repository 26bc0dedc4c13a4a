from deeprec_tpu_torch.data.kafka import KafkaClient, KafkaStreamReader
from deeprec_tpu_torch.data.pipeline import ParallelInputPipeline, plan_shards
from deeprec_tpu_torch.data.prefetch import Prefetcher, staged
from deeprec_tpu_torch.data.readers import (
    CriteoCSVReader, ParquetReader, criteo_block_parse, criteo_hash_salts)
from deeprec_tpu_torch.data.stream import FileStreamServer, FileTailReader, TCPStreamReader
from deeprec_tpu_torch.data.synthetic import (
    CriteoStats, SyntheticBehaviorSequence, SyntheticCriteo, SyntheticMultiTask, SyntheticTwoTower,
    zipf_ids)
from deeprec_tpu_torch.data.work_queue import WorkQueue, parse_slice

__all__ = ["CriteoCSVReader", "CriteoStats", "FileStreamServer", "FileTailReader", "KafkaClient",
           "KafkaStreamReader", "ParallelInputPipeline", "ParquetReader", "Prefetcher",
           "SyntheticBehaviorSequence", "SyntheticCriteo", "SyntheticMultiTask", "SyntheticTwoTower",
           "TCPStreamReader", "WorkQueue", "criteo_block_parse", "criteo_hash_salts", "parse_slice",
           "plan_shards", "staged", "zipf_ids"]
