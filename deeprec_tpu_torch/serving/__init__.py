"""Serving: the predictor with zero-stall updates, the micro-batching
server, the HTTP and protobuf front end, full-corpus retrieval, the socket
frontend with its fleet, and the remote and RESP feature stores (the port
of `deeprec_tpu/serving/`)."""
from deeprec_tpu_torch.serving.fleet import (
    FleetAutoscaler,
    FleetClient,
    FleetRegistry,
    HashRing,
    LeaseStamper,
)
from deeprec_tpu_torch.serving.frontend import (
    BackendServer,
    Frontend,
    spawn_backends,
    spawn_frontends,
)
from deeprec_tpu_torch.serving.http_server import HttpServer
from deeprec_tpu_torch.serving.predictor import ModelServer, Predictor, ServerGroup
from deeprec_tpu_torch.serving.remote_store import RemoteKVClient, RemoteKVServer
from deeprec_tpu_torch.serving.resp_store import RedisFeatureStore, RespConnection
from deeprec_tpu_torch.serving.retrieval import (
    RetrievalEngine,
    RetrievalResult,
    RetrievalServer,
)
from deeprec_tpu_torch.serving.stats import ServingStats

__all__ = [
    "BackendServer", "FleetAutoscaler", "FleetClient", "FleetRegistry",
    "Frontend", "HashRing", "HttpServer", "LeaseStamper", "ModelServer",
    "Predictor", "RedisFeatureStore", "RemoteKVClient", "RemoteKVServer",
    "RespConnection", "RetrievalEngine", "RetrievalResult", "RetrievalServer",
    "ServerGroup", "ServingStats", "spawn_backends", "spawn_frontends",
]
