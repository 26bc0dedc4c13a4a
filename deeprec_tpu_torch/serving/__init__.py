"""Serving: the predictor with zero-stall updates, the micro-batching
server, the HTTP and protobuf front end (the port of `deeprec_tpu/serving/`;
retrieval, the socket frontend, the fleet and the remote stores are later
slices, ROADMAP queue A item 7)."""
from deeprec_tpu_torch.serving.http_server import HttpServer
from deeprec_tpu_torch.serving.predictor import ModelServer, Predictor, ServerGroup
from deeprec_tpu_torch.serving.stats import ServingStats

__all__ = ["HttpServer", "ModelServer", "Predictor", "ServerGroup", "ServingStats"]
