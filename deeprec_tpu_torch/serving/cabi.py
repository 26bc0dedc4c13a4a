"""The Python half of the serving C ABI — the port of
`deeprec_tpu/serving/cabi.py`.

The reference exposes its serving stack to external RPC frameworks
through a 4-function C ABI (``initialize`` / ``process`` /
``batch_process`` / ``get_serving_model_info``, the reference's
serving/processor/serving/processor.h). The C library that embeds CPython
and forwards to the functions below (`native/processor.cpp`) is the next
slice of the port; `HttpServer` and `http_server --serve` use these
functions today. Payloads may be the reference's protobuf wire format
(serialized ``tensorflow.eas.PredictRequest`` -> ``PredictResponse``,
decoded by :mod:`predict_pb`) or JSON (``{"features": {...}}``); the
format is sniffed per request. All serving logic (validation, coalescing,
hot-swap polling, warmup) is the ordinary Python stack, so every frontend
behaves alike.

Config JSON accepted by :func:`create_server` (= the C ``model_config``):

    {
      "model": "wdl",                  # modelzoo registry name
      "ckpt_dir": "/path/to/ckpts",    # required
      "model_args": {"emb_dim": 16, "capacity": 1048576},
      "device": "cuda",                # "cpu" only when asked for
      "max_batch": 256,                # ModelServer coalescing cap (ROWS)
      "max_wait_ms": 2.0,              # coalescing deadline upper bound
      "adaptive": true,                # arrival-rate-tuned deadline (EWMA)
      "poll_secs": 10.0,               # 0 disables background hot-swap
      "warmup": false                  # run every batch bucket once
    }
"""
from __future__ import annotations

import json
from typing import Tuple

import numpy as np

from deeprec_tpu_torch.serving.predictor import (
    BadRequest,
    ModelServer,
    Predictor,
    parse_features,
)


def create_server(config_json: str) -> ModelServer:
    cfg = json.loads(config_json)
    if "ckpt_dir" not in cfg:
        raise ValueError("model_config must set 'ckpt_dir'")
    from deeprec_tpu_torch.models.registry import build_model

    model = build_model(cfg.get("model", "wdl"), **cfg.get("model_args", {}))
    pred = Predictor(model, cfg["ckpt_dir"], device=cfg.get("device"))
    server = ModelServer(
        pred,
        max_batch=int(cfg.get("max_batch", 256)),
        max_wait_ms=float(cfg.get("max_wait_ms", 2.0)),
        poll_updates_secs=float(cfg.get("poll_secs", 0.0)),
        adaptive=bool(cfg.get("adaptive", True)),
    )
    if cfg.get("warmup"):
        example = _synth_example(pred)
        server.warmup(example)
    return server


def _synth_example(pred: Predictor) -> dict:
    """One all-zeros row per feature — enough to run every bucket shape."""
    out = {}
    specs = {f.name: f for f in pred._trainer.sparse_specs}
    dense = {f.name: f for f in pred._trainer.dense_specs}
    for name, dt in pred.feature_dtypes.items():
        if dt.kind in "iu":
            L = specs[name].max_len or 1
            out[name] = np.zeros((1, L), dt)
        else:
            # the REAL dense width: a width-W feature warmed at width 1
            # would fail on the first live request
            w = dense[name].width if name in dense else 1
            out[name] = np.zeros((1, w), np.float32)
    return out


def process_request(server: ModelServer, payload: bytes) -> Tuple[int, bytes]:
    """Wire-format dispatch for the C ABI: a JSON object (first
    non-whitespace byte ``{``) takes the JSON path; anything else is
    parsed as a serialized ``tensorflow.eas.PredictRequest`` — the
    reference's native wire format (predict.proto, message_coding.cc) —
    so a host built against the reference processor can call this library
    with its protobuf payloads unchanged. A valid protobuf message never
    begins with RAW byte 0x7b ('{'): that would be field 15 wire-type 3,
    a group start, which protoc never emits for proto3. The sniff must
    NOT strip whitespace first — protobuf tag/length bytes 0x09-0x0d/0x20
    are ASCII whitespace (e.g. a tag byte of 0x0a is '\\n'), so stripping
    can expose a '{' from inside a valid message. Whitespace-prefixed
    JSON still works via the fallback below."""
    if not payload or payload[:1] == b"{":
        return process_json(server, payload)
    if payload.lstrip()[:1] == b"{":
        # Ambiguous: whitespace-prefixed '{' is either JSON or a protobuf
        # whose first tag byte happens to be ASCII whitespace. Proto3
        # "successfully" parses many JSON-ish byte strings by skipping
        # unknown fields, yielding an empty-inputs request and a misleading
        # parse_features 400 — so the proto path wins only when the parse
        # yields actual inputs; otherwise a payload that IS a JSON object
        # routes to the JSON path, and non-JSON bytes keep the protobuf
        # path's error reporting (e.g. an inputs-less proto request still
        # 400s with the proto-side message).
        from deeprec_tpu_torch.serving import predict_pb as pb

        try:
            has_inputs = bool(pb.PredictRequest.parse(bytes(payload)).inputs)
        except Exception:
            has_inputs = False
        if not has_inputs:
            try:
                is_json = isinstance(json.loads(payload), dict)
            except Exception:
                is_json = False
            if is_json:
                return process_json(server, payload)
    return process_proto(server, payload)


def process_proto(server: ModelServer, payload: bytes) -> Tuple[int, bytes]:
    """PredictRequest in, PredictResponse out. Error bodies are plain-text
    messages (the reference returns strndup'd error strings, not protobuf,
    on non-200 — processor.cc:38-46)."""
    from deeprec_tpu_torch.serving import predict_pb as pb

    try:
        req = pb.PredictRequest.parse(bytes(payload))
        feats = {k: v.to_numpy() for k, v in req.inputs.items()}
    except Exception as e:
        return 400, f"bad PredictRequest: {e}".encode()
    try:
        batch = parse_features(server.predictor, feats)
    except BadRequest as e:
        return 400, json.dumps(e.details).encode()
    except ValueError as e:
        return 400, str(e).encode()
    try:
        probs = server.request(batch)
        items = (
            list(probs.items())
            if isinstance(probs, dict)
            else [("probabilities", probs)]
        )
        outputs = {
            k: pb.ArrayProto.from_numpy(np.asarray(v))
            for k, v in items
            if not req.output_filter or k in req.output_filter
        }
        if not outputs:
            known = sorted(k for k, _ in items)
            return 400, (
                f"output_filter {req.output_filter} matches none of "
                f"{known}".encode()
            )
        return 200, pb.PredictResponse(outputs).serialize()
    except Exception as e:
        return 500, str(e).encode()


def process_json(server: ModelServer, payload: bytes) -> Tuple[int, bytes]:
    """One request through the coalescing queue. Returns (status, body):
    200 on success, 400 on a client error, 500 on a serving error — the
    C return code, mirroring the HTTP frontend's codes."""
    try:
        req = json.loads(payload or b"{}")
    except Exception as e:
        return 400, json.dumps({"error": f"bad json: {e}"}).encode()
    try:
        if not isinstance(req, dict):
            raise BadRequest("body must be a JSON object")
        batch = parse_features(server.predictor, req.get("features"))
    except BadRequest as e:
        return 400, json.dumps(e.details).encode()
    except ValueError as e:
        return 400, json.dumps({"error": str(e)}).encode()
    try:
        probs, version = server.request_versioned(batch)
        out = (
            {k: np.asarray(v).tolist() for k, v in probs.items()}
            if isinstance(probs, dict)
            else np.asarray(probs).tolist()
        )
        return 200, json.dumps(
            {"predictions": out, "model_version": version}
        ).encode()
    except Exception as e:
        return 500, json.dumps({"error": str(e)}).encode()


def model_info_json(server: ModelServer) -> Tuple[int, bytes]:
    try:
        return 200, json.dumps(server.predictor.model_info()).encode()
    except Exception as e:
        return 500, json.dumps({"error": str(e)}).encode()
