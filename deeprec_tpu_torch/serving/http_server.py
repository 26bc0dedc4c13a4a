"""HTTP serving frontend over the ModelServer — the port of
`deeprec_tpu/serving/http_server.py`.

The network-facing surface of the serving stack — the role of the
reference's processor C ABI + gRPC glue (serving/processor/serving/
processor.h: initialize/process) re-cut as a dependency-free JSON/HTTP
server (stdlib http.server; a threading server whose request threads block
on the ModelServer's coalescing queue, so concurrent requests batch into
full device batches automatically).

Protocol:
  POST /v1/predict   {"features": {"C1": [..ids..], "I1": [[..]], ...}}
                  -> {"predictions": [...], "model_version": V}
                     (or {"task": [...]} predictions for MTL)
  GET  /v1/model_info -> {"step": N, "table_sizes": {...}, "model_version": V}
  GET  /v1/stats     -> per-stage latency histograms (queue/pad/device/
                        post/e2e), batch shape stats, model update counters
  POST /v1/reload    -> {"updated": bool}   (poll full/delta updates now)
  POST /v1/retrieve  {"features": {<user features>}, "k": 100}
                  -> {"items": [[id,...]], "scores": [[...]],
                      "model_version": V, "partial": false,
                      "candidates_scanned": N}
                     (full-corpus top-k: the retrieval lane is a later
                      slice of the port; until then a server answers 400
                      "retrieval not enabled on this server", as the JAX
                      server does with no engine attached)
  GET  /healthz      -> 200 {"status": "ok", "staleness_seconds": ...,
                        "consecutive_poll_failures": 0, ...} — 503 with the
                        same body once the update poller is failing
                        (predictions still serve the last good snapshot)

Request bodies are capped (`max_body_bytes`, default 16 MiB): oversized
or malformed payloads get a structured 400 JSON error, never a 500.

Run: python -m deeprec_tpu_torch.serving.http_server --model wdl --ckpt DIR
(on the CUDA card; ``--device cpu`` serves on the CPU, and without a card
and without that flag the command raises), or embed:
``HttpServer(server, port=8500).start()``.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from deeprec_tpu_torch.obs import metrics as obs_metrics
from deeprec_tpu_torch.obs import trace as obs_trace
from deeprec_tpu_torch.serving.predictor import (
    BadRequest,
    ModelServer,
    Predictor,
    parse_features,
)


def instances_to_features(instances) -> dict:
    """TF-Serving row-major request body -> this stack's column-major
    features: [{"f1": v, ...}, ...] -> {"f1": [v, ...], ...}."""
    if not isinstance(instances, list) or not instances:
        raise BadRequest("'instances' must be a non-empty list")
    if not all(isinstance(r, dict) for r in instances):
        raise BadRequest("each instance must be an object of named features")
    names = set(instances[0])
    if any(set(r) != names for r in instances):
        raise BadRequest("instances disagree on feature names")
    return {k: [r[k] for r in instances] for k in names}


def _fill_missing_item_features(predictor, feats) -> dict:
    """A retrieval request carries USER features only: every absent item
    feature is filled with its pad value (dense with 0) before parsing, as
    the JAX `serving/retrieval.fill_missing_item_features` does."""
    if not isinstance(feats, dict) or not feats:
        raise BadRequest("missing 'features' object")
    item_feats = set(getattr(predictor.model, "item_feats", ()))
    if not item_feats:
        return feats
    v = next(iter(feats.values()))
    rows = len(v) if isinstance(v, list) else int(np.asarray(v).shape[0])
    specs = {f.name: f for f in predictor._trainer.sparse_specs}
    dtypes = predictor.feature_dtypes
    out = dict(feats)
    for name in item_feats - set(feats):
        want = dtypes.get(name)
        if want is None:
            continue
        if want.kind in "iu":
            out[name] = np.full((rows, 1), specs[name].pad_value, want)
        else:
            out[name] = np.zeros((rows, 1), np.float32)
    return out


class _Handler(BaseHTTPRequestHandler):
    server_version = "deeprec-tpu-serving/1.0"

    # set by HttpServer
    servers: dict = None  # name -> ModelServer
    default: str = None
    max_body: int = 16 << 20  # request-body byte cap (structured 400 past it)

    def log_message(self, fmt, *args):  # quiet by default
        pass

    @property
    def model_server(self) -> ModelServer:
        return self.servers[self.default]

    def _send(self, code: int, payload) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_text(self, code: int, text: str,
                   ctype: str = "text/plain; version=0.0.4") -> None:
        body = text.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _named(self, name: str) -> Optional[ModelServer]:
        srv = self.servers.get(name)
        if srv is None:
            self._send(404, {"error": f"unknown model {name!r}",
                             "models": sorted(self.servers)})
        return srv

    def do_GET(self):
        if self.path == "/healthz":
            # Watchdog surface (supervisor wedge detection): liveness +
            # model freshness. 200 while the poller is healthy, 503 once
            # it is failing consecutively — load balancers and the
            # online.supervisor treat non-200 as "degraded, watch it",
            # while predictions themselves keep serving the last good
            # snapshot either way.
            try:
                h = self.model_server.predictor.health()
            except Exception as e:  # health must never 500 the server
                return self._send(503, {"status": "error", "error": str(e)})
            self._send(200 if h.get("status") == "ok" else 503, h)
        elif self.path == "/v1/model_info":
            self._send(200, self.model_server.predictor.model_info())
        elif self.path == "/v1/stats":
            # live per-stage serving histograms
            self._send(200, self.model_server.stats_snapshot())
        elif self.path == "/metrics":
            # Prometheus-text exposition of the obs plane: this server's
            # serving series + the process-wide registry (training /
            # supervisor / placement gauges). A Frontend merges every
            # backend's series here, stale-marking down members. Must
            # never 500 — a scrape is a watchdog surface.
            try:
                fn = getattr(self.model_server, "metrics_text", None)
                text = (fn() if fn is not None
                        else obs_metrics.default_registry()
                        .render_prometheus())
            except Exception as e:
                return self._send_text(503, f"# metrics error: {e}\n")
            self._send_text(200, text)
        elif (self.path.startswith("/v1/models/")
              and self.path.endswith("/stats")):
            srv = self._named(self.path[len("/v1/models/"):-len("/stats")])
            if srv is not None:
                self._send(200, srv.stats_snapshot())
        elif self.path == "/v1/models":
            self._send(200, {"models": sorted(self.servers)})
        elif self.path.startswith("/v1/models/"):
            # TF-Serving REST model-status shape, so TFS clients can point
            # here unchanged: GET /v1/models/<name>
            srv = self._named(self.path[len("/v1/models/"):])
            if srv is not None:
                self._send(200, {"model_version_status": [{
                    "version": str(srv.predictor.step),
                    "state": "AVAILABLE",
                    "status": {"error_code": "OK", "error_message": ""},
                }]})
        else:
            self._send(404, {"error": f"unknown path {self.path}"})

    def _route_post(self):
        """(server, verb) for a POST path: the single-model back-compat
        routes (/v1/predict, /v1/reload) hit the default model; the
        TF-Serving shape (/v1/models/<name>:predict|:reload) names one."""
        if self.path in ("/v1/predict", "/v1/reload", "/v1/retrieve"):
            return self.model_server, self.path.rsplit("/", 1)[-1]
        if self.path.startswith("/v1/models/") and ":" in self.path:
            name, verb = self.path[len("/v1/models/"):].rsplit(":", 1)
            return self._named(name), verb
        self._send(404, {"error": f"unknown path {self.path}"})
        return None, None

    def do_POST(self):
        try:
            n = int(self.headers.get("Content-Length", 0))
        except (TypeError, ValueError):
            return self._send(400, {"error": "bad Content-Length"})
        if n < 0:
            return self._send(400, {"error": "bad Content-Length"})
        if n > self.max_body:
            # Reject BEFORE reading: an oversized body must cost a bounded
            # read and a structured 400, not an allocation + a 500. The
            # connection is closed (we never consumed the body).
            self.close_connection = True
            return self._send(400, {
                "error": "request body too large",
                "content_length": n,
                "limit_bytes": self.max_body,
            })
        raw = self.rfile.read(n)
        ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
        # Only explicit protobuf media types take the protobuf path;
        # octet-stream stays on the JSON path (clients commonly use it as
        # a generic default for JSON bodies, and it worked before).
        if ctype in ("application/x-protobuf", "application/protobuf"):
            # Reference wire format: serialized PredictRequest in,
            # PredictResponse out (predict.proto). Routing still applies.
            server, verb = self._route_post()
            if server is None:
                return
            if verb != "predict":
                return self._send(400, {"error":
                                        "protobuf body only valid on :predict"})
            from deeprec_tpu_torch.serving.cabi import process_proto

            code, body = process_proto(server, raw)
            self.send_response(code)
            self.send_header(
                "Content-Type",
                "application/x-protobuf" if code == 200 else "text/plain")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        try:
            payload = json.loads(raw or b"{}")
        except Exception as e:
            return self._send(400, {"error": f"bad json: {e}"})
        server, verb = self._route_post()
        if server is None:
            return  # 404 already sent
        if verb == "reload":
            try:
                updated = bool(server.predictor.poll_updates())
            except Exception as e:  # corrupt/partial checkpoint: report it
                return self._send(500, {"error": str(e)})
            return self._send(200, {"updated": updated})
        if verb == "retrieve":
            # Full-corpus top-k: the request carries USER features only
            # (absent item features are pad-filled before parsing). With
            # no retrieval lane attached, `retrieve_versioned` answers
            # BadRequest, a 400.
            rv = getattr(server, "retrieve_versioned", None)
            if rv is None:
                return self._send(501, {"error":
                                        "retrieval not supported here"})
            if not isinstance(payload, dict):
                return self._send(400, {"error":
                                        "body must be a JSON object"})
            try:
                k = int(payload.get("k", 10))
                feats = _fill_missing_item_features(
                    server.predictor, payload.get("features"))
                batch = parse_features(server.predictor, feats)
            except BadRequest as e:
                return self._send(400, e.details)
            except (TypeError, ValueError) as e:
                return self._send(400, {"error": str(e)})
            try:
                rkw = {"no_cache": True} if payload.get("no_cache") else {}
                res = rv(batch, k, **rkw)
            except BadRequest as e:
                return self._send(400, e.details)
            except Exception as e:  # request-level failure, keep serving
                return self._send(500, {"error": str(e)})
            return self._send(200, {
                "items": res.ids.tolist(),
                # -inf marks "fewer than k valid items" (item id -1);
                # serialize it as null — json.dumps would emit
                # `-Infinity`, which is not RFC 8259 JSON and strict
                # client parsers reject the whole body
                "scores": [[round(float(s), 6) if np.isfinite(s) else None
                            for s in row] for row in res.scores],
                "model_version": res.version,
                "partial": bool(res.partial),
                "candidates_scanned": int(res.scanned),
            })
        if verb != "predict":
            return self._send(404, {"error": f"unknown verb {verb!r}"})
        if not isinstance(payload, dict):
            return self._send(400, {"error": "body must be a JSON object"})
        try:
            feats = payload.get("features")
            if feats is None and "instances" in payload:
                feats = instances_to_features(payload["instances"])
            batch = parse_features(server.predictor, feats)
        except BadRequest as e:
            return self._send(400, e.details)
        except ValueError as e:
            return self._send(400, {"error": str(e)})
        try:
            # Sampled request tracing: continue the caller's context from
            # the X-Deeprec-Trace header, or make the edge sampling
            # decision here; the span context rides into the micro-batcher
            # (and, through a Frontend, over the TCP frames to a backend)
            # so one trace id spans edge -> dispatch -> stage spans. The
            # no-op singleton makes this line free with tracing off.
            edge = obs_trace.server_span(
                "http_predict", "edge",
                header=self.headers.get(obs_trace.HEADER))
            # `no_cache` forces a real evaluation through a warm
            # compute-reuse cache (canary/parity probes) — passed only
            # when set, so servers without the reuse layer keep their
            # signature.
            kw = {"no_cache": True} if payload.get("no_cache") else {}
            if payload.get("group_users"):
                # sample-aware compression: a <user, N items> request
                # rides the grouped lane of the coalescing queue — many
                # grouped requests share one device batch and the user
                # tower runs once per distinct user across ALL of them
                # (the batcher never mixes grouped and plain requests:
                # they dispatch through different traces).
                try:
                    with edge:
                        probs, version = server.request_versioned(
                            batch, group_users=True, **kw)
                except (BadRequest, ValueError) as e:  # no tower split
                    return self._send(400, getattr(e, "details",
                                                   {"error": str(e)}))
            else:
                with edge:
                    probs, version = server.request_versioned(batch, **kw)
            if isinstance(probs, dict):
                out = {k: np.asarray(v).tolist() for k, v in probs.items()}
            else:
                out = np.asarray(probs).tolist()
            # model_version stamps WHICH snapshot served this request — a
            # coalesced batch shares one, so clients can detect update
            # boundaries (and the torn-read test can pin atomicity).
            self._send(200, {"predictions": out, "model_version": version})
        except Exception as e:  # request-level failure, keep serving
            self._send(500, {"error": str(e)})


class _ThreadingServer(ThreadingHTTPServer):
    # The stdlib default listen backlog is 5: under concurrent
    # connection-per-request clients, a momentarily busy host (e.g. a
    # model update competing for CPU) overflows the accept queue, the
    # kernel drops the SYN, and the client retries after the TCP
    # retransmission timeout: a ~1 s request spike during updates.
    request_queue_size = 128
    daemon_threads = True


class HttpServer:
    """Bind one server — a ModelServer, a ServerGroup, or a {name: server}
    dict for multi-model serving — to a TCP port. start() is non-blocking.
    Servers are duck-typed: anything with `.request_versioned()`,
    `.stats_snapshot()` and `.predictor` works (ServerGroup feeds requests
    through its shared queue to whichever device-pinned member is free).
    With a dict, the TF-Serving routes address each model by name and the
    bare routes hit `default_model` (first name if unset)."""

    def __init__(self, model_server, port: int = 8500,
                 host: str = "127.0.0.1", default_model: Optional[str] = None,
                 max_body_bytes: int = 16 << 20):
        if isinstance(model_server, dict):
            servers = dict(model_server)
        else:
            servers = {"default": model_server}
        if not servers:
            raise ValueError("need at least one ModelServer")
        default = default_model or next(iter(servers))
        if default not in servers:
            raise ValueError(f"default_model {default!r} not in {sorted(servers)}")
        handler = type("BoundHandler", (_Handler,),
                       {"servers": servers, "default": default,
                        "max_body": int(max_body_bytes)})
        self.httpd = _ThreadingServer((host, port), handler)
        self.port = self.httpd.server_address[1]  # resolved if port=0
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "HttpServer":
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()  # release the listening socket
        if self._thread:
            self._thread.join(timeout=2)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", help="checkpoint directory (single-model mode)")
    p.add_argument("--model", default="wdl",
                   help="modelzoo model name (see deeprec_tpu_torch.models)")
    p.add_argument("--serve", action="append", default=[],
                   help="multi-model: JSON per model, repeatable — "
                        '\'{"name": "wdl-a", "model": "wdl", "ckpt_dir": '
                        '"...", "model_args": {...}}\' (same config schema '
                        "as the serving C ABI, serving/cabi.py)")
    p.add_argument("--port", type=int, default=8500)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--max_batch", type=int, default=256)
    p.add_argument("--poll_secs", type=float, default=10.0)
    p.add_argument("--emb_dim", type=int, default=16)
    p.add_argument("--capacity", type=int, default=1 << 20,
                   help="must match the trained checkpoint's table capacity")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu; without a CUDA card "
                        "the server raises unless cpu is asked for")
    args = p.parse_args(argv)

    if args.serve:
        from deeprec_tpu_torch.serving.cabi import create_server

        servers = {}
        for spec in args.serve:
            cfg = json.loads(spec)
            name = cfg.pop("name", None) or cfg.get("model", "default")
            if name in servers:
                p.error(f"duplicate --serve name {name!r}: set a distinct "
                        '"name" per model')
            cfg.setdefault("max_batch", args.max_batch)
            cfg.setdefault("poll_secs", args.poll_secs)
            cfg.setdefault("device", args.device)
            servers[name] = create_server(json.dumps(cfg))
        srv = HttpServer(servers, port=args.port, host=args.host)
        print(f"serving {sorted(servers)} on http://{args.host}:{srv.port}")
    else:
        if not args.ckpt:
            p.error("--ckpt is required without --serve")
        from deeprec_tpu_torch.models.registry import build_model

        model = build_model(args.model, emb_dim=args.emb_dim,
                            capacity=args.capacity)
        pred = Predictor(model, args.ckpt, device=args.device)
        ms = ModelServer(pred, max_batch=args.max_batch,
                         poll_updates_secs=args.poll_secs)
        srv = HttpServer(ms, port=args.port, host=args.host)
        print(f"serving {args.model} from {args.ckpt} on "
              f"http://{args.host}:{srv.port}")
    srv.start()
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        srv.stop()


if __name__ == "__main__":
    main()
