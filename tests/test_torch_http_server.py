"""The port's HTTP and protobuf front end held against the JAX package's on
one JAX-written checkpoint: JSON and TF-Serving `instances` predicts,
protobuf PredictRequest / PredictResponse (the codec's bytes equal the JAX
codec's), structured 400s (body cap, malformed JSON, the wire firewall),
`/healthz` 200 and 503, `/v1/stats`, `/metrics`, `/v1/model_info`,
`/v1/reload`, the TF-Serving and multi-model routes, `/v1/retrieve` with no
lane attached, the C ABI's Python half, and `main()` on the CPU through
`--device cpu` (and raising without CUDA otherwise). Probabilities agree
with the JAX server's within PROB_ATOL, status codes and error bodies
exactly."""
import json
import os
import re
import shutil
import subprocess
import sys
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeprec_tpu.data import SyntheticCriteo
from deeprec_tpu.models import WDL as JaxWDL
from deeprec_tpu.optim import Adagrad
from deeprec_tpu.serving import HttpServer as JaxHttp
from deeprec_tpu.serving import ModelServer as JaxServer
from deeprec_tpu.serving import Predictor as JaxPredictor
from deeprec_tpu.serving import cabi as jcabi
from deeprec_tpu.serving import predict_pb as jpb
from deeprec_tpu.training import Trainer as JaxTrainer
from deeprec_tpu.training.checkpoint import CheckpointManager as JaxCkpt
from deeprec_tpu_torch.models import WDL
from deeprec_tpu_torch.serving import HttpServer, ModelServer, Predictor
from deeprec_tpu_torch.serving import cabi as tcabi
from deeprec_tpu_torch.serving import predict_pb as tpb
from deeprec_tpu_torch.serving.http_server import instances_to_features

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(emb_dim=8, capacity=1 << 12, hidden=(32,), num_cat=4, num_dense=2)
PROB_ATOL = 1e-4
# one request served through the batcher against the same rows predicted
# alone (tests/test_serving.py:354's bound)
COALESCE_ATOL = 1e-6


def J(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _train_and_save(d, steps=4, seed=41):
    tr = JaxTrainer(JaxWDL(**KW), Adagrad(lr=0.1), optax.adam(1e-3))
    st = tr.init(0)
    gen = SyntheticCriteo(batch_size=128, num_cat=4, num_dense=2, vocab=800, seed=seed)
    for _ in range(steps):
        st, _ = tr.train_step(st, J(gen.batch()))
    ck = JaxCkpt(str(d), tr)
    st, _ = ck.save(st)
    req = {k: np.asarray(v) for k, v in gen.batch().items() if not k.startswith("label")}
    return tr, st, ck, gen, req


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """The port's and the JAX package's HttpServer over one checkpoint,
    each with its own copy of the directory."""
    src = tmp_path_factory.mktemp("src")
    tr, st, ck, gen, req = _train_and_save(src)
    dp, dj = str(tmp_path_factory.mktemp("p") / "ck"), str(tmp_path_factory.mktemp("j") / "ck")
    shutil.copytree(str(src), dp)
    shutil.copytree(str(src), dj)
    ms = ModelServer(Predictor(WDL(**KW), dp, device="cpu"), max_batch=64, max_wait_ms=2)
    jms = JaxServer(JaxPredictor(JaxWDL(**KW), dj), max_batch=64, max_wait_ms=2)
    http = HttpServer(ms, port=0, max_body_bytes=1 << 16).start()
    jhttp = JaxHttp(jms, port=0, max_body_bytes=1 << 16).start()
    feats = {k: v[:4].tolist() for k, v in req.items()}
    yield dict(ms=ms, jms=jms, port=http.port, jport=jhttp.port, req=req, feats=feats,
               dirs=(dp, dj), tr=tr, st=st, gen=gen)
    http.stop()
    jhttp.stop()
    ms.close()
    jms.close()


def call(port, path, payload=None, raw=None, ctype="application/json", method=None):
    """(status, body bytes) of one request."""
    data = raw if raw is not None else (None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": ctype},
                                 method=method or ("GET" if data is None else "POST"))
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def both(s, path, **kw):
    return call(s["port"], path, **kw), call(s["jport"], path, **kw)


def headers_only(port, path, length):
    """(status, body bytes) of a POST that announces `length` body bytes and
    sends none: the request line and headers over a plain socket, then the
    answer read to the server's close. A server that answers before reading
    the body is read without racing a client still writing it."""
    import http.client
    import socket

    with socket.create_connection(("127.0.0.1", port), timeout=60) as sock:
        sock.sendall((f"POST {path} HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                      f"Content-Type: application/json\r\nContent-Length: {length}\r\n\r\n"
                      ).encode())
        resp = http.client.HTTPResponse(sock)
        resp.begin()
        return resp.status, resp.read()


# ---------------------------------------------------------------- predict


def test_json_predict_matches_jax_and_in_process(servers):
    s = servers
    (c, b), (jc, jb) = both(s, "/v1/predict", payload={"features": s["feats"]})
    assert c == jc == 200
    out, jout = json.loads(b), json.loads(jb)
    assert out["model_version"] == jout["model_version"] == 0
    np.testing.assert_allclose(out["predictions"], jout["predictions"], rtol=0,
                               atol=PROB_ATOL)
    solo = s["ms"].predictor.predict({k: v[:4] for k, v in s["req"].items()})
    np.testing.assert_allclose(out["predictions"], solo, rtol=0, atol=COALESCE_ATOL)


def test_tf_serving_instances_body(servers):
    """A row-major `instances` body answers as the column-major one; a bad
    instances list is a structured 400 as in the JAX server."""
    s = servers
    inst = [{k: v[i] for k, v in s["feats"].items()} for i in range(4)]
    assert instances_to_features(inst) == s["feats"]
    c, b = call(s["port"], "/v1/predict", payload={"instances": inst})
    c2, b2 = call(s["port"], "/v1/predict", payload={"features": s["feats"]})
    assert c == c2 == 200
    assert json.loads(b)["predictions"] == json.loads(b2)["predictions"]
    for bad in ([], [{"C1": 1}, {"C2": 2}], [1, 2]):
        (c, b), (jc, jb) = both(s, "/v1/predict", payload={"instances": bad})
        assert c == jc == 400 and json.loads(b) == json.loads(jb)


def test_protobuf_predict_end_to_end(servers):
    """A serialized PredictRequest answers a PredictResponse whose
    probabilities are the JSON path's floats; an output_filter that matches
    nothing is a 400, and a protobuf body off :predict too — the JAX
    server's codes and bodies."""
    s = servers
    sub = {k: v[:4] for k, v in s["req"].items()}
    body = tpb.PredictRequest(inputs={k: tpb.ArrayProto.from_numpy(v)
                                      for k, v in sub.items()}).serialize()
    (c, b), (jc, jb) = both(s, "/v1/predict", raw=body, ctype="application/x-protobuf")
    assert c == jc == 200
    got = tpb.PredictResponse.parse(b).outputs["probabilities"].to_numpy()
    want = jpb.PredictResponse.parse(jb).outputs["probabilities"].to_numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=PROB_ATOL)
    _, jsn = call(s["port"], "/v1/predict", payload={"features": s["feats"]})
    np.testing.assert_array_equal(got, np.asarray(json.loads(jsn)["predictions"], np.float32))
    filt = tpb.PredictRequest(inputs=tpb.PredictRequest.parse(body).inputs,
                              output_filter=["nope"]).serialize()
    (c, b), (jc, jb) = both(s, "/v1/predict", raw=filt, ctype="application/x-protobuf")
    assert c == jc == 400 and b == jb
    (c, b), (jc, jb) = both(s, "/v1/reload", raw=body, ctype="application/x-protobuf")
    assert c == jc == 400 and json.loads(b) == json.loads(jb)
    (c, b), (jc, jb) = both(s, "/v1/predict", raw=b"\xff\xff", ctype="application/protobuf")
    assert c == jc == 400


def _arrays():
    return [np.arange(12, dtype=np.float32).reshape(3, 4) * 0.5,
            np.arange(6, dtype=np.float64).reshape(2, 3) - 2.5,
            np.asarray([[1, -2], [3, -(1 << 40)]], np.int64),
            np.asarray([5, -6, 7], np.int32), np.asarray([True, False, True]),
            np.asarray([1, 200, 255], np.uint8),
            np.asarray(["user_a", "user_b"], dtype=object)]


@pytest.mark.parametrize("i", range(7))
def test_predict_pb_array_bytes_equal_jax(i):
    arr = _arrays()[i]
    raw = tpb.ArrayProto.from_numpy(arr).serialize()
    assert raw == jpb.ArrayProto.from_numpy(arr).serialize()
    back = tpb.ArrayProto.parse(raw)
    jback = jpb.ArrayProto.parse(raw)
    assert (back.dtype, back.shape) == (jback.dtype, jback.shape)
    if arr.dtype != object:
        np.testing.assert_array_equal(back.to_numpy(), jback.to_numpy())


def test_predict_pb_messages_bytes_equal_jax():
    """PredictRequest, PredictResponse and ServingModelInfo serialise to
    the JAX codec's bytes, and each package parses the other's."""
    ins = {"C1": np.asarray([[1], [2]], np.int64), "I1": np.asarray([[0.5], [1.5]], np.float32)}
    t = tpb.PredictRequest(signature_name="serving_default",
                           inputs={k: tpb.ArrayProto.from_numpy(v) for k, v in ins.items()},
                           output_filter=["probabilities"]).serialize()
    j = jpb.PredictRequest(signature_name="serving_default",
                           inputs={k: jpb.ArrayProto.from_numpy(v) for k, v in ins.items()},
                           output_filter=["probabilities"]).serialize()
    assert t == j
    back = tpb.PredictRequest.parse(j)
    assert back.signature_name == "serving_default" and back.output_filter == ["probabilities"]
    out = {"probabilities": np.asarray([0.1, 0.9], np.float32)}
    assert (tpb.PredictResponse({k: tpb.ArrayProto.from_numpy(v) for k, v in out.items()})
            .serialize()
            == jpb.PredictResponse({k: jpb.ArrayProto.from_numpy(v) for k, v in out.items()})
            .serialize())
    assert (tpb.ServingModelInfo("ckpt/full-5").serialize()
            == jpb.ServingModelInfo("ckpt/full-5").serialize())
    raw = b"\x78\x07" + t  # an unknown field first: skipped by both
    assert sorted(tpb.PredictRequest.parse(raw).inputs) == ["C1", "I1"]


# ------------------------------------------------------------ client errors


def test_body_cap_and_malformed_json_match_jax(servers):
    """Past max_body_bytes: the structured 400 with the limit, before the
    body is read; malformed JSON: a 400 naming it; the server serves on."""
    s = servers
    big = json.dumps({"features": {k: v * 3000 for k, v in s["feats"].items()}}).encode()
    assert len(big) > 1 << 16
    # both servers answer from the headers: the body is never sent, so the
    # answer cannot race a client still writing it
    (c, b), (jc, jb) = (headers_only(p, "/v1/predict", len(big))
                        for p in (s["port"], s["jport"]))
    assert c == jc == 400 and json.loads(b) == json.loads(jb)
    assert json.loads(b)["limit_bytes"] == 1 << 16
    (c, b), (jc, jb) = both(s, "/v1/predict", raw=b'{"features": {oops')
    assert c == jc == 400 and json.loads(b) == json.loads(jb)
    assert json.loads(b)["error"].startswith("bad json")
    c, b = call(s["port"], "/v1/predict", payload={"features": s["feats"]})
    assert c == 200 and len(json.loads(b)["predictions"]) == 4


def test_client_errors_match_jax(servers):
    """The wire firewall's 400s: missing features, unknown and missing
    names, inconsistent rows, a non-object body, non-finite dense values;
    the same codes and bodies as the JAX server."""
    s = servers
    f = s["feats"]
    typo = dict(f)
    typo["C_TYPO"] = typo.pop("C1")
    ragged = dict(f, C2=f["C2"][:1])
    nonfinite = dict(f, I1=[[float("nan")]] * 4)
    for payload in ({}, [1, 2], {"features": typo}, {"features": ragged},
                    {"features": nonfinite}, {"features": dict(f, C3=["x"] * 4)}):
        (c, b), (jc, jb) = both(s, "/v1/predict", raw=json.dumps(payload).encode())
        assert c == jc == 400, payload
        got, want = json.loads(b), json.loads(jb)
        if "cannot coerce" in want["error"]:
            assert got["feature"] == want["feature"]
        else:
            assert got == want


def test_retrieve_answers_as_the_jax_server_without_a_lane(servers):
    s = servers
    (c, b), (jc, jb) = both(s, "/v1/retrieve", payload={"features": s["feats"], "k": 5})
    assert c == jc == 400 and json.loads(b) == json.loads(jb)
    assert json.loads(b) == {"error": "retrieval not enabled on this server"}


# ------------------------------------------------------------ the routes


def test_model_info_stats_metrics_and_tfs_routes(servers):
    s = servers
    (c, b), (jc, jb) = both(s, "/v1/model_info")
    assert c == jc == 200 and json.loads(b) == json.loads(jb)
    call(s["port"], "/v1/predict", payload={"features": s["feats"]})
    c, b = call(s["port"], "/v1/stats")
    stats = json.loads(b)
    assert c == 200 and stats["requests"] >= 1 and stats["errors"] == 0
    for stage in ("queue", "pad", "device", "post", "e2e"):
        assert stats["stages"][stage]["count"] >= 1
    assert stats["residency"]["measured_bytes"] == stats["residency"]["modeled_bytes"]
    assert set(stats) == set(json.loads(call(s["jport"], "/v1/stats")[1]))
    c, text = call(s["port"], "/metrics")
    assert c == 200 and b"deeprec_serving_stage_seconds" in text
    assert b"deeprec_serving_model_version" in text
    for path in ("/v1/models", "/v1/models/default", "/v1/models/nope", "/nope",
                 "/v1/models/nope/stats"):
        (c, b), (jc, jb) = both(s, path)
        assert c == jc, path
        if path != "/v1/models/default":
            assert json.loads(b) == json.loads(jb), path
    c, b = call(s["port"], "/v1/models/default/stats")
    assert c == 200 and json.loads(b)["model"]["version"] == 0


def test_healthz_200_then_503_on_failing_polls(tmp_path):
    """/healthz is 200 while polls succeed and 503 with the same body once
    they fail (/v1/reload answers 500 with the error); predictions keep
    serving the last good snapshot."""
    _, _, _, _, req = _train_and_save(tmp_path)
    ms = ModelServer(Predictor(WDL(**KW), str(tmp_path), device="cpu"), max_batch=32)
    http = HttpServer(ms, port=0).start()
    try:
        c, b = call(http.port, "/healthz")
        assert c == 200 and json.loads(b)["status"] == "ok"
        p = ms.predictor
        real = p._dirs
        p._dirs = lambda: (_ for _ in ()).throw(OSError("listing failed"))
        c, b = call(http.port, "/v1/reload", payload={})
        assert c == 500 and "listing failed" in json.loads(b)["error"]
        c, b = call(http.port, "/healthz")
        h = json.loads(b)
        assert c == 503 and h["status"] == "degraded" and h["consecutive_poll_failures"] == 1
        c, b = call(http.port, "/v1/predict",
                    payload={"features": {k: v[:2].tolist() for k, v in req.items()}})
        assert c == 200
        p._dirs = real
        c, b = call(http.port, "/v1/reload", payload={})
        assert c == 200 and json.loads(b) == {"updated": False}
        assert call(http.port, "/healthz")[0] == 200
    finally:
        http.stop()
        ms.close()


def test_reload_route_applies_a_delta(tmp_path):
    """POST /v1/reload polls now: a JAX-written delta is served, the step
    and version move, and the answer changes."""
    tr, st, ck, gen, req = _train_and_save(tmp_path)
    ms = ModelServer(Predictor(WDL(**KW), str(tmp_path), device="cpu"), max_batch=32)
    http = HttpServer(ms, port=0).start()
    feats = {k: v[:3].tolist() for k, v in req.items()}
    try:
        out1 = json.loads(call(http.port, "/v1/predict", payload={"features": feats})[1])
        for _ in range(3):
            st, _ = tr.train_step(st, J(gen.batch()))
        ck.save_incremental(st)
        c, b = call(http.port, "/v1/reload", payload={})
        assert c == 200 and json.loads(b) == {"updated": True}
        assert json.loads(call(http.port, "/v1/model_info")[1])["step"] == 7
        out2 = json.loads(call(http.port, "/v1/predict", payload={"features": feats})[1])
        assert out2["model_version"] == out1["model_version"] + 1
        assert np.abs(np.subtract(out2["predictions"], out1["predictions"])).max() > 1e-6
    finally:
        http.stop()
        ms.close()


def test_multi_model_routes(servers):
    """{name: server}: the TF-Serving routes address each model by name,
    the bare routes hit the default one, unknown names and verbs 404."""
    s = servers
    other = ModelServer(Predictor(WDL(**KW), s["dirs"][0], device="cpu"), max_batch=32)
    http = HttpServer({"a": s["ms"], "b": other}, port=0, default_model="b").start()
    try:
        assert json.loads(call(http.port, "/v1/models")[1]) == {"models": ["a", "b"]}
        for path in ("/v1/models/a:predict", "/v1/models/b:predict", "/v1/predict"):
            c, b = call(http.port, path, payload={"features": s["feats"]})
            assert c == 200 and len(json.loads(b)["predictions"]) == 4, path
        assert call(http.port, "/v1/models/zz:predict", payload={})[0] == 404
        assert call(http.port, "/v1/models/a:explode", payload={})[0] == 404
        assert json.loads(call(http.port, "/v1/models/a:reload", payload={})[1]) == {
            "updated": False}
        with pytest.raises(ValueError, match="default_model"):
            HttpServer({"a": s["ms"]}, port=0, default_model="x")
    finally:
        http.stop()
        other.close()


# ------------------------------------------------------------ the C ABI


def test_cabi_python_half_matches_jax(servers, tmp_path):
    """create_server from a config JSON; process_request sniffs JSON
    (whitespace-prefixed too) from protobuf per request; the codes, the
    error bodies and the model info equal the JAX C ABI's, the
    probabilities within PROB_ATOL."""
    s = servers
    dp, dj = s["dirs"]
    cfg = dict(model="wdl", model_args=dict(KW), max_batch=32, warmup=True)
    srv = tcabi.create_server(json.dumps(dict(cfg, ckpt_dir=dp, device="cpu")))
    jsrv = jcabi.create_server(json.dumps(dict(cfg, ckpt_dir=dj)))
    try:
        sub = {k: v[:3] for k, v in s["req"].items()}
        js = json.dumps({"features": {k: v.tolist() for k, v in sub.items()}}).encode()
        pb_req = tpb.PredictRequest(inputs={k: tpb.ArrayProto.from_numpy(v)
                                            for k, v in sub.items()}).serialize()
        for payload in (js, b"  \n" + js, pb_req):
            c, b = tcabi.process_request(srv, payload)
            jc, jb = jcabi.process_request(jsrv, payload)
            assert c == jc == 200
            if payload is pb_req:
                got = tpb.PredictResponse.parse(b).outputs["probabilities"].to_numpy()
                want = jpb.PredictResponse.parse(jb).outputs["probabilities"].to_numpy()
            else:
                got, want = (np.asarray(json.loads(x)["predictions"]) for x in (b, jb))
            np.testing.assert_allclose(got, want, rtol=0, atol=PROB_ATOL)
        for bad in (b"{}", b"[]", b'{"features": 3}', b"\x0a\x02ok"):
            c, b = tcabi.process_request(srv, bad)
            jc, jb = jcabi.process_request(jsrv, bad)
            assert (c, b) == (jc, jb), bad
        assert tcabi.model_info_json(srv) == jcabi.model_info_json(jsrv)
        assert len(srv.predictor._warm_batches) == len(srv._buckets())
        with pytest.raises(ValueError, match="ckpt_dir"):
            tcabi.create_server(json.dumps({"model": "wdl"}))
    finally:
        srv.close()
        jsrv.close()


# ------------------------------------------------------------ main()


def _serve_subprocess(args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    env.update(env_extra or {})
    return subprocess.Popen([sys.executable, "-m", "deeprec_tpu_torch.serving.http_server",
                             *args], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _first_line_port(proc):
    line = proc.stdout.readline()
    m = re.search(r"http://[^:]+:(\d+)", line)
    if m is None:
        proc.kill()
        raise AssertionError(f"no serving line: {line!r} {proc.stderr.read()}")
    return int(m.group(1))


@pytest.mark.parametrize("mode", ["ckpt", "serve"])
def test_main_serves_on_the_cpu_with_the_device_flag(tmp_path, mode):
    """`python -m deeprec_tpu_torch.serving.http_server ... --device cpu`:
    --model/--ckpt (a default-width WDL the port saved) and --serve JSON (a
    small WDL the JAX package trained) both answer /v1/predict and
    /healthz."""
    from deeprec_tpu_torch.training.checkpoint import CheckpointManager
    from deeprec_tpu_torch.training.trainer import Trainer

    if mode == "ckpt":
        from deeprec_tpu_torch.optim import Adagrad as TAdagrad

        tr = Trainer(WDL(emb_dim=8, capacity=1 << 12), TAdagrad(lr=0.1), device="cpu")
        CheckpointManager(str(tmp_path), tr).save(tr.init())
        args = ["--model", "wdl", "--ckpt", str(tmp_path), "--emb_dim", "8",
                "--capacity", str(1 << 12)]
        names = [f.name for f in WDL(emb_dim=8, capacity=1 << 12).features]
        feats = {n: ([[0.5]] * 2 if n.startswith("I") else [3, 4]) for n in names}
    else:
        _, _, _, _, req = _train_and_save(tmp_path)
        spec = json.dumps({"name": "small", "model": "wdl", "ckpt_dir": str(tmp_path),
                           "model_args": KW})
        args = ["--serve", spec]
        feats = {k: v[:2].tolist() for k, v in req.items()}
    proc = _serve_subprocess([*args, "--device", "cpu", "--port", "0", "--host", "127.0.0.1",
                              "--poll_secs", "0"])
    try:
        port = _first_line_port(proc)
        c, b = call(port, "/v1/predict", payload={"features": feats})
        assert c == 200 and len(json.loads(b)["predictions"]) == 2
        assert call(port, "/healthz")[0] == 200
        if mode == "serve":
            assert json.loads(call(port, "/v1/models")[1]) == {"models": ["small"]}
    finally:
        proc.kill()
        proc.wait(timeout=30)


def test_main_raises_without_cuda_unless_asked_for_the_cpu(tmp_path):
    """Without a CUDA card and without --device cpu the command fails
    naming the missing card: no silent CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device serves")
    _train_and_save(tmp_path)
    spec = json.dumps({"model": "wdl", "ckpt_dir": str(tmp_path), "model_args": KW})
    proc = _serve_subprocess(["--serve", spec, "--port", "0", "--poll_secs", "0"])
    out, err = proc.communicate(timeout=120)
    assert proc.returncode != 0 and "no CUDA device" in err and "serving" not in out
