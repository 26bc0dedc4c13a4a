"""The port's serving C ABI (deeprec_tpu_torch/native/processor.cpp over
serving/cabi.py), case for case with tests/test_processor_cabi.py: the
library is built by g++ at first use into build/deeprec_tpu_torch/ and
driven through ctypes exactly as an external RPC host would through dlopen
— initialize() with a JSON model config ("device": "cpu"), process() with
JSON and protobuf requests (good, client-error, post-hot-swap),
batch_process, batch_process_n, get_serving_model_info, shutdown — on a
JAX-trained checkpoint, answers equal the port's Predictor and within
PROB_ATOL of the JAX eval_step. The pure-C host boots the embedded
interpreter itself."""
import ctypes
import json
import os
import subprocess

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeprec_tpu.data import SyntheticCriteo
from deeprec_tpu.models import WDL
from deeprec_tpu.optim import Adagrad
from deeprec_tpu.training import Trainer
from deeprec_tpu.training.checkpoint import CheckpointManager
from deeprec_tpu_torch import native

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# One source of truth for the served model's hyperparameters (fixture +
# the pure-C host test restore the same checkpoint).
MODEL_ARGS = dict(emb_dim=8, capacity=1 << 12, hidden=(32,), num_cat=4,
                  num_dense=2)
# the port's answers against the JAX eval_step on one checkpoint
PROB_ATOL = 1e-4


def _build_lib():
    """The port's processor library, built at first use (a failed build
    raises) and loaded into this process."""
    return native.load_processor_library()


def _port_predictor(ckpt_dir):
    from deeprec_tpu_torch.models import WDL as PortWDL
    from deeprec_tpu_torch.serving import Predictor

    return Predictor(PortWDL(**MODEL_ARGS), ckpt_dir, device="cpu")


def _call_json(lib, fn, handle, payload=None):
    out = ctypes.c_void_p()
    n = ctypes.c_int()
    if payload is None:
        rc = fn(handle, ctypes.byref(out), ctypes.byref(n))
    else:
        rc = fn(handle, payload, len(payload), ctypes.byref(out),
                ctypes.byref(n))
    body = ctypes.string_at(out, n.value) if out.value else b"{}"
    if out.value:
        lib.free_buffer(out)
    return rc, json.loads(body)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cabi")
    model_args = MODEL_ARGS
    tr = Trainer(WDL(**model_args), Adagrad(lr=0.1), optax.adam(1e-3))
    st = tr.init(0)
    g = SyntheticCriteo(batch_size=128, num_cat=4, num_dense=2, vocab=900,
                        seed=5)
    batches = [
        {k: jnp.asarray(v) for k, v in g.batch().items()} for _ in range(3)
    ]
    for b in batches:
        st, _ = tr.train_step(st, b)
    ck = CheckpointManager(str(tmp), tr)
    st, _ = ck.save(st)

    lib = _build_lib()
    cfg = {
        "model": "wdl",
        "ckpt_dir": str(tmp),
        "model_args": {**model_args, "hidden": list(model_args["hidden"])},
        "max_wait_ms": 1.0,
        "poll_secs": 0.2,
        "device": "cpu",
    }
    state = ctypes.c_int(-2)
    handle = lib.initialize(b"", json.dumps(cfg).encode(),
                            ctypes.byref(state))
    assert state.value == 0 and handle
    yield lib, handle, tr, st, ck, batches
    lib.shutdown_processor(handle)


def test_process_matches_inprocess_predictor(served):
    lib, handle, tr, st, ck, batches = served
    b0 = {k: np.asarray(v) for k, v in batches[0].items() if k != "label"}
    feats = {k: v.tolist() for k, v in b0.items()}
    rc, resp = _call_json(
        lib, lib.process, handle,
        json.dumps({"features": feats}).encode(),
    )
    assert rc == 200, resp
    preds = np.asarray(resp["predictions"], np.float32)
    _, ref = tr.eval_step(st, batches[0])
    np.testing.assert_allclose(preds, np.asarray(ref), atol=PROB_ATOL, rtol=0)
    own = _port_predictor(ck.dir).predict(b0)
    np.testing.assert_array_equal(preds, own)


def test_client_errors_are_400(served):
    lib, handle, *_ = served
    # Not JSON (and not a parseable PredictRequest either): the wire
    # sniffer routes non-'{' payloads to the protobuf path, whose error
    # bodies are plain text like the reference's (processor.cc:38-46).
    out = ctypes.c_void_p()
    n = ctypes.c_int()
    payload = b"not json at all"
    rc = lib.process(handle, payload, len(payload), ctypes.byref(out),
                     ctypes.byref(n))
    assert rc == 400
    assert b"PredictRequest" in ctypes.string_at(out, n.value)
    lib.free_buffer(out)
    rc, resp = _call_json(
        lib, lib.process, handle,
        json.dumps({"features": {"BOGUS": [1]}}).encode(),
    )
    assert rc == 400 and "mismatch" in resp["error"]


def test_model_info_and_hot_swap(served):
    import time

    lib, handle, tr, st, ck, batches = served
    rc, info = _call_json(lib, lib.get_serving_model_info, handle)
    assert rc == 200 and info["step"] == int(st.step)

    # write a newer full checkpoint; the handle's background poller
    # (cfg poll_secs=0.2) must hot-swap it and the C surface must see the
    # new step
    st2 = st
    for b in batches:
        st2, _ = tr.train_step(st2, b)
    st2, _ = ck.save(st2)
    deadline = time.time() + 30
    while time.time() < deadline:
        rc, info2 = _call_json(lib, lib.get_serving_model_info, handle)
        assert rc == 200
        if info2["step"] == int(st2.step):
            break
        time.sleep(0.2)
    assert info2["step"] == int(st2.step)


def test_batch_process(served):
    """Reference-ABI batch_process: batch-of-1 semantics (the reference's
    sizeof(input_data)/sizeof(void*) always yields 1, message_coding.cc:79),
    and NO null terminator — reference hosts don't write one."""
    lib, handle, tr, st, ck, batches = served
    b0 = {k: np.asarray(v)[:4] for k, v in batches[0].items()
          if k != "label"}
    payload = json.dumps(
        {"features": {k: v.tolist() for k, v in b0.items()}}
    ).encode()
    n_req = 3
    inputs = (ctypes.c_char_p * n_req)(*([payload] * n_req))
    sizes = (ctypes.c_int * n_req)(*([len(payload)] * n_req))
    outputs = (ctypes.c_void_p * n_req)()
    out_sizes = (ctypes.c_int * n_req)()
    rc = lib.batch_process(handle, inputs, sizes, outputs, out_sizes)
    assert rc == 200
    body = json.loads(ctypes.string_at(outputs[0], out_sizes[0]))
    assert len(body["predictions"]) == 4
    lib.free_buffer(outputs[0])
    assert not outputs[1] and not outputs[2]  # only request 0 processed


def test_batch_process_n(served):
    """Extension entry point: explicit request count, real batching."""
    lib, handle, tr, st, ck, batches = served
    lib.batch_process_n.restype = ctypes.c_int
    lib.batch_process_n.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
    ]
    b0 = {k: np.asarray(v)[:4] for k, v in batches[0].items()
          if k != "label"}
    payload = json.dumps(
        {"features": {k: v.tolist() for k, v in b0.items()}}
    ).encode()
    n_req = 3
    inputs = (ctypes.c_char_p * n_req)(*([payload] * n_req))
    sizes = (ctypes.c_int * n_req)(*([len(payload)] * n_req))
    outputs = (ctypes.c_void_p * n_req)()
    out_sizes = (ctypes.c_int * n_req)()
    rc = lib.batch_process_n(handle, inputs, sizes, n_req, outputs, out_sizes)
    assert rc == 200
    for i in range(n_req):
        body = json.loads(ctypes.string_at(outputs[i], out_sizes[i]))
        assert len(body["predictions"]) == 4
        lib.free_buffer(outputs[i])

    # A size-0 slot is a client error for that slot (no info-ping semantics
    # inside an explicit-count batch); the good slot still serves.
    sizes2 = (ctypes.c_int * 2)(0, len(payload))
    inputs2 = (ctypes.c_char_p * 2)(payload, payload)
    outputs2 = (ctypes.c_void_p * 2)()
    out_sizes2 = (ctypes.c_int * 2)()
    rc = lib.batch_process_n(handle, inputs2, sizes2, 2, outputs2, out_sizes2)
    assert rc == 400
    err = json.loads(ctypes.string_at(outputs2[0], out_sizes2[0]))
    assert "error" in err
    ok = json.loads(ctypes.string_at(outputs2[1], out_sizes2[1]))
    assert len(ok["predictions"]) == 4
    for o in outputs2:
        lib.free_buffer(o)


def test_process_empty_payload_returns_model_info(served):
    """input_size==0 mirrors the reference (processor.cc:29-34): model
    debug/serving info with status 200, not a 400."""
    lib, handle, tr, st, ck, batches = served
    out = ctypes.c_void_p()
    n = ctypes.c_int()
    rc = lib.process(handle, b"", 0, ctypes.byref(out), ctypes.byref(n))
    assert rc == 200
    info = json.loads(ctypes.string_at(out, n.value))
    lib.free_buffer(out)
    assert "step" in info


def test_process_protobuf_payload(served):
    """A reference-built host's serialized PredictRequest through the real
    .so: process() sniffs protobuf, returns a PredictResponse."""
    from deeprec_tpu_torch.serving.predict_pb import (
        ArrayProto,
        PredictRequest,
        PredictResponse,
    )

    lib, handle, tr, st, ck, batches = served
    feats = {k: np.asarray(v)[:4] for k, v in batches[0].items()
             if k != "label"}
    wire = PredictRequest(
        inputs={k: ArrayProto.from_numpy(v) for k, v in feats.items()}
    ).serialize()
    out = ctypes.c_void_p()
    n = ctypes.c_int()
    rc = lib.process(handle, wire, len(wire), ctypes.byref(out),
                     ctypes.byref(n))
    assert rc == 200
    resp = PredictResponse.parse(ctypes.string_at(out, n.value))
    lib.free_buffer(out)
    probs = resp.outputs["probabilities"].to_numpy()
    assert probs.shape[0] == 4
    assert np.all((probs >= 0) & (probs <= 1))
    np.testing.assert_array_equal(probs, _port_predictor(ck.dir).predict(feats))


@pytest.mark.slow
def test_pure_c_host_boots_embedded_interpreter(served, tmp_path):
    """The EAS integration path for real: a PURE C program (no Python
    running) dlopens libdeeprec_processor.so, which must boot the
    embedded CPython interpreter itself (the initialize() branch the
    ctypes fixture short-circuits), serve a request, and shut down."""
    import sys

    lib, handle, tr, st, ck, batches = served  # reuse the trained ckpt dir
    chost = str(native.build_chost_demo())

    cfg = {
        "model": "wdl",
        "ckpt_dir": str(ck.dir),
        "model_args": {**MODEL_ARGS, "hidden": list(MODEL_ARGS["hidden"])},
        "max_wait_ms": 1.0,
        "device": "cpu",
    }
    b0 = {k: np.asarray(v)[:2].tolist() for k, v in batches[0].items()
          if k != "label"}
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    (tmp_path / "request.json").write_text(
        json.dumps({"features": b0}))

    import sysconfig

    env = {
        **os.environ,
        # The embedded interpreter needs the BASE install for the stdlib
        # (a venv prefix has no encodings/), plus the venv site-packages
        # and the repo on PYTHONPATH.
        "PYTHONHOME": sys.base_prefix,
        "PYTHONPATH": os.pathsep.join(
            [REPO, sysconfig.get_paths()["purelib"]]
        ),
        "OMP_NUM_THREADS": "1",
    }
    r = subprocess.run(
        [chost, str(native.processor_library_path()),
         str(tmp_path / "config.json"), str(tmp_path / "request.json")],
        capture_output=True, text=True, timeout=280, env=env,
    )
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert "process rc=200" in r.stdout
    body = json.loads(r.stdout.split("body=", 1)[1])
    assert len(body["predictions"]) == 2
