"""The port's online loop (`deeprec_tpu_torch/online/loop.py`,
`online/faults.py`, `parallel/elastic.py`) on the CPU, the mirror of
tests/test_online_loop.py:173-443 and tests/test_elastic_live.py:237:
TrainLoop's save cadence and heartbeat, a torn writer that self-heals, the
EXIT_RESCALE contract, the poll thread surviving a raising poll, ServeLoop's
health heartbeat and pause, the heartbeat lease from the environment, a
worker subprocess (`python -m deeprec_tpu_torch.online.loop --device cpu`)
SIGKILLed and resumed under the Supervisor, a corrupt delta quarantined
while serving continues, a broker outage the TCP reader reconnects through
exactly once, the ElasticCoordinator's plans, epochs and acks (the same
files as the JAX coordinator's), and `reshard` between capacities on one
device (per key, bit for bit)."""
import os
import sys
import time

import numpy as np
import pytest
import torch

from deeprec_tpu_torch.data import SyntheticCriteo
from deeprec_tpu_torch.models import WDL
from deeprec_tpu_torch.online import faults
from deeprec_tpu_torch.online.loop import ServeLoop, TrainLoop, wait_for_full_checkpoint
from deeprec_tpu_torch.online.supervisor import Heartbeat, ProcessSpec, Supervisor
from deeprec_tpu_torch.optim import Adagrad, adam
from deeprec_tpu_torch.parallel.elastic import (
    EXIT_RESCALE, ElasticCoordinator, factorize_mesh, plan_mesh_after_rescale, reshard)
from deeprec_tpu_torch.training.checkpoint import CheckpointManager
from deeprec_tpu_torch.training.trainer import Trainer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SENTINEL = int(np.iinfo(np.int32).min)


def _wait(pred, timeout=30.0, poll=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(poll)
    return None


def _mk_trainer(capacity=1 << 10):
    model = WDL(emb_dim=4, capacity=capacity, hidden=(16,), num_cat=2, num_dense=2)
    return Trainer(model, Adagrad(lr=0.2), adam(5e-3), device="cpu"), model


def _batches(B=96, seed=0):
    gen = SyntheticCriteo(batch_size=B, num_cat=2, num_dense=2, vocab=300, seed=seed)
    while True:
        yield gen.batch()


# ---------------------------------------------------------------- TrainLoop

def test_train_loop_cadence_and_heartbeat(tmp_path):
    tr, _ = _mk_trainer()
    ck = CheckpointManager(str(tmp_path / "ck"), tr)
    hb = Heartbeat(str(tmp_path / "t.hb"))
    loop = TrainLoop(tr, ck, _batches(), save_every=4, full_every=3, heartbeat=hb,
                     max_steps=16)
    state, code = loop.run()
    assert code == 0 and int(state.step) == 16
    dirs = sorted(d for d in os.listdir(tmp_path / "ck") if "-" in d)
    # anchor first, then deltas, a full again every 3rd save
    assert "full-4" in dirs and "incr-8" in dirs and "full-12" in dirs
    beat = Heartbeat.read(hb.path)
    assert beat["step"] == 16 and beat["status"] == "done"
    assert beat["saves"] == loop.saves >= 4
    assert "input_stall_s" in beat
    restored = CheckpointManager(str(tmp_path / "ck"), _mk_trainer()[0]).restore()
    assert int(restored.step) == 16


def test_train_loop_survives_torn_writer_and_self_heals(tmp_path):
    """An async writer dying mid-save kills neither training nor the chain:
    the loop counts the failure, keeps stepping, and the manager's
    force-full escalation re-anchors on the next cadence save."""
    tr, _ = _mk_trainer()
    ck = CheckpointManager(str(tmp_path / "ck"), tr)
    loop = TrainLoop(tr, ck, _batches(), save_every=3, full_every=100, max_steps=15)

    def on_step(step):
        if loop.saves == 1 and ck.on_write is None:
            faults.install_torn_write(ck)

    loop.on_step = on_step
    state, code = loop.run()
    assert code == 0 and int(state.step) == 15
    assert loop.save_failures >= 1
    names = os.listdir(tmp_path / "ck")
    assert any(d.startswith("full-") and os.path.exists(tmp_path / "ck" / d / "manifest.json")
               for d in names)
    restored = CheckpointManager(str(tmp_path / "ck"), _mk_trainer()[0]).restore()
    assert int(restored.step) >= 6


def test_train_loop_rescale_contract(tmp_path):
    """A posted scaling plan makes the loop checkpoint, ack and return
    EXIT_RESCALE."""
    tr, _ = _mk_trainer()
    ck = CheckpointManager(str(tmp_path / "ck"), tr)
    coord = ElasticCoordinator(str(tmp_path / "el"))
    epoch = coord.request_scale(2)
    loop = TrainLoop(tr, ck, _batches(), save_every=100, coordinator=coord,
                     elastic_every=2, max_steps=50)
    state, code = loop.run()
    assert code == EXIT_RESCALE
    assert int(state.step) <= 4
    assert coord.acked(epoch, 1)
    restored = CheckpointManager(str(tmp_path / "ck"), _mk_trainer()[0]).restore()
    assert int(restored.step) == int(state.step)  # durable before the ack


def test_trainloop_picks_up_heartbeat_env(tmp_path, monkeypatch):
    hb = str(tmp_path / "w.hb")
    monkeypatch.setenv("DEEPREC_HEARTBEAT_FILE", hb)

    class _Ck:
        def latest_full(self):
            return None

    loop = TrainLoop(trainer=None, ckpt=_Ck(), batches=[])
    assert loop.heartbeat is not None and loop.heartbeat.path == hb
    loop._beat(3)
    assert Heartbeat.read(hb)["step"] == 3
    other = Heartbeat(str(tmp_path / "explicit.hb"))
    assert TrainLoop(trainer=None, ckpt=_Ck(), batches=[], heartbeat=other).heartbeat is other


def test_env_kill_step_and_worker_argv(monkeypatch):
    monkeypatch.delenv(faults.KILL_STEP_ENV, raising=False)
    assert faults.env_kill_step() is None
    monkeypatch.setenv(faults.KILL_STEP_ENV, "5")
    assert callable(faults.env_kill_step())
    argv = faults.worker_argv("--ckpt", "d", "--steps", 3)
    assert argv[:3] == [sys.executable, "-m", "deeprec_tpu_torch.online.loop"]
    assert argv[3:] == ["--ckpt", "d", "--steps", "3"]
    lr = faults.exploding_lr(0.1, 5, 2, factor=1e3)
    assert [lr(s) for s in (4, 5, 6, 7)] == [0.1, 100.0, 100.0, 0.1]


# ---------------------------------------------------------- poll survival

def _build_serving_chain(tmp_path, steps=3):
    tr, model = _mk_trainer()
    ck = CheckpointManager(str(tmp_path / "ck"), tr)
    st = tr.init(0)
    gen = _batches(seed=4)
    for _ in range(steps):
        st = tr.train_step(st, next(gen))[0]
    st, _ = ck.save(st)
    req = {k: v for k, v in next(gen).items() if k != "label"}
    return tr, model, ck, st, req, gen


def test_poll_thread_survives_raising_poll_and_recovers(tmp_path):
    """A poll_updates that raises leaves the background poll loop running
    and the old snapshot serving; when the fault clears, deltas land again
    through the same thread."""
    from deeprec_tpu_torch.serving.predictor import ModelServer, Predictor

    tr, model, ck, st, req, gen = _build_serving_chain(tmp_path)
    p = Predictor(model, str(tmp_path / "ck"), device="cpu")
    server = ModelServer(p, max_batch=32, poll_updates_secs=0.05)
    try:
        before = np.asarray(server.request(req))
        real_list = p._ck._list

        def bad_list(kind):
            raise RuntimeError("injected: ckpt dir unreadable mid-scan")

        p._ck._list = bad_list
        assert _wait(lambda: p.consecutive_poll_failures >= 2, timeout=30)
        assert server._poller.is_alive()
        assert getattr(server, "update_failures", 0) >= 1
        assert p.health()["status"] == "degraded"
        np.testing.assert_array_equal(before, np.asarray(server.request(req)))
        p._ck._list = real_list
        st2 = tr.train_step(st, next(gen))[0]
        st2, _ = ck.save_incremental(st2)
        assert _wait(lambda: p.consecutive_poll_failures == 0 and p.step == int(st2.step),
                     timeout=30)
        assert p.health()["status"] == "ok"
        assert server._poller.is_alive()
    finally:
        server.close()


def test_serve_loop_heartbeats_health_and_pause(tmp_path):
    tr, model, ck, st, req, gen = _build_serving_chain(tmp_path)
    hb = str(tmp_path / "s.hb")
    sl = ServeLoop(model, str(tmp_path / "ck"), poll_secs=0.05, heartbeat=Heartbeat(hb),
                   device="cpu", wait_for_checkpoint_secs=5)
    try:
        out, ver = sl.request_versioned(req)
        assert np.asarray(out).shape[0] == 96
        beat = _wait(lambda: Heartbeat.read(hb), timeout=30)
        assert beat["status"] == "ok"
        assert "staleness_seconds" in beat and "quarantined" in beat
        sl.pause()
        time.sleep(0.2)
        v0 = sl.predictor.version
        st2 = tr.train_step(st, next(gen))[0]
        st2, _ = ck.save_incremental(st2)
        time.sleep(0.3)
        assert sl.predictor.version == v0
        sl.resume()
        assert _wait(lambda: sl.predictor.version > v0, timeout=30)
        assert sl.health()["step"] == int(st2.step)
    finally:
        sl.close()


def test_serve_loop_quarantines_corrupt_delta_and_serves_through(tmp_path):
    """A bit-flipped committed delta is quarantined by the poll; the old
    snapshot keeps answering, and the trainer's next save re-anchors."""
    tr, model, ck, st, req, gen = _build_serving_chain(tmp_path)
    sl = ServeLoop(model, str(tmp_path / "ck"), poll_secs=0.05, device="cpu")
    try:
        before, v0 = sl.request_versioned(req)
        sl.pause()
        time.sleep(0.2)
        st = tr.train_step(st, next(gen))[0]
        st, _ = ck.save_incremental(st)
        target = faults.corrupt_latest_delta(str(tmp_path / "ck"), mode="bitflip")
        assert target is not None and "incr-" in target
        q0 = sl.health()["quarantined"]
        sl.resume()
        assert _wait(lambda: sl.health()["quarantined"] > q0, timeout=30)
        after, v1 = sl.request_versioned(req)
        assert v1 == v0
        np.testing.assert_array_equal(np.asarray(before), np.asarray(after))
        st = tr.train_step(st, next(gen))[0]
        _, path = ck.save_incremental(st)
        assert os.path.basename(path).startswith("full-")  # the self-heal
        assert _wait(lambda: sl.predictor.step == int(st.step), timeout=30)
    finally:
        sl.close()
    os.makedirs(tmp_path / "empty")
    assert faults.corrupt_latest_delta(str(tmp_path / "empty")) is None


def test_wait_for_full_checkpoint(tmp_path):
    with pytest.raises(TimeoutError):
        wait_for_full_checkpoint(str(tmp_path / "none"), timeout=0.2, poll_secs=0.05)
    _build_serving_chain(tmp_path, steps=1)
    wait_for_full_checkpoint(str(tmp_path / "ck"), timeout=5)


def test_broker_outage_reconnects_exactly_once(tmp_path):
    """BrokerOutage takes the FileStreamServer down and revives it on the
    same port; the TCP reader reconnects with backoff and resumes at its
    offset: every record once, in order."""
    from deeprec_tpu_torch.data import FileStreamServer, TCPStreamReader

    p = tmp_path / "log.tsv"
    p.write_text("".join(f"row{i:04d}\n" for i in range(64)))
    srv = FileStreamServer(str(p), follow=True, poll_secs=0.02).start()
    outage = faults.BrokerOutage(srv)
    r = TCPStreamReader("127.0.0.1", srv.port, batch_size=32, reconnect_secs=0.05,
                        reconnect_max_secs=0.2,
                        parser=lambda lines: {"rows": np.asarray(lines, object)})
    it = iter(r)
    got = [next(it)]
    outage.down()
    assert outage.outages == 1 and outage.down_at is not None
    with open(p, "a") as f:
        f.write("".join(f"row{i:04d}\n" for i in range(64, 96)))
    time.sleep(0.3)
    srv = outage.up()
    try:
        got += [next(it), next(it)]
        assert r.reconnects >= 1
    finally:
        it.close()
        srv.stop()
    rows = np.concatenate([b["rows"] for b in got]).tolist()
    assert rows == [f"row{i:04d}" for i in range(96)]


# ------------------------------------------------ the worker subprocess

def test_worker_main_needs_cuda_or_device_cpu(tmp_path):
    from deeprec_tpu_torch.online.loop import main

    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--ckpt", str(tmp_path / "ck"), "--steps", "1"])


def test_worker_subprocess_kill_resume_via_supervisor(tmp_path):
    """The supervised generation cycle with the port's worker on the CPU:
    SIGKILL at step 6 (the environment injector), one restart, the worker
    RESUMEs from the chain and completes at step 12."""
    ck = str(tmp_path / "ck")
    hb = str(tmp_path / "t.hb")
    argv = faults.worker_argv("--ckpt", ck, "--steps", 12, "--save-every", 3,
                              "--heartbeat", hb, "--batch-size", 64, "--device", "cpu")
    env = {"PYTHONPATH": REPO, faults.KILL_STEP_ENV: "6", "OMP_NUM_THREADS": "1"}
    spec = ProcessSpec(name="trainer", argv=argv, heartbeat_path=hb, lease_secs=120,
                       grace_secs=120, max_restarts=3, backoff_base_secs=0.1, env=dict(env),
                       stdout=str(tmp_path / "trainer.log"))
    sup = Supervisor([spec], poll_secs=0.1, on_event=lambda m: None)
    orig_spawn = sup._spawn

    def spawn(s):  # the restarted generation must not re-arm the kill
        orig_spawn(s)
        s.env.pop(faults.KILL_STEP_ENV, None)

    sup._spawn = spawn
    sup.start()
    try:
        assert _wait(lambda: sup.stats()["trainer"]["done"], timeout=120)
        assert sup.stats()["trainer"]["restarts"] == 1
        log = open(tmp_path / "trainer.log").read().splitlines()
        assert any(line.startswith("RESUMED") for line in log)
        assert log[-1] == "DONE"
        restored = CheckpointManager(ck, _mk_trainer(capacity=1 << 12)[0]).restore()
        assert int(restored.step) == 12
    finally:
        sup.stop()


# ---------------------------------------------------------------- elastic

def test_coordinator_plan_epoch_and_acks(tmp_path, monkeypatch):
    """Plan epochs grow, applied plans do not trigger again, acks gate the
    supervisor; the plan and ack files are the JAX coordinator's."""
    from deeprec_tpu.parallel.elastic import ElasticCoordinator as JaxCoordinator

    monkeypatch.delenv("DEEPREC_ELASTIC_EPOCH", raising=False)
    coord = ElasticCoordinator(str(tmp_path))
    assert coord.plan() == (0, None)
    assert coord.should_scale() is None
    assert coord.request_scale(4) == 1
    assert coord.plan() == (1, 4) == JaxCoordinator(str(tmp_path)).plan()
    assert coord.should_scale() == 4
    monkeypatch.setenv("DEEPREC_ELASTIC_EPOCH", "1")
    assert coord.should_scale() is None
    assert coord.request_scale(2) == 2
    assert coord.should_scale() == 2
    monkeypatch.delenv("DEEPREC_ELASTIC_EPOCH")
    e = coord.request_scale(2)
    assert coord.should_scale() == 2
    coord.request_scale(8)  # a racing autoscaler posts e+1 mid-rescale
    assert not coord.acked(e, 2)
    coord.ack_rescale()  # process 0 acks the decided epoch e
    assert not coord.acked(e, 2)
    with open(os.path.join(str(tmp_path), f"ack-{e}-00001"), "w") as f:
        f.write("2")
    assert coord.acked(e, 2) and JaxCoordinator(str(tmp_path)).acked(e, 2)
    coord.wait_acked(e, 2, timeout=1)
    assert coord.wait_acked_after(e - 1, 2, timeout=1) == (e, 2)
    with pytest.raises(TimeoutError):
        coord.wait_acked(e + 5, 1, timeout=0.1)
    with pytest.raises(RuntimeError, match="should_scale"):
        ElasticCoordinator(str(tmp_path / "x")).ack_rescale()


@pytest.mark.parametrize("n,intra,want", [(8, 4, (4, 2)), (6, 4, (3, 2)), (7, 4, (7, 1)),
                                          (2, 4, (2, 1)), (12, 8, (6, 2))])
def test_factorize_mesh_matches_jax(n, intra, want):
    from deeprec_tpu.parallel.elastic import factorize_mesh as jax_factorize

    assert factorize_mesh(n, intra) == jax_factorize(n, intra) == want


def test_plan_mesh_after_rescale_names_item_6():
    with pytest.raises(NotImplementedError, match="item 6"):
        plan_mesh_after_rescale(4)


@pytest.mark.parametrize("dst_capacity", [1 << 9, 1 << 12])
def test_reshard_between_capacities(tmp_path, dst_capacity):
    """`reshard` moves a trained state into a trainer of another capacity:
    every key's value row, optimizer slot row, freq and version bit for
    bit, the dense parameters and the step equal."""
    src, _ = _mk_trainer(capacity=1 << 10)
    st = src.init(0)
    gen = _batches(B=64, seed=9)
    for _ in range(3):
        st, _ = src.train_step(st, next(gen))
    dst, _ = _mk_trainer(capacity=dst_capacity)
    out = reshard(src, st, dst, scratch_dir=str(tmp_path / "scratch"))
    assert int(out.step) == int(st.step) == 3

    def rows(s):
        d = {}
        for bname, ts in s.tables.items():
            keys = ts.keys.numpy()
            for m in range(keys.shape[0]):
                for i in np.nonzero(keys[m] != SENTINEL)[0]:
                    d[(bname, m, int(keys[m, i]))] = (
                        ts.values[m, i].numpy().tobytes(),
                        ts.slots["accum"][m, i].numpy().tobytes(),
                        int(ts.meta[m, 0, i]), int(ts.meta[m, 1, i]))
        return d

    assert rows(out) == rows(st)
    for b in dst.bundles.values():
        assert out.tables[b.name].keys.shape[1] == dst_capacity
    for k in st.dense:
        assert torch.equal(out.dense[k], st.dense[k])
