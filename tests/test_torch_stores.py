"""The port's feature stores (deeprec_tpu_torch/serving/resp_store.py and
remote_store.py) held against the JAX package, case for case with
tests/test_resp_store.py over a scripted RESP server (socket level: no
redis dependency, the bytes on the wire are the spec), plus the remote KV
round trip of tests/test_serving.py. Across packages: the same command
bytes, rows written by either package's store read by the other's, a JAX
RemoteKVClient against the port's RemoteKVServer and the other way round,
and both stores behind the port's `Predictor(stores=)` on a JAX-trained
checkpoint.

Reference contract being pinned (redis_feature_store.cc):
  * binary row keys: LE u64 model_version ++ LE u64 feature2id ++ LE i64 id
  * raw-f32 row values, MGET/MSET batches, nil => missing
  * literal metadata commands: GET/SET model_version ("full,latest"),
    GET/SET active, SET model_lock <v> ex <t> nx
"""
import socketserver
import struct
import threading

import numpy as np
import pytest
import torch

from deeprec_tpu.serving import resp_store as jax_resp
from deeprec_tpu_torch.serving.resp_store import (
    RedisFeatureStore,
    RespConnection,
    RespError,
    encode_command,
)

torch.set_num_threads(1)


class FakeRedis:
    """In-memory RESP server: AUTH/SELECT/GET/SET[ex/nx]/MGET/MSET/DEL —
    the command subset the feature store uses."""

    def __init__(self, password=None):
        self.data = {}
        self.password = password
        self.commands = []  # uppercased command names, in arrival order
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                authed = outer.password is None
                while True:
                    try:
                        args = outer._read_command(self.rfile)
                    except (ConnectionError, ValueError):
                        return
                    if args is None:
                        return
                    cmd = args[0].upper().decode()
                    outer.commands.append(cmd)
                    if cmd == "AUTH":
                        if args[1].decode() == (outer.password or ""):
                            authed = True
                            self.wfile.write(b"+OK\r\n")
                        else:
                            self.wfile.write(b"-ERR invalid password\r\n")
                    elif not authed:
                        self.wfile.write(b"-NOAUTH Authentication required.\r\n")
                    elif cmd == "SELECT":
                        self.wfile.write(b"+OK\r\n")
                    elif cmd == "GET":
                        v = outer.data.get(args[1])
                        self.wfile.write(outer._bulk(v))
                    elif cmd == "SET":
                        key, val = args[1], args[2]
                        opts = [a.upper() for a in args[3:]]
                        if b"NX" in opts and key in outer.data:
                            self.wfile.write(b"$-1\r\n")  # nil: not set
                        else:
                            outer.data[key] = val
                            self.wfile.write(b"+OK\r\n")
                    elif cmd == "MGET":
                        out = b"*%d\r\n" % (len(args) - 1)
                        for k in args[1:]:
                            out += outer._bulk(outer.data.get(k))
                        self.wfile.write(out)
                    elif cmd == "MSET":
                        for i in range(1, len(args) - 1, 2):
                            outer.data[args[i]] = args[i + 1]
                        self.wfile.write(b"+OK\r\n")
                    elif cmd == "DEL":
                        n = 0
                        for k in args[1:]:
                            n += 1 if outer.data.pop(k, None) is not None else 0
                        self.wfile.write(b":%d\r\n" % n)
                    else:
                        self.wfile.write(b"-ERR unknown command\r\n")
                    self.wfile.flush()

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._srv = Server(("127.0.0.1", 0), Handler)
        self.port = self._srv.server_address[1]
        threading.Thread(target=self._srv.serve_forever, daemon=True).start()

    @staticmethod
    def _bulk(v):
        return b"$-1\r\n" if v is None else b"$%d\r\n%s\r\n" % (len(v), v)

    @staticmethod
    def _read_command(rfile):
        line = rfile.readline()
        if not line:
            return None
        if not line.startswith(b"*"):
            raise ValueError(f"inline commands unsupported: {line!r}")
        n = int(line[1:].strip())
        args = []
        for _ in range(n):
            hdr = rfile.readline()
            if not hdr.startswith(b"$"):
                raise ValueError(f"expected bulk string, got {hdr!r}")
            ln = int(hdr[1:].strip())
            data = rfile.read(ln)
            rfile.read(2)  # CRLF
            if len(data) != ln:
                raise ConnectionError("short read")
            args.append(data)
        return args

    def stop(self):
        self._srv.shutdown()
        self._srv.server_close()


def test_encode_command_resp_bytes():
    assert encode_command(b"GET", b"k") == b"*2\r\n$3\r\nGET\r\n$1\r\nk\r\n"
    assert encode_command("SET", "k", 12) == (
        b"*3\r\n$3\r\nSET\r\n$1\r\nk\r\n$2\r\n12\r\n"
    )
    for args in ((b"MGET", b"a", b"\x00\xff"), ("SET", "model_lock", 3, "EX", 30, "NX"),
                 (b"MSET", struct.pack("<QQq", 1, 2, -3), np.ones(2, np.float32).tobytes())):
        assert encode_command(*args) == jax_resp.encode_command(*args)


def test_connection_roundtrip_and_pipeline():
    srv = FakeRedis()
    try:
        c = RespConnection("127.0.0.1", srv.port)
        assert c.command(b"SET", b"a", b"1") == b"OK"
        assert c.command(b"GET", b"a") == b"1"
        assert c.command(b"GET", b"missing") is None
        replies = c.pipeline([
            (b"SET", b"b", b"2"), (b"GET", b"b"), (b"DEL", b"b"),
            (b"GET", b"b"),
        ])
        assert replies == [b"OK", b"2", 1, None]
        with pytest.raises(RespError, match="unknown"):
            c.command(b"NOSUCH")
        c.close()
    finally:
        srv.stop()


def test_auth_and_select_on_connect():
    srv = FakeRedis(password="sekrit")
    try:
        good = RespConnection("127.0.0.1", srv.port, password="sekrit", db=3)
        assert good.command(b"SET", b"x", b"y") == b"OK"
        # AUTH and SELECT happened before the first user command
        assert srv.commands[:2] == ["AUTH", "SELECT"]
        good.close()

        bad = RespConnection("127.0.0.1", srv.port, password="wrong")
        with pytest.raises(RespError, match="invalid password"):
            bad.command(b"GET", b"x")
        bad.close()
    finally:
        srv.stop()


def test_store_put_get_reference_key_scheme():
    """Rows land under the reference's exact binary key layout and read
    back with a correct found mask."""
    srv = FakeRedis()
    try:
        store = RedisFeatureStore("127.0.0.1", srv.port, dim=4,
                                  model_version=7, feature2id=3)
        keys = np.asarray([5, -2, 1 << 40], np.int64)
        rows = np.arange(12, dtype=np.float32).reshape(3, 4)
        store.put(keys, rows)

        # the wire keys are memcpy(model_version) ++ memcpy(feature2id)
        # ++ memcpy(key) — exactly what redis_feature_store.cc builds
        want_key = struct.pack("<QQq", 7, 3, 5)
        assert want_key in srv.data
        assert srv.data[want_key] == rows[0].tobytes()

        vals, freqs, vers, found = store.get(
            np.asarray([5, 99, -2, 1 << 40], np.int64)
        )
        assert found.tolist() == [True, False, True, True]
        np.testing.assert_array_equal(vals[0], rows[0])
        np.testing.assert_array_equal(vals[2], rows[1])
        np.testing.assert_array_equal(vals[3], rows[2])
        np.testing.assert_array_equal(vals[1], 0.0)
        assert freqs.tolist() == [0, 0, 0, 0] and vers.tolist() == [0, 0, 0, 0]

        # a different model_version namespace misses
        other = RedisFeatureStore("127.0.0.1", srv.port, dim=4,
                                  model_version=8, feature2id=3,
                                  conn=store.conn)
        _, _, _, found2 = other.get(keys)
        assert not found2.any()
        # the JAX package's store reads the port's rows, and the other way
        jstore = jax_resp.RedisFeatureStore("127.0.0.1", srv.port, dim=4,
                                            model_version=7, feature2id=3)
        jvals, _, _, jfound = jstore.get(np.asarray([5, 99, -2, 1 << 40], np.int64))
        np.testing.assert_array_equal(jfound, found)
        np.testing.assert_array_equal(jvals, vals)
        jstore.put(np.asarray([77], np.int64), np.full((1, 4), 0.5, np.float32))
        v77, _, _, f77 = store.get(np.asarray([77], np.int64))
        assert f77.tolist() == [True] and (v77 == 0.5).all()
        jstore.close()
        assert store.delete(np.asarray([77], np.int64)) == 1
        assert store.delete(keys) == 3
        store.close()
    finally:
        srv.stop()


def test_store_dim_mismatch_is_loud():
    srv = FakeRedis()
    try:
        w = RedisFeatureStore("127.0.0.1", srv.port, dim=8)
        w.put(np.asarray([1], np.int64), np.ones((1, 8), np.float32))
        r = RedisFeatureStore("127.0.0.1", srv.port, dim=4, conn=w.conn)
        with pytest.raises(ConnectionError, match="dim mismatch"):
            r.get(np.asarray([1], np.int64))
        w.close()
    finally:
        srv.stop()


def test_store_metadata_commands():
    """model_version / active / lock: the literal reference commands."""
    srv = FakeRedis()
    try:
        store = RedisFeatureStore("127.0.0.1", srv.port, dim=2)
        assert store.get_model_version() == (-1, -1)
        store.set_model_version(41, 42)
        assert srv.data[b"model_version"] == b"41,42"
        assert store.get_model_version() == (41, 42)

        assert store.get_active() is False
        store.set_active(True)
        assert store.get_active() is True
        assert srv.data[b"active"] == b"1"

        assert store.acquire_lock(1, 30) is True
        assert store.acquire_lock(2, 30) is False  # NX: already held
        store.release_lock()
        assert store.acquire_lock(2, 30) is True
        store.close()
    finally:
        srv.stop()


@pytest.fixture(scope="module")
def wdl_ckpt(tmp_path_factory):
    """A JAX-trained WDL checkpoint (3 steps) and a request batch."""
    import jax.numpy as jnp
    import optax

    from deeprec_tpu.data import SyntheticCriteo
    from deeprec_tpu.models import WDL
    from deeprec_tpu.optim import Adagrad
    from deeprec_tpu.training import Trainer
    from deeprec_tpu.training.checkpoint import CheckpointManager

    kw = dict(emb_dim=8, capacity=1 << 12, hidden=(32,), num_cat=4, num_dense=2)
    tr = Trainer(WDL(**kw), Adagrad(lr=0.1), optax.adam(1e-3))
    st = tr.init(0)
    gen = SyntheticCriteo(batch_size=64, num_cat=4, num_dense=2, vocab=500, seed=3)
    batch = {k: jnp.asarray(v) for k, v in gen.batch().items()}
    for _ in range(3):
        st, _ = tr.train_step(st, batch)
    d = tmp_path_factory.mktemp("stores")
    CheckpointManager(str(d), tr).save(st)
    tname = sorted(tr.tables)[0]
    req = {k: np.asarray(v) for k, v in batch.items() if not k.startswith("label")}
    return str(d), kw, tname, tr.tables[tname].cfg.dim, req


def _predictor(ckpt, kw, stores=None):
    from deeprec_tpu_torch.models import WDL
    from deeprec_tpu_torch.serving import Predictor

    return Predictor(WDL(**kw), ckpt, stores=stores, device="cpu")


def test_predictor_read_through_via_resp(wdl_ckpt):
    """A Redis-protocol store plugs into the port's Predictor(stores=) like
    RemoteKVClient: a key missing from the table serves the Redis row, which
    the JAX store wrote; answers equal a Predictor over an in-process store
    holding the same row."""
    from deeprec_tpu_torch.native import HostKV

    ckpt, kw, tname, dim, batch = wdl_ckpt
    srv = FakeRedis()
    try:
        jstore = jax_resp.RedisFeatureStore("127.0.0.1", srv.port, dim=dim)
        novel = 999_999
        jstore.put(np.asarray([novel], np.int64), np.full((1, dim), 2.5, np.float32))
        store = RedisFeatureStore("127.0.0.1", srv.port, dim=dim)
        req = dict(batch)
        req[tname] = np.full_like(req[tname], novel)
        out_plain = _predictor(ckpt, kw).predict(req)
        out_store = _predictor(ckpt, kw, {tname: store}).predict(req)
        assert np.abs(np.asarray(out_store) - np.asarray(out_plain)).max() > 1e-6
        kv = HostKV(dim=dim, initial_capacity=64)
        kv.put(np.asarray([novel], np.int64), np.full((1, dim), 2.5, np.float32))
        np.testing.assert_array_equal(out_store, _predictor(ckpt, kw, {tname: kv}).predict(req))
        store.close()
        jstore.close()
    finally:
        srv.stop()


def test_remote_store_predictor_fallback(wdl_ckpt):
    """The remote KV round trip (tests/test_serving.py's case): rows served
    over the network by the port's RemoteKVServer over the native HostKV
    change predictions exactly like an in-process store; the JAX client
    reads the port's server and the port's client the JAX server."""
    from deeprec_tpu.native import HostKV as JaxHostKV
    from deeprec_tpu.serving import RemoteKVClient as JaxClient
    from deeprec_tpu.serving import RemoteKVServer as JaxKVServer
    from deeprec_tpu_torch.native import HostKV
    from deeprec_tpu_torch.serving import RemoteKVClient, RemoteKVServer

    ckpt, kw, tname, dim, req = wdl_ckpt
    srv = RemoteKVServer(HostKV(dim=dim, initial_capacity=64), dim=dim).start()
    jsrv = JaxKVServer(JaxHostKV(dim=dim, initial_capacity=64), dim=dim).start()
    try:
        client = RemoteKVClient("127.0.0.1", srv.port, dim=dim)
        novel = 424242
        client.put(np.asarray([novel], np.int64), np.full((1, dim), 1.75, np.float32))
        vals, _, _, found = client.get(np.asarray([novel, 77], np.int64))
        assert found.tolist() == [True, False]
        np.testing.assert_allclose(vals[0], 1.75)
        jclient = JaxClient("127.0.0.1", srv.port, dim=dim)
        jvals, jfreq, jver, jfound = jclient.get(np.asarray([novel, 77], np.int64))
        got = client.get(np.asarray([novel, 77], np.int64))
        for a, b in zip(got, (jvals, jfreq, jver, jfound)):
            np.testing.assert_array_equal(a, b)
        jclient.close()
        c2 = RemoteKVClient("127.0.0.1", jsrv.port, dim=dim)
        c2.put(np.asarray([5], np.int64), np.full((1, dim), -1.0, np.float32))
        v5, _, _, f5 = JaxClient("127.0.0.1", jsrv.port, dim=dim).get(np.asarray([5], np.int64))
        assert f5.tolist() == [True] and (v5 == -1.0).all()
        c2.close()

        p_remote = _predictor(ckpt, kw, {tname: client})
        p_plain = _predictor(ckpt, kw)
        req_novel = dict(req)
        req_novel[tname] = np.full_like(req[tname], novel)
        out_r = p_remote.predict(req_novel)
        assert np.abs(np.asarray(out_r) - np.asarray(p_plain.predict(req_novel))).max() > 1e-6
        np.testing.assert_allclose(np.asarray(p_remote.predict(req)),
                                   np.asarray(p_plain.predict(req)), atol=1e-6)
        client.close()
    finally:
        srv.stop()
        jsrv.stop()
