"""The PyTorch port on its own (no jax in this file, so it also runs on the
CUDA machine): package isolation, the no-silent-CPU rule, and the CUDA
kernels against their plain versions (marked `cuda`; skip without a card):
the row gather, the pooled gather (#4) and the row scatter, the fused bag
step's forward and backward, and flash attention's forward and backward
(f32 and bf16)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port, and chip_smoke.py, load with jax and
    deeprec_tpu absent from sys.modules; the modules include BST's
    (ops.flash_attention, models.bst, models.taobao)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import deeprec_tpu_torch\n"
        "for m in pkgutil.walk_packages(deeprec_tpu_torch.__path__, 'deeprec_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "       or k == 'deeprec_tpu' or k.startswith('deeprec_tpu.')]\n"
        "assert not bad, bad\n"
        "print(' '.join(k for k in sys.modules if k.startswith('deeprec_tpu_torch')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = set(out.stdout.split())
    assert len(loaded) >= 33
    for name in ("ops.flash_attention", "models.bst", "models.taobao", "models.wdl",
                 "models.deepfm", "models.dcn", "models.masknet", "models.din"):
        assert f"deeprec_tpu_torch.{name}" in loaded, name


def test_entry_points_raise_without_cuda(monkeypatch):
    """No device and no CUDA: raise, never fall back to the CPU."""
    from deeprec_tpu_torch import resolve_device
    from deeprec_tpu_torch.models import DLRMDCN
    from deeprec_tpu_torch.optim import Adagrad
    from deeprec_tpu_torch.serving import Predictor
    from deeprec_tpu_torch.training.trainer import Trainer

    from deeprec_tpu_torch.config import TableConfig
    from deeprec_tpu_torch.embedding.table import EmbeddingTable

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = DLRMDCN(emb_dim=8, capacity=1 << 6, bottom=(8,), top=(4, 1),
                    num_cat=2, num_dense=2, cross_depth=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(model, os.path.join(ROOT, "does-not-exist"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(model, Adagrad(lr=0.05))
    for budget in ("auto", 64):  # the budgeted trainer
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(model, Adagrad(lr=0.05), unique_budget=budget)
    # the state the fused bag step (bag_forward, apply_bag_gradients) runs on
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EmbeddingTable(TableConfig(name="t", dim=8, capacity=64)).create(2)
    # BST with flash attention, through training and serving
    from deeprec_tpu_torch.models import BST
    bst = BST(emb_dim=4, capacity=1 << 6, heads=2, ff=8, max_len=8,
              use_flash=True, hidden=(4,))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(bst, Adagrad(lr=0.2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(bst, os.path.join(ROOT, "does-not-exist"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    st = EmbeddingTable(TableConfig(name="t", dim=8, capacity=64)).create(2, "cpu")
    assert st.values.device.type == "cpu" and st.dedup_overflow.shape == (2,)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,C,D,n", [(3, 1000, 128, 2048), (2, 64, 16, 37),
                                     (1, 50, 3, 1), (4, 33, 7, 129)])
def test_gather_rows_kernel_matches_plain(cuda_device, dtype, T, C, D, n):
    """Bit-exact against the plain version, with clamped indices, at
    16-, 4- and 2-byte copy widths, and a launch counted per call."""
    from deeprec_tpu_torch.ops.fused_lookup import gather_rows, gather_rows_plain

    g = torch.Generator(device="cpu").manual_seed(0)
    values = torch.randn((T, C, D), generator=g).to(cuda_device, dtype)
    ix = torch.randint(-5, C + 5, (T, n), generator=g, dtype=torch.int32)
    ix = ix.to(cuda_device)
    before = gather_rows.launches
    got = gather_rows(values, ix)
    torch.cuda.synchronize()
    assert gather_rows.launches == before + 1
    assert torch.equal(got, gather_rows_plain(values, ix))
    # a view into a stacked table (offset start) goes through the same kernel
    assert torch.equal(gather_rows(values[1:], ix[1:]),
                       gather_rows_plain(values[1:], ix[1:]))
    np.testing.assert_array_equal(got.shape, (T, n, D))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,C,D,U", [(3, 1000, 128, 512), (2, 64, 16, 37),
                                     (1, 50, 3, 1), (4, 33, 7, 20),
                                     (2, 4096, 1, 300)])
def test_apply_rows_sr_kernel_matches_plain(cuda_device, dtype, T, C, D, U):
    """The whole table after the write is bit-exact against the plain
    version given the same bits: skipped rows (-1 and past the end) touch
    nothing, unique slots per table, 16-byte vectors and the scalar tail,
    and one launch counted per call."""
    from deeprec_tpu_torch.ops.fused_lookup import (
        apply_rows_sr, apply_rows_sr_plain, sr_bits)

    g = torch.Generator(device="cpu").manual_seed(1)
    values = torch.randn((T, C, D), generator=g).to(dtype)
    slot = torch.stack([torch.randperm(C, generator=g)[:U] for _ in range(T)])
    slot = slot.to(torch.int32)
    skip = torch.rand((T, U), generator=g) < 0.1
    slot[skip] = -1
    slot[0, 0] = C + 3  # past the end: dropped
    rows = torch.randn((T, U, D), generator=g)
    bits = sr_bits(7, (T, U, D), "cpu")
    want = apply_rows_sr_plain(values.clone(), slot, rows, bits)
    got = values.to(cuda_device)
    before = apply_rows_sr.launches
    out = apply_rows_sr(got, slot.to(cuda_device), rows.to(cuda_device),
                        bits=bits.to(cuda_device))
    torch.cuda.synchronize()
    assert out is got and apply_rows_sr.launches == before + 1
    assert torch.equal(got.cpu(), want)
    # the device's own bits equal the host's for one seed
    assert torch.equal(sr_bits(7, (T, U, D), cuda_device).cpu(), bits)
    # a view into a stacked table (offset start) goes through the same kernel
    sub = values.to(cuda_device)
    apply_rows_sr(sub[1:], slot[1:].to(cuda_device), rows[1:].to(cuda_device),
                  bits=bits[1:].to(cuda_device))
    assert torch.equal(sub.cpu()[1:], apply_rows_sr_plain(
        values.clone()[1:], slot[1:], rows[1:], bits[1:]))


@pytest.mark.cuda
@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,D,B,L", [(4096, 128, 37, 100), (4096, 16, 2048, 1),
                                     (1000, 16, 64, 8), (500, 12, 33, 7),
                                     (500, 7, 33, 7), (100, 4, 5, 3), (100, 1, 9, 4),
                                     (300, 96, 40, 33)])
def test_fused_gather_combine_kernel_matches_plain(cuda_device, combiner, dtype, C, D,
                                                   B, L):
    """Kernel #4 bit-exact against its plain version on the card: 16- and
    8-byte vectors (D % 4 == 0) and the scalar path (D 7 and 1), 1 to 32
    lanes per bag, a bag of pads only, rows past the table clipped, pads
    read no row; one launch counted per call; a view into a stacked table
    (offset start) through the same kernel."""
    from deeprec_tpu_torch.ops.fused_lookup import (
        fused_gather_combine, fused_gather_combine_plain)

    g = torch.Generator(device="cpu").manual_seed(5)
    values = torch.randn((2, C, D), generator=g).to(dtype)
    row_ix = torch.randint(-1, C + 3, (B, L), generator=g, dtype=torch.int32)
    row_ix[min(1, B - 1)] = -1
    n = (row_ix >= 0).sum(1, keepdim=True).clamp(min=1).float()
    w = {"sum": torch.ones_like(n), "mean": 1.0 / n, "sqrtn": 1.0 / n.sqrt()}[combiner]
    w = w.expand(B, L).contiguous()
    values, row_ix, w = values.to(cuda_device), row_ix.to(cuda_device), w.to(cuda_device)
    for v in (values[0], values[1]):
        before = fused_gather_combine.launches
        got = fused_gather_combine(v, row_ix, w)
        torch.cuda.synchronize()
        assert fused_gather_combine.launches == before + 1
        assert got.dtype == torch.float32 and got.shape == (B, D)
        assert torch.equal(got, fused_gather_combine_plain(v, row_ix, w))
        assert bool((got[min(1, B - 1)] == 0).all())


def _bag_ids(g, T, B, L, vocab, pad=0.1, head=False):
    """Zipf-like row ids (the square of a uniform favours small ids) with
    about `pad` of the positions padded (-1); `head`: one id in every
    position instead (a slot of B * L positions)."""
    if head:
        return torch.full((T, B, L), 7, dtype=torch.int32)
    u = torch.rand((T, B, L), generator=g)
    ids = (u * u * vocab).to(torch.int32)
    return torch.where(torch.rand((T, B, L), generator=g) < pad, -1, ids)


def _multisets(res, t):
    return sorted(zip(res.uids[t].cpu().tolist(), res.counts[t].cpu().tolist()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,C,D,B,L,budget,head", [
    (1, 4096, 128, 256, 100, None, False), (3, 500, 96, 32, 4, None, False),
    (2, 100, 1, 16, 3, None, False), (11, 1000, 128, 64, 1, None, False),
    (2, 1000, 128, 64, 8, 40, False), (1, 4096, 128, 2048, 100, None, True)])
def test_fused_sparse_forward_kernel_matches_plain(cuda_device, dtype, T, C, D,
                                                   B, L, budget, head):
    """`out` bit-exact; uids/counts as multisets per table (the kernel ranks
    in claim order, the plain version in scratch-slot order) without
    overflow; overflow counts equal; uids[inverse] rebuilds every budgeted
    position; one launch counted per call. The last case puts one id in
    every position of a 2048 x 100 bag matrix."""
    from deeprec_tpu_torch.ops import fused_lookup as fl
    from deeprec_tpu_torch.ops.dedup import resolve_size

    g = torch.Generator(device="cpu").manual_seed(2)
    values = torch.randn((T, C, D), generator=g).to(cuda_device, dtype)
    ids = _bag_ids(g, T, B, L, C, head=head).to(cuda_device)
    U = resolve_size(B * L if budget is None else budget, B * L)
    for combiner in ("sum", "mean"):
        before = fl.fused_sparse_forward.launches
        got = fl.fused_sparse_forward(values, ids, combiner=combiner, unique_size=U)
        torch.cuda.synchronize()
        assert fl.fused_sparse_forward.launches == before + 1
        want = fl.fused_sparse_forward_plain(values, ids, combiner=combiner,
                                             unique_size=U)
        assert torch.equal(got.overflow, want.overflow)
        flat = ids.reshape(T, -1).long()
        inv = got.inverse.reshape(T, -1).long()
        rebuilt = got.uids.long().gather(1, inv)
        assert torch.equal(rebuilt[inv > 0], flat[inv > 0])
        assert bool((got.uids[:, 0] == -1).all()) and bool((got.counts[:, 0] == 0).all())
        if budget is None:
            assert torch.equal(got.out, want.out)
            for t in range(T):
                assert _multisets(got, t) == _multisets(want, t)
        else:  # out-of-budget positions add nothing
            assert int(got.overflow.min()) > 0
            rows = values.float()[torch.arange(T, device=cuda_device)[:, None],
                                  flat.clamp(0, C - 1)]
            rows = torch.where((inv > 0)[..., None], rows, 0.0).view(T, B, L, D)
            want_sum = torch.zeros((T, B, D), device=cuda_device)
            for pos in range(L):
                want_sum = want_sum + rows[:, :, pos]
            if combiner == "sum":
                assert torch.equal(got.out, want_sum)


def _backward_state(opt, g, T, C, D, dtype, device):
    values = torch.randn((T, C, D), generator=g).to(device, dtype)
    slots = {n: torch.full((T, C, D), init, device=device)
             for n, (_, init) in opt.slot_specs(D).items()}
    return values, slots


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("opt_name,kw", [
    ("sgd", {}), ("adagrad", {}), ("adam", {}), ("adamw", {}), ("ftrl", {}),
    ("ftrl", {"learning_rate_power": -0.3, "l1": 0.001, "l2": 0.01})])
@pytest.mark.parametrize("T,C,D,B,L,head", [
    (2, 2000, 128, 128, 20, False), (3, 300, 96, 16, 3, False), (1, 64, 1, 8, 5, False),
    (1, 64, 128, 256, 50, False), (1, 4096, 128, 2048, 100, True)])
def test_fused_sparse_backward_kernel_matches_plain(cuda_device, dtype, opt_name,
                                                    kw, T, C, D, B, L, head):
    """The whole table and every slot after the step, bit-exact against the
    plain version on the card (the kernel's three-level summation order —
    the fourth shape gives one row some 1,600 positions, 50 chunks in 7
    runs; the last puts one id in all 204,800 positions of a 2048 x 100 bag
    matrix, a region past the CTA's shared memory — the same scalar
    factors, torch.pow's special exponents and powf otherwise); the
    sentinel and untouched rows unchanged; one launch counted per call."""
    from deeprec_tpu_torch.ops import fused_lookup as fl
    from deeprec_tpu_torch.ops.dedup import resolve_size
    from deeprec_tpu_torch.optim.sparse import REGISTRY

    opt = REGISTRY[opt_name](lr=0.05, **kw)
    g = torch.Generator(device="cpu").manual_seed(3)
    values, slots = _backward_state(opt, g, T, C, D, dtype, cuda_device)
    ids = _bag_ids(g, T, B, L, C, head=head).to(cuda_device)
    res = fl.fused_sparse_forward(values, ids, combiner="mean",
                                  unique_size=resolve_size(B * L, B * L))
    grad = torch.randn((T, B, D), generator=g).to(cuda_device)
    for averaging in (False, True):
        kv, ks = values.clone(), {n: s.clone() for n, s in slots.items()}
        pv, ps = values.clone(), {n: s.clone() for n, s in slots.items()}
        before = fl.fused_sparse_backward.launches
        fl.fused_sparse_backward(kv, ks, grad, ids, res, opt, combiner="mean",
                                 step=4, seed=4, grad_averaging=averaging)
        torch.cuda.synchronize()
        assert fl.fused_sparse_backward.launches == before + 1
        fl.fused_sparse_backward_plain(pv, ps, grad, ids, res, opt, combiner="mean",
                                       step=4, seed=4, grad_averaging=averaging)
        assert torch.equal(kv, pv)
        for n in slots:
            assert torch.equal(ks[n], ps[n]), n
        touched = torch.zeros((T, C), dtype=torch.bool, device=cuda_device)
        ok = res.uids >= 0
        touched[torch.arange(T, device=cuda_device)[:, None].expand_as(ok)[ok],
                res.uids[ok].long()] = True
        assert torch.equal(kv[~touched], values[~touched])
        # (averaged over 204,800 positions, the head row's step can fall
        # below half a bf16 ulp everywhere)
        if not (head and averaging):
            assert bool((kv[touched] != values[touched]).any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_sparse_backward_kernel_is_deterministic(cuda_device, dtype):
    """Two #7 calls on copies give the same bits, though the placement's
    atomics order each slot's positions differently from run to run:
    zipf bags of L = 100 whose head rows span many runs."""
    from deeprec_tpu_torch.ops import fused_lookup as fl
    from deeprec_tpu_torch.ops.dedup import resolve_size
    from deeprec_tpu_torch.optim.sparse import REGISTRY

    opt = REGISTRY["adagrad"](lr=0.05)
    g = torch.Generator(device="cpu").manual_seed(8)
    T, C, D, B, L = 2, 4096, 128, 2048, 100
    values, slots = _backward_state(opt, g, T, C, D, dtype, cuda_device)
    ids = _bag_ids(g, T, B, L, C).to(cuda_device)
    res = fl.fused_sparse_forward(values, ids, combiner="sum",
                                  unique_size=resolve_size(B * L, B * L))
    assert int(res.counts.max()) > 8 * 32
    grad = torch.randn((T, B, D), generator=g).to(cuda_device)
    outs = []
    for _ in range(2):
        v, s = values.clone(), {n: x.clone() for n, x in slots.items()}
        fl.fused_sparse_backward(v, s, grad, ids, res, opt, combiner="sum", step=1,
                                 seed=1)
        torch.cuda.synchronize()
        outs.append((v, s))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1]["accum"], outs[1][1]["accum"])


def _device_ops(fn, calls=20):
    """Device operations (kernels, memsets, copies) per call of fn, by
    torch.profiler over `calls` calls after a warm one, rounded; the larger
    of two windows (a window can lose an event)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    most = 0
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        most = max(most, sum(e.count for e in prof.key_averages()
                             if getattr(e, "device_type", None) == DeviceType.CUDA))
    return round(most / calls)


@pytest.mark.cuda
@pytest.mark.parametrize("T,L", [(1, 100), (10, 1)])
def test_fused_step_device_ops_per_call(cuda_device, T, L):
    """At most 3 device operations per #6 call (the memset and two
    launches) and 5 per #7 call under Adagrad (lr's fill, the scalar
    vector's stack and three launches), combiner "sum", at the L = 100 and
    L = 1 groups' shapes of the fused bag step (batch 2048)."""
    from deeprec_tpu_torch.ops import fused_lookup as fl
    from deeprec_tpu_torch.ops.dedup import resolve_size
    from deeprec_tpu_torch.optim.sparse import REGISTRY

    opt = REGISTRY["adagrad"](lr=0.05)
    g = torch.Generator(device="cpu").manual_seed(9)
    C, D, B = 1 << 16, 128, 2048
    values, slots = _backward_state(opt, g, T, C, D, torch.float32, cuda_device)
    ids = _bag_ids(g, T, B, L, C).to(cuda_device)
    U = resolve_size(B * L, B * L)
    res = fl.fused_sparse_forward(values, ids, combiner="sum", unique_size=U)
    grad = res.out * 0.25 + 1.0
    fwd = _device_ops(lambda: fl.fused_sparse_forward(values, ids, combiner="sum",
                                                      unique_size=U))
    bwd = _device_ops(lambda: fl.fused_sparse_backward(values, slots, grad, ids, res,
                                                       opt, combiner="sum", step=1))
    assert fwd <= 3, fwd
    assert bwd <= 5, bwd


# Flash attention (#8, #9) on the card: not bit-exact with the plain version
# (expf is not torch.exp, and the sums run in another order), so o and lse
# are held within 1e-5 * max(1, |plain|) and dq, dk, dv within 1e-4 of the
# largest |plain| gradient of the tensor.
FLASH_FWD_RTOL, FLASH_GRAD_TOL = 1e-5, 1e-4


def _flash_inputs(g, B, H, Lq, S, D, dead, device):
    q = torch.randn((B, H, Lq, D), generator=g)
    k, v = (torch.randn((B, H, S, D), generator=g) for _ in range(2))
    do = torch.randn((B, H, Lq, D), generator=g)
    lengths = torch.randint(S // 2, S + 1, (B,), generator=g)
    mask = torch.arange(S)[None, :] < lengths[:, None]
    if dead:  # batch 0 sees no key; batch 1's first 64 keys are masked
        mask[0] = False
        if B > 1:
            mask[1, :64] = False
    return [t.to(device) for t in (q, k, v, mask, do)]


def _assert_flash_close(got, want, name, grad):
    if grad:
        tol = FLASH_GRAD_TOL * max(float(want.abs().max()), 1e-30)
        err = float((got - want).abs().max())
        assert err <= tol, f"{name}: max err {err} above {tol}"
    else:
        bound = FLASH_FWD_RTOL * torch.clamp(want.abs(), min=1.0)
        assert bool(((got - want).abs() <= bound).all()), (
            f"{name}: max err {float((got - want).abs().max())}")


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("B,H,Lq,S,D,block_q,block_k,dead", [
    (4, 4, 256, 256, 8, 128, 128, False),   # BST's head width, two tiles
    (2, 2, 256, 256, 32, 64, 64, False),    # tests/test_attention.py
    (2, 2, 256, 256, 32, 128, 128, False),
    (3, 2, 256, 256, 16, 64, 64, True),     # dead rows
    (2, 1, 128, 256, 64, 64, 128, False),   # Lq != S, mixed blocks
    (1, 3, 64, 192, 3, 32, 64, True),       # a padded head width, 64 rows
    (1, 2, 128, 128, 128, 128, 32, False),  # the widest head
])
def test_flash_kernels_match_plain(cuda_device, causal, B, H, Lq, S, D, block_q,
                                   block_k, dead):
    """Kernel #8 (o, lse) and kernel #9 (dq, dk, dv, from the plain
    forward's o and lse) against their plain versions on the card; dead
    rows' gradients exactly 0; one launch of each counted per call."""
    from deeprec_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cpu").manual_seed(11)
    q, k, v, mask, do = _flash_inputs(g, B, H, Lq, S, D, dead, cuda_device)
    scale = 1.0 / D ** 0.5
    before = (fa.flash_forward.launches, fa.flash_backward.launches_dkdv,
              fa.flash_backward.launches_dq)
    o, lse = fa.flash_forward(q, k, v, mask, causal, scale, block_q, block_k)
    po, plse = fa.flash_forward_plain(q, k, v, mask, causal, scale, block_q, block_k)
    torch.cuda.synchronize()
    _assert_flash_close(o, po, "o", False)
    _assert_flash_close(lse, plse, "lse", False)
    got = fa.flash_backward(q, k, v, mask, causal, scale, block_q, block_k, po,
                            plse, do)
    want = fa.flash_backward_plain(q, k, v, mask, causal, scale, block_q, block_k,
                                   po, plse, do)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == torch.float32
        _assert_flash_close(a, b, name, True)
    assert (fa.flash_forward.launches, fa.flash_backward.launches_dkdv,
            fa.flash_backward.launches_dq) == tuple(n + 1 for n in before)
    if dead:
        assert bool((got[0][0] == 0).all() and (got[1][0] == 0).all()
                    and (got[2][0] == 0).all())
        assert bool((lse[0] == -1e30).all())


@pytest.mark.cuda
def test_flash_attention_autograd_on_card(cuda_device):
    """FlashAttention's gradient on the card against the plain versions'
    on the CPU, through torch.autograd.grad."""
    from deeprec_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cpu").manual_seed(12)
    q, k, v, mask, _ = _flash_inputs(g, 2, 2, 128, 128, 16, False, "cpu")
    grads = {}
    for dev in ("cpu", cuda_device):
        leaves = [t.to(dev).requires_grad_(True) for t in (q, k, v)]
        out = fa.flash_attention(*leaves, mask.to(dev), True, None, 64, 64)
        grads[str(dev)] = [x.cpu() for x in torch.autograd.grad((out ** 2).sum(), leaves)]
    for name, a, b in zip("qkv", grads[str(cuda_device)], grads["cpu"]):
        _assert_flash_close(a, b, f"d{name}", True)


def _bf16_ulp(x):
    """One bf16 ulp of each element of x (8 significant bits), 0 at 0."""
    a = x.abs().double()
    e = torch.floor(torch.log2(torch.where(a > 0, a, torch.ones_like(a))))
    return torch.where(a > 0, torch.exp2(e - 7), torch.zeros_like(a))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernels_bf16_match_plain(cuda_device, causal):
    """bf16 q, k, v, do at [2, 2, 256, 32]: o, dq, dk and dv come back in
    bf16, lse in f32, each within its f32 tolerance plus one bf16 ulp of
    the plain value (a sum in another order can round to the neighbour)."""
    from deeprec_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cpu").manual_seed(13)
    q, k, v, mask, do = _flash_inputs(g, 2, 2, 256, 256, 32, False, cuda_device)
    q, k, v, do = (t.to(torch.bfloat16) for t in (q, k, v, do))
    scale = 1.0 / 32 ** 0.5
    o, lse = fa.flash_forward(q, k, v, mask, causal, scale, 64, 64)
    po, plse = fa.flash_forward_plain(q, k, v, mask, causal, scale, 64, 64)
    got = fa.flash_backward(q, k, v, mask, causal, scale, 64, 64, po, plse, do)
    want = fa.flash_backward_plain(q, k, v, mask, causal, scale, 64, 64, po, plse, do)
    torch.cuda.synchronize()
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    _assert_flash_close(lse, plse, "lse", False)
    tol = FLASH_FWD_RTOL * torch.clamp(po.double().abs(), min=1.0) + _bf16_ulp(po)
    assert bool(((o.double() - po.double()).abs() <= tol).all()), "o"
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16, name
        tol = FLASH_GRAD_TOL * float(b.double().abs().max()) + _bf16_ulp(b)
        assert bool(((a.double() - b.double()).abs() <= tol).all()), name
