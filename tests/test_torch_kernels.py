"""The PyTorch port on its own (no jax in this file, so it also runs on the
CUDA machine): package isolation, the no-silent-CPU rule, and the CUDA
row-gather and row-scatter kernels against their plain versions (marked
`cuda`; skip without a card)."""
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
    deeprec_tpu absent from sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import deeprec_tpu_torch\n"
        "for m in pkgutil.walk_packages(deeprec_tpu_torch.__path__, 'deeprec_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "       or k == 'deeprec_tpu' or k.startswith('deeprec_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('deeprec_tpu_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 29


def test_entry_points_raise_without_cuda(monkeypatch):
    """No device and no CUDA: raise, never fall back to the CPU."""
    from deeprec_tpu_torch import resolve_device
    from deeprec_tpu_torch.models import DLRMDCN
    from deeprec_tpu_torch.optim import Adagrad
    from deeprec_tpu_torch.serving import Predictor
    from deeprec_tpu_torch.training.trainer import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = DLRMDCN(emb_dim=8, capacity=1 << 6, bottom=(8,), top=(4, 1),
                    num_cat=2, num_dense=2, cross_depth=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(model, os.path.join(ROOT, "does-not-exist"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(model, Adagrad(lr=0.05))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


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
