"""The port's CUDA kernels on the card: each against its plain version.

This file imports no JAX, so it also runs on a machine with a card and no
JAX, where ``tests/conftest.py`` (which imports JAX) is skipped:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Without a CUDA device every test skips.  The plain versions are themselves
held Δ=0 against the JAX package by the other ``tests/test_torch_*.py``.
"""

import numpy as np
import pytest
import torch

import qublas_tpu_torch as qt
from qublas_tpu_torch.ops.fused_gemm import (fused_int8_gemm,
                                             fused_int8_gemm_plain)
from qublas_tpu_torch.ops.tree_gemm import (plan_tree, tree_gemm,
                                            tree_gemm_plain)

pytestmark = pytest.mark.cuda

FA, WIDE, MID = qt.pipeline_formats()
F88Z = qt.qformat(8, 8, overflow_mode=qt.OverflowMode.SAT_ZERO)
LAYERS = (qt.qformat(9, 6, round_mode=qt.RoundMode.RND_CONV),
          qt.qformat(10, 4))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _raws(seed, fmt, shape, dtype):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(
        rng.randint(fmt.raw_min, fmt.raw_max + 1, size=shape).astype(dtype))


@pytest.mark.parametrize("m,k,n,dtype", [
    (256, 512, 256, np.int8), (1000, 777, 1003, np.int8), (1, 1, 1, np.int8),
    (130, 16, 129, np.int8), (70, 96, 50, np.int16), (33, 300, 17, np.int32)])
def test_k1_matches_plain(cuda, m, k, n, dtype):
    f = FA if dtype == np.int8 else qt.qformat(7, 4)
    a = _raws(m, f, (m, k), dtype).to(cuda)
    b = _raws(n, f, (k, n), dtype).to(cuda)
    for out in (MID, qt.qformat(3, 2, round_mode=qt.RoundMode.RND_CONV),
                qt.qformat(2, 1, False, qt.RoundMode.RND_ZERO,
                           qt.OverflowMode.WRP_TCPL),
                qt.qformat(8, 10)):
        got = fused_int8_gemm(a, b, 8, out)
        want = fused_int8_gemm_plain(a, b, 8, out)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype
        assert torch.equal(got, want), (m, k, n, out)


@pytest.mark.parametrize("m,k,n,layers", [
    (128, 512, 128, ()), (77, 1000, 45, ()), (33, 13, 17, ()),
    (128, 128, 128, LAYERS), (5, 1, 3, ()), (40, 96, 300, LAYERS)])
def test_k2_matches_plain(cuda, m, k, n, layers):
    a = _raws(m + k, F88Z, (m, k), np.int32).to(cuda)
    b = _raws(n + k, F88Z, (k, n), np.int32).to(cuda)
    plan = plan_tree(F88Z, F88Z, qt.mul_merge(F88Z, F88Z), layers, k, F88Z)
    got = tree_gemm(a, b, plan, F88Z)
    want = tree_gemm_plain(a, b, plan, F88Z)
    torch.cuda.synchronize()
    assert torch.equal(got, want), (m, k, n, layers)


def test_main_path_matches_cpu_and_counts_launches(cuda):
    """The main path on the card equals the same calls on CPU tensors (the
    plain versions), and launches K1 twice and K2 once."""
    x = _raws(0, FA, (256, 256), np.int8)
    w1 = _raws(1, FA, (256, 256), np.int8).numpy()
    w2 = _raws(2, FA, (256, 128), np.int8).numpy()
    a = qt.from_raw(_raws(3, F88Z, (64, 100), np.int32).numpy(), F88Z, "cpu")
    b = qt.from_raw(_raws(4, F88Z, (100, 48), np.int32).numpy(), F88Z, "cpu")
    pipe_gpu = qt.QuantPipeline.from_numpy(w1, w2, cuda)
    fused_int8_gemm.launches = 0
    tree_gemm.launches = 0
    y = pipe_gpu(x.to(cuda))
    c = qt.qgemul(a.to(cuda), b.to(cuda), F88Z)
    torch.cuda.synchronize()
    assert (fused_int8_gemm.launches, tree_gemm.launches) == (2, 1)
    y_cpu = qt.QuantPipeline.from_numpy(w1, w2, "cpu")(x)
    c_cpu = qt.qgemul(a, b, F88Z)
    assert (fused_int8_gemm.launches, tree_gemm.launches) == (2, 1)
    assert torch.equal(y.cpu(), y_cpu)
    assert c.fmt == c_cpu.fmt and torch.equal(c.data.cpu(), c_cpu.data)


def test_operands_on_two_devices_raise(cuda):
    a = _raws(5, FA, (8, 8), np.int8)
    with pytest.raises(ValueError, match="operands on"):
        fused_int8_gemm(a.to(cuda), a, 8, MID)
