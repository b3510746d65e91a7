"""K1's operand layout, checked on the CPU.

K1's tensor-core route (``csrc/fused_gemm.cu``) reads A [M, K] and B as
Bt [N, K] through TMA, which needs unit stride along K, a row stride that
is a multiple of 16 bytes and a 16-byte aligned base.  ``k1_route`` decides
from shape, strides and alignment whether an operand goes in as it is or as
a K-major copy, zero-padded to a multiple of 16 columns when K is not one;
``k1_operand`` makes that copy.  These tests pin the choice and show that
the padded operands give the same int32 dot.  ``QuantPipeline`` keeps its
weights K-major so the route reads them in place.
"""

import io

import numpy as np
import pytest
import torch

import qublas_tpu_torch as qt
from qublas_tpu_torch.ops.fused_gemm import (int_dot_plain, k1_operand,
                                             k1_route, kmajor)


def _int8(seed, shape):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randint(-128, 128, size=shape).astype(np.int8))


@pytest.mark.parametrize("k,route", [(16, "direct"), (32, "direct"),
                                     (48, "direct"), (4112, "direct"),
                                     (1, "padded"), (777, "padded"),
                                     (1003, "padded")])
def test_route_of_a_contiguous_operand(k, route):
    a = _int8(k, (3, k))
    assert a.data_ptr() % 16 == 0
    assert k1_route(a) == route


def test_route_of_views():
    big = _int8(0, (8, 64))
    assert k1_route(big[:, :40]) == "direct"      # row stride 64 bytes
    assert k1_route(big[:, 1:17]) == "copy"       # base one byte off
    assert k1_route(big[:, 1:14]) == "padded"
    b = _int8(1, (48, 20))                        # B [K, N] row-major
    assert k1_route(b.t()) == "copy"              # Bt [N, K] is strided
    assert k1_route(kmajor(b).t()) == "direct"
    assert k1_route(_int8(2, (1, 48)).expand(5, 48)) == "copy"
    odd = _int8(3, (7, 30))[:, :30:2]             # stride 2 along K
    assert k1_route(odd) == "padded"


@pytest.mark.parametrize("k", [1, 13, 16, 777, 1003])
@pytest.mark.parametrize("dtype", [torch.int8, torch.int16])
def test_padded_operands_give_the_same_dot(k, dtype):
    rng = np.random.RandomState(k)
    lo, hi = (-128, 128) if dtype == torch.int8 else (-400, 401)
    a = torch.from_numpy(rng.randint(lo, hi, (9, k))).to(dtype)
    b = torch.from_numpy(rng.randint(lo, hi, (k, 11))).to(dtype)
    a[0, -1] = 127 if dtype == torch.int8 else 300  # a wart raw at K - 1
    a_op, bt_op = k1_operand(a[:, :]), k1_operand(b.t())
    for t, src in ((a_op, a), (bt_op, b.t())):
        assert torch.equal(t, src)
        assert t.stride(1) == 1 and t.stride(0) % 16 == 0
        assert t.data_ptr() % 16 == 0
        kp = t.stride(0)
        assert kp == -(-k // 16) * 16
        full = torch.as_strided(t, (t.shape[0], kp), (kp, 1))
        if kp > k:
            assert k1_route(src) == "padded"
            assert not full[:, k:].any()
    full_a = torch.as_strided(a_op, (9, a_op.stride(0)), (a_op.stride(0), 1))
    full_b = torch.as_strided(bt_op, (11, bt_op.stride(0)),
                              (bt_op.stride(0), 1))
    assert torch.equal(int_dot_plain(full_a, full_b.t()), int_dot_plain(a, b))


def test_direct_operand_is_not_copied():
    a = _int8(5, (4, 32))
    assert k1_operand(a) is a
    w = kmajor(_int8(6, (32, 8)))
    assert k1_operand(w.t()).data_ptr() == w.data_ptr()


def _pipeline(seed, n=32):
    rng = np.random.RandomState(seed)
    w1 = rng.randint(-128, 128, (n, n)).astype(np.int8)
    w2 = rng.randint(-128, 128, (n, n)).astype(np.int8)
    return qt.QuantPipeline.from_numpy(w1, w2, "cpu"), w1, w2


def test_pipeline_weights_are_k_major():
    pipe, w1, w2 = _pipeline(0)
    for w, src in ((pipe.w1, w1), (pipe.w2, w2)):
        assert w.shape == src.shape and w.t().is_contiguous()
        assert np.array_equal(w.numpy(), src)
        assert k1_route(w.t()) == "direct"


def test_pipeline_state_dict_round_trip_keeps_bits_and_layout():
    pipe, _, _ = _pipeline(1)
    buf = io.BytesIO()
    torch.save(pipe.state_dict(), buf)
    buf.seek(0)
    other, _, _ = _pipeline(2)
    other.load_state_dict(torch.load(buf))
    for name in ("w1", "w2"):
        assert torch.equal(getattr(other, name), getattr(pipe, name))
        assert getattr(other, name).t().is_contiguous()
    x = _int8(3, (8, 32))
    assert torch.equal(other(x), pipe(x))
