"""The torch port's quantized GEMM against the JAX package, Δ=0.

* Plan parity: the port's copies of ``exact_plan``, ``plan_tree``,
  ``drain_ops`` and ``_device_epilogue_ok`` equal the JAX package's over a
  format x k sweep (the machine with the card runs the copies without JAX).
* The lossless tier (kernel K1's plain version on the CPU) against the
  Pallas kernel ``pallas_gemm.qgemul_fast`` in interpret mode, and against
  ``qgemul(use_pallas=False)`` at ragged shapes, transposes and int16 lanes.

The K1 kernel itself is held against this plain version on the card by
``tests/test_torch_cuda.py``.  Formats cross into the port with ``P`` (the
port's own QFormat class) and are compared field by field.
"""

import dataclasses

import numpy as np
import pytest
import torch

from qublas_tpu.ops import gemm as JG
from qublas_tpu.ops import pallas_gemm
from qublas_tpu.ops import tree_gemm as JT
from qublas_tpu.qformat import OverflowMode, RoundMode, mul_merge, qformat
from qublas_tpu.qtensor import from_raw as jfrom_raw
from qublas_tpu_torch.convert import port_format
from qublas_tpu_torch.ops import gemm as TG
from qublas_tpu_torch.ops import tree_gemm as TT
from qublas_tpu_torch.qtensor import from_raw

FA = qformat(3, 4)
WIDE = qformat(20, 8)
MID = qformat(3, 4, overflow_mode=OverflowMode.SAT_ZERO)
F88Z = qformat(8, 8, overflow_mode=OverflowMode.SAT_ZERO)
F44 = qformat(4, 4)

# (fa, fb, mul_to, mul_full_prec, add_formats, out)
CONFIGS = {
    "headline": (FA, FA, WIDE, False, (WIDE,), MID),
    "canonical": (F88Z, F88Z, None, False, (), F88Z),
    "layered": (F44, F44, qformat(5, 5, overflow_mode=OverflowMode.SAT_ZERO),
                False, (qformat(6, 4, round_mode=RoundMode.RND_CONV),
                        qformat(5, 2)), qformat(6, 3)),
    "full_prec": (FA, FA, None, True, (qformat(22, 10),), qformat(6, 4)),
    "wrap_sat": (qformat(3, 4, overflow_mode=OverflowMode.WRP_TCPL_SAT),
                 FA, WIDE, False, (WIDE,),
                 qformat(3, 4, overflow_mode=OverflowMode.WRP_TCPL_SAT)),
    "wrap_out": (FA, FA, WIDE, False, (WIDE,),
                 qformat(1, 3, overflow_mode=OverflowMode.WRP_TCPL_SAT)),
    "unsigned": (qformat(4, 4, signed=False), FA, None, False,
                 (qformat(12, 6, signed=False,
                          round_mode=RoundMode.RND_INF),),
                 qformat(6, 2, signed=False)),
    "pair_products": (qformat(15, 16), qformat(15, 16), qformat(15, 16),
                      False, (), qformat(15, 16)),
    "host_only": (qformat(40, 40), qformat(40, 40), None, False, (),
                  qformat(40, 40)),
}


def P(f):
    """The port's QFormat of a JAX-package format (or tuple of them)."""
    if f is None:
        return None
    if isinstance(f, tuple):
        return tuple(P(x) for x in f)
    return port_format(f)


def _fields(plan):
    return None if plan is None else dataclasses.astuple(plan)


@pytest.mark.parametrize("k", [1, 3, 13, 64, 1000])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plans_match_jax(name, k):
    fa, fb, mul_to, full, adds, out = CONFIGS[name]
    mf = mul_merge(fa, fb, mul_to, full)
    ep_t = TG.exact_plan(P(fa), P(fb), P(mf), P(adds), k)
    ep_j = JG.exact_plan(fa, fb, mf, adds, k)
    assert _fields(ep_t) == _fields(ep_j)
    if ep_j is not None:
        assert TG._device_epilogue_ok(ep_t, P(out)) == \
            JG._device_epilogue_ok(ep_j, out)
    tp_t = TT.plan_tree(P(fa), P(fb), P(mf), P(adds), k, P(out))
    tp_j = JT.plan_tree(fa, fb, mf, adds, k, out)
    assert _fields(tp_t) == _fields(tp_j)
    for levels in (max(k.bit_length(), 1), 12):
        assert TT.drain_ops(k, levels) == JT.drain_ops(k, levels)
    assert [[dataclasses.astuple(f) for f in fs]
            for fs in TT.level_formats(P(mf), P(adds), k)] == \
        [[dataclasses.astuple(f) for f in fs]
         for fs in JT.level_formats(mf, adds, k)]


def _raws(rng, fmt, shape, dtype=np.int64):
    return rng.randint(fmt.raw_min, fmt.raw_max + 1, size=shape).astype(dtype)


def test_fast_tier_matches_pallas_interpret():
    """As tests/test_reduce_gemm.py runs the Pallas kernel on the CPU."""
    rng = np.random.RandomState(11)
    wide = qformat(24, 8)
    out = qformat(6, 4, overflow_mode=OverflowMode.SAT_ZERO)
    m = n = 256
    k = 512
    A, B = _raws(rng, FA, (m, k)), _raws(rng, FA, (k, n))
    plan = JG.exact_plan(FA, FA, wide, (wide,), k)
    pal = pallas_gemm.qgemul_fast(jfrom_raw(A, FA), jfrom_raw(B, FA), out,
                                  plan, interpret=True)
    got = TG.qgemul(from_raw(A, P(FA), "cpu"), from_raw(B, P(FA), "cpu"),
                    P(out), mul_to=P(wide), add_formats=(P(wide),))
    assert got.fmt == P(pal.fmt)
    assert got.data.dtype == getattr(torch, str(pal.data.dtype))
    np.testing.assert_array_equal(got.raw(), np.asarray(pal.raw()))


@pytest.mark.parametrize("m,k,n,ta,tb", [
    (1, 1, 1, False, False), (5, 7, 3, False, False),
    (33, 100, 17, False, False), (13, 65, 9, True, False),
    (8, 31, 12, False, True), (3, 1000, 4, True, True)])
def test_fast_tier_matches_jax_ragged(m, k, n, ta, tb):
    rng = np.random.RandomState(m * 1000 + k)
    A = _raws(rng, FA, (k, m) if ta else (m, k))
    B = _raws(rng, FA, (n, k) if tb else (k, n))
    want = JG.qgemul(jfrom_raw(A, FA), jfrom_raw(B, FA), MID, mul_to=WIDE,
                     add_formats=(WIDE,), transpose_a=ta, transpose_b=tb,
                     use_pallas=False)
    got = TG.qgemul(from_raw(A, P(FA), "cpu"), from_raw(B, P(FA), "cpu"),
                    P(MID), mul_to=P(WIDE), add_formats=(P(WIDE),),
                    transpose_a=ta, transpose_b=tb)
    assert got.fmt == P(want.fmt)
    np.testing.assert_array_equal(got.raw(), np.asarray(want.raw()))


@pytest.mark.parametrize("name", ["wrap_out", "int16_lanes"])
def test_fast_tier_other_lanes(name):
    """int16 operand lanes (the kernel's int32 instantiation) and the
    word-wrapping epilogue."""
    rng = np.random.RandomState(5)
    if name == "int16_lanes":
        f = qformat(7, 4)
        fa, fb, mul_to, full, adds = f, f, qformat(24, 8), False, \
            (qformat(24, 8),)
        out = qformat(7, 4, overflow_mode=OverflowMode.SAT_ZERO)
    else:
        fa, fb, mul_to, full, adds, out = CONFIGS[name]
    A, B = _raws(rng, fa, (17, 40)), _raws(rng, fb, (40, 23))
    mf = mul_merge(fa, fb, mul_to, full)
    plan = TG.exact_plan(P(fa), P(fb), P(mf), P(adds), 40)
    assert plan is not None and TG._device_epilogue_ok(plan, P(out))
    want = JG.qgemul(jfrom_raw(A, fa), jfrom_raw(B, fb), out, mul_to=mul_to,
                     add_formats=adds, mul_full_prec=full, use_pallas=False)
    got = TG.qgemul(from_raw(A, P(fa), "cpu"), from_raw(B, P(fb), "cpu"),
                    P(out), mul_to=P(mul_to), add_formats=P(adds),
                    mul_full_prec=full)
    assert got.fmt == P(want.fmt)
    assert got.data.dtype == getattr(torch, str(want.data.dtype))
    np.testing.assert_array_equal(got.raw(), np.asarray(want.raw()))


def test_unported_tiers_raise():
    rng = np.random.RandomState(3)
    a = from_raw(_raws(rng, FA, (2, 3, 4)), P(FA), "cpu")
    b = from_raw(_raws(rng, FA, (4, 5)), P(FA), "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP item 4"):
        TG.qgemul(a, b, P(MID))            # a broadcast batch
    # a lossless dot wider than int32 takes the limb tier (the digit dot,
    # as in the JAX package), and the int64 wide tier with it turned off
    f, w = P(qformat(15, 0)), P(qformat(40, 0))
    x = from_raw(_raws(rng, f, (2, 8)), f, "cpu")
    y = from_raw(_raws(rng, f, (8, 2)), f, "cpu")
    want = JG.qgemul(jfrom_raw(x.raw(), qformat(15, 0)),
                     jfrom_raw(y.raw(), qformat(15, 0)), qformat(15, 0),
                     mul_to=qformat(40, 0), add_formats=(qformat(40, 0),))
    got = TG.qgemul(x, y, f, mul_to=w, add_formats=(w,))
    np.testing.assert_array_equal(got.raw(), np.asarray(want.raw()))
    with TG.force_tiers_off("limb"):
        got = TG.qgemul(x, y, f, mul_to=w, add_formats=(w,))
    np.testing.assert_array_equal(got.raw(), np.asarray(want.raw()))
    # one whose products need limbs (82 bits) computes on the limb route
    jw = qformat(40, 0)
    x = from_raw(_raws(rng, w, (2, 8)), w, "cpu")
    y = from_raw(_raws(rng, w, (8, 2)), w, "cpu")
    want = JG.qgemul(jfrom_raw(x.raw(), jw), jfrom_raw(y.raw(), jw), jw)
    np.testing.assert_array_equal(TG.qgemul(x, y, w).raw(),
                                  np.asarray(want.raw()))
    # one whose products need host storage (1,801 bits) raises
    h = P(qformat(900, 0))
    x = from_raw([[1, 2]], h, "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A4b"):
        TG.qgemul(x, from_raw([[3], [4]], h, "cpu"), h,
                  mul_full_prec=True)


def test_kernel_wrappers_validate_operands():
    from qublas_tpu_torch.ops.fused_gemm import fused_int8_gemm

    f88z = P(F88Z)
    plan = TT.plan_tree(f88z, f88z, P(mul_merge(F88Z, F88Z)), (), 4, f88z)
    for fn, arg in ((fused_int8_gemm, 8), (TT.tree_gemm, plan)):
        out = P(MID) if fn is fused_int8_gemm else f88z
        with pytest.raises(TypeError, match="int8/int16/int32"):
            fn(torch.zeros(3, 4), torch.zeros(4, 2), arg, out)
        with pytest.raises(ValueError):
            fn(torch.zeros(3, 4, dtype=torch.int8),
               torch.zeros(5, 2, dtype=torch.int8), arg, out)


@pytest.mark.parametrize("name", ["headline", "canonical", "layered"])
def test_batched_qgemul_matches_jax(name):
    """Equal leading dims: the port loops its 2-D kernels (their plain
    versions here) over the flattened batch, the JAX package broadcasts or
    vmaps; the same bits, transposes included."""
    fa, fb, mul_to, full, adds, out = CONFIGS[name]
    rng = np.random.RandomState(len(name))
    A = _raws(rng, fa, (2, 3, 5, 9))
    B = _raws(rng, fb, (2, 3, 9, 4))
    for ta, tb in ((False, False), (True, True)):
        x = np.swapaxes(A, -1, -2) if ta else A
        y = np.swapaxes(B, -1, -2) if tb else B
        want = JG.qgemul(jfrom_raw(x, fa), jfrom_raw(y, fb), out,
                         mul_to=mul_to, add_formats=adds, mul_full_prec=full,
                         transpose_a=ta, transpose_b=tb, use_pallas=False)
        got = TG.qgemul(from_raw(x, P(fa), "cpu"), from_raw(y, P(fb), "cpu"),
                        P(out), mul_to=P(mul_to), add_formats=P(adds),
                        mul_full_prec=full, transpose_a=ta, transpose_b=tb)
        assert got.shape == (2, 3, 5, 4) and got.fmt == P(want.fmt)
        assert got.data.dtype == getattr(torch, str(want.data.dtype))
        np.testing.assert_array_equal(got.raw(), np.asarray(want.raw()))


@pytest.mark.parametrize("name", ["headline", "canonical"])
def test_qgemv_matches_jax(name):
    fa, fb, mul_to, full, adds, out = CONFIGS[name]
    rng = np.random.RandomState(7)
    A = _raws(rng, fa, (6, 11))
    x = _raws(rng, fb, (11,))
    xt = _raws(rng, fb, (6,))
    for mat, vec, ta in ((A, x, False), (A, xt, True),
                         (_raws(rng, fa, (2, 6, 11)), _raws(rng, fb, (2, 11)),
                          False)):
        want = JG.qgemv(jfrom_raw(mat, fa), jfrom_raw(vec, fb), out,
                        mul_to=mul_to, add_formats=adds, transpose_a=ta)
        got = TG.qgemv(from_raw(mat, P(fa), "cpu"),
                       from_raw(vec, P(fb), "cpu"), P(out),
                       mul_to=P(mul_to), add_formats=P(adds), transpose_a=ta)
        assert got.fmt == P(want.fmt) and got.shape == tuple(want.shape)
        np.testing.assert_array_equal(got.raw(), np.asarray(want.raw()))


def test_int_dot_plain_is_the_exact_int32_dot():
    """K1 with the identity epilogue: the plain version keeps every dot
    value, the int32 extremes included, for int8, int16 and int32 lanes."""
    from qublas_tpu_torch.ops.fused_gemm import int_dot, int_dot_plain

    i32 = torch.int32
    a = torch.tensor([[1, 0], [-1, 0], [1, 1]], dtype=i32)
    b = torch.tensor([[-(1 << 31), (1 << 31) - 1], [0, 0]], dtype=i32)
    got = int_dot(a, b)
    assert got.dtype == i32
    assert got.tolist() == [[-(1 << 31), (1 << 31) - 1],
                            [-(1 << 31), -(1 << 31) + 1],  # 2^31 wraps
                            [-(1 << 31), (1 << 31) - 1]]
    # sums that reach INT32_MAX and INT32_MIN exactly from int16 lanes
    a16 = torch.tensor([[-(1 << 15), (1 << 15) - 1],
                        [-(1 << 15), -(1 << 15)]], dtype=torch.int16)
    b16 = torch.tensor([[-(1 << 15), 1 << 15], [(1 << 15) + 1, 1 << 15]],
                       dtype=i32)
    assert int_dot(a16, b16).tolist() == [[(1 << 31) - 1, -(1 << 15)],
                                          [-(1 << 15), -(1 << 31)]]
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randint(-128, 128, (33, 70)).astype(np.int8))
    y = torch.from_numpy(rng.randint(-128, 128, (70, 9)).astype(np.int8))
    want = x.long() @ y.long()
    assert torch.equal(int_dot(x, y).long(), want)
    assert torch.equal(int_dot_plain(x.to(torch.int16), y), want.int())
