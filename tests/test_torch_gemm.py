"""The torch port's quantized GEMM against the JAX package, Δ=0.

* Plan parity: the port's copies of ``exact_plan``, ``plan_tree``,
  ``drain_ops`` and ``_device_epilogue_ok`` equal the JAX package's over a
  format x k sweep (the machine with the card runs the copies without JAX).
* The lossless tier (kernel K1's plain version on the CPU) against the
  Pallas kernel ``pallas_gemm.qgemul_fast`` in interpret mode, and against
  ``qgemul(use_pallas=False)`` at ragged shapes, transposes and int16 lanes.

The K1 kernel itself is held against this plain version on the card by
``tests/test_torch_cuda.py``.
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


def _fields(plan):
    return None if plan is None else dataclasses.astuple(plan)


@pytest.mark.parametrize("k", [1, 3, 13, 64, 1000])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plans_match_jax(name, k):
    fa, fb, mul_to, full, adds, out = CONFIGS[name]
    mf = mul_merge(fa, fb, mul_to, full)
    ep_t = TG.exact_plan(fa, fb, mf, adds, k)
    ep_j = JG.exact_plan(fa, fb, mf, adds, k)
    assert _fields(ep_t) == _fields(ep_j)
    if ep_j is not None:
        assert TG._device_epilogue_ok(ep_t, out) == \
            JG._device_epilogue_ok(ep_j, out)
    tp_t = TT.plan_tree(fa, fb, mf, adds, k, out)
    tp_j = JT.plan_tree(fa, fb, mf, adds, k, out)
    assert _fields(tp_t) == _fields(tp_j)
    for levels in (max(k.bit_length(), 1), 12):
        assert TT.drain_ops(k, levels) == JT.drain_ops(k, levels)
    assert TT.level_formats(mf, adds, k) == JT.level_formats(mf, adds, k)


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
    got = TG.qgemul(from_raw(A, FA, "cpu"), from_raw(B, FA, "cpu"), out,
                    mul_to=wide, add_formats=(wide,))
    assert got.fmt == pal.fmt
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
    got = TG.qgemul(from_raw(A, FA, "cpu"), from_raw(B, FA, "cpu"), MID,
                    mul_to=WIDE, add_formats=(WIDE,), transpose_a=ta,
                    transpose_b=tb)
    assert got.fmt == want.fmt
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
    plan = TG.exact_plan(fa, fb, mf, adds, 40)
    assert plan is not None and TG._device_epilogue_ok(plan, out)
    want = JG.qgemul(jfrom_raw(A, fa), jfrom_raw(B, fb), out, mul_to=mul_to,
                     add_formats=adds, mul_full_prec=full, use_pallas=False)
    got = TG.qgemul(from_raw(A, fa, "cpu"), from_raw(B, fb, "cpu"), out,
                    mul_to=mul_to, add_formats=adds, mul_full_prec=full)
    assert got.fmt == want.fmt
    assert got.data.dtype == getattr(torch, str(want.data.dtype))
    np.testing.assert_array_equal(got.raw(), np.asarray(want.raw()))


def test_unported_tiers_raise():
    rng = np.random.RandomState(3)
    a = from_raw(_raws(rng, FA, (2, 3, 4)), FA, "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP item 4"):
        TG.qgemul(a, a, MID)
    # a lossless dot wider than int32 needs the wide tiers
    f, w = qformat(15, 0), qformat(40, 0)
    x = from_raw(_raws(rng, f, (2, 8)), f, "cpu")
    y = from_raw(_raws(rng, f, (8, 2)), f, "cpu")
    with pytest.raises(NotImplementedError, match="wide tiers"):
        TG.qgemul(x, y, f, mul_to=w, add_formats=(w,))


def test_kernel_wrappers_validate_operands():
    from qublas_tpu_torch.ops.fused_gemm import fused_int8_gemm

    mf = mul_merge(F88Z, F88Z)
    plan = TT.plan_tree(F88Z, F88Z, mf, (), 4, F88Z)
    for fn, arg in ((fused_int8_gemm, 8), (TT.tree_gemm, plan)):
        out = MID if fn is fused_int8_gemm else F88Z
        with pytest.raises(TypeError, match="int8/int16/int32"):
            fn(torch.zeros(3, 4), torch.zeros(4, 2), arg, out)
        with pytest.raises(ValueError):
            fn(torch.zeros(3, 4, dtype=torch.int8),
               torch.zeros(5, 2, dtype=torch.int8), arg, out)
