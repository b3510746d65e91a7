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
    # a broadcast batch computes now: a 3-D activation against a 2-D
    # weight, Δ=0 against the JAX package
    A, B = _raws(rng, FA, (2, 3, 4)), _raws(rng, FA, (4, 5))
    want = JG.qgemul(jfrom_raw(A, FA), jfrom_raw(B, FA), MID)
    got = TG.qgemul(from_raw(A, P(FA), "cpu"), from_raw(B, P(FA), "cpu"),
                    P(MID))
    assert got.shape == (2, 3, 5) and got.fmt == P(want.fmt)
    np.testing.assert_array_equal(got.raw(), np.asarray(want.raw()))
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
    # one whose products need host storage (1,801 bits) takes the host
    # tier, as in the JAX package
    jh = qformat(900, 0)
    want = JG.qgemul(jfrom_raw(np.array([[1, 2]]), jh),
                     jfrom_raw(np.array([[3], [4]]), jh), jh,
                     mul_full_prec=True)
    got = TG.qgemul(from_raw([[1, 2]], P(jh), "cpu"),
                    from_raw([[3], [4]], P(jh), "cpu"), P(jh),
                    mul_full_prec=True)
    assert got.fmt == P(want.fmt) and got.is_limb == want.is_limb
    np.testing.assert_array_equal(got.raw(), np.asarray(want.raw()))


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


# ---------------------------------------------------------------------------
# Broadcast batch dims
# ---------------------------------------------------------------------------

# a tier -> (fa, fb, qgemul keywords, out, k); formats of the JAX package
_F15, _W40 = qformat(15, 0), qformat(40, 0)
_Q16 = qformat(16, 16)
_F70, _W141, _W152 = qformat(70, 10), qformat(141, 20), qformat(152, 20)
_F70Z = qformat(70, 10, round_mode=RoundMode.TRN_TCPL,
                overflow_mode=OverflowMode.SAT_ZERO)
BCAST_TIERS = {
    "lossless": (FA, FA, dict(mul_to=WIDE, add_formats=(WIDE,)), MID, 5),
    "tree": (F88Z, F88Z, {}, F88Z, 5),
    # 30-bit products, 5 of them: a lossless dot beyond int32
    "limb": (_F15, _F15, dict(mul_to=_W40, add_formats=(_W40,)), _F15, 5),
    "wide": (_F15, _F15, dict(mul_to=_W40, add_formats=(_W40,)), _F15, 5),
    # Q16.16 pair values, lossy products: the stream needs k >= 16 (two
    # chunks of 8 and a tail of 4 here); at k = 5 the layered path
    "streaming": (_Q16, _Q16, dict(mul_to=_Q16, add_formats=(_Q16,)), _Q16,
                  20),
    "layered": (_Q16, _Q16, dict(mul_to=_Q16, add_formats=(_Q16,)), _Q16,
                5),
    # 81-bit limb operands: the limb tier, and lossy products on the
    # layered path
    "limb-operands": (_F70, _F70, dict(mul_to=_W141, add_formats=(_W152,)),
                      _W152, 5),
    "layered-limbs": (_F70Z, _F70Z, dict(mul_to=_F70Z, add_formats=(_F70Z,)),
                      _F70Z, 5),
}
# (a's batch, b's batch) of (.., 4, k) @ (.., k, 6); the calls a folded
# batch makes (one) or the per-matrix loop (one a batch element)
BCAST_SHAPES = {"a3d-b2d": ((2, 3), (), 1), "a2d-b3d": ((), (2,), 2),
                "a-b-cross": ((2, 1), (3,), 6), "b-ones": ((3,), (1,), 1)}
# the 2-D entry point each tier calls (None: the layered path, no tier)
_TIER_FN = {"lossless": "fused_int8_gemm", "tree": "tree_gemm",
            "limb": "_fast_gemm_limb", "wide": "_fast_gemm_wide",
            "streaming": "_stream_gemm_wide", "layered": None,
            "limb-operands": "_fast_gemm_limb", "layered-limbs": None}


def _count_tier_calls(monkeypatch):
    """Counts the results each tier entry point of ``TG`` returns."""
    seen = {}
    for name in set(_TIER_FN.values()) - {None}:
        fn = getattr(TG, name)

        def spy(*args, _fn=fn, _name=name, **kw):
            res = _fn(*args, **kw)
            if res is not None:
                seen[_name] = seen.get(_name, 0) + 1
            return res

        monkeypatch.setattr(TG, name, spy)
    return seen


def _wide_raws(rng, fmt, shape):
    """Raws over the whole range of a format of any width."""
    span = fmt.raw_max - fmt.raw_min + 1
    vals = [fmt.raw_min + (int(rng.randint(0, 1 << 62)) << 62
                           | int(rng.randint(0, 1 << 62))) % span
            for _ in range(int(np.prod(shape)))]
    return np.array(vals, dtype=object).reshape(shape)


def _bcast_case(tier, shapes, seed):
    fa, fb, kw, out, k = BCAST_TIERS[tier]
    ba, bb, calls = BCAST_SHAPES[shapes]
    rng = np.random.RandomState(seed)
    raws = _raws if fa.storage_bits <= 62 else _wide_raws
    A, B = raws(rng, fa, ba + (4, k)), raws(rng, fb, bb + (k, 6))
    return fa, fb, kw, out, A, B, calls


@pytest.mark.parametrize("shapes", list(BCAST_SHAPES))
@pytest.mark.parametrize("tier", list(BCAST_TIERS))
def test_broadcast_qgemul_matches_jax(tier, shapes, monkeypatch):
    """Broadcast batch dims on each tier, Δ=0 against the JAX package (which
    may take another tier: its limb and int64 tiers are 2-D only).  The
    port folds a batch against a shared ``b`` into one 2-D call and loops
    otherwise; the spy counts the calls."""
    fa, fb, kw, out, A, B, calls = _bcast_case(tier, shapes, len(shapes))
    want = JG.qgemul(jfrom_raw(A, fa), jfrom_raw(B, fb), out, **kw)
    seen = _count_tier_calls(monkeypatch)
    tkw = {key: P(v) for key, v in kw.items()}
    x, y = from_raw(A, P(fa), "cpu"), from_raw(B, P(fb), "cpu")
    with TG.force_tiers_off(*(("limb",) if tier == "wide" else ())), \
            TG.stream_gate(0 if tier == "streaming" else TG._STREAM_MIN_ELEMS):
        got = TG.qgemul(x, y, P(out), **tkw)
    name = _TIER_FN[tier]
    if tier == "streaming":
        calls = 1   # the stream takes the expanded operands whole
    assert seen == ({} if name is None else {name: calls}), seen
    assert got.shape == tuple(want.shape) and got.fmt == P(want.fmt)
    assert (got.is_pair, got.is_limb) == (want.is_pair, want.is_limb)
    np.testing.assert_array_equal(np.asarray(got.raw(), dtype=object),
                                  np.asarray(want.raw(), dtype=object))


@pytest.mark.parametrize("tier", ["lossless", "tree", "limb"])
def test_broadcast_qgemul_with_transposes_matches_jax(tier):
    """Transposed operands broadcast too: the fold reshapes a transposed
    view (a copy), the loop indexes it."""
    fa, fb, kw, out, k = BCAST_TIERS[tier]
    rng = np.random.RandomState(17)
    tkw = {key: P(v) for key, v in kw.items()}
    for sa, sb in (((2, 3, k, 4), (6, k)), ((k, 4), (2, 6, k))):
        A, B = _raws(rng, fa, sa), _raws(rng, fb, sb)
        want = JG.qgemul(jfrom_raw(A, fa), jfrom_raw(B, fb), out,
                         transpose_a=True, transpose_b=True, **kw)
        got = TG.qgemul(from_raw(A, P(fa), "cpu"), from_raw(B, P(fb), "cpu"),
                        P(out), transpose_a=True, transpose_b=True, **tkw)
        assert got.shape == tuple(want.shape) and got.fmt == P(want.fmt)
        np.testing.assert_array_equal(got.raw(), np.asarray(want.raw()))


def test_broadcast_limb_fold_outside_its_envelope_loops(monkeypatch):
    """A fold whose digit dot leaves the limb tier's envelope runs the
    limb tier once per matrix, not another tier."""
    fa, fb, kw, out, A, B, _ = _bcast_case("limb", "a3d-b2d", 9)
    want = JG.qgemul(jfrom_raw(A, fa), jfrom_raw(B, fb), out, **kw)
    plan = TG.exact_plan(P(fa), P(fb), P(mul_merge(fa, fb, kw["mul_to"])),
                         P(kw["add_formats"]), A.shape[-1])
    # the envelope of one 4 x 6 matrix exactly: the 24 x 6 fold is outside
    from qublas_tpu_torch.ops import limbdot as TD
    iva, ivb = (TG.fmt_interval(P(f)) for f in (fa, fb))
    da, db = TD.digits_needed(iva), TD.digits_needed(ivb)
    nseg = -(-5 // TD._seg_len(5, min(da, db)))
    monkeypatch.setattr(TG, "_LIMBDOT_MAX_DOT_ELEMS", da * db * nseg * 24)
    assert TG.limb_dot_plan(P(fa), P(fb), P(out), plan, 5, 4, 6) is not None
    assert TG.limb_dot_plan(P(fa), P(fb), P(out), plan, 5, 24, 6) is None
    seen = _count_tier_calls(monkeypatch)
    got = TG.qgemul(from_raw(A, P(fa), "cpu"), from_raw(B, P(fb), "cpu"),
                    P(out), **{key: P(v) for key, v in kw.items()})
    assert seen == {"_fast_gemm_limb": 6}, seen
    np.testing.assert_array_equal(got.raw(), np.asarray(want.raw()))


@pytest.mark.parametrize("tier", ["lossless", "tree", "limb-operands"])
def test_broadcast_fold_splits_at_the_grid_limit(tier, monkeypatch):
    """A folded batch of more rows than K1's and K2's grids hold goes in
    whole matrices at a time: 6 matrices of 4 rows, 8 rows a call, 3
    calls."""
    fa, fb, kw, out, A, B, _ = _bcast_case(tier, "a3d-b2d", 21)
    want = JG.qgemul(jfrom_raw(A, fa), jfrom_raw(B, fb), out, **kw)
    monkeypatch.setattr(TG, "_FOLD_MAX_ROWS", 8)
    seen = _count_tier_calls(monkeypatch)
    got = TG.qgemul(from_raw(A, P(fa), "cpu"), from_raw(B, P(fb), "cpu"),
                    P(out), **{key: P(v) for key, v in kw.items()})
    assert seen == {_TIER_FN[tier]: 3}, seen
    assert got.shape == tuple(want.shape) and got.fmt == P(want.fmt)
    np.testing.assert_array_equal(np.asarray(got.raw(), dtype=object),
                                  np.asarray(want.raw(), dtype=object))


def test_broadcast_batch_dims_that_do_not_broadcast_raise():
    a = from_raw(np.zeros((2, 4, 5), np.int64), P(FA), "cpu")
    b = from_raw(np.zeros((3, 5, 6), np.int64), P(FA), "cpu")
    with pytest.raises(ValueError, match="do not broadcast"):
        TG.qgemul(a, b, P(MID))


@pytest.mark.parametrize("sa,sb", [((0, 4, 5), (3, 1, 5, 6)),
                                   ((2, 0, 4, 5), (5, 6))])
def test_broadcast_empty_batch_matches_jax(sa, sb):
    rng = np.random.RandomState(2)
    A, B = _raws(rng, FA, sa), _raws(rng, FA, sb)
    want = JG.qgemul(jfrom_raw(A, FA), jfrom_raw(B, FA), MID, mul_to=WIDE,
                     add_formats=(WIDE,))
    got = TG.qgemul(from_raw(A, P(FA), "cpu"), from_raw(B, P(FA), "cpu"),
                    P(MID), mul_to=P(WIDE), add_formats=(P(WIDE),))
    assert got.shape == tuple(want.shape) and got.fmt == P(want.fmt)
    assert got.data.dtype == getattr(torch, str(want.data.dtype))


@pytest.mark.parametrize("name", ["headline", "canonical"])
def test_batched_qgemv_matches_jax(name, monkeypatch):
    """A batch of vectors against one matrix is one GEMM whose columns are
    the vectors: one K1 or K2 call.  A batched matrix broadcasts through
    qgemul."""
    fa, fb, mul_to, full, adds, out = CONFIGS[name]
    rng = np.random.RandomState(13)
    kernel = "fused_int8_gemm" if name == "headline" else "tree_gemm"
    for mat, vec, ta, calls in (
            (_raws(rng, fa, (6, 11)), _raws(rng, fb, (2, 3, 11)), False, 1),
            (_raws(rng, fa, (11, 6)), _raws(rng, fb, (4, 11)), True, 1),
            (_raws(rng, fa, (2, 6, 11)), _raws(rng, fb, (3, 1, 11)), False,
             6)):
        want = JG.qgemv(jfrom_raw(mat, fa), jfrom_raw(vec, fb), out,
                        mul_to=mul_to, add_formats=adds, transpose_a=ta)
        seen = _count_tier_calls(monkeypatch)
        got = TG.qgemv(from_raw(mat, P(fa), "cpu"),
                       from_raw(vec, P(fb), "cpu"), P(out),
                       mul_to=P(mul_to), add_formats=P(adds), transpose_a=ta)
        monkeypatch.undo()
        assert seen == {kernel: calls}, seen
        assert got.fmt == P(want.fmt) and got.shape == tuple(want.shape)
        np.testing.assert_array_equal(got.raw(), np.asarray(want.raw()))


def test_broadcast_cgemul_matches_jax():
    """cgemul with a batched A against a 2-D B: the layered path broadcasts,
    as before; Δ=0 against the JAX package."""
    from qublas_tpu.complex import complex_from_raw as jcomplex
    from qublas_tpu.ops import cgemm as JCG
    from qublas_tpu_torch.convert import complex_from_jax
    from qublas_tpu_torch.ops import cgemm as TCG

    rng = np.random.RandomState(21)
    mid = qformat(5, 4)
    tags = dict(ab=mid, cd=mid, ba=mid, abc=WIDE, cdb=WIDE, bad=WIDE,
                AB=WIDE, BC=WIDE)
    a = jcomplex(_raws(rng, FA, (2, 3, 5)), _raws(rng, FA, (2, 3, 5)), FA)
    b = jcomplex(_raws(rng, FA, (5, 4)), _raws(rng, FA, (5, 4)), FA)
    want = JCG.cgemul(a, b, MID, algo="tf", add_formats=(WIDE,), **tags)
    got = TCG.cgemul(complex_from_jax(a, "cpu"), complex_from_jax(b, "cpu"),
                     P(MID), algo="tf", add_formats=(P(WIDE),),
                     **{k: P(v) for k, v in tags.items()})
    assert got.shape == (2, 3, 4)
    for g, w in ((got.real, want.real), (got.imag, want.imag)):
        assert g.fmt == P(w.fmt)
        np.testing.assert_array_equal(g.raw(), np.asarray(w.raw()))
