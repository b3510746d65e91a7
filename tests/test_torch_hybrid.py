"""The port's prefix-lossless hybrid tier against the JAX package, Δ=0.

``plan_hybrid`` is the port's copy of the JAX planner, pinned to it over a
sweep of formats and k.  K2h's plain version (``tree_gemm_hybrid_plain``:
one matmul a block, the tail layer by layer) must give the raws of the JAX
package's ``tree_gemm_hybrid``, and ``qgemul`` on the hybrid tier those of
the JAX ``qgemul`` and of the host golden model, at the JAX package's own
k (16, 48, 64, 80, 176: odd block counts included), with a shift dl > 0,
batched and broadcast; and the bits of K2 on ``plan_tree`` of the same
configuration.  The K2h kernel cannot run here, so its schedule is
replayed from the int32 parameters it receives (``_hybrid_params``): k in
slices of 16 products, the exact dot of each block of s, shifted by dl and
pushed onto the slot stack of tree levels L and up, then the drain over
the k / s block values and the final requantize; a mutation check shows
that the replay reads each parameter.  The kernel itself is held against
the plain version on the card by ``tests/test_torch_cuda.py``.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from qublas_tpu import hostops as JO
from qublas_tpu.ops import gemm as JG
from qublas_tpu.ops import tree_gemm as JT
from qublas_tpu.qformat import OverflowMode, RoundMode, mul_merge, qformat
from qublas_tpu.qtensor import from_raw as jfrom_raw
from qublas_tpu_torch.convert import port_format
from qublas_tpu_torch.ops import gemm as TG
from qublas_tpu_torch.ops import tree_gemm as TT
from qublas_tpu_torch.ops.wideint import requantize_i32
from qublas_tpu_torch.qtensor import from_raw

# the JAX package's hybrid configuration (tests/test_tree_gemm.py)
FA = qformat(3, 4)
MUL = qformat(7, 8)
LAYERS = (qformat(8, 8), qformat(9, 8), qformat(10, 8), qformat(11, 8),
          qformat(6, 4, overflow_mode=OverflowMode.SAT_ZERO))
OUT = qformat(5, 4)
# frac growth in the lossless prefix: dl = 2
MUL_DL = qformat(7, 10)
LAYERS_DL = (qformat(8, 11), qformat(9, 12), qformat(10, 12),
             qformat(5, 6, overflow_mode=OverflowMode.SAT_ZERO))
OUT_DL = qformat(5, 5)
CONFIGS = {"base": (MUL, LAYERS, OUT), "dl": (MUL_DL, LAYERS_DL, OUT_DL)}


def P(f):
    """The port's QFormat of a JAX-package format (or tuple of them)."""
    if isinstance(f, tuple):
        return tuple(P(x) for x in f)
    return None if f is None else port_format(f)


def _plans(fa, fb, mul_to, layers, k, out):
    mul = mul_merge(fa, fb, mul_to)
    jp = JT.plan_hybrid(fa, fb, mul, layers, k, out)
    tp = TT.plan_hybrid(P(fa), P(fb), P(mul), P(layers), k, P(out))
    return jp, tp


def _raws(seed, fmt, shape):
    rng = np.random.RandomState(seed)
    return rng.randint(fmt.raw_min, fmt.raw_max + 1, shape)


def _sweep():
    """(fa, mul_to, layers, out): prefixes that stay lossless for 0 to all
    layers, shifts, saturating and wrapping tails, modes of every kind."""
    rms = (RoundMode.TRN_TCPL, RoundMode.RND_CONV, RoundMode.RND_ZERO)
    oms = (OverflowMode.SAT_ZERO, OverflowMode.SAT_TCPL,
           OverflowMode.WRP_TCPL)
    cases = []
    for (rm, om), fa in itertools.product(itertools.product(rms, oms),
                                          (qformat(3, 4), qformat(2, 2),
                                           qformat(7, 0, signed=False))):
        mul = qformat(fa.int_bits * 2 + 2, fa.frac_bits * 2 + 1)
        grow = tuple(qformat(mul.int_bits + 1 + i,
                             mul.frac_bits + (i + 1) // 2)
                     for i in range(4))
        tail = qformat(6, 3, round_mode=rm, overflow_mode=om)
        for layers in ((), grow, grow[:2] + (tail,), grow + (tail,),
                       (tail,)):
            for out in (qformat(5, 4, round_mode=rm), qformat(20, 0),
                        qformat(40, 8)):
                cases.append((fa, mul, layers, out))
    return cases


def test_plan_hybrid_matches_jax():
    """The copy answers as the original over formats, modes and k: the
    same plans (field by field) and the same refusals."""
    seen = 0
    for fa, mul, layers, out in _sweep():
        for k in (1, 2, 8, 16, 24, 48, 64, 80, 176, 2040, 2048, 4096):
            jp, tp = _plans(fa, fa, mul, layers, k, out)
            assert (jp is None) == (tp is None), (fa, mul, layers, out, k)
            if jp is not None:
                seen += 1
                assert dataclasses.astuple(tp) == dataclasses.astuple(jp)
    assert seen > 100


def test_plan_hybrid_min_level_is_the_kernels():
    """The shortest lossless prefix the planner accepts is the one K2h
    runs: a block spans whole half slices of HALF products, and
    ``read_hybrid`` refuses a shorter level, so a plan the CPU runs is
    never one the kernel refuses."""
    import pathlib
    import re

    src = (pathlib.Path(TT.__file__).parent.parent / "csrc" /
           "tree_gemm_hybrid.cu").read_text()
    half = int(re.search(r"constexpr int HALF = (\d+);", src).group(1))
    least = int(re.search(r"p->level < (\d+)", src).group(1))
    assert 1 << TT._HYB_MIN_LEVEL == half
    assert least == TT._HYB_MIN_LEVEL


@pytest.mark.parametrize("config,k", [("base", 16), ("base", 48),
                                      ("base", 64), ("base", 80),
                                      ("base", 176), ("base", 2040),
                                      ("dl", 32), ("dl", 96)])
def test_plain_matches_jax_tree_gemm_hybrid(config, k):
    mul, layers, out = CONFIGS[config]
    jp, tp = _plans(FA, FA, mul, layers, k, out)
    assert tp is not None and (tp.dl > 0) == (config == "dl")
    A = _raws(k, FA, (6, k)).astype(np.int8)
    B = _raws(k + 1, FA, (k, 5)).astype(np.int8)
    import jax.numpy as jnp

    want = np.asarray(JT.tree_gemm_hybrid(jnp.asarray(A), jnp.asarray(B), jp,
                                          out))
    got = TT.tree_gemm_hybrid_plain(torch.from_numpy(A), torch.from_numpy(B),
                                    tp, P(out))
    assert got.dtype == torch.int16 and want.dtype == np.int16
    np.testing.assert_array_equal(got.numpy(), want)


def _host(A, B, mul, layers, out):
    ar = [[(int(A[i, p]), FA) for p in range(A.shape[1])]
          for i in range(A.shape[0])]
    br = [[(int(B[p, j]), FA) for j in range(B.shape[1])]
          for p in range(B.shape[0])]
    return np.array([[v[0] for v in row]
                     for row in JO.qgemul(ar, br, out, mul, layers)])


def _spy(monkeypatch):
    """Counts the calls of ``tree_gemm_hybrid`` and ``tree_gemm`` that
    ``qgemul`` makes."""
    seen = {"tree_gemm_hybrid": 0, "tree_gemm": 0}
    for name in seen:
        fn = getattr(TG, name)

        def spy(*args, _fn=fn, _name=name, **kw):
            seen[_name] += 1
            return _fn(*args, **kw)

        monkeypatch.setattr(TG, name, spy)
    return seen


@pytest.mark.parametrize("config,k", [("base", 16), ("base", 48),
                                      ("base", 64), ("base", 80),
                                      ("base", 176), ("dl", 32)])
def test_qgemul_hybrid_tier_matches_jax_and_hostops(config, k, monkeypatch):
    """``qgemul`` takes the hybrid tier (one K2h call, no K2) and gives the
    raws of the JAX ``qgemul``, of the host golden tree and of K2's plain
    version on ``plan_tree`` of the same configuration.  At k = 16 the
    lossy layer is never reached, so the lossless tier (K1) takes it, in
    both packages."""
    mul, layers, out = CONFIGS[config]
    A, B = _raws(2 * k, FA, (4, k)), _raws(2 * k + 1, FA, (k, 5))
    seen = _spy(monkeypatch)
    got = TG.qgemul(from_raw(A, P(FA), "cpu"), from_raw(B, P(FA), "cpu"),
                    P(out), mul_to=P(mul), add_formats=P(layers))
    assert seen == {"tree_gemm_hybrid": int(k > 16), "tree_gemm": 0}
    assert got.fmt == P(out)
    want = JG.qgemul(jfrom_raw(A, FA), jfrom_raw(B, FA), out, mul_to=mul,
                     add_formats=layers)
    np.testing.assert_array_equal(got.raw(), np.asarray(want.raw()))
    np.testing.assert_array_equal(got.raw(), _host(A, B, mul, layers, out))
    tplan = TT.plan_tree(P(FA), P(FA), P(mul_merge(FA, FA, mul)), P(layers),
                         k, P(out))
    k2 = TT.tree_gemm_plain(torch.from_numpy(A).to(torch.int8),
                            torch.from_numpy(B).to(torch.int8), tplan, P(out))
    np.testing.assert_array_equal(got.raw(), k2.numpy())


@pytest.mark.parametrize("shapes,calls", [(((2, 3), ()), 1), (((), (2,)), 2),
                                          (((2, 1), (3,)), 6),
                                          (((3,), (1,)), 1)],
                         ids=["a3d-b2d", "a2d-b3d", "a-b-cross", "b-ones"])
def test_batched_hybrid_matches_jax(shapes, calls, monkeypatch):
    """Batch dims on the hybrid tier: a batch against a shared ``b`` folds
    into one K2h call, a batched ``b`` runs a call a matrix; Δ=0 against
    the JAX package's einsum over the broadcast batch."""
    ba, bb = shapes
    k = 48
    A, B = _raws(5, FA, ba + (4, k)), _raws(6, FA, bb + (k, 3))
    seen = _spy(monkeypatch)
    got = TG.qgemul(from_raw(A, P(FA), "cpu"), from_raw(B, P(FA), "cpu"),
                    P(OUT), mul_to=P(MUL), add_formats=P(LAYERS))
    assert seen == {"tree_gemm_hybrid": calls, "tree_gemm": 0}
    want = JG.qgemul(jfrom_raw(A, FA), jfrom_raw(B, FA), OUT, mul_to=MUL,
                     add_formats=LAYERS)
    assert got.shape == tuple(want.shape)
    np.testing.assert_array_equal(got.raw(), np.asarray(want.raw()))


def test_hybrid_declines_where_jax_does():
    """An immediately lossy product (the canonical ``Qu<8,8>``) and a
    prefix of fewer than three layers get no hybrid plan: ``qgemul`` stays
    on K2."""
    f = qformat(8, 8, overflow_mode=OverflowMode.SAT_ZERO)
    for fa, mul, layers, k in ((f, f, (), 64), (FA, MUL, (qformat(8, 8),
                                                          qformat(4, 2)), 64),
                               (FA, MUL, LAYERS, 4), (FA, MUL, LAYERS, 17)):
        jp, tp = _plans(fa, fa, mul, layers, k, f)
        assert jp is None and tp is None


# ---------------------------------------------------------------------------
# K2h's schedule, replayed from its parameters
# ---------------------------------------------------------------------------

def _rq(v, r):
    d, rnd, ovf, w, sgn = r
    fmt = P(qformat(w - 1, 0, bool(sgn), RoundMode(rnd), OverflowMode(ovf)))
    return requantize_i32(v, d, fmt)


def _replay_k2h(a, b, params):
    """K2h's schedule over ``a`` [M, K] @ ``b`` [K, N] from its parameters
    (level, dl, levels, merge[levels][5], ndrain, (op, level)[ndrain],
    fin[5]): slices of 16 products, each output's running block dot, a
    push after each half slice of 8 products where a block of 2^level
    ends."""
    p = list(params)
    level, dl, levels = p[0], p[1], p[2]
    merges = [p[3 + 5 * l:8 + 5 * l] for l in range(levels)]
    q = 3 + 5 * levels
    nd = p[q]
    ops = [(p[q + 1 + 2 * s], p[q + 2 + 2 * s]) for s in range(nd)]
    fin = p[q + 1 + 2 * nd:q + 6 + 2 * nd]
    a32, b32 = a.to(torch.int32), b.to(torch.int32)
    k = a.shape[1]
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.int32)
    slots, t = {}, 0
    for k0 in range(0, k, 16):
        for qq in range(min(16, k - k0)):
            acc = acc + a32[:, k0 + qq, None] * b32[None, k0 + qq, :]
            if qq % 8 == 7 and (k0 + qq + 1) % (1 << level) == 0:
                v, j = acc << dl, 0
                while t & (1 << j):
                    v = _rq(slots.pop(j) + v, merges[j])
                    j += 1
                slots[j] = v
                acc = torch.zeros_like(acc)
                t += 1
    zero = torch.zeros_like(acc)   # the kernel's stack starts at 0
    carry = None
    for op, l in ops:
        if op == 1:
            carry = _rq(carry, merges[l])
        elif op == 0:
            carry = slots.get(l, zero)
        else:
            carry = _rq(slots.get(l, zero) + carry, merges[l])
    return _rq(carry, fin)


@pytest.mark.parametrize("config,k", [("base", 16), ("base", 48),
                                      ("base", 80), ("base", 176),
                                      ("base", 2040), ("base", 4096),
                                      ("dl", 32), ("dl", 96)])
def test_k2h_schedule_matches_plain(config, k):
    mul, layers, out = CONFIGS[config]
    _, tp = _plans(FA, FA, mul, layers, k, out)
    A = torch.from_numpy(_raws(k, FA, (5, k))).to(torch.int8)
    B = torch.from_numpy(_raws(k + 3, FA, (k, 6))).to(torch.int8)
    want = TT.tree_gemm_hybrid_plain(A, B, tp, P(out))
    params = TT._hybrid_params(tp, k, P(out))
    assert list(params[:2]) == [tp.level, tp.dl]
    got = _replay_k2h(A, B, params).to(want.dtype)
    assert torch.equal(got, want)


def test_k2h_drain_ends_in_the_plans_final_format():
    """The drain over the k / s block values, offset by L, ends in the
    format that the layerwise tail of ``plan_hybrid`` ends in."""
    for k in (16, 48, 64, 80, 176, 2040, 2048, 4096, 16 * 1023):
        _, tp = _plans(FA, FA, MUL, LAYERS, k, OUT)
        nb = k // tp.s
        fmt = None
        for op, l in TT.drain_ops(nb, max(nb.bit_length(), 1)):
            fmt = tp.level_fmts[tp.level + l] if op == "seed" \
                else tp.merge_fmts[tp.level + l]
        assert fmt == tp.final_fmt, k


@pytest.mark.parametrize("field", ["dl", "merge0", "merge-top", "level"])
def test_k2h_schedule_replay_sees_a_wrong_parameter(field):
    """Mutation check of the replay: a changed shift of the block values
    (dl), of the tail's first or last merge, or a block size of 8 for 16
    changes the result, so the replay reads each parameter it is given."""
    k = 176
    _, tp = _plans(FA, FA, MUL_DL, LAYERS_DL, k, OUT_DL) \
        if field == "dl" else _plans(FA, FA, MUL, LAYERS, k, OUT)
    out = OUT_DL if field == "dl" else OUT
    A = torch.from_numpy(_raws(9, FA, (16, k))).to(torch.int8)
    B = torch.from_numpy(_raws(10, FA, (k, 16))).to(torch.int8)
    want = TT.tree_gemm_hybrid_plain(A, B, tp, P(out))
    params = list(TT._hybrid_params(tp, k, P(out)))
    levels = params[2]
    pos = {"dl": 1, "merge0": 3, "merge-top": 3 + 5 * (levels - 1),
           "level": 0}[field]
    params[pos] += -1 if field == "level" else 1
    got = _replay_k2h(A, B, params).to(want.dtype)
    assert not torch.equal(got, want)
