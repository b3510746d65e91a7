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
that the replay reads each parameter.  The tensor-core kernel for int8
lanes (``csrc/tree_gemm_hybrid_mma.cu``) is replayed the same way, down to
its fragments: stages of 64 products, m16n8k16 MMAs on the PTX fragment
layouts, B's columns transposed by its byte permutes, pairs of blocks as
one accumulation of 2s products with one requantize at tree level L (a
pair of blocks of 8 is one k16 step), the carry through stack levels 1
and 2 in registers and the push from level 3, the odd last block (a
zero-filled half step for s = 8) at level 0, and each accumulator
register's output; ``k2h_route`` and ``k2h_modes`` (its compiled tail
modes, against the kernel source's table) are checked.  The
kernels themselves are held against the plain version on the card by
``tests/test_torch_cuda.py``.
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
from qublas_tpu_torch import _build
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
# one more lossless layer: blocks of s = 32
LAYERS_S32 = LAYERS[:4] + (qformat(12, 8),) + LAYERS[4:]
CONFIGS = {"base": (MUL, LAYERS, OUT), "dl": (MUL_DL, LAYERS_DL, OUT_DL),
           "s32": (MUL, LAYERS_S32, OUT)}
# the top layer rounding, saturating or wrapping otherwise: tail modes that
# no tensor-core instantiation compiles in (read at run time)
TOPS = {"conv": qformat(6, 4, round_mode=RoundMode.RND_CONV,
                        overflow_mode=OverflowMode.SAT_ZERO),
        "sat": qformat(6, 4, overflow_mode=OverflowMode.SAT_TCPL),
        "wrap": qformat(6, 4, overflow_mode=OverflowMode.WRP_TCPL)}
CONFIGS.update({name: (MUL, LAYERS[:4] + (top,), OUT)
                for name, top in TOPS.items()})


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

    csrc = pathlib.Path(TT.__file__).parent.parent / "csrc"
    tail = (csrc / "hybrid_tail.cuh").read_text()
    imad = (csrc / "tree_gemm_hybrid.cu").read_text()
    mma = (csrc / "tree_gemm_hybrid_mma.cu").read_text() + \
        (csrc / "tree_gemm_hybrid_mma.cuh").read_text()
    least = int(re.search(r"constexpr int HYB_MIN_LEVEL = (\d+);",
                          tail).group(1))
    assert least == TT._HYB_MIN_LEVEL
    # read_hybrid, which both kernels call, refuses a shorter prefix
    assert "p->level < HYB_MIN_LEVEL" in tail
    assert imad.count('#include "hybrid_tail.cuh"') == 1
    assert mma.count('#include "hybrid_tail.cuh"') == 1    # the .cuh
    assert "read_hybrid(" in imad and "read_hybrid(" in mma
    # the IMAD kernel folds half slices of 2^HYB_MIN_LEVEL products
    assert "constexpr int HALF = 1 << HYB_MIN_LEVEL;" in imad
    # the tensor-core kernel: a pair of the least blocks fills whole
    # m16n8k16 steps, an odd last one half of one
    frag_k = {int(x) for x in re.findall(r"mma\.sync\.aligned\.m16n8k(\d+)",
                                         mma)}
    mma_k = int(re.search(r"constexpr int MMA_K = (\d+);", mma).group(1))
    assert frag_k == {mma_k}
    assert (2 << TT._HYB_MIN_LEVEL) % mma_k == 0
    assert (1 << TT._HYB_MIN_LEVEL) * 2 == mma_k
    assert "static_assert((2 << HYB_MIN_LEVEL) % MMA_K == 0" in mma


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


def _parse(params):
    """(level, dl, merges, drain ops, fin) from K2h's parameters."""
    p = list(params)
    level, dl, levels = p[0], p[1], p[2]
    merges = [p[3 + 5 * l:8 + 5 * l] for l in range(levels)]
    q = 3 + 5 * levels
    nd = p[q]
    ops = [(p[q + 1 + 2 * s], p[q + 2 + 2 * s]) for s in range(nd)]
    return level, dl, merges, ops, p[q + 1 + 2 * nd:q + 6 + 2 * nd]


def _byte_perm(x, y, sel):
    """CUDA's ``__byte_perm(x, y, sel)`` on uint32 arrays: byte i of the
    result is byte ``sel >> 4 i & 7`` of the eight bytes of (x, y)."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + \
        [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(src[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))


def _sbytes(x):
    """The four signed bytes of uint32 array ``x``, on a new last axis."""
    b = (x[..., None] >> (8 * np.arange(4))) & 0xFF
    return b.astype(np.int64) - ((b >= 128) << 8)


# the lanes' groupID and thread-in-group
_G, _T = np.arange(32) >> 2, np.arange(32) & 3


def _mma(a0, a1, b, c):
    """``mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32`` on the PTX ISA's
    fragment layouts, for arrays of lanes [..., 32] (``c`` and the result
    [..., 32, 4]): lane (g, t) holds A's rows g (a0) and g + 8 (a1) at k
    4t..4t+3, B's column g at k 4t..4t+3, and D's rows g (registers 0, 1)
    and g + 8 (2, 3) at columns 2t, 2t + 1; the sum wraps to int32."""
    sh = a0.shape[:-1]
    A = np.zeros(sh + (16, 16), np.int64)
    Bm = np.zeros(sh + (16, 8), np.int64)
    kk = 4 * _T[:, None] + np.arange(4)                # [32, 4]
    A[..., _G[:, None], kk] = _sbytes(a0)
    A[..., _G[:, None] + 8, kk] = _sbytes(a1)
    Bm[..., kk, _G[:, None]] = _sbytes(b)
    D = A @ Bm                                         # [..., 16, 8]
    d = c.astype(np.int64).copy()
    for e in range(2):
        d[..., e] += D[..., _G, 2 * _T + e]
        d[..., 2 + e] += D[..., _G + 8, 2 * _T + e]
    return ((d + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)


def _replay_k2h_mma(a, b, params):
    """The tensor-core K2h kernel's schedule
    (``csrc/tree_gemm_hybrid_mma.cuh``) over int8 ``a`` [M, K] @ ``b`` [K, N], every warp of every 32 x 32 tile
    at once: stages of 64 products (zero past the matrices), k16 MMAs on
    each lane's fragments (A words at k 4t, B's columns 2g, 2g + 1 read as
    16-bit words at k 4t..4t+3 and transposed by the kernel's byte
    permutes), accumulated over a pair of blocks (2s products); at a pair's
    end its dot, shifted, through tree level L's requantize, then the
    binary carry through stack levels 1 and 2 (registers) and, one value in
    four pairs, the push onto level 3; where K ends an odd block, its
    shifted dot at stack level 0; the drain, the final requantize, and tile
    j's register i stored at row g + 8 (i >> 1), column 4t + 2 (i & 1) + j
    of the warp's 16 x 16 tile."""
    level, dl, merges, ops, fin = _parse(params)
    M, K = a.shape
    N = b.shape[1]
    Mp, Np, Kp = -(-M // 32) * 32, -(-N // 32) * 32, -(-K // 64) * 64
    A = np.zeros((Mp, Kp), np.uint8)
    A[:M, :K] = a.numpy().view(np.uint8)
    Bm = np.zeros((Kp, Np), np.uint8)
    Bm[:K, :N] = b.numpy().view(np.uint8)
    A, Bm = A.astype(np.uint32), Bm.astype(np.uint32)
    rows = 16 * np.arange(Mp // 16)[:, None, None] + _G     # [WR, 1, 32]
    cols = 16 * np.arange(Np // 16)[None, :, None] + 2 * _G  # [1, WC, 32]
    shape = (Mp // 16, Np // 16, 32, 8)

    def word(r, k):  # the four bytes A[r, k..k+3], little-endian
        return sum(A[r, k + i] << (8 * i) for i in range(4))

    slots = {}

    def push(v, base, t):
        top = base
        while t & (1 << (top - base)):
            v = _rq(slots[top] + v, merges[top])
            top += 1
        slots[top] = v

    acc = np.zeros(shape, np.int32)
    zero = torch.zeros(shape, dtype=torch.int32)
    first = l1 = l2 = zero   # stack levels 0, 1 and 2: the kernel's registers
    pairs = 0
    for st in range(-(-K // 64)):
        k0 = 64 * st
        for q in range((min(64, K - k0) + 15) // 16):
            kq = k0 + 16 * q
            a0 = np.broadcast_to(word(rows, kq + 4 * _T), shape[:3])
            a1 = np.broadcast_to(word(rows + 8, kq + 4 * _T), shape[:3])
            w = [Bm[kq + 4 * _T + i, cols] | Bm[kq + 4 * _T + i, cols + 1] << 8
                 for i in range(4)]
            w01 = _byte_perm(w[0], w[1], 0x5140)
            w23 = _byte_perm(w[2], w[3], 0x5140)
            bf = [np.broadcast_to(_byte_perm(w01, w23, sel), shape[:3])
                  for sel in (0x5410, 0x7632)]
            acc = np.concatenate(
                [_mma(a0, a1, bf[j], acc[..., 4 * j:4 * j + 4])
                 for j in range(2)], axis=-1)
            kend = min(kq + 16, K)
            if kend % (2 << level) == 0:
                v = _rq(torch.from_numpy(acc.copy()) << dl, merges[0])
                if pairs & 1 == 0:
                    l1 = v
                else:
                    v = _rq(l1 + v, merges[1])
                    if pairs & 2 == 0:
                        l2 = v
                    else:
                        push(_rq(l2 + v, merges[2]), 3, pairs >> 2)
                pairs += 1
                acc = np.zeros(shape, np.int32)
            elif kend == K:
                first = torch.from_numpy(acc.copy()) << dl
    slots.update({0: first, 1: l1, 2: l2})
    carry = None
    for op, l in ops:
        if op == 1:
            carry = _rq(carry, merges[l])
        elif op == 0:
            carry = slots[l]
        else:
            carry = _rq(slots[l] + carry, merges[l])
    res = _rq(carry, fin).numpy()
    out = np.zeros((Mp, Np), np.int32)
    for o in range(8):
        r = rows + 8 * ((o & 3) >> 1)
        c = cols - 2 * _G + 4 * _T + 2 * (o & 1) + (o >> 2)
        out[np.broadcast_to(r, shape[:3]), np.broadcast_to(c, shape[:3])] = \
            res[..., o]
    return torch.from_numpy(out[:M, :N])


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


@pytest.mark.parametrize("config,k,s", [
    ("base", 16, 16), ("base", 48, 16), ("base", 80, 16), ("base", 176, 16),
    ("base", 2040, 8), ("base", 2048, 16), ("base", 8, 8), ("base", 24, 8),
    ("dl", 32, 8), ("dl", 96, 8), ("dl", 104, 8), ("s32", 96, 32),
    ("s32", 2048, 32), ("conv", 2040, 8), ("conv", 2048, 16),
    ("sat", 2040, 8), ("sat", 2048, 16), ("wrap", 2040, 8),
    ("wrap", 2048, 16)])
@pytest.mark.parametrize("m,n", [(5, 6), (33, 17)])
def test_k2h_mma_schedule_matches_jax(config, k, s, m, n):
    """The tensor-core kernel's replay equals the JAX package's
    ``tree_gemm_hybrid`` and the port's plain version, Δ=0: s = 8 (an odd
    last block at k = 8 mod 16), 16 and 32, dl > 0, odd block counts,
    ragged tiles, tails that round, saturate or wrap."""
    import jax.numpy as jnp

    mul, layers, out = CONFIGS[config]
    jp, tp = _plans(FA, FA, mul, layers, k, out)
    assert tp.s == s and dataclasses.astuple(tp) == dataclasses.astuple(jp)
    A = _raws(k + m, FA, (m, k)).astype(np.int8)
    B = _raws(k + n, FA, (k, n)).astype(np.int8)
    A[0, :8] = B[:8, 0] = -128   # raw_min: the largest product, 2^14
    want = np.asarray(JT.tree_gemm_hybrid(jnp.asarray(A), jnp.asarray(B), jp,
                                          out))
    At, Bt = torch.from_numpy(A), torch.from_numpy(B)
    plain = TT.tree_gemm_hybrid_plain(At, Bt, tp, P(out))
    np.testing.assert_array_equal(plain.numpy(), want)
    got = _replay_k2h_mma(At, Bt, TT._hybrid_params(tp, k, P(out)))
    np.testing.assert_array_equal(got.to(plain.dtype).numpy(), want)


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


@pytest.mark.parametrize("replay", [_replay_k2h, _replay_k2h_mma],
                         ids=["imad", "mma"])
@pytest.mark.parametrize("field", ["dl", "merge0", "merge-top", "level"])
def test_k2h_schedule_replay_sees_a_wrong_parameter(field, replay):
    """Mutation check of the replays: a changed shift of the block values
    (dl), of the tail's first or last merge, or a block size of 8 for 16
    changes the result, so each replay reads each parameter it is given."""
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
    got = replay(A, B, params).to(want.dtype)
    assert not torch.equal(got, want)


@pytest.mark.parametrize("config,k,want", [
    ("base", 2048, 1), ("base", 176, 1), ("base", 48, 1), ("base", 2040, 2),
    ("dl", 2048, 1), ("dl", 96, 1), ("s32", 2048, 1), ("base", 16, 1),
    ("conv", 2040, 0), ("conv", 2048, 0), ("sat", 2040, 0),
    ("sat", 2048, 0), ("wrap", 2040, 0), ("wrap", 2048, 0)])
def test_k2h_modes_of_the_hybrid_configurations(config, k, want):
    """The JAX package's hybrid configurations take the tensor-core
    kernel's compiled tail modes: every tail merge TRN::TCPL, SAT::ZERO,
    or at k = 8 mod 16 (s = 8) tree level L's SAT::TCPL layer below them;
    a top layer that rounds, saturates or wraps otherwise reads them at
    run time (0), as the card tests' run-time cases do."""
    mul, layers, out = CONFIGS[config]
    _, tp = _plans(FA, FA, mul, layers, k, out)
    assert TT.k2h_modes(tp, k) == want


def test_k2h_modes_reads_only_the_tails_merges():
    """An instantiation is picked only when tree level L's merge and every
    merge above it over the k / s block values have its modes; any other
    mode there reads the modes at run time (0).  The lossless prefix's
    and the output's modes do not matter."""
    base = LAYERS[:4]
    for rm, om, top, want in (
            (RoundMode.TRN_TCPL, OverflowMode.SAT_ZERO, None, 1),
            (RoundMode.RND_CONV, OverflowMode.SAT_ZERO, None, 0),
            (RoundMode.TRN_TCPL, OverflowMode.SAT_TCPL, None, 0),
            (RoundMode.TRN_TCPL, OverflowMode.SAT_ZERO,
             qformat(7, 4, overflow_mode=OverflowMode.WRP_TCPL), 0),
            (RoundMode.TRN_TCPL, OverflowMode.SAT_ZERO,
             qformat(7, 4, overflow_mode=OverflowMode.SAT_ZERO), 1)):
        layers = base + (qformat(6, 4, round_mode=rm, overflow_mode=om),)
        if top is not None:
            layers += (top,)
        _, tp = _plans(FA, FA, MUL, layers, 2048, OUT)
        assert tp is not None and tp.s == 16
        assert TT.k2h_modes(tp, 2048) == want, (rm, om, top)
    # the prefix's layers may round and wrap as they like: lossless there
    odd = tuple(dataclasses.replace(f, round_mode=RoundMode.RND_CONV,
                                    overflow_mode=OverflowMode.WRP_TCPL)
                for f in base)
    _, tp = _plans(FA, FA, MUL, odd + LAYERS[4:], 2048,
                   qformat(5, 4, round_mode=RoundMode.RND_ZERO))
    assert tp is not None and tp.s == 16 and TT.k2h_modes(tp, 2048) == 1


def test_k2h_modes_match_the_kernel_source():
    """csrc/tree_gemm_hybrid_mma.cuh's K2H_MODES: the run-time entry, then
    ops.tree_gemm.K2H_MODES, as k2h_modes numbers them; one source
    instantiates each entry."""
    import pathlib
    import re

    csrc = pathlib.Path(TT.__file__).parent.parent / "csrc"
    src = (csrc / "tree_gemm_hybrid_mma.cuh").read_text()
    for i in range(len(TT.K2H_MODES) + 1):
        name = "tree_gemm_hybrid_mma" + (f"_{i}" if i else "") + ".cu"
        assert f"K2H_INSTANCE({i});" in (csrc / name).read_text()
    body = re.search(r"K2H_MODES\[\]\[3\] = \{(.*?)\};", src,
                     re.S).group(1)
    rows = [[x.strip().replace("qk::", "") for x in r.split(",")]
            for r in re.findall(r"\{([^{}]*)\}", body)]
    assert rows[0] == ["ANY"] * 3
    assert rows[1:] == [[m.name for m in e] for e in TT.K2H_MODES]


@pytest.mark.parametrize("da", [torch.int8, torch.int16, torch.int32])
@pytest.mark.parametrize("db", [torch.int8, torch.int16, torch.int32])
def test_k2h_route_by_lanes(da, db):
    """int8 x int8 lanes take the tensor-core kernel; any wider lane the
    IMAD kernel, which widens both operands to int32."""
    a, b = torch.zeros((2, 16), dtype=da), torch.zeros((16, 3), dtype=db)
    want = "mma" if da == db == torch.int8 else "imad"
    assert TT.k2h_route(a, b) == want


def _c_entries():
    """{name: C parameter types} of every ``extern "C"`` entry point in
    the kernels' sources."""
    import pathlib
    import re

    out = {}
    for src in (pathlib.Path(TT.__file__).parent.parent / "csrc").glob("*.cu"):
        for name, args in re.findall(r'extern "C" int (\w+)\((.*?)\)',
                                     src.read_text(), re.S):
            out[name] = [" ".join(a.split()[:-1]) for a in args.split(",")]
    return out


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_ctypes_signatures_match_the_entry_points(name):
    """Each kernel entry point's ctypes argument types (``_build``) are its
    C parameters' (pointers, int, long long), so a CUDA launch on the card
    passes what the kernel reads; K2h's two entries among them."""
    import ctypes

    kind = {ctypes.c_void_p: "ptr", ctypes.c_int: "int",
            ctypes.c_longlong: "long long"}
    c_types = _c_entries()[name]
    want = ["ptr" if t.endswith("*") else t.replace("const ", "")
            for t in c_types]
    assert [kind[t] for t in _build._SIGNATURES[name]] == want
