"""The port's prefix-lossless hybrid tier against the JAX package, Δ=0.

``plan_hybrid`` is the port's copy of the JAX planner, pinned to it over a
sweep of formats and k.  K2h's plain version (``tree_gemm_hybrid_plain``:
one matmul a block, the tail layer by layer) must give the raws of the JAX
package's ``tree_gemm_hybrid``, and ``qgemul`` on the hybrid tier those of
the JAX ``qgemul`` and of the host golden model, at the JAX package's own
k (16, 48, 64, 80, 176: odd block counts included), with a shift dl > 0,
batched and broadcast; and the bits of K2 on ``plan_tree`` of the same
configuration.  The K2h kernels cannot run here, so their schedules are
replayed from the int32 parameters they receive (``_hybrid_params``): the
tensor-core kernel for int8 lanes (``csrc/tree_gemm_hybrid_mma.cu``) down
to its fragments: stages of 64 products, m16n8k16 MMAs on the PTX fragment
layouts, B's columns transposed by its byte permutes, pairs of blocks as
one accumulation of 2s products with one requantize at tree level L (a
pair of blocks of 8 is one k16 step), the carry through stack levels 1
and 2 in registers and the push from level 3, the odd last block (a
zero-filled half step for s = 8) at level 0, and each accumulator
register's output; and the same template on int16 and int32 lanes (the
digit kernels): each element's byte digits (u8 low bytes, s8 top byte)
split from the staged words by the kernel's byte permutes, the u8/s8 MMAs
of each digit pair into the accumulator of its shift class, their sum in
wrapping int32 where a pair ends.  Mutation checks show that the replays
read each parameter; the digit split is checked on every int16 value, and
the digit kernels' plain version (``hybrid_digit_dots_plain``) against
the int32-wrapped block dot on full-range lanes.  ``k2h_route`` and
``k2h_modes`` (its compiled tail modes, against the kernel source's table)
are checked.  The kernels themselves are held against the plain version on
the card by ``tests/test_torch_cuda.py``.
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
    runs: a block spans half an m16n8k16 step on every lane width, and
    ``read_hybrid`` refuses a shorter level, so a plan the CPU runs is
    never one the kernel refuses."""
    import pathlib
    import re

    csrc = pathlib.Path(TT.__file__).parent.parent / "csrc"
    tail = (csrc / "hybrid_tail.cuh").read_text()
    mma = (csrc / "tree_gemm_hybrid_mma.cu").read_text() + \
        (csrc / "tree_gemm_hybrid_mma.cuh").read_text()
    least = int(re.search(r"constexpr int HYB_MIN_LEVEL = (\d+);",
                          tail).group(1))
    assert least == TT._HYB_MIN_LEVEL
    # read_hybrid, which the kernels' entry calls, refuses a shorter prefix
    assert "p->level < HYB_MIN_LEVEL" in tail
    assert mma.count('#include "hybrid_tail.cuh"') == 1    # the .cuh
    assert "read_hybrid(" in mma
    # every K2h source is the tensor-core template's entry or an
    # instantiation of it
    for src in csrc.glob("tree_gemm_hybrid*.cu"):
        assert '#include "tree_gemm_hybrid_mma.cuh"' in src.read_text()
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


def _bytes(x, signed=True):
    """The four bytes of uint32 array ``x``, on a new last axis, read as
    signed (s8) or unsigned (u8)."""
    b = ((x[..., None] >> (8 * np.arange(4))) & 0xFF).astype(np.int64)
    return b - ((b >= 128) << 8) if signed else b


# the lanes' groupID and thread-in-group
_G, _T = np.arange(32) >> 2, np.arange(32) & 3


def _mma(a0, a1, b, c, sa=True, sb=True):
    """``mma.sync.aligned.m16n8k16.row.col.s32.{s8,u8}.{s8,u8}.s32`` (A's
    bytes s8 when ``sa``, B's when ``sb``) on the PTX ISA's fragment
    layouts, for arrays of lanes [..., 32] (``c`` and the result
    [..., 32, 4]): lane (g, t) holds A's rows g (a0) and g + 8 (a1) at k
    4t..4t+3, B's column g at k 4t..4t+3, and D's rows g (registers 0, 1)
    and g + 8 (2, 3) at columns 2t, 2t + 1; the sum wraps to int32."""
    sh = a0.shape[:-1]
    A = np.zeros(sh + (16, 16), np.int64)
    Bm = np.zeros(sh + (16, 8), np.int64)
    kk = 4 * _T[:, None] + np.arange(4)                # [32, 4]
    A[..., _G[:, None], kk] = _bytes(a0, sa)
    A[..., _G[:, None] + 8, kk] = _bytes(a1, sa)
    Bm[..., kk, _G[:, None]] = _bytes(b, sb)
    D = A @ Bm                                         # [..., 16, 8]
    d = c.astype(np.int64).copy()
    for e in range(2):
        d[..., e] += D[..., _G, 2 * _T + e]
        d[..., 2 + e] += D[..., _G + 8, 2 * _T + e]
    return _wrap32(d)


def _wrap32(x):
    """int64 array ``x`` mod 2^32, as int32."""
    return ((x + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)


def _transpose_bytes(w0, w1, w2, w3):
    """The kernels' ``transpose_bytes``: word j holds byte j of w0, w1, w2
    and w3, by its eight byte permutes."""
    t0, t1 = _byte_perm(w0, w1, 0x5140), _byte_perm(w0, w1, 0x7362)
    t2, t3 = _byte_perm(w2, w3, 0x5140), _byte_perm(w2, w3, 0x7362)
    return [_byte_perm(t0, t2, 0x5410), _byte_perm(t0, t2, 0x7632),
            _byte_perm(t1, t3, 0x5410), _byte_perm(t1, t3, 0x7632)]


def _replay_k2h_tc(a, b, params, d):
    """K2h's tensor-core schedule (``csrc/tree_gemm_hybrid_mma.cuh``) over
    ``a`` [M, K] @ ``b`` [K, N] in ``d``-byte lanes, every warp of every
    32 x 32 tile at once: stages of 64 products (zero past the matrices),
    each lane's fragments of a k16 step read as the kernel reads the
    staged bytes, the MMAs of each digit pair (i, j) into the accumulator
    of shift class i + j (d = 1: one s8 MMA), accumulated over a pair of
    blocks (2s products); at a pair's end the classes' sum (class c
    shifted by 8c, wrapping), shifted by dl, through tree level L's
    requantize, then the binary carry through stack levels 1 and 2
    (registers) and, one value in four pairs, the push onto level 3; where
    K ends an odd block, its shifted sum at stack level 0; the drain, the
    final requantize, and tile j's register i stored at row g + 8 (i >>
    1), column 4t + 2 (i & 1) + j of the warp's 16 x 16 tile."""
    level, dl, merges, ops, fin = _parse(params)
    M, K = a.shape
    N = b.shape[1]
    Mp, Np, Kp = -(-M // 32) * 32, -(-N // 32) * 32, -(-K // 64) * 64
    A = np.zeros((Mp, Kp * d), np.uint8)
    A[:M, :K * d] = a.contiguous().numpy().view(np.uint8).reshape(M, K * d)
    Bm = np.zeros((Kp, Np * d), np.uint8)
    Bm[:K, :N * d] = b.contiguous().numpy().view(np.uint8).reshape(K, N * d)
    A, Bm = A.astype(np.uint32), Bm.astype(np.uint32)
    rows = 16 * np.arange(Mp // 16)[:, None, None] + _G     # [WR, 1, 32]
    cols = 16 * np.arange(Np // 16)[None, :, None] + 2 * _G  # [1, WC, 32]
    shape = (Mp // 16, Np // 16, 32, 8)
    classes = min(2 * d - 1, 4)

    def word(X, r, c):  # the four bytes X[r, c..c+3], little-endian
        return np.broadcast_to(sum(X[r, c + i] << (8 * i) for i in range(4)),
                               shape[:3])

    def frags(kq):
        """(A's fragments [h][digit], B's [tile][digit]) at k16 step kq:
        A's rows g + 8h at k 4t..4t+3, B's columns 2g + j."""
        k, kb = kq + 4 * _T, kq + 4 * _T
        if d == 1:
            fa = [[word(A, rows + 8 * h, k)] for h in range(2)]
            w = [Bm[kb + i, cols] | Bm[kb + i, cols + 1] << 8
                 for i in range(4)]
            w01 = _byte_perm(w[0], w[1], 0x5140)
            w23 = _byte_perm(w[2], w[3], 0x5140)
            fb = [[np.broadcast_to(_byte_perm(w01, w23, sel), shape[:3])]
                  for sel in (0x5410, 0x7632)]
        elif d == 2:
            fa = []
            for h in range(2):
                x = word(A, rows + 8 * h, 2 * k)
                y = word(A, rows + 8 * h, 2 * k + 4)
                fa.append([_byte_perm(x, y, 0x6420),
                           _byte_perm(x, y, 0x7531)])
            r = _transpose_bytes(*[word(Bm, kb + i, 2 * cols)
                                   for i in range(4)])
            fb = [r[:2], r[2:]]
        else:
            fa = [_transpose_bytes(*[word(A, rows + 8 * h, 4 * k + 4 * j)
                                     for j in range(4)]) for h in range(2)]
            fb = [_transpose_bytes(*[word(Bm, kb + i, 4 * cols + 4 * j)
                                     for i in range(4)]) for j in range(2)]
        return fa, fb

    def total(acc):  # the classes' sum, wrapping, as a torch tensor
        return torch.from_numpy(_wrap32(sum(
            acc[c].astype(np.int64) << (8 * c) for c in range(classes))))

    slots = {}

    def push(v, base, t):
        top = base
        while t & (1 << (top - base)):
            v = _rq(slots[top] + v, merges[top])
            top += 1
        slots[top] = v

    acc = np.zeros((classes,) + shape, np.int32)
    zero = torch.zeros(shape, dtype=torch.int32)
    first = l1 = l2 = zero   # stack levels 0, 1 and 2: the kernel's registers
    pairs = 0
    for st in range(-(-K // 64)):
        k0 = 64 * st
        for q in range((min(64, K - k0) + 15) // 16):
            kq = k0 + 16 * q
            fa, fb = frags(kq)
            for j in range(2):
                for i in range(d):
                    for h in range(d):
                        if i + h < classes:
                            acc[i + h][..., 4 * j:4 * j + 4] = _mma(
                                fa[0][i], fa[1][i], fb[j][h],
                                acc[i + h][..., 4 * j:4 * j + 4],
                                i == d - 1, h == d - 1)
            kend = min(kq + 16, K)
            if kend % (2 << level) == 0:
                v = _rq(total(acc) << dl, merges[0])
                if pairs & 1 == 0:
                    l1 = v
                else:
                    v = _rq(l1 + v, merges[1])
                    if pairs & 2 == 0:
                        l2 = v
                    else:
                        push(_rq(l2 + v, merges[2]), 3, pairs >> 2)
                pairs += 1
                acc = np.zeros((classes,) + shape, np.int32)
            elif kend == K:
                first = total(acc) << dl
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


def _replay_k2h_mma(a, b, params):
    """The tensor-core K2h kernel's schedule on int8 ``a`` [M, K] @ ``b``
    [K, N]: one s8 MMA a k16 step and n8 tile, A words at k 4t, B's
    columns 2g, 2g + 1 read as 16-bit words at k 4t..4t+3 and transposed by
    the kernel's four byte permutes (:func:`_replay_k2h_tc`)."""
    return _replay_k2h_tc(a, b, params, 1)


def _replay_k2h_digits(a, b, params):
    """The digit kernels' schedule on ``a`` @ ``b`` in int16 or int32 lanes
    (the narrower operand widened, as the op does): D = 2 or 4 bytes an
    element, A's row split into its digit planes by byte permutes of an
    8-byte word pair (D = 2: lo u8, hi s8) or a 4 x 4 byte transpose of a
    16-byte quad (D = 4: three u8 planes, the top byte s8), B's columns
    2g, 2g + 1 at k 4t..4t+3 by the 4 x 4 transpose of their 2D-byte words;
    the u8/s8 MMAs of each digit pair (4 for D = 2 into three shift classes,
    10 for D = 4 into four), the classes' sum where a pair ends
    (:func:`_replay_k2h_tc`)."""
    d = max(a.element_size(), b.element_size())
    lane = {2: torch.int16, 4: torch.int32}[d]
    return _replay_k2h_tc(a.to(lane), b.to(lane), params, d)


@pytest.mark.parametrize("lane", [torch.int16, torch.int32])
@pytest.mark.parametrize("config,k", [("base", 16), ("base", 48),
                                      ("base", 80), ("base", 176),
                                      ("base", 2040), ("base", 4096),
                                      ("dl", 32), ("dl", 96)])
def test_k2h_schedule_matches_plain(config, k, lane):
    """The digit kernels' replay on int16 and int32 copies of int8
    operands equals the plain version on the int8 lanes: the digit planes
    of a narrow value (its high bytes 0 or all ones) give its dots."""
    mul, layers, out = CONFIGS[config]
    _, tp = _plans(FA, FA, mul, layers, k, out)
    A = torch.from_numpy(_raws(k, FA, (5, k))).to(torch.int8)
    B = torch.from_numpy(_raws(k + 3, FA, (k, 6))).to(torch.int8)
    want = TT.tree_gemm_hybrid_plain(A, B, tp, P(out))
    params = TT._hybrid_params(tp, k, P(out))
    assert list(params[:2]) == [tp.level, tp.dl]
    got = _replay_k2h_digits(A.to(lane), B.to(lane), params).to(want.dtype)
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


# The digit kernels' configurations: (fa, fb, mul_to, layers, out).  int16
# lanes (chip_smoke.py's i1 int16: Qu<5,6>, 12 bits), int16 x int8, int32
# lanes (Qu<8,8>: 17 bits) against int8 and against int16 (Qu<4,4>).
_SZ = OverflowMode.SAT_ZERO
DIGIT_CONFIGS = {
    "i16": (qformat(5, 6), qformat(5, 6), qformat(11, 12),
            (qformat(12, 12), qformat(13, 12), qformat(14, 12),
             qformat(15, 12), qformat(10, 6, overflow_mode=_SZ)),
            qformat(7, 6)),
    "i16xi8": (qformat(5, 6), qformat(3, 4), qformat(9, 10),
               (qformat(10, 10), qformat(11, 10), qformat(12, 10),
                qformat(13, 10), qformat(8, 5, overflow_mode=_SZ)),
               qformat(6, 4)),
    "i32xi8": (qformat(8, 8), qformat(3, 4), qformat(12, 12),
               (qformat(13, 12), qformat(14, 12), qformat(15, 12),
                qformat(16, 12), qformat(10, 6, overflow_mode=_SZ)),
               qformat(7, 6)),
    "i16xi32": (qformat(4, 4), qformat(8, 8), qformat(13, 12),
                (qformat(14, 12), qformat(15, 12), qformat(16, 12),
                 qformat(17, 12), qformat(10, 6, overflow_mode=_SZ)),
                qformat(7, 6)),
}


def _lane_raws(rng, fmt, shape, full):
    """Raws of ``fmt`` in its lane, or (``full``) over the whole lane,
    outside the format, its least and greatest values included."""
    import jax.numpy as jnp

    from qublas_tpu.ops.widths import dtype_for

    dt = np.dtype(jnp.dtype(dtype_for(fmt)).name)
    lo, hi = (np.iinfo(dt).min, np.iinfo(dt).max) if full \
        else (fmt.raw_min, fmt.raw_max)
    x = rng.randint(lo, hi + 1, shape, dtype=np.int64)
    if full:
        x.flat[:4] = (lo, hi, lo, hi)
    return x.astype(dt)


@pytest.mark.parametrize("config", sorted(DIGIT_CONFIGS))
@pytest.mark.parametrize("k", [48, 176, 2040])
@pytest.mark.parametrize("full", [False, True], ids=["in", "full"])
@pytest.mark.parametrize("m,n", [(5, 6), (33, 17)])
def test_k2h_digits_schedule_matches_jax(config, k, full, m, n):
    """The digit kernels' replay, their plain version (the op's CPU
    implementation: ``hybrid_digit_dots_plain`` and the tail) and
    ``tree_gemm_hybrid_plain`` equal the JAX package's
    ``tree_gemm_hybrid``, Δ=0, on int16 lanes, int16 x int8, int32 x int8
    and int16 x int32: raws inside the formats, and over the whole lanes
    (the block dots wrap mod 2^32 as the JAX einsum's int32 dot does);
    s = 8 and 16, odd block counts, ragged tiles."""
    import jax.numpy as jnp

    fa, fb, mul_to, layers, out = DIGIT_CONFIGS[config]
    jp, tp = _plans(fa, fb, mul_to, layers, k, out)
    assert tp is not None and dataclasses.astuple(tp) == \
        dataclasses.astuple(jp)
    rng = np.random.RandomState(k + m + 7 * full)
    A = _lane_raws(rng, fa, (m, k), full)
    B = _lane_raws(rng, fb, (k, n), full)
    want = np.asarray(JT.tree_gemm_hybrid(jnp.asarray(A), jnp.asarray(B), jp,
                                          out))
    At, Bt = torch.from_numpy(A), torch.from_numpy(B)
    assert TT.k2h_route(At, Bt) == "digits"
    plain = TT.tree_gemm_hybrid_plain(At, Bt, tp, P(out))
    np.testing.assert_array_equal(plain.numpy(), want)
    op = TT.tree_gemm_hybrid(At, Bt, tp, P(out))
    np.testing.assert_array_equal(op.numpy(), want)
    got = _replay_k2h_digits(At, Bt, TT._hybrid_params(tp, k, P(out)))
    np.testing.assert_array_equal(got.to(plain.dtype).numpy(), want)


def test_digit_split_every_int16_value():
    """Every int16 value is its low byte (u8) plus 256 times its high
    byte (s8): ``digit_planes`` and the kernel's byte permutes of the
    staged word pairs (0x6420: the low bytes of four elements, 0x7531:
    the high bytes) give those digits, and they rebuild the value."""
    x = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    lo, hi = TT.digit_planes(x, 2)
    assert lo.min() == 0 and lo.max() == 255
    assert hi.min() == -128 and hi.max() == 127
    assert torch.equal(lo + 256 * hi, x.to(torch.int64))
    words = x.numpy().view(np.uint32).astype(np.int64)  # two elements a word
    xw, yw = words[0::2], words[1::2]                   # an 8-byte load
    a_lo = _bytes(_byte_perm(xw, yw, 0x6420), signed=False)
    a_hi = _bytes(_byte_perm(xw, yw, 0x7531), signed=True)
    np.testing.assert_array_equal(a_lo.reshape(-1), lo.numpy())
    np.testing.assert_array_equal(a_hi.reshape(-1), hi.numpy())


def test_digit_split_int32_extremes_and_samples():
    """int32 lanes as four digits (three u8, the top byte s8): the
    extremes, powers of two and their neighbours, and random samples are
    rebuilt exactly, by ``digit_planes`` and by the kernel's 4 x 4 byte
    transpose of four staged elements."""
    edge = [-2 ** 31, 2 ** 31 - 1, 0, -1, 1, -256, 255, 256]
    edge += [s * 2 ** e + d for e in range(31) for s in (1, -1)
             for d in (-1, 0, 1) if -2 ** 31 <= s * 2 ** e + d < 2 ** 31]
    vals = np.concatenate([edge, np.random.RandomState(3).randint(
        -2 ** 31, 2 ** 31, 4096, dtype=np.int64)])
    vals = vals[:len(vals) // 4 * 4]        # whole quads of elements
    x = torch.from_numpy(vals.astype(np.int32))
    planes = TT.digit_planes(x, 4)
    assert planes[:3].min() >= 0 and planes[:3].max() <= 255
    assert planes[3].min() >= -128 and planes[3].max() <= 127
    assert torch.equal(sum(planes[i] << (8 * i) for i in range(4)),
                       x.to(torch.int64))
    w = x.numpy().view(np.uint32).astype(np.int64).reshape(-1, 4)
    r = _transpose_bytes(w[:, 0], w[:, 1], w[:, 2], w[:, 3])
    for i in range(4):
        got = _bytes(r[i], signed=i == 3)         # [n / 4, 4 elements]
        np.testing.assert_array_equal(got.reshape(-1), planes[i].numpy())


@pytest.mark.parametrize("da,db", [(np.int8, np.int8), (np.int16, np.int16),
                                   (np.int16, np.int8), (np.int8, np.int16),
                                   (np.int32, np.int32), (np.int32, np.int8),
                                   (np.int16, np.int32)])
@pytest.mark.parametrize("s", [8, 16, 32])
def test_hybrid_digit_dots_plain_is_the_wrapped_block_dot(da, db, s):
    """``hybrid_digit_dots_plain`` on lanes filled over their whole range
    (extremes included) equals each block's dot mod 2^32, as the JAX
    package's einsum forms it (``preferred_element_type=int32``) and as
    int64 arithmetic wraps it."""
    import jax.numpy as jnp

    rng = np.random.RandomState(s)
    k, m, n = 6 * s, 7, 5

    def full(dt, shape):
        i = np.iinfo(dt)
        x = rng.randint(i.min, i.max + 1, shape, dtype=np.int64)
        x.flat[:2] = (i.min, i.max)
        return x.astype(dt)

    A, B = full(da, (m, k)), full(db, (k, n))
    got = TT.hybrid_digit_dots_plain(torch.from_numpy(A), torch.from_numpy(B),
                                     s)
    assert got.dtype == torch.int32 and got.shape == (k // s, m, n)
    a64, b64 = A.astype(np.int64), B.astype(np.int64)
    want = np.stack([a64[:, t * s:(t + 1) * s] @ b64[t * s:(t + 1) * s]
                     for t in range(k // s)])
    np.testing.assert_array_equal(got.numpy(), _wrap32(want))
    jx = jnp.einsum("mts,tsn->tmn", jnp.asarray(A).reshape(m, k // s, s),
                    jnp.asarray(B).reshape(k // s, s, n),
                    preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jx))


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


@pytest.mark.parametrize("replay", [
    lambda a, b, p: _replay_k2h_digits(a.to(torch.int16), b, p),
    _replay_k2h_mma], ids=["digits", "mma"])
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
    entry = (csrc / "tree_gemm_hybrid_mma.cu").read_text()
    for i in range(len(TT.K2H_MODES) + 1):
        name = "tree_gemm_hybrid_mma" + (f"_{i}" if i else "") + ".cu"
        assert f"K2H_INSTANCE({i});" in (csrc / name).read_text()
        # the digit kernels: one source an instantiation, every lane width
        for d in (2, 4):
            inst = (csrc / f"tree_gemm_hybrid_mma_d{d}_{i}.cu").read_text()
            assert f"K2H_DIGIT_INSTANCE({d}, {i});" in inst
            assert f"extern K2H_DIGIT_INSTANCE({d}, {i});" in src
            assert f"k2h::launch_modes<{i}, {d}>" in entry
    body = re.search(r"K2H_MODES\[\]\[3\] = \{(.*?)\};", src,
                     re.S).group(1)
    rows = [[x.strip().replace("qk::", "") for x in r.split(",")]
            for r in re.findall(r"\{([^{}]*)\}", body)]
    assert rows[0] == ["ANY"] * 3
    assert rows[1:] == [[m.name for m in e] for e in TT.K2H_MODES]


@pytest.mark.parametrize("da", [torch.int8, torch.int16, torch.int32])
@pytest.mark.parametrize("db", [torch.int8, torch.int16, torch.int32])
def test_k2h_route_by_lanes(da, db):
    """int8 x int8 lanes take the tensor-core kernel on int8 lanes; any
    wider lane the digit kernel of the wider lane's bytes, which widens
    the narrower operand to it."""
    a, b = torch.zeros((2, 16), dtype=da), torch.zeros((16, 3), dtype=db)
    want = "mma" if da == db == torch.int8 else "digits"
    assert TT.k2h_route(a, b) == want
    assert TT.digit_lanes(a, b) == max(da.itemsize, db.itemsize)


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
