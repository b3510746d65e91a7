"""K2's schedule and instantiation choice, checked on the CPU.

The tiled K2 kernel (``csrc/tree_gemm_tiled.cu``) cannot
run here, so its schedule is replayed in torch from the int32 parameter
array the kernel receives (``ops.tree_gemm._kernel_params`` with
``K2_LOG_BLK``), as ``tests/test_torch_reduce.py`` replays K3's: k in
slices of 16 products, each product folded in as a binary-carry count
(one merge per trailing one-bit of its index in the slice), a full slice's
value pushed onto the slot stack, a ragged last slice left in levels 0-3,
then the drain (levels below 4 read from the slice's partials) and the
final requantize.  The replay must equal ``tree_gemm_plain`` (held to the
JAX package by ``tests/test_torch_tree_gemm.py``).  ``k2_modes``, which
picks the compiled (round, overflow) instantiation, is swept over plans.
"""

import itertools

import numpy as np
import pytest
import torch

import qublas_tpu_torch as qt
from qublas_tpu_torch.ops import tree_gemm as TT
from qublas_tpu_torch.ops.wideint import requantize_i32, requantize_split_mul

F88Z = qt.qformat(8, 8, overflow_mode=qt.OverflowMode.SAT_ZERO)
LAYERS = (qt.qformat(9, 6, round_mode=qt.RoundMode.RND_CONV),
          qt.qformat(10, 4))
I32F = qt.qformat(3, 4, round_mode=qt.RoundMode.RND_CONV,
                  overflow_mode=qt.OverflowMode.WRP_TCPL)


def _raws(seed, fmt, shape):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(
        rng.randint(fmt.raw_min, fmt.raw_max + 1, size=shape).astype(np.int32))


def _rq_fmt(r):
    """A format whose requantize from frac ``d`` is ``r``'s step."""
    d, rnd, ovf, w, sgn = r
    return d, qt.QFormat(w - 1, 0, bool(sgn), qt.RoundMode(rnd),
                         qt.OverflowMode(ovf))


def _replay_k2(a, b, params):
    """K2's schedule over ``a`` [M, K] @ ``b`` [K, N] from its parameters:
    split, log_blk, prod[5], levels, merge[levels][5], ndrain,
    (op, level)[ndrain], fin[5]."""
    p = list(params)
    split, log_blk = p[0], p[1]
    levels = p[7]
    merges = [p[8 + 5 * l:13 + 5 * l] for l in range(levels)]
    q = 8 + 5 * levels
    nd = p[q]
    drain = [(p[q + 1 + 2 * s], p[q + 2 + 2 * s]) for s in range(nd)]
    fin = p[q + 1 + 2 * nd:q + 6 + 2 * nd]

    def rq(v, r):
        return requantize_i32(v, *_rq_fmt(r))

    def product(x, y):
        d, fmt = _rq_fmt(p[2:7])
        return requantize_split_mul(x, y, d, fmt) if split else \
            requantize_i32(x * y, d, fmt)

    def merge(l, left, right):
        return rq(left + right, merges[l])

    blk = 1 << log_blk
    k = a.shape[1]
    part, slots, t = {}, {}, 0
    for k0 in range(0, k, blk):
        cnt = min(blk, k - k0)
        for qq in range(cnt):
            v = product(a[:, k0 + qq, None], b[None, k0 + qq, :])
            ones = 0
            while qq & (1 << ones):   # one carry per trailing one-bit
                v = merge(ones, part.pop(ones), v)
                ones += 1
            if qq == blk - 1:         # a full slice: push its value
                j = 0
                while t & (1 << j):
                    v = merge(log_blk + j, slots.pop(j), v)
                    j += 1
                slots[j] = v
            else:
                part[ones] = v
        if cnt == blk:
            t += 1

    def level(l):
        return part[l] if l < log_blk else slots[l - log_blk]

    carry = None
    for op, l in drain:
        if op == 1:
            carry = rq(carry, merges[l])
        elif op == 0:
            carry = level(l)
        else:
            carry = merge(l, level(l), carry)
    return rq(carry, fin)


def _case(fmt, layers, k, seed=0, m=5, n=7):
    a = _raws(seed, fmt, (m, k))
    b = _raws(seed + 1, fmt, (k, n))
    plan = TT.plan_tree(fmt, fmt, qt.mul_merge(fmt, fmt), layers, k, fmt)
    assert plan is not None
    return a, b, plan


@pytest.mark.parametrize("k", [1, 2, 13, 16, 17, 48, 1000])
@pytest.mark.parametrize("config", ["canonical", "layered", "i32"])
def test_k2_schedule_matches_plain(k, config):
    fmt, layers = {"canonical": (F88Z, ()), "layered": (F88Z, LAYERS),
                   "i32": (I32F, ())}[config]
    a, b, plan = _case(fmt, layers, k, seed=k)
    want = TT.tree_gemm_plain(a, b, plan, fmt)
    params = TT._kernel_params(plan, fmt, TT.K2_LOG_BLK)
    got = _replay_k2(a, b, params).to(want.dtype)
    assert torch.equal(got, want)


@pytest.mark.parametrize("level,k", [(0, 17), (2, 13), (3, 1000),
                                     (5, 1000)])
def test_k2_schedule_replay_sees_a_wrong_merge(level, k):
    """Mutation check of the replay: one merge's shift changed in the
    parameters (0 -> 1) changes the result, so the replay reads every level
    it is given: levels 0-3 inside a slice or its ragged tail, 4 and up on
    the stack and in the drain.  Small raws keep the sums clear of
    SAT::ZERO, which would hide the change."""
    fmt = qt.qformat(3, 4)
    a, b, plan = _case(fmt, (), k, seed=3, m=16, n=16)
    want = TT.tree_gemm_plain(a, b, plan, fmt)
    params = list(TT._kernel_params(plan, fmt, TT.K2_LOG_BLK))
    d = 8 + 5 * level
    assert params[d] == 0 and level < plan.levels
    params[d] = 1
    got = _replay_k2(a, b, params).to(want.dtype)
    assert not torch.equal(got, want)


def test_k2_parameters_carry_its_block_size():
    _, _, plan = _case(F88Z, (), 48)
    assert TT._kernel_params(plan, F88Z, TT.K2_LOG_BLK)[1] == 4
    assert TT.K2_LOG_BLK == 4


_ROUNDS = (qt.RoundMode.TRN_TCPL, qt.RoundMode.RND_CONV)
_OVFS = (qt.OverflowMode.SAT_ZERO, qt.OverflowMode.SAT_TCPL,
         qt.OverflowMode.WRP_TCPL)


@pytest.mark.parametrize("rm,om", list(itertools.product(_ROUNDS, _OVFS)))
@pytest.mark.parametrize("layer", ["none", "same", "other-round",
                                   "other-ovf"])
def test_k2_modes_specialises_only_shared_pairs(rm, om, layer):
    """k2_modes returns a compiled pair only when the product and every
    merge share it; the operand format's own modes do not matter."""
    fmt = qt.qformat(4, 4, round_mode=qt.RoundMode.RND_ZERO)
    mul = qt.qformat(8, 8, round_mode=rm, overflow_mode=om)
    layers = {
        "none": (),
        "same": (qt.qformat(9, 8, round_mode=rm, overflow_mode=om),),
        "other-round": (qt.qformat(9, 8, round_mode=qt.RoundMode.RND_INF,
                                   overflow_mode=om),),
        "other-ovf": (qt.qformat(9, 8, round_mode=rm,
                                 overflow_mode=qt.OverflowMode.SAT_SMGN),),
    }[layer]
    out = qt.qformat(6, 2, round_mode=qt.RoundMode.RND_INF)
    for k in (1, 16, 100):
        plan = TT.plan_tree(fmt, fmt, mul, layers, k, out)
        assert plan is not None
        steps = (plan.mul_fmt,) + plan.merge_fmts
        shared = {(f.round_mode, f.overflow_mode) for f in steps}
        want = TT.K2_MODES.index(shared.pop()) + 1 \
            if len(shared) == 1 and shared <= set(TT.K2_MODES) else 0
        if layer in ("none", "same") and \
                (rm, om) == (qt.RoundMode.TRN_TCPL, qt.OverflowMode.SAT_ZERO):
            assert want == 1
        assert TT.k2_modes(plan) == want, (k, layer, rm, om)


def test_canonical_plan_takes_the_compiled_modes():
    _, _, plan = _case(F88Z, (), 2048)
    assert TT.k2_modes(plan) == 1
    _, _, plan = _case(F88Z, LAYERS, 128)
    assert TT.k2_modes(plan) == 0
