"""The torch port's Qreduce against the JAX package, Δ=0.

* ``qreduce`` (K3's plain version on the CPU for proven lane configs, the
  layered elementwise path or the host resume otherwise) against
  ``qublas_tpu.ops.reduce.qreduce``: BASELINE config 2, odd n, every axis
  form, no layer formats, an out-of-range raw at the odd tail, a host
  resume, n = 1 — raws, lane dtype and format fields;
* against the JAX Pallas reducer in interpret mode;
* ``qreduce_args`` and the copy of ``_plan_reduce_lanes``;
* K3's schedules, replayed from the kernel's own parameters
  (``ReducePlan.kernel_params``: the slot stack and drain that
  ``csrc/qreduce.cu`` runs; the warp kernel's lane subtrees and shuffle
  levels for every S it may take), against the layered plain version;
* which kernel and S a tensor takes (``k3_route``: n, lane type, a base
  off 16 bytes) and which compiled modes a plan takes (``k3_modes``,
  pinned to ``csrc/qreduce.cuh``'s table).

The kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import qublas_tpu_torch as qt
from qublas_tpu.ops import reduce as JR
from qublas_tpu.qformat import OverflowMode, RoundMode, qformat
from qublas_tpu.qtensor import from_raw as jfrom_raw
from qublas_tpu_torch.convert import port_format
from qublas_tpu_torch.ops import reduce as TR
from qublas_tpu_torch.ops.wideint import requantize_i32

F44 = qformat(4, 4)
CONFIG2 = (qformat(5, 3, round_mode=RoundMode.RND_CONV,
                   overflow_mode=OverflowMode.SAT_ZERO), qformat(6, 2))
SMGN = qformat(3, 4, overflow_mode=OverflowMode.SAT_SMGN)


def P(f):
    """The port's QFormat of a JAX-package format (or tuple of them)."""
    if isinstance(f, tuple):
        return tuple(P(x) for x in f)
    return port_format(f)


def _raws(seed, fmt, shape):
    rng = np.random.RandomState(seed)
    return rng.randint(fmt.raw_min, fmt.raw_max + 1, size=shape)


def _same(got, want):
    w = np.asarray(want.raw())
    assert dataclasses.astuple(got.fmt) == dataclasses.astuple(want.fmt)
    assert got.data.dtype == getattr(torch, str(w.dtype))
    assert got.shape == w.shape
    np.testing.assert_array_equal(got.raw(), w)


# name: (input format, layer formats, shape, axis, raw at the last element)
CASES = {
    "config2-64x64-axis1": (F44, CONFIG2, (64, 64), 1, None),
    "config2-axis0": (F44, CONFIG2, (64, 64), 0, None),
    "config2-axis-none": (F44, CONFIG2, (13, 7), None, None),
    "config2-3d-axis-2": (F44, CONFIG2, (5, 13, 3), -2, None),
    "config2-odd-n13": (F44, CONFIG2, (9, 13), 1, None),
    "config2-n1000": (F44, CONFIG2, (3, 1000), 1, None),
    "no-layers-odd": (F44, (), (7, 13), 1, None),
    "no-layers-smgn": (SMGN, (), (3, 7), 1, None),
    "one-layer-format": (F44, CONFIG2[:1], (4, 11), 1, None),
    "int32-lanes": (qformat(20, 8), (qformat(26, 2),), (3, 1000), 1, None),
    "int32-unproven": (qformat(20, 8), (qformat(29, 2),), (3, 1000), 1,
                       None),
    "unsigned-layers": (qformat(4, 4, signed=False),
                        (qformat(6, 2, signed=False,
                                 round_mode=RoundMode.RND_INF),),
                        (6, 21), 1, None),
    "n1": (F44, CONFIG2, (4, 1), 1, None),
    "n1-axis-none": (F44, CONFIG2, (1,), None, None),
    "tail-wart-smgn": (SMGN, (), (2, 7), 1, -128),
    "tail-wart-wide-lane": (qformat(3, 4), (), (2, 7), 1, 300),
    "tail-wart-unsigned": (qformat(3, 4, signed=False), (), (2, 7), 1, -100),
    "host-resume-layer1": (F44, (qformat(8, 8), qformat(1000, 0),
                                 qformat(6, 2)), (3, 8), 1, None),
    "host-resume-layer0": (F44, (qformat(1000, 0), qformat(6, 2)), (2, 5),
                           1, None),
    "word-wrap-host": (qformat(3, 4, overflow_mode=OverflowMode.WRP_TCPL_SAT),
                       (), (3, 6), 1, None),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_qreduce_matches_jax(name):
    fmt, layers, shape, axis, wart = CASES[name]
    raws = _raws(len(name), fmt, shape)
    if wart is not None:
        raws.reshape(-1)[-1] = wart
    want = JR.qreduce(jfrom_raw(raws, fmt), layers, axis=axis)
    got = qt.qreduce(qt.from_raw(raws, P(fmt), "cpu"), P(layers), axis=axis)
    _same(got, want)


def test_qreduce_matches_pallas_interpret(monkeypatch):
    """As tests/test_reduce_gemm.py runs the JAX package's Pallas reducer."""
    raws = _raws(7, F44, (128, 64))
    monkeypatch.setattr(JR, "_USE_PALLAS", True)
    assert JR._plan_reduce_lanes(F44, CONFIG2, 64) is not None
    want = JR.qreduce(jfrom_raw(raws, F44), CONFIG2, axis=1)
    got = qt.qreduce(qt.from_raw(raws, P(F44), "cpu"), P(CONFIG2), axis=1)
    _same(got, want)


def test_qreduce_rejects_empty_axis():
    with pytest.raises(ValueError, match="empty axis"):
        qt.qreduce(qt.from_raw(np.zeros((3, 0), np.int8), P(F44), "cpu"),
                   axis=1)


@pytest.mark.parametrize("n", [1, 4, 5])
def test_qreduce_args_matches_jax(n):
    fmts = (F44, qformat(2, 6), SMGN)
    raws = _raws(n, F44, (n,))
    vals = [(int(r), fmts[i % 3]) for i, r in enumerate(raws)]
    for layers in ((), CONFIG2):
        want = JR.qreduce_args([jfrom_raw(np.array(r), f) for r, f in vals],
                               layers)
        got = qt.qreduce_args([qt.from_raw(np.array(r), P(f), "cpu")
                               for r, f in vals], P(layers))
        assert dataclasses.astuple(got.fmt) == dataclasses.astuple(want.fmt)
        assert int(got.raw()) == int(np.asarray(want.raw()))


@pytest.mark.parametrize("layers", [(), CONFIG2, (qformat(20, 8),),
                                    (qformat(3, 4), qformat(40, 0))],
                         ids=["none", "config2", "wide-int32", "to-pair"])
def test_plan_reduce_lanes_matches_jax(layers):
    for fmt in (F44, SMGN, qformat(20, 8), qformat(28, 2),
                qformat(3, 4, overflow_mode=OverflowMode.WRP_TCPL_SAT),
                qformat(40, 0), qformat(4, 4, signed=False)):
        for n in (1, 2, 3, 13, 64, 1000, 1 << 20):
            want = JR._plan_reduce_lanes(fmt, layers, n)
            got = TR._plan_reduce_lanes(P(fmt), P(layers), n)
            if want is None:
                assert got is None, (fmt, n)
                continue
            sched_w, fin_w = want
            sched_g, fin_g = got
            assert [(dataclasses.astuple(c), dataclasses.astuple(lf), m)
                    for c, lf, m in sched_g] == \
                [(dataclasses.astuple(c), dataclasses.astuple(lf), m)
                 for c, lf, m in sched_w]
            assert dataclasses.astuple(fin_g) == dataclasses.astuple(fin_w)


class _Params:
    """K3's int32 parameters (``ReducePlan.kernel_params``) read back:
    log_blk, levels, merge[levels][5], ndrain, (op, level)[ndrain]."""

    def __init__(self, params):
        p = list(params)
        self.log_blk, levels = p[0], p[1]
        self.rqs = [p[2 + 5 * l:7 + 5 * l] for l in range(levels)]
        q = 2 + 5 * levels
        self.drain = [(p[q + 1 + 2 * s], p[q + 2 + 2 * s])
                      for s in range(p[q])]

    def rq(self, v, r):
        d, rnd, ovf, w, sgn = r
        fmt = qt.QFormat(w - 1, 0, bool(sgn), qt.RoundMode(rnd),
                         qt.OverflowMode(ovf))
        return requantize_i32(v, d, fmt)

    def merge(self, l, left, right):
        return self.rq(left + right, self.rqs[l])

    def push(self, slots, t, val, log_blk):
        """A block's value onto the binary-carry slot stack."""
        j = 0
        while t & (1 << j):
            val = self.merge(log_blk + j, slots.pop(j), val)
            j += 1
        slots[j] = val

    def run_drain(self, slots, log_blk):
        carry = None
        for op, l in self.drain:
            if op == 1:
                carry = self.rq(carry, self.rqs[l])
            elif op == 0:
                carry = slots[max(l - log_blk, 0)]
            else:
                carry = self.merge(l, slots[max(l - log_blk, 0)], carry)
        return carry


def _replay_k3(x, plan):
    """K3's schedule over the columns of ``x`` [n, batch], from the int32
    parameters the kernel receives: in-block fold, slot stack, drain."""
    p = _Params(plan.kernel_params())
    log_blk = p.log_blk
    blk = 1 << log_blk
    slots = {}
    for t in range(x.shape[0] // blk):
        v = x[t * blk:(t + 1) * blk].to(torch.int32)
        for l in range(log_blk):
            v = p.merge(l, v[0::2], v[1::2])
        p.push(slots, t, v[0], log_blk)
    return p.run_drain(slots, log_blk)


@pytest.mark.parametrize("n", [2, 3, 5, 7, 13, 16, 24, 48, 100, 1000, 1024])
@pytest.mark.parametrize("config", ["config2", "none", "smgn-wart", "mixed"])
def test_k3_schedule_matches_layered(n, config):
    fmt, layers = {
        "config2": (F44, CONFIG2),
        "none": (F44, ()),
        "smgn-wart": (SMGN, ()),
        "mixed": (qformat(6, 5), (qformat(7, 5), qformat(7, 5),
                                  qformat(6, 4, round_mode=RoundMode.RND_ZERO,
                                          overflow_mode=OverflowMode.WRP_TCPL),
                                  qformat(8, 3))),
    }[config]
    x = torch.from_numpy(_raws(n, fmt, (n, 37)))
    if config == "smgn-wart":
        x[-1] = fmt.raw_min  # SAT::SMGN would clamp it; qcast keeps it
    x = x.to(torch.int32 if fmt.storage_bits > 8 else torch.int8)
    plan = TR.plan_reduce(P(fmt), P(layers), n)
    want = TR.qreduce_plain(x, 0, plan)
    got = _replay_k3(x, plan).to(want.dtype)
    assert torch.equal(got, want)


def test_kernel_wrapper_checks_and_counts_nothing_on_cpu():
    plan = TR.plan_reduce(P(F44), P(CONFIG2), 8)
    x = torch.zeros((3, 8), dtype=torch.int16)
    TR.qreduce_kernel.launches = 0
    assert TR.qreduce_kernel(x, 1, plan).shape == (3,)
    assert TR.qreduce_kernel.launches == 0
    with pytest.raises(TypeError, match="int8/int16/int32"):
        TR.qreduce_kernel(x.float(), 1, plan)
    with pytest.raises(ValueError, match="plan's n"):
        TR.qreduce_kernel(x, 0, plan)
    assert TR.plan_reduce(P(F44), (), 1) is None


# ---------------------------------------------------------------------------
# K3's warp kernel (csrc/qreduce.cuh:qreduce_warp), its route and its modes
# ---------------------------------------------------------------------------

def _replay_k3_warp(x, params, s):
    """The warp kernel's schedule over the rows of ``x`` [batch, n], from
    the kernel's parameters, with S = ``s`` leaves a lane: each chunk of
    32 S leaves folded by lane i over its leaves [i S, (i+1) S) (levels
    0 .. log2 S - 1), then across the lanes as the shuffles do it (at level
    log2 S + j lanes i and i ^ 2^j merge, the lower lane's value left), the
    chunk's value pushed onto the slot stack at level log2 S + 5; then the
    drain."""
    p = _Params(params)
    log_s = s.bit_length() - 1
    log_c = log_s + 5
    lane = torch.arange(32)
    slots = {}
    for t in range(x.shape[1] >> log_c):
        v = x[:, t << log_c:(t + 1) << log_c].to(torch.int32)
        v = v.reshape(x.shape[0], 32, s)
        for l in range(log_s):
            v = p.merge(l, v[..., 0::2], v[..., 1::2])
        v = v[..., 0]
        for j in range(5):
            other = v[:, lane ^ (1 << j)]
            upper = ((lane >> j) & 1).bool()
            v = p.merge(log_s + j, torch.where(upper, other, v),
                        torch.where(upper, v, other))
        assert torch.equal(v, v[:, :1].expand_as(v))  # every lane agrees
        p.push(slots, t, v[:, 0], log_c)
    return p.run_drain(slots, log_c)


_WARP_CONFIGS = {
    "config2": (F44, CONFIG2),
    "none": (F44, ()),
    "smgn-wart": (SMGN, ()),
    "mixed": (qformat(6, 5), (qformat(7, 5), qformat(7, 5),
                              qformat(6, 4, round_mode=RoundMode.RND_ZERO,
                                      overflow_mode=OverflowMode.WRP_TCPL),
                              qformat(8, 3))),
}


def _lane_tensor(seed, fmt, shape):
    x = torch.from_numpy(_raws(seed, fmt, shape))
    return x.to(TR.torch_dtype_for(P(fmt)))


@pytest.mark.parametrize("n", [32, 64, 96, 512, 1000, 1024, 1536, 4096])
@pytest.mark.parametrize("config", sorted(_WARP_CONFIGS))
def test_k3_warp_schedule_matches_plain(n, config):
    """Every S the warp kernel may take for n (its largest, and the
    narrower ones an unaligned base gives) replays to qreduce_plain; an n
    that 32 does not divide takes the thread kernel's schedule."""
    fmt, layers = _WARP_CONFIGS[config]
    x = _lane_tensor(n + len(config), fmt, (5, n))
    if config == "smgn-wart":
        x[:, -1] = fmt.raw_min  # SAT::SMGN would clamp it; qcast keeps it
    plan = TR.plan_reduce(P(fmt), P(layers), n)
    want = TR.qreduce_plain(x, 1, plan)
    top = TR.k3_lanes(n, x.element_size(), 0)
    if top == 0:
        assert n % 32
        got = _replay_k3(x.t(), plan).to(want.dtype)
        assert torch.equal(got, want)
        return
    s = top
    while s:
        got = _replay_k3_warp(x, plan.kernel_params(), s).to(want.dtype)
        assert torch.equal(got, want), s
        s //= 2


@pytest.mark.parametrize("level", ["lane", "shuffle", "stack"])
def test_k3_warp_replay_sees_a_wrong_merge(level):
    """Mutation check of the replay: one merge's shift changed in the
    parameters (0 -> 1) changes the result, at a level folded inside a
    lane, across the lanes, or on the slot stack."""
    fmt = qformat(3, 4)
    n, s = 2048, 4
    x = _lane_tensor(5, fmt, (8, n))
    plan = TR.plan_reduce(P(fmt), (), n)
    want = TR.qreduce_plain(x, 1, plan)
    l = {"lane": 1, "shuffle": 4, "stack": 8}[level]
    params = list(plan.kernel_params())
    assert params[2 + 5 * l] == 0
    assert torch.equal(_replay_k3_warp(x, params, s).to(want.dtype), want)
    params[2 + 5 * l] = 1
    got = _replay_k3_warp(x, params, s).to(want.dtype)
    assert not torch.equal(got, want)


@pytest.mark.parametrize("shape,axis,dtype,offset,want", [
    ((3, 1024), 1, torch.int8, 0, ("warp", 32)),
    ((3, 1024), 1, torch.int8, 1, ("warp", 1)),
    ((3, 1024), 1, torch.int8, 2, ("warp", 2)),
    ((3, 1024), 1, torch.int8, 8, ("warp", 8)),
    ((3, 1024), 1, torch.int8, 16, ("warp", 32)),
    ((3, 1024), 1, torch.int8, 24, ("warp", 8)),
    ((3, 1024), 1, torch.int16, 0, ("warp", 16)),
    ((3, 1024), 1, torch.int16, 8, ("warp", 16)),
    ((3, 1024), 1, torch.int16, 1, ("warp", 1)),
    ((3, 1024), 1, torch.int32, 0, ("warp", 8)),
    ((3, 1024), 1, torch.int32, 2, ("warp", 2)),
    ((3, 96), 1, torch.int8, 0, ("warp", 1)),
    ((3, 64), 1, torch.int8, 0, ("warp", 2)),
    ((3, 4096), 1, torch.int8, 0, ("warp", 32)),
    ((3, 512), 1, torch.int8, 0, ("warp", 16)),
    ((3, 1000), 1, torch.int8, 0, ("thread", 0)),
    ((3, 13), 1, torch.int8, 0, ("thread", 0)),
    ((3, 1024, 5), 1, torch.int8, 0, ("columns", 0)),
    ((1024, 3), 0, torch.int8, 0, ("columns", 0)),
    ((3, 1024, 1), 1, torch.int8, 0, ("warp", 32)),
], ids=lambda v: str(v).replace(" ", "").replace("torch.", ""))
def test_k3_route(shape, axis, dtype, offset, want):
    """Rows whose length 32 divides take the warp kernel, with S from the
    lane type, n's factors of two and the base's alignment (a storage
    offset narrows the load); other rows the thread kernel; an axis with
    elements after it the columns kernel."""
    numel = int(np.prod(shape))
    base = torch.zeros(numel + 32, dtype=dtype)
    assert base.data_ptr() % 32 == 0
    x = base[offset:offset + numel].view(shape)
    assert x.storage_offset() == offset
    plan = TR.plan_reduce(P(F44), P(CONFIG2), shape[axis])
    assert TR.k3_route(x, axis, plan) == want
    s = want[1]
    if s:
        assert x.data_ptr() % min(s * x.element_size(), 16) == 0
        assert shape[axis] % (32 * s) == 0 and s * x.element_size() <= 32
    # the plain version does not care where the rows start
    assert torch.equal(TR.qreduce_kernel(x, axis, plan),
                       TR.qreduce_plain(x.clone(), axis, plan))


_MODE_PAIRS = [(RoundMode.TRN_TCPL, OverflowMode.SAT_ZERO),
               (RoundMode.RND_CONV, OverflowMode.SAT_ZERO),
               (RoundMode.TRN_TCPL, OverflowMode.SAT_TCPL),
               (RoundMode.RND_CONV, OverflowMode.SAT_TCPL),
               (RoundMode.TRN_SMGN, OverflowMode.WRP_TCPL)]


@pytest.mark.parametrize("first", range(len(_MODE_PAIRS)))
@pytest.mark.parametrize("upper", range(len(_MODE_PAIRS)))
@pytest.mark.parametrize("layers", ["one", "two", "three"])
def test_k3_modes_specialises_only_matching_plans(first, upper, layers):
    """k3_modes picks entry i + 1 only when layer 0 merges with
    K3_MODES[i]'s first pair and every layer above (the drain's converts
    included) with its upper pair; else 0.  One layer format gives every
    level the same pair; a third format changes the levels from 2 up."""
    r0, o0 = _MODE_PAIRS[first]
    r1, o1 = _MODE_PAIRS[upper]
    lf = {
        "one": (qformat(5, 3, round_mode=r0, overflow_mode=o0),),
        "two": (qformat(5, 3, round_mode=r0, overflow_mode=o0),
                qformat(6, 2, round_mode=r1, overflow_mode=o1)),
        "three": (qformat(5, 3, round_mode=r0, overflow_mode=o0),
                  qformat(6, 2, round_mode=r1, overflow_mode=o1),
                  qformat(7, 1, round_mode=RoundMode.RND_INF)),
    }[layers]
    for n in (2, 3, 13, 1024):
        plan = TR.plan_reduce(P(F44), P(lf), n)
        assert plan is not None
        above = {"one": (r0, o0), "two": (r1, o1)}.get(layers)
        if layers == "three":
            above = (r1, o1) if n < 4 else None   # level 2 is RND::INF's
        want = 0
        for i, entry in enumerate(TR.K3_MODES):
            if entry == ((r0, o0), above):
                want = i + 1
        assert TR.k3_modes(plan) == want == plan.modes, (n, layers)


def test_k3_modes_of_the_main_paths():
    """BASELINE config 2 takes entry 1, the layered canonical GEMM's
    reduce entry 2 (its product format Qu<8,8,TRN::TCPL,SAT::ZERO>, no
    layer formats), the default-mode formats the run-time entry 0."""
    f88z = qformat(8, 8, overflow_mode=OverflowMode.SAT_ZERO)
    assert TR.plan_reduce(P(F44), P(CONFIG2), 1024).modes == 1
    assert TR.plan_reduce(P(F44), P(CONFIG2), 13).modes == 1
    assert TR.plan_reduce(P(f88z), (), 512).modes == 2
    assert TR.plan_reduce(P(F44), (), 1024).modes == 0
    assert TR.plan_reduce(P(SMGN), (), 64).modes == 0


def test_k3_modes_match_the_kernel_source():
    """ops.reduce.K3_MODES lists csrc/qreduce.cuh's K3_MODES after its
    run-time entry."""
    import pathlib
    import re

    src = (pathlib.Path(TR.__file__).parent.parent / "csrc" /
           "qreduce.cuh").read_text()
    body = re.search(r"K3_MODES\[\]\[4\] = \{(.*?)\};", src, re.S).group(1)
    rows = re.findall(r"\{(\w+), (\w+), (\w+), (\w+)\}", body)
    assert rows[0] == ("ANY",) * 4
    names = [((qt.RoundMode[a], qt.OverflowMode[b]),
              (qt.RoundMode[c], qt.OverflowMode[d])) for a, b, c, d in rows[1:]]
    assert tuple(names) == TR.K3_MODES


def test_k3_parameters_are_built_once():
    plan = TR.plan_reduce(P(F44), P(CONFIG2), 1000)
    assert plan.kernel_params() is plan.kernel_params()
    assert list(plan.kernel_params())[0] == 3   # blocks of 8: 1000 = 8 * 125
