"""The torch port's Qreduce against the JAX package, Δ=0.

* ``qreduce`` (K3's plain version on the CPU for proven lane configs, the
  layered elementwise path or the host resume otherwise) against
  ``qublas_tpu.ops.reduce.qreduce``: BASELINE config 2, odd n, every axis
  form, no layer formats, an out-of-range raw at the odd tail, a host
  resume, n = 1 — raws, lane dtype and format fields;
* against the JAX Pallas reducer in interpret mode;
* ``qreduce_args`` and the copy of ``_plan_reduce_lanes``;
* K3's schedule, replayed from the kernel's own parameters
  (``ReducePlan.kernel_params``: the slot stack and drain that
  ``csrc/qreduce.cu`` runs), against the layered plain version.

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


def _replay_k3(x, plan):
    """K3's schedule over the columns of ``x`` [n, batch], from the int32
    parameters the kernel receives: in-block fold, slot stack, drain."""
    p = list(plan.kernel_params())
    log_blk, levels = p[0], p[1]
    rqs = [p[2 + 5 * l:7 + 5 * l] for l in range(levels)]
    q = 2 + 5 * levels
    drain = [(p[q + 1 + 2 * s], p[q + 2 + 2 * s]) for s in range(p[q])]

    def rq(v, r):
        d, rnd, ovf, w, sgn = r
        fmt = qt.QFormat(w - 1, 0, bool(sgn), qt.RoundMode(rnd),
                         qt.OverflowMode(ovf))
        return requantize_i32(v, d, fmt)

    def merge(l, left, right):
        return rq(left + right, rqs[l])

    blk = 1 << log_blk
    slots = {}
    for t in range(x.shape[0] // blk):
        v = x[t * blk:(t + 1) * blk].to(torch.int32)
        for l in range(log_blk):
            v = merge(l, v[0::2], v[1::2])
        val, j = v[0], 0
        while t & (1 << j):
            val = merge(log_blk + j, slots.pop(j), val)
            j += 1
        slots[j] = val
    carry = None
    for op, l in drain:
        if op == 1:
            carry = rq(carry, rqs[l])
        elif op == 0:
            carry = slots[max(l - log_blk, 0)]
        else:
            carry = merge(l, slots[max(l - log_blk, 0)], carry)
    return carry


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
