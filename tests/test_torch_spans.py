"""The port's spans (``utils.profiling.span``) on the CPU: under
``torch.profiler`` a ``qgemul`` is one ``qublas.qgemul`` range with its
proofs and planners as ``qublas.plan`` ranges inside it, and a ROM lookup
after the GEMM one ``qublas.rom`` range (a ROM in K1's epilogue opens
none); with no profiler no ``record_function`` is
entered; the results are the same bits either way; and a compiled graph
holds no profiler op.  The launch record (``.seen``) is kept only inside
``launch_record``."""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import profile

import qublas_tpu_torch as qt
from qublas_tpu_torch import _build
from qublas_tpu_torch.ops import fused_gemm as FG
from qublas_tpu_torch.ops import library
from qublas_tpu_torch.utils import profiling as P

F88Z = qt.qformat(8, 8, overflow_mode=qt.OverflowMode.SAT_ZERO)
FA, WIDE, MID = qt.pipeline_formats()


def _raws(shape, lo, hi, seed, dtype):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randint(lo, hi, shape).astype(dtype))


def _tree_call():
    """The order-sensitive tier (K2's plain version on the CPU)."""
    a = qt.QTensor(_raws((8, 48), -1024, 1024, 1, np.int32), F88Z)
    b = qt.QTensor(_raws((48, 8), -1024, 1024, 2, np.int32), F88Z)
    return lambda: qt.qgemul(a, b, F88Z).data


def _k1_call(epilogue_lut=None):
    """The lossless tier (K1's plain version), as the pipeline's GEMMs."""
    a = qt.QTensor(_raws((16, 32), -128, 128, 3, np.int8), FA)
    b = qt.QTensor(_raws((32, 16), -128, 128, 4, np.int8), FA)
    return lambda: qt.qgemul(a, b, MID, mul_to=WIDE, add_formats=(WIDE,),
                             epilogue_lut=epilogue_lut).data


def _pipeline_call():
    pipe = qt.QuantPipeline(_raws((32, 16), -128, 128, 5, np.int8),
                            _raws((16, 32), -128, 128, 6, np.int8))
    x = _raws((8, 32), -128, 128, 7, np.int8)
    return lambda: pipe(x)


def _lut_call(out_fmt=MID):
    """A ``qgemul`` whose result goes through a ROM (``epilogue_lut``):
    into an int8 lane, in K1's epilogue; into a pair (``Qu<20,20>``),
    after the GEMM."""
    return _k1_call(qt.build_table(qt.sqrt_func, MID, out_fmt))


def _spans(fn):
    """fn's result and its ``qublas.`` ranges as (name, start, end), in
    order of start."""
    with profile() as prof:
        out = fn()
    ev = sorted(((e.name, e.time_range.start, e.time_range.end)
                 for e in prof.events() if e.name.startswith("qublas.")),
                key=lambda s: s[1])
    return out, ev


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("case", ["tree", "k1"])
def test_qgemul_is_one_span_with_its_plans_inside(case):
    """Every tier's proofs run in one plan (``plan_qgemul``), one span
    inside the call's one span: the tree tier's three (the lossless one,
    the hybrid and the tree planner) as K1's one."""
    fn = {"tree": _tree_call, "k1": _k1_call}[case]()
    _, ev = _spans(fn)
    names = Counter(n for n, _, _ in ev)
    assert names == {"qublas.qgemul": 1, "qublas.plan": 1}, names
    call = next(s for s in ev if s[0] == "qublas.qgemul")
    assert all(_inside(s, call) for s in ev if s[0] == "qublas.plan")


def test_pipeline_block_spans():
    """A ``QuantPipeline`` block: two calls, each with its plan inside,
    and no ROM span: the ROM and the cast run in the first call's K1
    epilogue."""
    _, ev = _spans(_pipeline_call())
    assert [n for n, _, _ in ev] == ["qublas.qgemul", "qublas.plan",
                                     "qublas.qgemul", "qublas.plan"]
    first, plan1, second, plan2 = ev
    assert _inside(plan1, first) and _inside(plan2, second)
    assert first[2] <= second[1]


@pytest.mark.parametrize("out_fmt,names", [
    (MID, {"qublas.qgemul": 1, "qublas.plan": 1}),
    (qt.qformat(20, 20), {"qublas.qgemul": 1, "qublas.plan": 1,
                          "qublas.rom": 1})], ids=["fused", "after"])
def test_epilogue_lut_is_inside_one_call_span(out_fmt, names):
    """``epilogue_lut`` opens no second ``qublas.qgemul``: a table K1's
    epilogue takes opens no ROM span, one it does not runs inside the one
    call span."""
    _, ev = _spans(_lut_call(out_fmt))
    assert Counter(n for n, _, _ in ev) == names
    call = next(s for s in ev if s[0] == "qublas.qgemul")
    assert all(_inside(s, call) for s in ev)


def test_no_profiler_enters_no_record_function(monkeypatch):
    """With no profiler recording, ``span`` never reaches
    ``record_function``: patched to raise, nothing raises; under a
    profiler the patched one is reached."""
    def boom(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    calls = [_tree_call(), _k1_call(), _pipeline_call(), _lut_call()]
    for fn in calls:
        fn()
    assert P.span("qublas.x") is P.span("qublas.y")
    with profile():
        with pytest.raises(AssertionError, match="entered"):
            calls[0]()


@pytest.mark.parametrize("case", ["tree", "k1", "pipeline", "lut",
                                  "lut_after"])
def test_same_bits_with_and_without_the_profiler(case):
    fn = {"tree": _tree_call, "k1": _k1_call, "pipeline": _pipeline_call,
          "lut": _lut_call,
          "lut_after": lambda: _lut_call(qt.qformat(20, 20))}[case]()
    want = fn()
    got, ev = _spans(fn)
    assert ev and torch.equal(got, want)


def test_compiled_graph_holds_no_profiler_op():
    """Traced under a recording profiler, the pipeline block and the tree
    call still compile as one graph each (``fullgraph=True``), with no
    profiler op in it."""
    targets = []

    def backend(gm, example_inputs):
        targets.extend(str(n.target) for n in gm.graph.nodes)
        return gm.forward

    torch._dynamo.reset()
    with profile():
        for fn in (_pipeline_call(), _tree_call()):
            want = fn()
            got = torch.compile(fn, fullgraph=True, dynamic=False,
                                backend=backend)()
            assert torch.equal(got, want)
    torch._dynamo.reset()
    assert "qublas.fused_gemm_s8" in targets and "qublas.tree_gemm" in targets
    assert not [t for t in targets if "profiler" in t or "record" in t]


def test_launch_record_only_inside_its_block(monkeypatch):
    """A launch always counts in ``launches``; it notes itself in ``seen``
    only inside ``launch_record``, whose end restores the state before."""
    monkeypatch.setattr(FG.fused_int8_gemm, "launches", 0)
    monkeypatch.setattr(FG.fused_int8_gemm, "seen", Counter())
    rq = _build.rq_args(8, MID)
    assert not P.recording_launches()
    library._k1_record("s8/direct/direct", rq)
    assert FG.fused_int8_gemm.launches == 1 and not FG.fused_int8_gemm.seen
    with P.launch_record():
        with P.launch_record():
            library._k1_record("s8/direct/direct", rq)
        assert P.recording_launches()
        library._k1_record("s32", ())
    assert not P.recording_launches()
    library._k1_record("s32", ())
    assert FG.fused_int8_gemm.launches == 4
    assert FG.fused_int8_gemm.seen == Counter({
        ("gemm/s8/direct/direct", (("TRN_TCPL", "SAT_ZERO"),)): 1,
        ("int_dot/s32", ()): 1})


def test_table_launch_counts_apart(monkeypatch):
    """A launch with K1's table counts in ``launches`` and in
    ``lut_launches``, and notes itself under ``gemm+lut/``, apart from the
    plain epilogues' ``gemm/`` that the fuzz's gate reads."""
    monkeypatch.setattr(FG.fused_int8_gemm, "launches", 0)
    monkeypatch.setattr(FG.fused_int8_gemm, "lut_launches", 0)
    monkeypatch.setattr(FG.fused_int8_gemm, "seen", Counter())
    rq = _build.rq_args(8, MID)
    with P.launch_record():
        library._k1_record("s8/direct/direct", rq, True)
        library._k1_record("s8/direct/direct", rq)
    assert (FG.fused_int8_gemm.launches,
            FG.fused_int8_gemm.lut_launches) == (2, 1)
    assert FG.fused_int8_gemm.seen == Counter({
        ("gemm+lut/s8/direct/direct", (("TRN_TCPL", "SAT_ZERO"),)): 1,
        ("gemm/s8/direct/direct", (("TRN_TCPL", "SAT_ZERO"),)): 1})
