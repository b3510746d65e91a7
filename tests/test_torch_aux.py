"""The port's auxiliaries against the JAX package, Δ=0: checkpoints
(``qublas_tpu_torch.checkpoint``, cross-loaded both ways), BitStream
records, ``requant_stats`` in all 7 x 5 modes on lane, pair and limb
inputs, ``format_range_report``, and ``QTensor``'s remaining surface
(``raw_list``, ``to_bits``, ``display``, ``to_matlab``, ``shuffle``,
``from_raw(validate=)``).  Inputs come from numpy seeds; formats cross with
``P`` and compare field by field."""

import dataclasses

import numpy as np
import pytest
import torch

from qublas_tpu import checkpoint as JC
from qublas_tpu import diagnostics as JD
from qublas_tpu import qtensor as JQ
from qublas_tpu.complex import complex_from_raw as jcomplex
from qublas_tpu.qformat import OverflowMode, RoundMode, qformat
from qublas_tpu_torch import bitstream as TBS
from qublas_tpu_torch import checkpoint as TC
from qublas_tpu_torch import diagnostics as TD
from qublas_tpu_torch import qtensor as TQ
from qublas_tpu_torch.complex import QComplexTensor, complex_from_raw
from qublas_tpu_torch.convert import port_format as P

F_LANE = qformat(6, 3)
F_LANE16 = qformat(10, 4)
F_PAIR = qformat(30, 9)
F_LIMB = qformat(60, 40, signed=False)


def _same(got, want):
    assert dataclasses.astuple(got.fmt) == dataclasses.astuple(want.fmt)
    assert (got.is_pair, got.is_limb) == (want.is_pair, want.is_limb)
    assert got.shape == tuple(want.shape)
    np.testing.assert_array_equal(np.asarray(got.raw(), dtype=object),
                                  np.asarray(want.raw(), dtype=object))


def _both(raws, fmt):
    raws = np.asarray(raws, dtype=object)
    return JQ.from_raw(raws, fmt), TQ.from_raw(raws, P(fmt), "cpu")


def _raws(fmt, shape, seed):
    """Raws over the format's whole range, from a numpy seed."""
    rng = np.random.RandomState(seed)
    span = fmt.raw_max - fmt.raw_min + 1
    vals = [fmt.raw_min + (int(rng.randint(0, 1 << 62)) << 62
                           | int(rng.randint(0, 1 << 62))) % span
            for _ in range(int(np.prod(shape)))]
    return np.array(vals, dtype=object).reshape(shape)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _trees():
    """The same tree in both packages: lane (int8 and int16 lanes, a wart
    raw in a wider lane), pair and limb tensors (wart raws within the limb
    word), a complex tensor, scalars, an array, nesting."""
    wart = np.array([-5, F_LIMB.raw_max + 99, 7, -(1 << 90)], dtype=object)
    parts = {"a": (_raws(F_LANE, (3, 4), 1), F_LANE),
             "b": (_raws(F_LANE16, (2, 2), 2), F_LANE16),
             "w8": (np.array([300, -3]), qformat(3, 4)),
             "p": (_raws(F_PAIR, (2, 3), 3), F_PAIR),
             "l": (wart, F_LIMB)}
    jt, tt = {}, {}
    for key, (raws, f) in parts.items():
        jt[key], tt[key] = _both(raws, f)
    cf = qformat(3, 2)
    jt["c"] = jcomplex([1, -2], [3, -4], cf)
    tt["c"] = complex_from_raw([1, -2], [3, -4], P(cf), device="cpu")
    # a plain array: numpy in the JAX tree, a torch tensor in the port's
    jt["arr"], tt["arr"] = np.arange(4.0), torch.arange(4.0,
                                                        dtype=torch.float64)
    for t in (jt, tt):
        t.update(meta=42, s="s", nest=[t["a"], ("x", t["l"])])
    return jt, tt


def _check_tree(got, want):
    for key in ("a", "b", "w8", "p", "l"):
        _same(got[key], want[key])
        if not got[key].is_limb:
            assert got[key].data.dtype == want[key].data.dtype
    assert isinstance(got["c"], QComplexTensor)
    _same(got["c"].real, want["c"].real)
    _same(got["c"].imag, want["c"].imag)
    assert got["meta"] == 42 and got["s"] == "s"
    np.testing.assert_array_equal(got["arr"], np.arange(4.0))
    _same(got["nest"][0], want["a"])
    assert isinstance(got["nest"][1], tuple) and got["nest"][1][0] == "x"
    _same(got["nest"][1][1], want["l"])


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("jax", "port"),
                                           ("port", "jax")])
def test_checkpoint_roundtrip_and_cross_loads(writer, reader, tmp_path):
    jt, tt = _trees()
    p = str(tmp_path / "ckpt.npz")
    (TC.save if writer == "port" else JC.save)(p, tt if writer == "port"
                                               else jt)
    if reader == "port":
        back = TC.load(p, device="cpu")
        _check_tree(back, tt)
        assert back["a"].device == torch.device("cpu")
        assert back["w8"].data.dtype == torch.int16
    else:
        back = JC.load(p)
        for key in ("a", "b", "w8", "p", "l"):
            _same(tt[key], back[key])
        _same(tt["c"].imag, back["c"].imag)
        assert back["nest"][1][0] == "x"


def test_checkpoint_files_are_the_same_bytes(tmp_path):
    """Both packages write the same arrays and spec for the same tree."""
    jt, tt = _trees()
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    JC.save(pj, jt)
    TC.save(pt, tt)
    with np.load(pj) as zj, np.load(pt) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            assert zj[k].dtype == zt[k].dtype, k
            np.testing.assert_array_equal(zj[k], zt[k])


def test_checkpoint_host_raws_raise(tmp_path):
    """A JAX checkpoint of a tensor in host storage loads into host storage
    with its raws; the port's save of it loads in the JAX package."""
    p = str(tmp_path / "host.npz")
    raws = np.array([1 << 40, -3], dtype=object)
    JC.save(p, JQ.from_raw(raws, qformat(3, 4)))
    t = TC.load(p, device="cpu")
    assert t.is_host and t.device == torch.device("cpu")
    np.testing.assert_array_equal(t.raw(), raws)
    q = str(tmp_path / "host_port.npz")
    TC.save(q, t)
    j = JC.load(q)
    assert j.is_host
    np.testing.assert_array_equal(np.asarray(j.raw()), raws)


@pytest.mark.parametrize("fmt", [F_LANE, F_PAIR, qformat(59, 40)])
def test_bits_interchange_matches_jax(fmt):
    from qublas_tpu import bitstream as JBS

    jt, tt = _both(_raws(fmt, (2, 3), 4), fmt)
    for orders in ((None, None), (TBS.r2l(2), TBS.r2l(5)), (TBS.r2l, None)):
        jorders = tuple(None if o is None else JBS.r2l(
            o.chunk if isinstance(o, TBS.r2l) else 1) for o in orders)
        s = TC.dumps_bits(tt, *orders)
        assert s == JC.dumps_bits(jt, *jorders)
        _same(TC.loads_bits(s, device="cpu"), JC.loads_bits(s))
        _same(TC.loads_bits(s, device="cpu"), jt)


# ---------------------------------------------------------------------------
# diagnostics
# ---------------------------------------------------------------------------

MODES = [(rm, om) for rm in RoundMode for om in OverflowMode]

# (source format, raws) of each storage kind, and the targets' int/frac
SOURCES = {
    "lane": (qformat(8, 8), lambda: [0, 1, 1 << 14, -(1 << 14), 255, -256,
                                     (1 << 16) - 1, -(1 << 16), 0x80, -0x81]),
    "lane32": (qformat(15, 16), lambda: [(1 << 31) - 1, -(1 << 31), 1 << 15,
                                         -(1 << 15) - 1, 12345, 0]),
    "pair": (qformat(30, 12), lambda: [(1 << 42) - 1, -(1 << 42), 1 << 12,
                                       -(1 << 11), 4095, 0, 3 << 30]),
    "limb": (qformat(70, 30), lambda: [(1 << 100) - 1, -(1 << 100),
                                       1 << 29, -(1 << 29), 0, 7 << 60]),
}
TARGETS = ((2, 2), (5, 10), (12, 20), (8, -4))


@pytest.mark.parametrize("rm,om", MODES,
                         ids=[f"{r.name}-{o.name}" for r, o in MODES])
def test_requant_stats_match_jax_in_every_mode(rm, om):
    """Against the JAX package's exact host route on the same raws, and
    its device route too where that runs: it compares int32 lanes with the
    target's bounds, and raises OverflowError for a target whose range
    passes int32 (the (12, 20) targets), where the port counts in int64."""
    for src, raws in SOURCES.values():
        jx, tx = _both(raws(), src)
        host = JQ.QTensor(np.asarray(jx.raw(), dtype=object), src)
        for ib, fb in TARGETS:
            for signed in (True, False):
                dst = qformat(ib, fb, signed=signed, round_mode=rm,
                              overflow_mode=om)
                got = TD.requant_stats(tx, P(dst))
                assert all(type(v) is int for v in got), got
                want = tuple(int(v) for v in JD.requant_stats(host, dst))
                assert tuple(got) == want, (src, dst, got, want)
                if -(1 << 31) <= dst.raw_min and dst.raw_max < (1 << 31):
                    assert tuple(got) == tuple(
                        int(v) for v in JD.requant_stats(jx, dst))


def test_requant_stats_counts_and_host_shift():
    """tests/test_aux.py's counts, and a lane shift beyond 31 bits, which
    takes the host route in both packages."""
    src = qformat(8, 8)
    dst = qformat(2, 2, overflow_mode=OverflowMode.SAT_ZERO)
    x = TQ.from_raw([0, 1, 1 << 14, -(1 << 14)], P(src), "cpu")
    assert tuple(TD.requant_stats(x, P(dst))) == (4, 2, 1, (1 << 14) >> 6)
    jx, tx = _both([5, -7, 1 << 20, 0], qformat(20, 30))
    dst = qformat(30, -4)
    assert tuple(TD.requant_stats(tx, P(dst))) == \
        tuple(int(v) for v in JD.requant_stats(jx, dst))
    empty = TQ.from_raw(np.zeros((0,), np.int64), P(src), "cpu")
    assert tuple(TD.requant_stats(empty, P(dst))) == (0, 0, 0, 0)


@pytest.mark.parametrize("fmt", [qformat(4, 4), F_PAIR, F_LIMB])
def test_format_range_report_matches_jax(fmt):
    jx, tx = _both(_raws(fmt, (5,), 7).tolist() + [0], fmt)
    assert TD.format_range_report(tx) == JD.format_range_report(jx)


# ---------------------------------------------------------------------------
# QTensor's remaining surface
# ---------------------------------------------------------------------------

KINDS = {"lane": qformat(4, 4), "pair": F_PAIR, "limb": F_LIMB}


@pytest.mark.parametrize("kind", list(KINDS))
def test_qtensor_surface_matches_jax(kind, tmp_path, capsys):
    fmt = KINDS[kind]
    jx, tx = _both(_raws(fmt, (3, 4), 8), fmt)
    assert tx.raw_list() == jx.raw_list()
    assert tx.to_bits() == jx.to_bits()
    text = tx.display("x")
    printed = capsys.readouterr().out
    assert text == jx.display("x") and printed == capsys.readouterr().out
    assert text.startswith("x :\nintBits: ")
    pt, pj = tmp_path / "t.m", tmp_path / "j.m"
    tx.to_matlab(str(pt))
    jx.to_matlab(str(pj))
    assert pt.read_bytes() == pj.read_bytes()
    for seed in (1, 7):
        got = tx.shuffle(seed)
        assert got.shape == (3, 4)
        _same(got, JQ.from_raw(np.asarray(jx.raw(), dtype=object).reshape(-1)
                               [np.random.RandomState(seed).permutation(12)]
                               .reshape(3, 4), fmt))
        if kind != "limb":
            _same(got, jx.shuffle(seed))


@pytest.mark.parametrize("fmt", [qformat(3, 4), qformat(4, 4, signed=False),
                                 F_PAIR, F_LIMB])
def test_from_raw_validate_matches_jax(fmt):
    inside = [fmt.raw_min, fmt.raw_max, 0]
    _same(TQ.from_raw(inside, P(fmt), "cpu", validate=True),
          JQ.from_raw(inside, fmt, validate=True))
    for bad in ([fmt.raw_max + 1], [fmt.raw_min - 1, 0]):
        with pytest.raises(ValueError) as jerr:
            JQ.from_raw(bad, fmt, validate=True)
        with pytest.raises(ValueError) as terr:
            TQ.from_raw(bad, P(fmt), "cpu", validate=True)
        assert str(terr.value) == str(jerr.value)
        # without validate the wart raw is stored as given
        assert TQ.from_raw(bad, P(fmt), "cpu").raw_list() == bad
