"""K1's table epilogue on the CPU: the composed table of the pipeline's ROM
and cast, ``qublas::fused_gemm_s8``'s plain version with a table against
the plain GEMM followed by the lookup, and ``qgemul(..., epilogue_lut=)``
giving the same bits whether K1's epilogue takes the table or the table
runs after the GEMM.  The kernel itself is held to these plain versions in
``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

import qublas_tpu_torch as qt
from qublas_tpu_torch import _build
from qublas_tpu_torch.ops import gemm as G
from qublas_tpu_torch.ops.fused_gemm import (fused_int8_gemm,
                                             fused_int8_gemm_plain)
from qublas_tpu_torch.ops.widths import storage_dtype

FA, WIDE, MID = qt.pipeline_formats()
LANE = {1: torch.int8, 2: torch.int16, 4: torch.int32}


def _raws(rng, fmt, shape, dtype=torch.int8):
    return torch.from_numpy(rng.randint(fmt.raw_min, fmt.raw_max + 1,
                                        shape)).to(dtype)


def _patterns(fmt):
    """Every raw of ``fmt`` (a format of at most 20 bits)."""
    return np.arange(fmt.raw_min, fmt.raw_max + 1)


@pytest.mark.parametrize("func,in_fmt,mid,out_fmt", [
    ("sqrt_func", MID, MID, FA),
    ("rsqrt_func", qt.qformat(4, 4, signed=False), qt.qformat(2, 9),
     qt.qformat(1, 3, round_mode=qt.RoundMode.RND_CONV)),
    ("reciprocal_func", qt.qformat(1, 6), qt.qformat(8, 8),
     qt.qformat(20, 20)),
    ("sqrt_func", MID, MID, qt.qformat(40, 40))],
    ids=["pipeline", "narrowing", "to_pair", "to_limb"])
def test_composed_table_is_the_table_then_the_cast(func, in_fmt, mid,
                                                   out_fmt):
    """``QTable.astype``: over every raw of the input, the composed table's
    lookup is the table's lookup cast, bit for bit and format for
    format."""
    rom = qt.QTable(getattr(qt.anus, func), in_fmt, mid)
    both = rom.astype(out_fmt)
    x = qt.from_raw(_patterns(in_fmt), in_fmt, "cpu")
    want = rom(x).astype(out_fmt)
    got = both(x)
    assert both.in_fmt == in_fmt and got.fmt == want.fmt == out_fmt
    assert np.array_equal(np.asarray(got.raw(), dtype=object),
                          np.asarray(want.raw(), dtype=object))


def test_pipeline_holds_the_composed_table():
    """The pipeline's table is the sqrt ROM into ``Qu<3,4,SAT::ZERO>``
    cast to ``Qu<3,4>``, over all 256 raws, and its ``rom`` buffer holds
    those entries."""
    pipe = qt.QuantPipeline(torch.zeros((8, 8), dtype=torch.int8),
                            torch.zeros((8, 8), dtype=torch.int8))
    x = qt.from_raw(_patterns(MID), MID, "cpu")
    want = qt.QTable(qt.sqrt_func, MID)(x).astype(FA)
    got = pipe.table(x)
    assert got.fmt == FA and torch.equal(got.data, want.data)
    assert pipe.rom.numel() == 256 and torch.equal(pipe.rom,
                                                   pipe.table.table)


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (33, 17, 70), (130, 48, 129)])
@pytest.mark.parametrize("w,out_bytes", [(1, 1), (3, 2), (5, 4), (8, 1),
                                         (8, 2), (8, 4)])
def test_k1_table_plain_is_the_gemm_then_the_lookup(m, k, n, w, out_bytes):
    """``fused_gemm_s8``'s plain version with a table of 2^w entries (the
    lane's extremes among them) equals the plain GEMM into a w-bit format
    followed by the lookup of each raw's low w bits, stored in the lane of
    ``out_bytes``; the op's fake gives the same shape and dtype."""
    rng = np.random.RandomState(1000 * w + m + out_bytes)
    a, b = _raws(rng, FA, (m, k)), _raws(rng, FA, (k, n))
    fmt = qt.qformat(w - 1, 0, round_mode=qt.RoundMode.RND_CONV)
    info = torch.iinfo(LANE[out_bytes])
    entries = rng.randint(info.min, info.max, 1 << w, dtype=np.int64)
    entries[0], entries[-1] = info.min, info.max
    lut = torch.from_numpy(entries).to(torch.int32)
    got = torch.ops.qublas.fused_gemm_s8(a, b, _build.rq_args(8, fmt),
                                         out_bytes, lut)
    raw = fused_int8_gemm_plain(a, b, 8, fmt).numpy().astype(np.int64)
    want = np.take(entries, raw & ((1 << w) - 1))
    assert got.dtype == LANE[out_bytes] and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)
    assert torch.equal(fused_int8_gemm(a, b, 8, fmt, lut, qt.qformat(
        8 * out_bytes - 1, 0)), got)


def test_k1_table_refuses_what_the_kernel_cannot_read():
    """A table that is not 2^w <= 256 contiguous int32 entries, or int16
    operands with a table, raise before any launch."""
    rng = np.random.RandomState(3)
    a, b = _raws(rng, FA, (4, 16)), _raws(rng, FA, (16, 4))
    rq = _build.rq_args(8, MID)
    for bad in (torch.zeros(255, dtype=torch.int32),
                torch.zeros(512, dtype=torch.int32),
                torch.zeros(256, dtype=torch.int64),
                torch.zeros(512, dtype=torch.int32)[::2]):
        with pytest.raises(ValueError, match="K1's table"):
            torch.ops.qublas.fused_gemm_s8(a, b, rq, 1, bad)
    with pytest.raises(TypeError, match="int8 operands"):
        fused_int8_gemm(a.to(torch.int16), b, 8, MID,
                        torch.zeros(256, dtype=torch.int32), FA)


I16 = qt.qformat(7, 4)           # 12-bit operands: int16 lanes, lossless
OUT16 = qt.qformat(5, 4)         # a 10-bit output: an int16 lane
# (operand format, GEMM output, table output, whether K1 takes the table)
ROUTES = {
    "pipeline": (FA, MID, FA, True),
    "table_to_int16": (FA, MID, qt.qformat(10, 4), True),
    "table_to_int32": (FA, MID, qt.qformat(20, 4), True),
    "int16_operands": (I16, MID, FA, False),
    "int16_out_lane": (FA, OUT16, OUT16, False),
    "pair_table": (FA, MID, qt.qformat(20, 20), False),
    "limb_table": (FA, MID, qt.qformat(40, 40), False),
}


@pytest.mark.parametrize("batch", [(), (2,)])
@pytest.mark.parametrize("case", sorted(ROUTES))
def test_qgemul_table_same_bits_on_either_route(case, batch):
    """``qgemul(..., epilogue_lut=)`` on the lossless tier equals the GEMM
    followed by the table's own lookup, whether K1's epilogue takes the
    table (int8 operands into an int8 lane, a table of at most 256 lane
    entries) or it runs after the GEMM (int16 operands, a wider output,
    pair and limb tables); entries passed in (a module's buffer) give the
    same bits."""
    fa, out, lut_out, fused = ROUTES[case]
    rng = np.random.RandomState(len(case))
    a = qt.QTensor(_raws(rng, fa, batch + (9, 40), storage_dtype(fa)),
                   fa)
    b = qt.QTensor(_raws(rng, fa, (40, 21), storage_dtype(fa)), fa)
    lut = qt.QTable(qt.sqrt_func, out, out).astype(lut_out)
    kw = dict(mul_to=WIDE, add_formats=(WIDE,))
    assert (G._k1_lut(lut, None, a, b, out) is not None) == fused
    want = lut(qt.qgemul(a, b, out, **kw))
    for entries in (None, lut.table.clone()):
        got = qt.qgemul(a, b, out, epilogue_lut=lut, lut_table=entries,
                        **kw)
        assert got.fmt == want.fmt == lut_out
        assert np.array_equal(np.asarray(got.raw(), dtype=object),
                              np.asarray(want.raw(), dtype=object)), case


def test_table_entries_elsewhere_run_after_the_gemm():
    """Entries on another device than the operands are not handed to K1
    (a lookup must copy no entry to the card)."""
    rng = np.random.RandomState(5)
    a = qt.QTensor(_raws(rng, FA, (4, 16)), FA)
    b = qt.QTensor(_raws(rng, FA, (16, 4)), FA)
    lut = qt.QTable(qt.sqrt_func, MID).astype(FA)
    assert G._k1_lut(lut, lut.table, a, b, MID) is lut.table
    assert G._k1_lut(lut, lut.table.to("meta"), a, b, MID) is None
    assert G._k1_lut(None, None, a, b, MID) is None
