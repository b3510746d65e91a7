"""The torch port's int32 requantize core against the JAX package, Δ=0.

``qublas_tpu_torch.ops.wideint`` (requantize_i32, requantize_split_mul) and
``qublas_tpu_torch.ops.elementwise.qcast`` must give the JAX package's raws
bit for bit under every rounding x overflow mode, signed and unsigned, at
the int32 edges (INT32_MIN/MAX), at each format's range edges +-1, and at
shifts d = -2, 0, 1, 31.  Inputs are made with numpy from a seed; formats
cross into the port with ``port_format`` and are compared field by field.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qublas_tpu.ops import elementwise as jew
from qublas_tpu.ops import wideint as jW
from qublas_tpu.qformat import OverflowMode, QFormat, RoundMode, qformat
from qublas_tpu.qtensor import from_raw as jfrom_raw
from qublas_tpu_torch.convert import port_format as P
from qublas_tpu_torch.ops import wideint as tW
from qublas_tpu_torch.ops.elementwise import qcast
from qublas_tpu_torch.qtensor import from_raw

I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1
MODES = [(rm, om, s) for rm in RoundMode for om in OverflowMode
         for s in (True, False)]


def _wrap32(v: int) -> int:
    return (v + (1 << 31)) % (1 << 32) - (1 << 31)


def _inputs(rng, fmt: QFormat, d: int) -> np.ndarray:
    """Random int32 values plus the edges where rounding and overflow
    decide: 0, +-1, INT32_MIN/MAX, and the format's range edges +-1 at the
    source scale."""
    edges = [0, 1, -1, I32_MIN, I32_MAX, I32_MIN + 1, I32_MAX - 1]
    for r in (fmt.raw_min, fmt.raw_max, 0):
        base = r << d if d >= 0 else r >> -d
        for off in (-1, 0, 1, (1 << max(d - 1, 0)), -(1 << max(d - 1, 0))):
            edges.append(_wrap32(base + off))
    rnd = rng.randint(I32_MIN, I32_MAX, size=200, dtype=np.int64)
    small = rng.randint(-(1 << 12), 1 << 12, size=200)
    return np.concatenate([np.array(edges), rnd, small]).astype(np.int32)


@pytest.mark.parametrize("rm,om,signed", MODES,
                         ids=[f"{r.name}-{o.name}-{'s' if s else 'u'}"
                              for r, o, s in MODES])
def test_requant_core_matches_jax(rm, om, signed):
    rng = np.random.RandomState(int(rm) * 10 + int(om) * 2 + int(signed))
    # requantize_i32: storage widths 8/16/32 bits, shifts d = -2, 0, 1, 31
    for int_bits in (3, 11, 27):
        fmt = QFormat(int_bits, 4, signed, rm, om)
        for d in (-2, 0, 1, 31):
            x = _inputs(rng, fmt, d)
            want = np.asarray(jW.requantize_i32(jnp.asarray(x), 4 + d, fmt))
            got = tW.requantize_i32(torch.from_numpy(x), 4 + d,
                                    P(fmt)).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"{fmt} d={d}")

    # requantize_split_mul: products wider than int32, d in [1, 30]
    for d in (1, 7, 30):
        fmt = QFormat(8, 8, signed, rm, om)
        a = np.concatenate([[0, 1, -1, I32_MIN, I32_MAX],
                            rng.randint(-(1 << 16), 1 << 16, 300)])
        b = np.concatenate([[0, -1, 1, -(1 << 16), (1 << 16) - 1],
                            rng.randint(-(1 << 16), 1 << 16, 300)])
        a, b = a.astype(np.int32), b.astype(np.int32)
        want = np.asarray(jW.requantize_split_mul(
            jnp.asarray(a), jnp.asarray(b), 8 + d, fmt))
        got = tW.requantize_split_mul(torch.from_numpy(a), torch.from_numpy(b),
                                      8 + d, P(fmt)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"split d={d}")

    # qcast (i32 route): full int16 source range into a narrower format
    src = qformat(7, 6)
    raws = np.arange(src.raw_min, src.raw_max + 1, 7, dtype=np.int64)
    for dst in (QFormat(3, 2, signed, rm, om), QFormat(5, 9, signed, rm, om)):
        want = jew.qcast(jfrom_raw(raws, src), dst)
        got = qcast(from_raw(raws, P(src), "cpu"), P(dst))
        assert got.fmt == P(want.fmt)
        assert got.data.dtype == getattr(torch, str(want.data.dtype))
        np.testing.assert_array_equal(got.raw(), np.asarray(want.raw()))
