"""Exact lookup tables (ASIC ROMs) on torch tensors.

Port of ``qublas_tpu.anus`` lines 210-383: :class:`QTable` maps every input
bit pattern through a Python-double function and requantizes it into the
output format with the exact host pipeline (``hostint``), exactly as the JAX
package builds it.  Applying the table is a mask of the input raws and a
plain index of the table on the tensor's device: int32 entries for a lane
output format, int64 for a pair-storage one (33..64 bits), a column of
stacked limbs for a limb-storage one (65..992 bits).  (The JAX
package's 63-select packed tree exists only because Mosaic has no 1-D
gather; torch indexes natively.)  ``qpoly``/``qapprox`` are still to be
ported (ROADMAP item 6).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from . import hostint
from .ops.limbint import LimbArray, limbs_from_ints
from .ops.widths import limb_count, storage_dtype, storage_kind
from .qformat import QFormat
from .qtensor import QTensor, host_storage_error

__all__ = ["QTable", "build_table", "rsqrt_func", "reciprocal_func",
           "sqrt_func"]


def rsqrt_func(v: float) -> float:
    """1/sqrt(x) (readme.md:68)."""
    return 1.0 / math.sqrt(v) if v > 0 else math.inf if v == 0 else math.nan


def reciprocal_func(v: float) -> float:
    """1/x (readme.md:71)."""
    return 1.0 / v if v != 0 else math.inf


def sqrt_func(v: float) -> float:
    """sqrt(x) (readme.md:74)."""
    return math.sqrt(v) if v >= 0 else math.nan


MAX_TABLE_BITS = 20  # 1M int32 entries


class QTable:
    """A precomputed exact LUT: input bit pattern -> output raw value.

    ``table[p]`` holds the output for the input whose logical-width bit
    pattern is ``p``: the pattern is sign-interpreted per the input format,
    mapped through ``func`` in double, and converted with the output
    format's exact pipeline (non-finite -> 0).
    """

    def __init__(self, func: Callable[[float], float], in_fmt: QFormat,
                 out_fmt: Optional[QFormat] = None):
        self.func = func
        self.in_fmt = in_fmt
        self.out_fmt = out_fmt or in_fmt
        w = in_fmt.width
        if w > MAX_TABLE_BITS:
            raise ValueError(
                f"LUT over a {w}-bit input needs 2^{w} entries; cap is "
                f"2^{MAX_TABLE_BITS}.  Use qapprox for wide formats.")
        kind = storage_kind(self.out_fmt)
        if kind is None:
            raise host_storage_error(f"a table into {self.out_fmt}")
        raws = []
        for p in range(1 << max(w, 0)):
            raw_in = p - (1 << w) if (in_fmt.signed and w > 0
                                      and p >= (1 << (w - 1))) else p
            val = hostint.raw_to_double(raw_in, in_fmt)
            try:
                out_val = float(func(val))
            except (ValueError, ZeroDivisionError, OverflowError):
                out_val = math.nan
            raws.append(hostint.double_to_raw(out_val, self.out_fmt))
        self._mask = (1 << w) - 1 if w > 0 else 0
        if kind == "limb":
            # [K, entries]: entry p is column p
            self.table = limbs_from_ints(raws, limb_count(self.out_fmt))
        else:
            self.table = torch.from_numpy(np.array(
                raws, dtype=np.int64 if kind == "pair" else np.int32))
        self._on_device = {}

    def _table_on(self, device: torch.device) -> torch.Tensor:
        t = self._on_device.get(device)
        if t is None:
            t = self._on_device[device] = self.table.to(device)
        return t

    def __call__(self, x: QTensor) -> QTensor:
        # signedness and int_bits change how a bit pattern is interpreted;
        # round/overflow modes do not, so they may differ
        f, t = x.fmt, self.in_fmt
        if (f.int_bits, f.frac_bits, f.signed) != (t.int_bits, t.frac_bits,
                                                   t.signed):
            raise ValueError(f"QTable built for {self.in_fmt}, got {x.fmt}")
        idx = (x.data.to(torch.int32) & self._mask).long()
        table = self._table_on(x.device)
        if table.ndim == 2:
            return QTensor(LimbArray(table[:, idx]), self.out_fmt)
        return QTensor(table[idx].to(storage_dtype(self.out_fmt)),
                       self.out_fmt)


def build_table(func, in_fmt: QFormat,
                out_fmt: Optional[QFormat] = None) -> QTable:
    return QTable(func, in_fmt, out_fmt)
