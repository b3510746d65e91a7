"""Requantization diagnostics: how often a conversion saturates or rounds.

Port of ``qublas_tpu.diagnostics``.  The reference can only ``display()``
values (QuBLAS.h:2418-2431); these helpers report how often converting a
tensor into a format would saturate or round, the usual diagnostic when
choosing fixed-point formats for an ASIC datapath.  They return Python
ints and floats.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import hostint
from .ops.wideint import requantize_i32
from .ops.widths import fmt_interval, rounded_interval
from .qformat import OverflowMode, QFormat
from .qtensor import QTensor

__all__ = ["RequantStats", "requant_stats", "format_range_report"]


class RequantStats(NamedTuple):
    """Counts over one requantization x -> fmt."""

    total: int        # element count
    saturated: int    # elements clamped/zeroed/wrapped by int_convert
    rounded: int      # elements whose dropped fraction bits were nonzero
    max_abs: int      # max |raw| before overflow handling


def _identity_bounds(fmt: QFormat):
    hi = fmt.raw_max
    if not fmt.signed:
        lo = 0
    elif fmt.overflow_mode == OverflowMode.SAT_SMGN:
        lo = fmt.raw_min + 1
    else:
        lo = fmt.raw_min
    return lo, hi


def requant_stats(x: QTensor, fmt: QFormat) -> RequantStats:
    """Statistics of converting ``x`` into ``fmt`` (without performing it).

    ``saturated`` counts elements whose *rounded* value falls outside the
    target's identity range, i.e. that int_convert would clamp, zero or
    **wrap** (for WRP_TCPL / WRP_TCPL_SAT targets it counts wraps).  Lane
    tensors whose rounded values stay in int32 (and whose shift is at most
    31) are counted on their device with ``requantize_i32`` under a
    WRP_TCPL_SAT (no-op) overflow, and the four numbers read back once;
    other tensors, host storage included, take the exact host route on
    their raws, as in the JAX package.
    """
    d = x.fmt.frac_bits - fmt.frac_bits
    lo, hi = _identity_bounds(fmt)
    riv, inters = rounded_interval(fmt_interval(x.fmt), x.fmt.frac_bits, fmt)
    if x.is_host or d > 31 or not all(v.fits32 for v in inters + [riv]):
        # host storage, or beyond int32 (pair and limb formats always
        # are): the host route
        raws = [int(v) for v in np.asarray(x.raw(), dtype=object).reshape(-1)]
        rounded_vals = [hostint.frac_convert(r, x.fmt.frac_bits,
                                             fmt.frac_bits, fmt.round_mode)
                        for r in raws]
        n_round = sum(1 for r in raws if d > 0 and r & ((1 << d) - 1))
        n_sat = sum(1 for rv in rounded_vals if not lo <= rv <= hi)
        mx = max((abs(rv) for rv in rounded_vals), default=0)
        return RequantStats(len(raws), n_sat, n_round, mx)

    xi = x.data.to(torch.int32)
    if d > 0:
        rounded = torch.count_nonzero(xi & ((1 << d) - 1))
    else:
        rounded = torch.zeros((), dtype=torch.int64, device=x.device)
    nosat = fmt.with_modes(overflow_mode=OverflowMode.WRP_TCPL_SAT)
    rv = requantize_i32(xi, x.fmt.frac_bits, nosat).to(torch.int64)
    saturated = torch.count_nonzero((rv < lo) | (rv > hi))
    mag = rv.abs().max() if x.size else torch.zeros((), dtype=torch.int64,
                                                     device=x.device)
    sat, rnd, mx = torch.stack([saturated, rounded, mag]).tolist()
    return RequantStats(x.size, sat, rnd, mx)


def format_range_report(x: QTensor) -> dict:
    """Utilization of the format's dynamic range: a quick way to see
    whether int_bits/frac_bits are wasted or insufficient."""
    vals = np.asarray(x.to_double(), dtype=np.float64).reshape(-1)
    mx = float(np.max(np.abs(vals))) if vals.size else 0.0
    fmt = x.fmt
    full = fmt.raw_max * fmt.scale
    return {
        "fmt": repr(fmt),
        "max_abs": mx,
        "range_utilization": (mx / full) if full else 0.0,
        "zero_fraction": float(np.mean(vals == 0.0)) if vals.size else 0.0,
    }
