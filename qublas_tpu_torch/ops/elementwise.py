"""Elementwise quantized ops on torch (port of ``qublas_tpu.ops.elementwise``).

Only the converting cast's ``i32`` route is ported: the one the quantized
GEMM pipeline runs.  The pair, limb and host routes, and the other
elementwise ops, are ROADMAP items 5 and 10-11.
"""

from __future__ import annotations

import torch

from qublas_tpu.ops.widths import fmt_interval, route_requant
from qublas_tpu.qformat import QFormat

from ..qtensor import QTensor
from .wideint import requantize_i32
from .widths import torch_dtype_for

__all__ = ["qcast"]


def qcast(a: QTensor, fmt: QFormat) -> QTensor:
    """Cross-format conversion (requantize with the destination's modes) —
    reference converting copy ctor (QuBLAS.h:2758-2830)."""
    if a.fmt == fmt:
        return QTensor(a.data, fmt)
    route = route_requant(fmt_interval(a.fmt), a.fmt.frac_bits, fmt)
    if route != "i32":
        raise NotImplementedError(
            f"qcast {a.fmt} -> {fmt} needs the {route!r} route, not yet "
            "ported (ROADMAP items 5, 10-11)")
    raw = requantize_i32(a.data.to(torch.int32), a.fmt.frac_bits, fmt)
    return QTensor(raw.to(torch_dtype_for(fmt)), fmt)
