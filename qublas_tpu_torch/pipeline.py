"""The quantized GEMM pipeline as a torch module.

Port of ``__graft_entry__.entry()``'s forward (``__graft_entry__.py:12-49``):
an int8-storage ``Qu<3,4>`` GEMM with lossless ``Qu<20,8>`` products and
accumulation into a ``Qu<3,4,SAT::ZERO>`` output, an ANUS sqrt ROM, a
converting cast back to ``Qu<3,4>``, and a second GEMM of the same kind.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from qublas_tpu.qformat import OverflowMode, QFormat, qformat

from .anus import build_table, sqrt_func
from .ops.gemm import qgemul
from .qtensor import QTensor, from_raw

__all__ = ["QuantPipeline", "pipeline_formats"]


def pipeline_formats():
    """(operand, product/accumulator, output) formats of ``entry()``."""
    fa = qformat(3, 4)                                   # int8 storage
    wide = qformat(20, 8)                                # lossless accumulate
    mid = qformat(3, 4, overflow_mode=OverflowMode.SAT_ZERO)
    return fa, wide, mid


def _raws(w, fmt: QFormat) -> np.ndarray:
    """Raws of a weight given as a numpy array or as any object with
    ``.raw()`` and ``.fmt`` (e.g. a ``qublas_tpu.QTensor``)."""
    if hasattr(w, "raw") and hasattr(w, "fmt"):
        if w.fmt != fmt:
            raise ValueError(f"weight in {w.fmt}, pipeline needs {fmt}")
        return np.asarray(w.raw())
    return np.asarray(w)


class QuantPipeline(nn.Module):
    """``y = qgemul(table(qgemul(x, w1)).astype(fa), w2)`` on raw tensors.

    ``w1`` and ``w2`` are int8 buffers of ``Qu<3,4>`` raws; ``forward``
    takes the raws of ``x`` in ``Qu<3,4>`` and returns the raws of ``y`` in
    ``Qu<3,4,SAT::ZERO>``, as ``entry()``'s forward does.
    """

    def __init__(self, w1: torch.Tensor, w2: torch.Tensor):
        super().__init__()
        self.fa, self.wide, self.out_fmt = pipeline_formats()
        self.register_buffer("w1", w1)
        self.register_buffer("w2", w2)
        self.table = build_table(sqrt_func, self.out_fmt, self.out_fmt)

    @classmethod
    def from_numpy(cls, w1_raw, w2_raw, device) -> "QuantPipeline":
        """Carry weights over from the JAX side: numpy raws, or objects with
        ``.raw()`` and ``.fmt``, placed on ``device``."""
        fa = pipeline_formats()[0]
        w1 = from_raw(_raws(w1_raw, fa), fa, device).data
        w2 = from_raw(_raws(w2_raw, fa), fa, device).data
        return cls(w1, w2)

    def forward(self, x_raw: torch.Tensor) -> torch.Tensor:
        fa, wide, mid = self.fa, self.wide, self.out_fmt
        x = QTensor(x_raw, fa)
        h = qgemul(x, QTensor(self.w1, fa), mid, mul_to=wide,
                   add_formats=(wide,))
        h = self.table(h)                    # ANUS LUT nonlinearity
        h = h.astype(fa)
        y = qgemul(h, QTensor(self.w2, fa), mid, mul_to=wide,
                   add_formats=(wide,))
        return y.data
