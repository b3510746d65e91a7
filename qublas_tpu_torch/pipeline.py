"""The quantized GEMM pipeline as a torch module.

Port of ``__graft_entry__.entry()``'s forward (``__graft_entry__.py:12-49``):
an int8-storage ``Qu<3,4>`` GEMM with lossless ``Qu<20,8>`` products and
accumulation into a ``Qu<3,4,SAT::ZERO>`` output, an ANUS sqrt ROM, a
converting cast back to ``Qu<3,4>``, and a second GEMM of the same kind.
The ROM and the cast map each int8 raw to an int8 raw, so they run as one
256-entry table that K1's epilogue applies to the first GEMM's output
before its store.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .anus import build_table, sqrt_func
from .convert import from_jax
from .ops.fused_gemm import kmajor
from .ops.gemm import qgemul
from .qformat import OverflowMode, qformat
from .qtensor import QTensor, from_raw

__all__ = ["QuantPipeline", "pipeline_formats"]


def pipeline_formats():
    """(operand, product/accumulator, output) formats of ``entry()``."""
    fa = qformat(3, 4)                                   # int8 storage
    wide = qformat(20, 8)                                # lossless accumulate
    mid = qformat(3, 4, overflow_mode=OverflowMode.SAT_ZERO)
    return fa, wide, mid


class QuantPipeline(nn.Module):
    """``y = qgemul(table(qgemul(x, w1)).astype(fa), w2)`` on raw tensors.

    ``w1`` and ``w2`` are int8 buffers of ``Qu<3,4>`` raws, [K, N] as the
    GEMM takes them but stored K-major (each the ``.t()`` view of an [N, K]
    contiguous tensor, made once here), the layout K1's tensor-core route
    reads without a copy; ``load_state_dict`` copies into them and keeps
    it.  ``table`` is the sqrt ROM and the cast to ``fa`` composed
    (``QTable.astype``: ``Qu<3,4,SAT::ZERO>`` in, ``Qu<3,4>`` out), its
    entries the buffer ``rom``, on the weights' device; the first GEMM
    hands it to K1's epilogue (``qgemul``'s ``epilogue_lut``).
    ``forward`` takes the raws of ``x`` in ``Qu<3,4>`` and returns the
    raws of ``y`` in ``Qu<3,4,SAT::ZERO>``, as ``entry()``'s forward does.
    """

    def __init__(self, w1: torch.Tensor, w2: torch.Tensor):
        super().__init__()
        self.fa, self.wide, self.out_fmt = pipeline_formats()
        self.register_buffer("w1", kmajor(w1))
        self.register_buffer("w2", kmajor(w2))
        self.table = build_table(sqrt_func, self.out_fmt,
                                 self.out_fmt).astype(self.fa)
        # the table's entries placed with the weights (and moved with them
        # by ``.to``), so that no call copies them to the card, as a first
        # call inside a CUDA graph capture would; not in the state dict
        self.register_buffer("rom", self.table.table.to(self.w1.device),
                             persistent=False)

    @classmethod
    def from_numpy(cls, w1_raw, w2_raw, device) -> "QuantPipeline":
        """Carry weights over from the JAX side: numpy raws, or objects with
        ``.raw()`` and ``.fmt``, placed on ``device``."""
        fa = pipeline_formats()[0]

        def weight(w) -> torch.Tensor:
            if hasattr(w, "raw") and hasattr(w, "fmt"):
                t = from_jax(w, device)
                if t.fmt != fa:
                    raise ValueError(f"weight in {t.fmt}, pipeline needs {fa}")
                return t.data
            return from_raw(np.asarray(w), fa, device).data

        return cls(weight(w1_raw), weight(w2_raw))

    def forward(self, x_raw: torch.Tensor) -> torch.Tensor:
        fa, wide, mid = self.fa, self.wide, self.out_fmt
        x = QTensor(x_raw, fa)
        # the ANUS LUT nonlinearity and the cast to fa, in K1's epilogue
        h = qgemul(x, QTensor(self.w1, fa), mid, mul_to=wide,
                   add_formats=(wide,), epilogue_lut=self.table,
                   lut_table=self.rom)
        y = qgemul(h, QTensor(self.w2, fa), mid, mul_to=wide,
                   add_formats=(wide,))
        return y.data
