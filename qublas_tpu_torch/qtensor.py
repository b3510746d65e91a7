"""QTensor on torch: a raw-integer tensor plus its fixed-point format.

Port of ``qublas_tpu.qtensor`` for **lane storage only**: formats of at
most 32 storage bits, held in int8/int16/int32 tensors by
:func:`~qublas_tpu_torch.ops.widths.torch_dtype_for`.  Pair storage (33..64
bits), limb storage (65..992 bits) and the host-resident object arrays that
hold ``fill(int)`` wart raws beyond the int32 word are ROADMAP items 10-11
and raise ``NotImplementedError`` here.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from qublas_tpu.ops.widths import storage_kind
from qublas_tpu.qformat import QFormat

from .ops.widths import LANE_DTYPES, torch_dtype_for

__all__ = ["QTensor", "from_raw"]


def _lane_only(fmt: QFormat):
    if storage_kind(fmt) != "lane":
        raise NotImplementedError(
            f"{fmt}: {fmt.storage_bits}-bit storage needs pair or limb "
            "storage, not yet ported (ROADMAP items 10-11)")


class QTensor:
    """Raw integer tensor + fixed-point format (lane storage)."""

    __slots__ = ("data", "fmt")

    def __init__(self, data: torch.Tensor, fmt: QFormat):
        _lane_only(fmt)
        if data.dtype not in LANE_DTYPES:
            raise TypeError(f"QTensor data must be int8/int16/int32, "
                            f"got {data.dtype}")
        self.data = data
        self.fmt = fmt

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def ndim(self) -> int:
        return self.data.ndim

    @property
    def device(self) -> torch.device:
        return self.data.device

    def to(self, device) -> "QTensor":
        return QTensor(self.data.to(device), self.fmt)

    def raw(self) -> np.ndarray:
        """Raw storage integers as a NumPy array."""
        return self.data.cpu().numpy()

    def to_double(self) -> np.ndarray:
        """Per-element double value = raw / 2^frac_bits (QuBLAS.h:2413-2416)."""
        return self.raw().astype(np.float64) * (2.0 ** -self.fmt.frac_bits)

    def astype(self, fmt: QFormat) -> "QTensor":
        """Cross-format conversion: requantize with the destination's modes
        (reference converting copy, QuBLAS.h:2758-2830)."""
        from .ops.elementwise import qcast

        return qcast(self, fmt)

    def __getitem__(self, idx) -> "QTensor":
        return QTensor(self.data[idx], self.fmt)

    def __repr__(self):
        return (f"QTensor(shape={self.shape}, fmt={self.fmt}, "
                f"device={self.device})")


def from_raw(values: Any, fmt: QFormat, device) -> QTensor:
    """Build a QTensor from raw storage integers on ``device``.

    Like ``qublas_tpu.qtensor.from_raw`` (and the reference's ``fill(int)``)
    the raws are stored as given, not masked: the lane is the smallest of
    int8/int16/int32, no narrower than the format's own, that holds every
    value.  Raws beyond int32 need the host object storage (ROADMAP item
    11) and raise.
    """
    _lane_only(fmt)
    arr = np.asarray(values)
    if arr.dtype == object:
        raise NotImplementedError(
            "object-dtype raws need host object storage (ROADMAP items "
            "10-11)")
    if not np.issubdtype(arr.dtype, np.integer):
        raise TypeError(f"from_raw takes integer raws, got {arr.dtype}")
    vmin = int(arr.min()) if arr.size else 0
    vmax = int(arr.max()) if arr.size else 0
    floor = LANE_DTYPES.index(torch_dtype_for(fmt))
    for np_dt in (np.int8, np.int16, np.int32)[floor:]:
        info = np.iinfo(np_dt)
        if info.min <= vmin and vmax <= info.max:
            data = torch.from_numpy(np.array(arr, dtype=np_dt, order="C"))
            return QTensor(data.to(device), fmt)
    raise NotImplementedError(
        f"raws [{vmin}, {vmax}] exceed the int32 lane: the fill(int) wart "
        "needs host object storage (ROADMAP item 11)")
