"""Storage dtypes of lane formats on torch tensors.

The interval proofs (``Interval``, ``fmt_interval``, ``route_requant``, ...)
are pure Python and the port imports them from ``qublas_tpu.ops.widths``;
only the dtype rule (``qublas_tpu.ops.widths.dtype_for``) is restated here,
because the JAX package's version returns ``jax.numpy`` dtypes.
"""

from __future__ import annotations

import torch

from qublas_tpu.qformat import OverflowMode, QFormat

__all__ = ["torch_dtype_for", "LANE_DTYPES"]

LANE_DTYPES = (torch.int8, torch.int16, torch.int32)


def torch_dtype_for(fmt: QFormat):
    """Smallest single-lane torch dtype holding the format's storage, or
    None when the format needs pair/limb/host storage.

    WRP_TCPL_SAT formats wrap only at the machine word, so their lane is
    always a full int32 word (narrower dtypes would wrap too early).
    """
    s = fmt.storage_bits
    if fmt.overflow_mode == OverflowMode.WRP_TCPL_SAT:
        return torch.int32 if s <= 32 else None
    if s <= 8:
        return torch.int8
    if s <= 16:
        return torch.int16
    if s <= 32:
        return torch.int32
    return None
