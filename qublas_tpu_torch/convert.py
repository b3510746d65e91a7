"""Carry formats and tensors into the port from another package.

The port has its own :class:`~qublas_tpu_torch.qformat.QFormat`, so a format
made by another package (the JAX package ``qublas_tpu``, say) is a different
class: it compares unequal to the port's even with the same fields, and the
port's mergers refuse it as an output spec.  These functions convert by duck
typing and import nothing of the other package.
"""

from __future__ import annotations

import numpy as np

from .qformat import OverflowMode, QFormat, RoundMode
from .qtensor import QTensor, from_raw

__all__ = ["port_format", "from_jax", "complex_from_jax"]


def port_format(f) -> QFormat:
    """The port's QFormat with the fields of ``f``: any object with
    ``int_bits``, ``frac_bits``, ``signed``, ``round_mode`` and
    ``overflow_mode`` (the modes as the reference's mode numbers)."""
    if isinstance(f, QFormat):
        return f
    return QFormat(int(f.int_bits), int(f.frac_bits), bool(f.signed),
                   RoundMode(int(f.round_mode)),
                   OverflowMode(int(f.overflow_mode)))


def from_jax(t, device) -> QTensor:
    """A port QTensor on ``device`` with the raws and format of ``t``: any
    object with ``.raw()`` and ``.fmt`` (e.g. a ``qublas_tpu.QTensor``).
    Raws of limb formats, Python ints, become stacked limbs."""
    return from_raw(np.asarray(t.raw()), port_format(t.fmt), device)


def complex_from_jax(c, device):
    """A port QComplexTensor on ``device`` with the parts of ``c``: any
    object with ``.real`` and ``.imag`` parts that :func:`from_jax` takes
    (e.g. a ``qublas_tpu.complex.QComplexTensor``)."""
    from .complex import QComplexTensor

    return QComplexTensor(from_jax(c.real, device), from_jax(c.imag, device))
