"""Complex fixed-point tensors and their quantized arithmetic on torch.

Port of ``qublas_tpu/complex.py`` (the reference's ``Qcomplex``,
``include/QuBLAS.h:2500-2617``, and the complex algorithms,
``QuBLAS.h:3374-3739``): a complex value is a pair of independently
formatted fixed-point parts, here two lane-storage
:class:`~qublas_tpu_torch.qtensor.QTensor` s on one device.  Every complex
op composes the elementwise ops of :mod:`.ops.elementwise` (plain torch
ops, as the JAX package leaves them to XLA).

Per-step quantization tags of the reference are keyword arguments, with
``None`` meaning "infer by the default merger", as omitting the tag in C++
does; the reference's tag-default quirks come from
:func:`~qublas_tpu_torch.hostops.single_tag_default`.  Constructors place
their tensors on ``device``, the card unless the caller names another.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch.utils._pytree as pytree

from . import hostops
from .ops import elementwise as ew
from .ops.widths import route_addsub, route_mul
from .qformat import QFormat, add_merge, mul_merge
from .qtensor import QTensor, from_float, from_raw, zeros

__all__ = [
    "QComplexTensor", "complex_from_parts", "complex_from_float",
    "complex_from_raw", "complex_zeros",
    "cmul", "cmul_tf", "cmul_formats", "cadd", "csub", "cneg", "ceq",
    "rc_mul", "cr_mul", "rc_add", "cr_add", "rc_sub", "cr_sub", "cr_div",
    "cdiv", "rc_div",
]


class QComplexTensor:
    """A pair of independently formatted fixed-point tensors (reference
    ``Qu_s<Qu_s<realArgs...>, Qu_s<imagArgs...>>``, QuBLAS.h:2501-2605)."""

    __slots__ = ("real", "imag")

    def __init__(self, real: QTensor, imag: QTensor):
        if tuple(real.shape) != tuple(imag.shape):
            raise ValueError("real/imag shape mismatch")
        if real.device != imag.device:
            raise ValueError(f"real part on {real.device}, imag part on "
                             f"{imag.device}")
        self.real = real
        self.imag = imag

    @property
    def shape(self):
        return self.real.shape

    @property
    def ndim(self) -> int:
        return self.real.ndim

    @property
    def fmt(self):
        return (self.real.fmt, self.imag.fmt)

    @property
    def width(self) -> int:
        """Logical width = realWidth + imagWidth (QuBLAS.h:2509)."""
        return self.real.fmt.width + self.imag.fmt.width

    @property
    def device(self):
        return self.real.device

    def to(self, device) -> "QComplexTensor":
        return QComplexTensor(self.real.to(device), self.imag.to(device))

    def to_complex(self) -> np.ndarray:
        """complex128 value array (QuBLAS.h:2548-2551)."""
        return self.real.to_double() + 1j * self.imag.to_double()

    def astype(self, real_fmt: QFormat, imag_fmt: Optional[QFormat] = None):
        """Per-part requantize (reference converting ctor,
        QuBLAS.h:2526-2530)."""
        imag_fmt = real_fmt if imag_fmt is None else imag_fmt
        return QComplexTensor(self.real.astype(real_fmt),
                              self.imag.astype(imag_fmt))

    def to_bits(self, tensor_order=None, elem_order=None) -> str:
        from . import bitstream

        return bitstream.to_bits_complex(self, tensor_order, elem_order)

    def __repr__(self):
        return (f"QComplexTensor(shape={tuple(self.shape)}, "
                f"re={self.real.fmt}, im={self.imag.fmt}, "
                f"device={self.device})")

    def __getitem__(self, idx):
        return QComplexTensor(self.real[idx], self.imag[idx])

    # operators: the reference's untagged operators
    def __mul__(self, other):
        if isinstance(other, QComplexTensor):
            return cmul(self, other)
        return cr_mul(self, other)

    def __add__(self, other):
        if isinstance(other, QComplexTensor):
            return cadd(self, other)
        return cr_add(self, other)

    def __sub__(self, other):
        if isinstance(other, QComplexTensor):
            return csub(self, other)
        return cr_sub(self, other)

    # reflected operators: real op complex (QuBLAS.h:3600-3663); QTensor's
    # operators return NotImplemented for a complex right operand
    def __rmul__(self, other):
        return rc_mul(other, self)

    def __radd__(self, other):
        return rc_add(other, self)

    def __rsub__(self, other):
        return rc_sub(other, self)

    def __neg__(self):
        return cneg(self)

    def __truediv__(self, other):
        if isinstance(other, QComplexTensor):
            return cdiv(self, other)  # raises, as the reference does
        return cr_div(self, other)


# A pytree node, as the JAX package's QComplexTensor is: its two parts.
def _complex_unflatten(children, _ctx) -> QComplexTensor:
    out = object.__new__(QComplexTensor)
    out.real, out.imag = children
    return out


pytree.register_pytree_node(
    QComplexTensor,
    lambda c: ([c.real, c.imag], None),
    _complex_unflatten,
    serialized_type_name="qublas_tpu_torch.complex.QComplexTensor")


# ---------------------------------------------------------------------------
# Constructors
# ---------------------------------------------------------------------------

def complex_from_parts(real: QTensor, imag: QTensor) -> QComplexTensor:
    return QComplexTensor(real, imag)


def complex_from_float(values, real_fmt: QFormat,
                       imag_fmt: Optional[QFormat] = None,
                       device="cuda") -> QComplexTensor:
    """Exact complex double -> fixed conversion (QuBLAS.h:2519-2533)."""
    imag_fmt = real_fmt if imag_fmt is None else imag_fmt
    arr = np.asarray(values, dtype=np.complex128)
    return QComplexTensor(from_float(arr.real, real_fmt, device),
                          from_float(arr.imag, imag_fmt, device))


def complex_from_raw(real_raws, imag_raws, real_fmt: QFormat,
                     imag_fmt: Optional[QFormat] = None,
                     device="cuda") -> QComplexTensor:
    imag_fmt = real_fmt if imag_fmt is None else imag_fmt
    return QComplexTensor(from_raw(real_raws, real_fmt, device),
                          from_raw(imag_raws, imag_fmt, device))


def complex_zeros(shape, real_fmt: QFormat,
                  imag_fmt: Optional[QFormat] = None,
                  device="cuda") -> QComplexTensor:
    imag_fmt = real_fmt if imag_fmt is None else imag_fmt
    return QComplexTensor(zeros(shape, real_fmt, device),
                          zeros(shape, imag_fmt, device))


# ---------------------------------------------------------------------------
# Complex x complex
# ---------------------------------------------------------------------------

def cmul(a: QComplexTensor, b: QComplexTensor, ac=None, bd=None, ad=None,
         bc=None, acbd=None, adbc=None) -> QComplexTensor:
    """4-mul/2-add complex multiply ``(ac-bd) + (ad+bc)i`` with six optional
    per-step formats (reference BasicComplexMul, QuBLAS.h:3376-3446, the
    default algorithm for complex ``Qmul``).  Omitted step formats follow
    ``hostops.single_tag_default``."""
    return QComplexTensor(*_basic_steps(
        _TensorSteps, a.real, a.imag, b.real, b.imag, ac=ac, bd=bd, ad=ad,
        bc=bc, acbd=acbd, adbc=adbc))


def cmul_tf(a: QComplexTensor, b: QComplexTensor, ab=None, cd=None, ba=None,
            abc=None, cdb=None, bad=None, AB=None, BC=None) -> QComplexTensor:
    """3-mul/5-add complex multiply (reference TFComplexMul,
    QuBLAS.h:3448-3535)::

        A = (a+b)c,  B = (c+d)b,  C = (b-a)d
        re = A - B,  im = B - C

    Omitted step tags follow ``hostops.single_tag_default``, except ``ba``:
    it applies to its own step when supplied but, lacking ``::list``
    (QuBLAS.h:3515), never inherits the single-tag fallback when absent.
    """
    return QComplexTensor(*_tf_steps(
        _TensorSteps, a.real, a.imag, b.real, b.imag, ab=ab, cd=cd, ba=ba,
        abc=abc, cdb=cdb, bad=bad, AB=AB, BC=BC))


def cmul_formats(far: QFormat, fai: QFormat, fbr: QFormat, fbi: QFormat,
                 algo: str = "basic", **tags):
    """The part formats of :func:`cmul` (``algo="basic"``) or
    :func:`cmul_tf` (``"tf"``) of operands of these formats when every step
    runs on a device route of the elementwise ops; None when a step takes
    the host route.  The same steps, on formats: nothing is computed."""
    steps = _tf_steps if algo == "tf" else _basic_steps
    re, im = steps(_FormatSteps, far, fai, fbr, fbi, **tags)
    return None if re is None or im is None else (re, im)


def _basic_steps(ops, ar, ai, br, bi, ac=None, bd=None, ad=None, bc=None,
                 acbd=None, adbc=None):
    fb = hostops.single_tag_default(ac, bd, ad, bc, acbd, adbc)
    ac, bd, ad, bc, acbd, adbc = (x if x is not None else fb
                                  for x in (ac, bd, ad, bc, acbd, adbc))
    real = ops.sub(ops.mul(ar, br, ac), ops.mul(ai, bi, bd), acbd)
    imag = ops.add(ops.mul(ar, bi, ad), ops.mul(ai, br, bc), adbc)
    return real, imag


def _tf_steps(ops, ar, ai, br, bi, ab=None, cd=None, ba=None, abc=None,
              cdb=None, bad=None, AB=None, BC=None):
    fb = hostops.single_tag_default(ab, cd, ba, abc, cdb, bad, AB, BC)
    ab, cd, abc, cdb, bad, AB, BC = (x if x is not None else fb
                                     for x in (ab, cd, abc, cdb, bad, AB, BC))
    A = ops.mul(ops.add(ar, ai, ab), br, abc)
    B = ops.mul(ops.add(br, bi, cd), ai, bad)
    C = ops.mul(ops.sub(ai, ar, ba), bi, cdb)
    return ops.sub(A, B, AB), ops.sub(B, C, BC)


class _TensorSteps:
    """The steps on QTensors: the elementwise ops."""

    @staticmethod
    def mul(x, y, to):
        return ew.qmul(x, y, to=to)

    @staticmethod
    def add(x, y, to):
        return ew.qadd(x, y, to=to)

    @staticmethod
    def sub(x, y, to):
        return ew.qsub(x, y, to=to)


class _FormatSteps:
    """The steps on formats: the result's format where the elementwise op
    takes a device route, else None (a None operand gives None)."""

    @staticmethod
    def mul(x, y, to):
        if x is None or y is None:
            return None
        out = mul_merge(x, y, to)
        return None if route_mul(x, y, out)[0] == "host" else out

    @staticmethod
    def add(x, y, to, sub=False):
        if x is None or y is None:
            return None
        out = add_merge(x, y, to)
        return None if route_addsub(x, y, out, sub)[0] == "host" else out

    @staticmethod
    def sub(x, y, to):
        return _FormatSteps.add(x, y, to, sub=True)


def cadd(a: QComplexTensor, b: QComplexTensor, real_to=None,
         imag_to=None) -> QComplexTensor:
    """Complex add with optional per-part formats (QuBLAS.h:3549-3562);
    exactly one part's format applies to both parts."""
    fb = hostops.single_tag_default(real_to, imag_to)
    return QComplexTensor(
        ew.qadd(a.real, b.real, to=real_to if real_to is not None else fb),
        ew.qadd(a.imag, b.imag, to=imag_to if imag_to is not None else fb))


def csub(a: QComplexTensor, b: QComplexTensor, real_to=None,
         imag_to=None) -> QComplexTensor:
    """Complex sub (QuBLAS.h:3570-3584), tags as :func:`cadd`."""
    fb = hostops.single_tag_default(real_to, imag_to)
    return QComplexTensor(
        ew.qsub(a.real, b.real, to=real_to if real_to is not None else fb),
        ew.qsub(a.imag, b.imag, to=imag_to if imag_to is not None else fb))


def cneg(a: QComplexTensor) -> QComplexTensor:
    """Complex negation: negate both parts (QuBLAS.h:3320-3329)."""
    return QComplexTensor(ew.qneg(a.real), ew.qneg(a.imag))


def ceq(a: QComplexTensor, b: QComplexTensor):
    """Complex equality, both parts equal (QuBLAS.h:3363-3370): a bool
    tensor."""
    return ew.qeq(a.real, b.real) & ew.qeq(a.imag, b.imag)


# ---------------------------------------------------------------------------
# Real x complex mixed ops (QuBLAS.h:3600-3739), with the reference's
# asymmetric quirks
# ---------------------------------------------------------------------------

def rc_mul(r: QTensor, c: QComplexTensor, real_to=None,
           imag_to=None) -> QComplexTensor:
    """real x complex: per-part multiply (QuBLAS.h:3603-3620)."""
    fb = hostops.single_tag_default(real_to, imag_to)
    return QComplexTensor(
        ew.qmul(r, c.real, to=real_to if real_to is not None else fb),
        ew.qmul(r, c.imag, to=imag_to if imag_to is not None else fb))


def cr_mul(c: QComplexTensor, r: QTensor, real_to=None,
           imag_to=None) -> QComplexTensor:
    """complex x real (QuBLAS.h:3626-3642)."""
    fb = hostops.single_tag_default(real_to, imag_to)
    return QComplexTensor(
        ew.qmul(c.real, r, to=real_to if real_to is not None else fb),
        ew.qmul(c.imag, r, to=imag_to if imag_to is not None else fb))


def rc_add(r: QTensor, c: QComplexTensor, to=None) -> QComplexTensor:
    """real + complex: the imaginary part passes through unquantized
    (QuBLAS.h:3648-3663)."""
    return QComplexTensor(ew.qadd(r, c.real, to=to), c.imag)


def cr_add(c: QComplexTensor, r: QTensor, to=None) -> QComplexTensor:
    """complex + real (QuBLAS.h:3665-3679)."""
    return QComplexTensor(ew.qadd(c.real, r, to=to), c.imag)


def rc_sub(r: QTensor, c: QComplexTensor, to=None) -> QComplexTensor:
    """real - complex: imag = (0 - c.imag) quantized with ``to``, the zero a
    default-constructed scalar of r's format (QuBLAS.h:3682-3697)."""
    zero = zeros((), r.fmt, r.device)
    return QComplexTensor(ew.qsub(r, c.real, to=to),
                          ew.qsub(zero, c.imag, to=to))


def cr_sub(c: QComplexTensor, r: QTensor, to=None) -> QComplexTensor:
    """complex - real: imag passes through unquantized (QuBLAS.h:3699-3713)."""
    return QComplexTensor(ew.qsub(c.real, r, to=to), c.imag)


def cr_div(c: QComplexTensor, r: QTensor, real_to=None,
           imag_to=None) -> QComplexTensor:
    """complex / real: per-part divide (QuBLAS.h:3722-3736)."""
    fb = hostops.single_tag_default(real_to, imag_to)
    return QComplexTensor(
        ew.qdiv(c.real, r, to=real_to if real_to is not None else fb),
        ew.qdiv(c.imag, r, to=imag_to if imag_to is not None else fb))


def cdiv(a: QComplexTensor, b: QComplexTensor, *args, **kwargs):
    """Complex / complex: unsupported, as the reference throws "Complex
    division is not supported yet." (QuBLAS.h:3591-3598)."""
    raise NotImplementedError("Complex division is not supported yet.")


def rc_div(r: QTensor, c: QComplexTensor, *args, **kwargs):
    """real / complex: unsupported, as the reference throws
    (QuBLAS.h:3716-3720)."""
    raise NotImplementedError("Real-Complex division is not supported yet.")
