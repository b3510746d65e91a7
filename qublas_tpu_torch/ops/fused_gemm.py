"""K1: integer GEMM with the requantize fused on its int32 accumulator.

Hopper counterpart of the Pallas kernel
``qublas_tpu/ops/pallas_gemm.py:_pallas_gemm`` (body ``_epilogue_kernel``);
the CUDA source is ``csrc/fused_gemm.cu``.  It serves qgemul's lossless tier
and is valid only under ``gemm.exact_plan``'s proof: every partial sum of
the dot fits int32, so int32 accumulation in any order is exact, and one
``requantize_i32(dot, prod_frac, out_fmt)`` gives the tree's bits.

int8 operands run on the tensor cores (TMA + ``wgmma``), which read A
[M, K] and B as Bt [N, K], both K-major: a ``b`` that is the ``.t()`` view
of a K-major tensor (:func:`kmajor`) goes in without a copy, a row-major
``b`` is transposed on every call.  TMA needs 16-byte aligned bases and
row strides, so an operand that has neither goes in as a zero-padded copy
with K rounded up to 16 (:func:`k1_route` says which).  Other lanes are
widened to int32 and run the int32 instantiation on row-major operands, as
``qgemul_fast`` casts them.

:func:`int_dot` is the same kernel with an identity epilogue: the plain
int32 dot that the complex GEMM's fast path combines (the JAX package's
``jnp.matmul(..., preferred_element_type=int32)`` in ``ops/cgemm.py``).
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

import torch

from .. import _build
from ..qformat import OverflowMode, QFormat, RoundMode
from .wideint import requantize_i32
from .widths import LANE_DTYPES, torch_dtype_for

__all__ = ["fused_int8_gemm", "fused_int8_gemm_plain", "int_dot",
           "int_dot_plain", "k1_route", "k1_operand", "kmajor"]


def fused_int8_gemm_plain(a: torch.Tensor, b: torch.Tensor, prod_frac: int,
                          out_fmt: QFormat) -> torch.Tensor:
    """Plain-torch K1: a float64 matmul (exact, since the proof bounds every
    partial sum by int32 < 2^53), then the int32 requantize."""
    dot = torch.matmul(a.to(torch.float64), b.to(torch.float64))
    raw = requantize_i32(dot.to(torch.int32), prod_frac, out_fmt)
    return raw.to(torch_dtype_for(out_fmt))


def kmajor(b: torch.Tensor) -> torch.Tensor:
    """``b`` [K, N] as the ``.t()`` view of a K-major copy ([N, K]
    contiguous), the layout K1's tensor-core route reads in place.  A
    caller that multiplies by one B several times converts it once."""
    return b.t().contiguous().t()


def k1_route(t: torch.Tensor) -> str:
    """How the tensor-core route reads the int8 matrix ``t`` [R, K] (A, or
    B transposed): ``"direct"`` where TMA can describe it in place (unit
    stride along K, a row stride that is a multiple of 16 bytes and not
    below K, a 16-byte aligned base), else a K-major copy, ``"copy"`` when
    K is a multiple of 16, ``"padded"`` (zero columns up to the next one)
    when it is not."""
    if (t.stride(1) == 1 and t.stride(0) % 16 == 0
            and t.stride(0) >= t.shape[1] and t.data_ptr() % 16 == 0):
        return "direct"
    return "copy" if t.shape[1] % 16 == 0 else "padded"


def k1_operand(t: torch.Tensor, route: Optional[str] = None) -> torch.Tensor:
    """``t`` [R, K] as the tensor-core route reads it: itself, or a view of
    the first K columns of a fresh K-major [R, K'] tensor, K' = K rounded up
    to 16, zero beyond K (zero products add 0 to every partial sum).
    ``route`` is ``k1_route(t)``, computed here when None."""
    route = k1_route(t) if route is None else route
    if route == "direct":
        return t
    r, k = t.shape
    kp = -(-k // 16) * 16
    buf = (torch.zeros if route == "padded" else torch.empty)(
        (r, kp), dtype=t.dtype, device=t.device)
    buf[:, :k] = t
    return buf[:, :k]


def _launch(a: torch.Tensor, b: torch.Tensor, rq, out_dtype,
            out_fmt=None) -> torch.Tensor:
    """Launch K1 on CUDA operands with the requantize ``rq``
    (``csrc/requant.cuh``'s ``Rq`` fields) into ``out_fmt``, or the
    identity epilogue of :func:`int_dot` where ``out_fmt`` is None."""
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    lib = _build.lib()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    if a.dtype == torch.int8 and b.dtype == torch.int8:
        ra, rb = k1_route(a), k1_route(b.t())
        a8 = k1_operand(a, ra)
        bt = k1_operand(b.t(), rb)  # [N, K]
        instance = f"s8/{ra}/{rb}"
        err = lib.qk_fused_gemm_s8(a.device.index, a8.data_ptr(), a8.stride(0),
                                   bt.data_ptr(), bt.stride(0),
                                   out.data_ptr(), m, n, k,
                                   out.element_size(), *rq, stream)
    else:
        instance = "s32"
        a32 = a.to(torch.int32).contiguous()
        b32 = b.to(torch.int32).contiguous()
        err = lib.qk_fused_gemm_s32(a.device.index, a32.data_ptr(),
                                    b32.data_ptr(), out.data_ptr(), m, n, k,
                                    out.element_size(), *rq, stream)
    _build.check(err, "fused_int8_gemm")
    fused_int8_gemm.launches += 1
    if out_fmt is None:
        _build.record(fused_int8_gemm, "int_dot/" + instance)
    else:
        _build.record(fused_int8_gemm, "gemm/" + instance, (out_fmt,))
    return out


def _check_operands(name: str, a: torch.Tensor, b: torch.Tensor):
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"need [M, K] @ [K, N], got {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.dtype not in LANE_DTYPES or b.dtype not in LANE_DTYPES:
        raise TypeError(f"operands must be int8/int16/int32 lanes, got "
                        f"{a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CUDA or CPU, not {a.device}")


def fused_int8_gemm(a: torch.Tensor, b: torch.Tensor, prod_frac: int,
                    out_fmt: QFormat) -> torch.Tensor:
    """``requantize_i32(a @ b, prod_frac, out_fmt)`` for 2-D lane tensors
    ``a`` [M, K] and ``b`` [K, N], stored in ``torch_dtype_for(out_fmt)``.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    ``fused_int8_gemm.launches`` counts kernel launches, and
    ``fused_int8_gemm.seen`` (``_build.record``) each launch's route and
    epilogue modes.
    """
    _check_operands("fused_int8_gemm", a, b)
    out_dtype = torch_dtype_for(out_fmt)
    if out_dtype is None:
        raise ValueError(f"{out_fmt} has no lane storage")
    if a.device.type == "cpu":
        return fused_int8_gemm_plain(a, b, prod_frac, out_fmt)
    return _launch(a, b, _build.rq_args(prod_frac, out_fmt), out_dtype,
                   out_fmt)


# K1's identity epilogue: requant.cuh returns y unchanged for d = 0 under
# WRP_TCPL at a signed width of 32 (shift, round mode, overflow mode, width,
# signedness)
_IDENTITY_RQ = (0, int(RoundMode.TRN_TCPL), int(OverflowMode.WRP_TCPL), 32, 1)


def int_dot_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain-torch :func:`int_dot`: a float64 matmul, exact while every
    partial sum stays below 2^53 (the callers' proofs bound them by int32),
    wrapped into int32 as the kernel's accumulator wraps."""
    dot = torch.matmul(a.to(torch.float64), b.to(torch.float64))
    return dot.to(torch.int64).to(torch.int32)


def int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The int32 dot ``a @ b`` of 2-D lane tensors ``a`` [M, K] and ``b``
    [K, N]: K1 with the identity epilogue.  int8 operands run the tensor-core
    instantiation, int16/int32 operands the int32 one, so every raw keeps its
    value whatever its format (no narrowing by interval).

    CPU tensors take the plain version; CUDA tensors launch the kernel and
    add one to ``fused_int8_gemm.launches``.
    """
    _check_operands("int_dot", a, b)
    if a.device.type == "cpu":
        return int_dot_plain(a, b)
    return _launch(a, b, _IDENTITY_RQ, torch.int32)


fused_int8_gemm.launches = 0
fused_int8_gemm.seen = Counter()
