"""K1: integer GEMM with the requantize fused on its int32 accumulator.

Hopper counterpart of the Pallas kernel
``qublas_tpu/ops/pallas_gemm.py:_pallas_gemm`` (body ``_epilogue_kernel``);
the CUDA source is ``csrc/fused_gemm.cu``.  It serves qgemul's lossless tier
and is valid only under ``gemm.exact_plan``'s proof: every partial sum of
the dot fits int32, so int32 accumulation in any order is exact, and one
``requantize_i32(dot, prod_frac, out_fmt)`` gives the tree's bits.

int8 operands run on the tensor cores; other lanes are widened to int32 and
run the int32 instantiation, as ``qgemul_fast`` casts them.
"""

from __future__ import annotations

import torch

from qublas_tpu.qformat import QFormat

from .. import _build
from .wideint import requantize_i32
from .widths import LANE_DTYPES, torch_dtype_for

__all__ = ["fused_int8_gemm", "fused_int8_gemm_plain"]


def fused_int8_gemm_plain(a: torch.Tensor, b: torch.Tensor, prod_frac: int,
                          out_fmt: QFormat) -> torch.Tensor:
    """Plain-torch K1: a float64 matmul (exact, since the proof bounds every
    partial sum by int32 < 2^53), then the int32 requantize."""
    dot = torch.matmul(a.to(torch.float64), b.to(torch.float64))
    raw = requantize_i32(dot.to(torch.int32), prod_frac, out_fmt)
    return raw.to(torch_dtype_for(out_fmt))


def fused_int8_gemm(a: torch.Tensor, b: torch.Tensor, prod_frac: int,
                    out_fmt: QFormat) -> torch.Tensor:
    """``requantize_i32(a @ b, prod_frac, out_fmt)`` for 2-D lane tensors
    ``a`` [M, K] and ``b`` [K, N], stored in ``torch_dtype_for(out_fmt)``.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    ``fused_int8_gemm.launches`` counts kernel launches.
    """
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"need [M, K] @ [K, N], got {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.dtype not in LANE_DTYPES or b.dtype not in LANE_DTYPES:
        raise TypeError(f"operands must be int8/int16/int32 lanes, got "
                        f"{a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    out_dtype = torch_dtype_for(out_fmt)
    if out_dtype is None:
        raise ValueError(f"{out_fmt} has no lane storage")
    if a.device.type == "cpu":
        return fused_int8_gemm_plain(a, b, prod_frac, out_fmt)
    if a.device.type != "cuda":
        raise ValueError(f"fused_int8_gemm runs on CUDA or CPU, not "
                         f"{a.device}")
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    lib = _build.lib()
    rq = _build.rq_args(prod_frac, out_fmt)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    if a.dtype == torch.int8 and b.dtype == torch.int8:
        a8 = a.contiguous()
        bt = b.t().contiguous()  # [N, K]: both tiles load along K
        err = lib.qk_fused_gemm_s8(a.device.index, a8.data_ptr(),
                                   bt.data_ptr(), out.data_ptr(), m, n, k,
                                   out.element_size(), *rq, stream)
    else:
        a32 = a.to(torch.int32).contiguous()
        b32 = b.to(torch.int32).contiguous()
        err = lib.qk_fused_gemm_s32(a.device.index, a32.data_ptr(),
                                    b32.data_ptr(), out.data_ptr(), m, n, k,
                                    out.element_size(), *rq, stream)
    _build.check(err, "fused_int8_gemm")
    fused_int8_gemm.launches += 1
    return out


fused_int8_gemm.launches = 0
