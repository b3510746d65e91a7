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

The tensor-core instantiation also takes a table of at most 256 int32
entries that its epilogue applies to each requantized raw before the
store (``lut``): an ANUS ROM on the output, and a cast after it, cost no
pass over device memory (``gemm.qgemul``'s ``epilogue_lut`` hands such a
table over where it can).

:func:`int_dot` is the same kernel with an identity epilogue: the plain
int32 dot that the complex GEMM's fast path combines (the JAX package's
``jnp.matmul(..., preferred_element_type=int32)`` in ``ops/cgemm.py``).
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

import torch

from .. import _build
from ..qformat import QFormat
from .wideint import requantize_i32
from .widths import LANE_DTYPES, torch_dtype_for

__all__ = ["fused_int8_gemm", "fused_int8_gemm_grouped",
           "fused_int8_gemm_plain", "int_dot", "int_dot_plain", "k1_route",
           "k1_operand", "k1_stack", "kmajor"]


def fused_int8_gemm_plain(a: torch.Tensor, b: torch.Tensor, prod_frac: int,
                          out_fmt: QFormat) -> torch.Tensor:
    """Plain-torch K1: a float64 matmul (exact, since the proof bounds every
    partial sum by int32 < 2^53), then the int32 requantize."""
    dot = torch.matmul(a.to(torch.float64), b.to(torch.float64))
    raw = requantize_i32(dot.to(torch.int32), prod_frac, out_fmt)
    return raw.to(torch_dtype_for(out_fmt))


def kmajor(b: torch.Tensor) -> torch.Tensor:
    """``b`` [..., K, N] as the transposed view of a K-major copy ([...,
    N, K] contiguous; none where ``b`` is such a view already), the layout
    K1's tensor-core route reads in place.  A caller that multiplies by
    one B several times converts it once."""
    return b.transpose(-2, -1).contiguous().transpose(-2, -1)


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


def k1_stack(b: torch.Tensor):
    """``(route, bt)``: the int8 stack ``b`` [G, K, N] as the grouped
    tensor-core route reads it, ``bt`` [G, N, K] K-major, its G * N rows
    one TMA map: ``b``'s own storage (``"direct"``, each matrix as
    :func:`k1_route` takes it and the next one right after it), else a
    copy, zero-padded to K rounded up to 16 (``"copy"``, ``"padded"``)."""
    bt = b.transpose(1, 2)
    g, n, k = bt.shape
    if g == 0 or (k1_route(bt[0]) == "direct"
                  and bt.stride(0) == n * bt.stride(1)):
        return "direct", bt
    kp = -(-k // 16) * 16
    buf = (torch.zeros if kp != k else torch.empty)(
        (g, n, kp), dtype=bt.dtype, device=bt.device)
    buf[..., :k] = bt
    return ("copy" if kp == k else "padded"), buf[..., :k]


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
                    out_fmt: QFormat, lut: Optional[torch.Tensor] = None,
                    lut_fmt: Optional[QFormat] = None) -> torch.Tensor:
    """``requantize_i32(a @ b, prod_frac, out_fmt)`` for 2-D lane tensors
    ``a`` [M, K] and ``b`` [K, N], stored in ``torch_dtype_for(out_fmt)``.

    ``lut`` (int8 operands only): int32 entries, 2^w <= 256 of them on the
    operands' device, that the epilogue applies before its store: each
    requantized raw ``r`` becomes ``lut[r & (2^w - 1)]``, stored in
    ``lut_fmt``'s lane (an ANUS ROM on ``out_fmt``'s raws, with any cast
    after it composed into the entries).

    One call of the custom op ``qublas::fused_gemm_s8`` (int8 operands)
    or ``qublas::fused_gemm_s32`` (:mod:`.library`): CPU tensors take the
    plain version; CUDA tensors launch the kernel.
    ``fused_int8_gemm.launches`` counts kernel launches,
    ``fused_int8_gemm.lut_launches`` those with a table, and
    ``fused_int8_gemm.seen`` (``_build.record``) each launch's route and
    epilogue modes.
    """
    _check_operands("fused_int8_gemm", a, b)
    out_dtype = torch_dtype_for(out_fmt if lut is None else lut_fmt)
    if out_dtype is None:
        raise ValueError(f"{out_fmt if lut is None else lut_fmt} has no "
                         f"lane storage")
    rq = _build.rq_args(prod_frac, out_fmt)
    if lut is None:
        return _op(a, b)(a, b, rq, out_dtype.itemsize)
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"the table epilogue takes int8 operands, got "
                        f"{a.dtype} and {b.dtype}")
    return torch.ops.qublas.fused_gemm_s8(a, b, rq, out_dtype.itemsize, lut)


def fused_int8_gemm_grouped(a: torch.Tensor, b: torch.Tensor, offsets,
                            prod_frac: int, out_fmt: QFormat,
                            lut: Optional[torch.Tensor] = None,
                            lut_fmt: Optional[QFormat] = None
                            ) -> torch.Tensor:
    """:func:`fused_int8_gemm` a group: rows ``offsets[g]`` ..
    ``offsets[g + 1] - 1`` of the int8 ``a`` [M, K] times ``b[g]`` of the
    int8 stack ``b`` [G, K, N] (K-major matrices, :func:`kmajor`, go in
    without a copy), into one [M, N] result.  ``offsets``: G + 1 ints from
    0 to M, non-decreasing.  ``lut`` and ``lut_fmt`` as there.

    One call of the custom op ``qublas::fused_gemm_s8_grouped``: CPU
    tensors take the plain version a group; CUDA tensors launch K1's
    grouped instantiation once (once a 256 groups), its grid the row tiles
    of every group with rows, a group of one row too; each launch counted
    in ``fused_int8_gemm.launches`` (and ``lut_launches``).
    """
    offsets = [int(o) for o in offsets]
    if (a.dtype != torch.int8 or b.dtype != torch.int8 or a.ndim != 2
            or b.ndim != 3 or a.shape[1] != b.shape[1]):
        raise ValueError(f"need int8 [M, K] and a stack [G, K, N], got "
                         f"{a.dtype} {tuple(a.shape)} and {b.dtype} "
                         f"{tuple(b.shape)}")
    if (len(offsets) != b.shape[0] + 1 or offsets[0] != 0
            or offsets[-1] != a.shape[0]
            or any(e < s for s, e in zip(offsets, offsets[1:]))):
        raise ValueError(f"offsets {offsets} do not split {a.shape[0]} "
                         f"rows into {b.shape[0]} groups")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    out_dtype = torch_dtype_for(out_fmt if lut is None else lut_fmt)
    if out_dtype is None:
        raise ValueError(f"{out_fmt if lut is None else lut_fmt} has no "
                         f"lane storage")
    return torch.ops.qublas.fused_gemm_s8_grouped(
        a, b, offsets, _build.rq_args(prod_frac, out_fmt),
        out_dtype.itemsize, lut)


def _op(a: torch.Tensor, b: torch.Tensor):
    """K1's custom op for the operands' lanes: the tensor-core
    instantiation for int8 x int8, the int32 one otherwise."""
    if a.dtype == torch.int8 and b.dtype == torch.int8:
        return torch.ops.qublas.fused_gemm_s8
    return torch.ops.qublas.fused_gemm_s32


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

    The same custom ops as :func:`fused_int8_gemm`, with no requantize
    step: CPU tensors take the plain version; CUDA tensors launch the
    kernel and add one to ``fused_int8_gemm.launches``.
    """
    _check_operands("int_dot", a, b)
    return _op(a, b)(a, b, (), 4)


fused_int8_gemm.launches = 0
fused_int8_gemm.lut_launches = 0
fused_int8_gemm.seen = Counter()
