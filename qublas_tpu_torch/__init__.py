"""qublas_tpu_torch — the PyTorch/CUDA port of qublas_tpu.

Bit-exact QuBLAS fixed-point semantics on torch tensors, with the
quantized-GEMM main path's kernels written by hand for NVIDIA Hopper
(``csrc/``): K1, the lossless int8 GEMM with a fused requantize epilogue,
and K2, the order-sensitive tree GEMM.  The JAX package ``qublas_tpu`` is
the reference each piece is tested against; this package shares only its
JAX-free modules (``qformat``, ``hostint``, ``hostops`` and the interval
proofs of ``ops.widths``) and never imports JAX.

Kernels build at first use (``nvcc``); a CPU tensor takes each kernel's
plain-torch version instead.
"""

from qublas_tpu.qformat import (
    OverflowMode,
    QFormat,
    RoundMode,
    add_merge,
    mul_merge,
    qformat,
)

from .anus import QTable, build_table, reciprocal_func, rsqrt_func, sqrt_func
from .ops.elementwise import qcast
from .ops.gemm import exact_plan, host_qgemul, qgemul
from .pipeline import QuantPipeline, pipeline_formats
from .qtensor import QTensor, from_raw

__all__ = [
    "OverflowMode", "QFormat", "RoundMode", "add_merge", "mul_merge",
    "qformat", "QTable", "build_table", "reciprocal_func", "rsqrt_func",
    "sqrt_func", "qcast", "exact_plan", "host_qgemul", "qgemul",
    "QuantPipeline", "pipeline_formats", "QTensor", "from_raw",
]
