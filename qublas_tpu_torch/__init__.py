"""qublas_tpu_torch — the PyTorch/CUDA port of qublas_tpu.

Bit-exact QuBLAS fixed-point semantics on torch tensors, with the kernels of
the ported paths written by hand for NVIDIA Hopper (``csrc/``): K1, the
lossless int8 GEMM with a fused requantize epilogue (also the int32 dots of
the complex GEMM's fast path); K2 and K2′, the order-sensitive tree GEMM on
its blocked and one-pass schedules; K3, the layered tree reduce (Qreduce);
and P1, the probe that measures the tree GEMM's per-product work.  The
elementwise and complex elementwise ops are plain torch ops, on int32
lanes, int64 (pair storage, 33..64 bits) or stacked 32-bit limbs in int64
(limb storage, 65..992 bits: ``ops.limbint``); the wide lossless GEMMs run
as balanced int8 digit dots on K1 (``ops.limbdot``); ``bitstream``
serializes tensors to the reference's bit strings.

The package stands alone: it imports torch and numpy, never JAX and nothing
of the JAX package ``qublas_tpu``.  It keeps its own copies of the JAX
package's pure-Python modules (``qformat``, ``hostint``, ``hostops`` and
the width proofs of ``ops.widths``), pinned to the originals by
``tests/test_torch_copies.py``.  :func:`port_format`, :func:`from_jax` and
:func:`complex_from_jax` carry formats and tensors of another package
across by duck typing.

Kernels build at first use (``nvcc``); a CPU tensor takes each kernel's
plain-torch version instead.  Constructors place tensors on the card unless
the caller names another device.
"""

from . import bitstream
from .anus import QTable, build_table, reciprocal_func, rsqrt_func, sqrt_func
from .complex import (QComplexTensor, cadd, cdiv, ceq, cmul, cmul_tf, cneg,
                      complex_from_float, complex_from_parts, complex_from_raw,
                      complex_zeros, cr_add, cr_div, cr_mul, cr_sub, csub,
                      rc_add, rc_div, rc_mul, rc_sub)
from .convert import complex_from_jax, from_jax, port_format
from .ops.cgemm import cgemul, cgemv
from .ops.elementwise import (qabs, qadd, qcast, qcmp, qdiv, qeq, qmul, qneg,
                              qsub)
from .ops.gemm import exact_plan, host_qgemul, qgemul, qgemv
from .ops.reduce import qreduce, qreduce_args
from .pipeline import QuantPipeline, pipeline_formats
from .qformat import (
    OverflowMode,
    QFormat,
    RoundMode,
    add_merge,
    mul_merge,
    qformat,
)
from .qtensor import (QTensor, from_double, from_float, from_raw, random_fill,
                      scalar, zeros)

__all__ = [
    "OverflowMode", "QFormat", "RoundMode", "add_merge", "mul_merge",
    "qformat", "QTable", "build_table", "reciprocal_func", "rsqrt_func",
    "sqrt_func", "qcast", "qmul", "qadd", "qsub", "qdiv", "qabs", "qneg",
    "qcmp", "qeq", "exact_plan", "host_qgemul", "qgemul", "qgemv",
    "qreduce", "qreduce_args", "QuantPipeline", "pipeline_formats",
    "QTensor", "from_raw", "from_float", "from_double", "scalar", "zeros",
    "random_fill", "from_jax", "port_format", "complex_from_jax",
    "QComplexTensor", "complex_from_parts", "complex_from_float",
    "complex_from_raw", "complex_zeros", "cmul", "cmul_tf", "cadd", "csub",
    "cneg", "ceq", "rc_mul", "cr_mul", "rc_add", "cr_add", "rc_sub",
    "cr_sub", "cr_div", "cdiv", "rc_div", "cgemul", "cgemv", "bitstream",
]
