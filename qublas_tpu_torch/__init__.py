"""qublas_tpu_torch — the PyTorch/CUDA port of qublas_tpu.

Bit-exact QuBLAS fixed-point semantics on torch tensors, with the kernels of
the ported paths written by hand for NVIDIA Hopper (``csrc/``): K1, the
lossless int8 GEMM with a fused requantize epilogue (also the int32 dots of
the complex GEMM's fast path, and in a grouped instantiation the experts'
GEMMs of a mixture of experts); K2 and K2′, the order-sensitive tree GEMM on
its blocked and one-pass schedules; K2h, the prefix-lossless hybrid tree
GEMM (exact block dots, then the lossy tail); K3, the layered tree reduce
(Qreduce); and P1, the probe that measures the tree GEMM's per-product
work.  The elementwise and complex elementwise ops are plain torch ops, on
int32 lanes, int64 (pair storage, 33..64 bits) or stacked 32-bit limbs in
int64 (limb storage, 65..992 bits: ``ops.limbint``); host storage (beyond
992 bits, or wart raws beyond the storage word) runs on the native host
engine (``native``, built with ``g++`` at first use) or the exact Python
model; the wide lossless GEMMs run as balanced int8 digit dots on K1
(``ops.limbdot``); ``bitstream`` serializes tensors to the reference's bit
strings.  Around them:
``anus`` (``qpoly``/``qapprox``/``QTable``), ``pipeline.QuantPipeline``
(an FFN block) and ``moe.QuantMoE`` (DeepSeek-V3's MoE layer, with its
combine C1, its g·u pass G1, and ``QuantRMSNorm``, the norm before it,
N1), ``refrand`` (the reference's
mt19937 ``fill()``/``shuffle()`` streams), ``bitwise``, ``checkpoint`` and
``diagnostics``.

The package stands alone: it imports torch and numpy, never JAX and nothing
of the JAX package ``qublas_tpu``.  It keeps its own copies of the JAX
package's pure-Python modules (``qformat``, ``hostint``, ``hostops`` and
the width proofs of ``ops.widths``), pinned to the originals by
``tests/test_torch_copies.py``.  :func:`port_format`, :func:`from_jax` and
:func:`complex_from_jax` carry formats and tensors of another package
across by duck typing.

Kernels build at first use (``nvcc``); a CPU tensor takes each kernel's
plain-torch version instead.  Constructors place tensors on the card
unless the caller names another device; host tensors never live on it.
"""

from . import bitstream, bitwise
from .anus import (QTable, Segment, build_table, qapprox, qpoly, qtable,
                   reciprocal_func, rsqrt_func, sigmoid_func, silu_func,
                   sqrt_func)
from .checkpoint import dumps_bits, load, loads_bits, save
from .complex import (QComplexTensor, cadd, cdiv, ceq, cmul, cmul_tf, cneg,
                      complex_from_float, complex_from_parts, complex_from_raw,
                      complex_zeros, cr_add, cr_div, cr_mul, cr_sub, csub,
                      rc_add, rc_div, rc_mul, rc_sub)
from .convert import complex_from_jax, from_jax, port_format
from .diagnostics import format_range_report, requant_stats
from .ops.cgemm import cgemul, cgemv
from .ops.elementwise import (qabs, qadd, qcast, qcmp, qdiv, qeq, qmul, qneg,
                              qsub)
from .moe import QuantMoE, QuantRMSNorm, moe_formats
from .ops.gemm import exact_plan, host_qgemul, qgemul, qgemul_grouped, qgemv
from .ops.reduce import qreduce, qreduce_args
from .pipeline import QuantPipeline, pipeline_formats
from .qformat import (
    FULL_PREC,
    FullPrec,
    OverflowMode,
    QFormat,
    RoundMode,
    add_merge,
    mul_merge,
    qformat,
)
from .qtensor import (QTensor, from_double, from_float, from_raw, random_fill,
                      scalar, zeros)
from .refrand import reference_fill, reference_shuffle

__all__ = [
    "FULL_PREC", "FullPrec", "OverflowMode", "QFormat", "RoundMode", "add_merge", "mul_merge",
    "qformat", "QTable", "build_table", "reciprocal_func", "rsqrt_func",
    "sqrt_func", "sigmoid_func", "silu_func", "qcast", "qmul", "qadd",
    "qsub", "qdiv", "qabs", "qneg", "qcmp", "qeq", "exact_plan",
    "host_qgemul", "qgemul", "qgemul_grouped", "qgemv",
    "qreduce", "qreduce_args", "QuantPipeline", "pipeline_formats",
    "QuantMoE", "QuantRMSNorm", "moe_formats",
    "QTensor", "from_raw", "from_float", "from_double", "scalar", "zeros",
    "random_fill", "from_jax", "port_format", "complex_from_jax",
    "QComplexTensor", "complex_from_parts", "complex_from_float",
    "complex_from_raw", "complex_zeros", "cmul", "cmul_tf", "cadd", "csub",
    "cneg", "ceq", "rc_mul", "cr_mul", "rc_add", "cr_add", "rc_sub",
    "cr_sub", "cr_div", "cdiv", "rc_div", "cgemul", "cgemv", "bitstream",
    "qpoly", "qapprox", "Segment", "qtable", "reference_fill",
    "reference_shuffle", "requant_stats", "format_range_report", "save",
    "load", "dumps_bits", "loads_bits", "bitwise",
]
