"""Quantized GEMM (Qgemul) on torch: the exactness proof and the dispatch.

Port of ``qublas_tpu.ops.gemm``.  The proof machinery (``_identity_range``,
``_lossless_requant``, ``ExactPlan``, ``tree_exact``,
``dot_partial_interval``, ``exact_plan``, ``_device_epilogue_ok``,
``wide_dot_ok``, ``limb_dot_plan``) is a copy of the JAX package's
pure-Python planners: the machine with the card has no JAX, and
``qublas_tpu.ops.gemm`` imports it at module level.  The CPU tests pin the
copies to the originals.

:func:`plan_qgemul` chooses a call's tier once, the first in the JAX
package's order that admits it (by the losslessness proof, every tier that
admits a configuration gives the same bits; the order is about speed), and
:func:`qgemul` runs it:

1. **Lossless tier** (``exact_plan`` and ``_device_epilogue_ok``): every
   association order gives the same bits, so the dot is one int8 (or int32)
   integer GEMM with the requantize fused on its int32 accumulator —
   :func:`~qublas_tpu_torch.ops.fused_gemm.fused_int8_gemm` (kernel K1).
2. **Lossless limb tier** (:func:`_fast_gemm_limb`): the proof holds but
   the dot outgrows int32, so it runs as balanced int8 digit dots, one K1
   ``int_dot`` launch a k-segment, recombined exactly into stacked limbs
   (:mod:`.limbdot`) and requantized once, into any device storage.
   ``limb_dot_plan`` bounds the digit grid and the dot tensor.
3. **Lossless wide tier** (:func:`_fast_gemm_wide`): configurations outside
   the limb tier's envelope whose dot fits int64 sum it exactly in int64 —
   segment dots on K1's ``int_dot`` where every product fits int32, chunked
   int64 products otherwise — and requantize once.
   :func:`force_tiers_off` turns tiers 2 and 3 off by name ("limb",
   "wide"), as the JAX package's switch does.
4. **Hybrid tier** (``plan_hybrid``): when the product's requantize and
   the first L >= 3 tree layers are provably lossless, each block of
   2^L products is an exact integer dot and only the tail from level L up
   requantizes —
   :func:`~qublas_tpu_torch.ops.tree_gemm.tree_gemm_hybrid` (kernel K2h),
   lane operands only.
5. **Order-sensitive tier** (``plan_tree``): the reference's balanced tree
   with per-product and per-layer requantization on the kernel of
   :func:`~qublas_tpu_torch.ops.tree_gemm.tree_kernel` (K2′ or K2),
   products on the i32, split or 64-bit pair route, lane operands only.
6. **Streaming tier** (:func:`_stream_gemm_wide`): the same tree as a
   binary-carry stream of k-chunks over the elementwise ops and
   :func:`~qublas_tpu_torch.ops.reduce.qreduce`, for configurations outside
   the int32 tree (pair or limb values, layer sums beyond 32 bits); small
   GEMMs take the layered path instead: all products, then ``qreduce``.

Host operands (``is_host``), and configurations whose products need host
storage, take the exact host model (:func:`_host_gemm`): the native
engine's tree GEMM for 2-D operands inside its envelope, else
``hostops.qgemul`` a matrix.

Leading (batch) dims broadcast, as ``np.broadcast_shapes`` does in the JAX
package: both operands are expanded to the broadcast batch as views (stride
0 where a dim broadcasts, no copy).  The kernel tiers take 2-D operands;
:func:`qgemul` says how a batch reaches them.
"""

from __future__ import annotations

import itertools
from contextlib import contextmanager
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import hostops
from ..qformat import OverflowMode, QFormat, add_merge, mul_merge
from ..qtensor import QTensor, from_raw, result_device, zeros
from ..utils.profiling import span
from . import elementwise as ew
from . import limbint as L
from .fused_gemm import fused_int8_gemm, fused_int8_gemm_grouped, int_dot
from .reduce import layer_format, qreduce, reduce_format
from .tree_gemm import (
    ROUTES,
    HybridPlan,
    TreePlan,
    drain_ops,
    plan_hybrid,
    plan_tree,
    tree_gemm,
    tree_gemm_hybrid,
    tree_gemm_stream,
    tree_kernel,
)
from .wideint import mul_wide, requantize_i64
from .widths import (
    I32_MAX,
    LIMB_INTER_MAX_BITS,
    Interval,
    fmt_interval,
    requant_work_bits,
    route_mul,
    route_requant,
    storage_dtype,
    storage_kind,
    torch_dtype_for,
)

__all__ = ["qgemul", "qgemul_grouped", "qgemv", "exact_plan", "ExactPlan",
           "host_qgemul", "wide_dot_ok", "pair_dot_2d", "stream_gate",
           "force_tiers_off", "limb_dot_plan", "gemm_on_device",
           "plan_qgemul", "GemmPlan"]

_TIERS_OFF: frozenset = frozenset()   # subset of {"wide", "limb"}
_STREAM_GATE_OVERRIDE: Optional[int] = None


@contextmanager
def force_tiers_off(*tiers: str):
    """Turn the named lossless wide tiers off within the context ("limb":
    the balanced-digit dot; "wide": the int64 dot), as
    ``qublas_tpu.ops.gemm.force_tiers_off`` does: a check or a timing can
    then run the next tier on a configuration both admit."""
    global _TIERS_OFF
    saved = _TIERS_OFF
    _TIERS_OFF = saved | (frozenset(tiers) & {"limb", "wide"})
    try:
        yield
    finally:
        _TIERS_OFF = saved


@contextmanager
def stream_gate(min_elems: int):
    """Override the streaming tier's admission gate (``_STREAM_MIN_ELEMS``)
    within the context, as ``qublas_tpu.ops.gemm.stream_gate`` does: 0
    sends small GEMMs onto the stream."""
    global _STREAM_GATE_OVERRIDE
    saved = _STREAM_GATE_OVERRIDE
    _STREAM_GATE_OVERRIDE = min_elems
    try:
        yield
    finally:
        _STREAM_GATE_OVERRIDE = saved


# ---------------------------------------------------------------------------
# Exactness proof (copy of qublas_tpu/ops/gemm.py:100-204)
# ---------------------------------------------------------------------------

def _identity_range(fmt: QFormat):
    """Raw interval on which ``int_convert`` + the store are the identity.
    WRP_TCPL_SAT's store wraps at the machine word, so its identity range is
    the signed word interval."""
    if fmt.overflow_mode == OverflowMode.WRP_TCPL_SAT:
        w = fmt.storage_bits
        word = 32 if w <= 32 else 64 if w <= 64 else 64 * ((w + 63) // 64)
        return -(1 << (word - 1)), (1 << (word - 1)) - 1
    hi = fmt.raw_max
    if not fmt.signed:
        lo = 0
    elif fmt.overflow_mode == OverflowMode.SAT_SMGN:
        lo = fmt.raw_min + 1
    else:
        lo = fmt.raw_min
    return lo, hi


def _lossless_requant(iv: Interval, from_frac: int, fmt: QFormat):
    """Interval after a provably-lossless requantize into ``fmt``; None if
    the requantize can round (frac drops) or saturate/wrap."""
    d = fmt.frac_bits - from_frac
    if d < 0:
        return None  # precision drops -> rounding may occur
    out = iv << d
    rng = _identity_range(fmt)
    if rng is not None and not (out.lo >= rng[0] and out.hi <= rng[1]):
        return None
    return out


@dataclass(frozen=True)
class ExactPlan:
    """Proof artifact: the dot is lossless, so int32 accumulation at the
    product's fractional scale + one epilogue reproduces the tree
    bit-exactly."""

    prod_frac: int        # fa.frac + fb.frac — scale of the raw dot product
    final_fmt: QFormat    # format of the tree's final value
    dot_interval: Interval  # bound on every partial sum of raw products
    prod_interval: Interval  # bound on one raw product


def tree_exact(value_iv: Interval, value_fmt: QFormat, add_formats,
               k: int) -> Optional[QFormat]:
    """Prove the tree accumulation of k per-product values lossless (every
    layer add, odd-tail pass-through conversions included, neither rounds
    nor saturates).  Returns the tree's final format, or None."""
    iv, cur_fmt, cur_frac = value_iv, value_fmt, value_fmt.frac_bits
    n, layer = k, 0
    while n > 1:
        lf = layer_format(add_formats, layer)
        if lf is None:
            lf = add_merge(cur_fmt, cur_fmt)
        pair = _lossless_requant(iv + iv, cur_frac, lf)
        if pair is None:
            return None
        if n % 2:
            tail = _lossless_requant(iv, cur_frac, lf)
            if tail is None:
                return None
            iv = Interval(min(pair.lo, tail.lo), max(pair.hi, tail.hi))
        else:
            iv = pair
        cur_fmt, cur_frac = lf, lf.frac_bits
        n = (n + 1) // 2
        layer += 1
    return cur_fmt


def dot_partial_interval(prod_iv: Interval, k: int) -> Interval:
    """Bound on every partial sum of j in 1..k products, each in prod_iv."""
    lo, hi = prod_iv.lo, prod_iv.hi
    return Interval(min(k * lo, lo), max(k * hi, hi))


def exact_plan(fa: QFormat, fb: QFormat, mul_fmt: QFormat, add_formats,
               k: int) -> Optional[ExactPlan]:
    """Prove the product-quantize + tree-accumulate pipeline lossless."""
    pf = fa.frac_bits + fb.frac_bits
    prod_iv = fmt_interval(fa) * fmt_interval(fb)
    iv = _lossless_requant(prod_iv, pf, mul_fmt)
    if iv is None:
        return None
    final_fmt = tree_exact(iv, mul_fmt, add_formats, k)
    if final_fmt is None:
        return None
    return ExactPlan(pf, final_fmt, dot_partial_interval(prod_iv, k),
                     prod_iv)


def _device_epilogue_ok(plan: ExactPlan, out_fmt: QFormat) -> bool:
    """Copy of qublas_tpu/ops/gemm.py:729-734: the int32 dot and its
    requantize into ``out_fmt`` both stay on int32 lanes."""
    if torch_dtype_for(out_fmt) is None:
        return False
    if not plan.dot_interval.fits32:
        return False
    return route_requant(plan.dot_interval, plan.prod_frac, out_fmt) == "i32"


# ---------------------------------------------------------------------------
# The planner: a call's tier and kernel, chosen once
# ---------------------------------------------------------------------------

class GemmPlan(NamedTuple):
    """How :func:`qgemul` runs a call: the ``tier`` ("host", "k1", "limb",
    "wide", "hybrid", "tree", "stream", "layered"), the proofs it needs,
    the tree tier's ``kernel`` ("k2s": K2′, "k2": K2) and instantiation,
    whether a batch ``fold``s onto ``b``'s one matrix (else a call a
    matrix) and whether every route stays ``on_device``.  Built on every
    call: a named tuple builds in a third of a frozen dataclass's time."""

    tier: str
    mul_fmt: QFormat
    exact: Optional[ExactPlan] = None
    limbs: int = 0
    hybrid: Optional[HybridPlan] = None
    tree: Optional[TreePlan] = None
    kernel: str = ""
    inst: int = 0
    fold: bool = False
    on_device: bool = True


def plan_qgemul(a_fmt: QFormat, b_fmt: QFormat, a_kind: str, b_kind: str,
                out_fmt: QFormat, mul_to, add_formats: tuple,
                mul_full_prec: bool, m: int, k: int, n: int, batch=(),
                b_shared: bool = True, device_type: str = "cpu",
                tiers_off: frozenset = frozenset(),
                stream_min: Optional[int] = None) -> GemmPlan:
    """The plan of ``a`` [*batch, m, k] @ ``b`` [*, k, n] from hashable
    inputs: the formats, the storage kinds ("lane", "pair", "limb",
    "host"), the shapes, whether ``b``'s batch dims are all 1 and the
    device type.  The first tier in the JAX package's order that admits
    the call is taken; no later tier's proof runs.  ``tiers_off`` skips
    "k1", "limb" or "wide"; ``stream_min`` is the streaming gate (None:
    ``_STREAM_MIN_ELEMS``)."""
    mul_fmt = mul_merge(a_fmt, b_fmt, mul_to, mul_full_prec)
    if a_kind == "host" or b_kind == "host":
        return GemmPlan("host", mul_fmt, on_device=False)
    plan = exact_plan(a_fmt, b_fmt, mul_fmt, add_formats, k)
    if plan is not None:
        if "k1" not in tiers_off and _device_epilogue_ok(plan, out_fmt):
            return GemmPlan("k1", mul_fmt, plan, fold=b_shared)
        if "limb" not in tiers_off:
            # the envelope at a folded call's rows, then at one matrix's
            fold = bool(batch) and b_shared
            rows = min(max(_FOLD_MAX_ROWS // max(m, 1), 1),
                       int(np.prod(batch))) * m if fold else m
            limbs = limb_dot_plan(a_fmt, b_fmt, out_fmt, plan, k, rows, n)
            if limbs is None and fold:
                fold = False
                limbs = limb_dot_plan(a_fmt, b_fmt, out_fmt, plan, k, m, n)
            if limbs is not None:
                return GemmPlan("limb", mul_fmt, plan, limbs, fold=fold)
        if "wide" not in tiers_off and _wide_epilogue_ok(plan, out_fmt):
            return GemmPlan("wide", mul_fmt, plan, fold=b_shared)
    tplan = None
    if a_kind == b_kind == "lane":   # the tree kernels take lanes
        # prefix-lossless hybrid: exact block dots, then the lossy tail
        hplan = plan_hybrid(a_fmt, b_fmt, mul_fmt, add_formats, k, out_fmt)
        if hplan is not None:
            return GemmPlan("hybrid", mul_fmt, plan, hybrid=hplan,
                            fold=b_shared)
        tplan = plan_tree(a_fmt, b_fmt, mul_fmt, add_formats, k, out_fmt)
        # K2 and K2′ requantize products on the int32 and 64-bit routes; a
        # plan whose product needs wider working bits ("limb") takes the
        # tiers below, whose products run on limbs
        if tplan is not None and tplan.prod_route in ROUTES:
            kernel, inst = tree_kernel(tplan, device_type)
            return GemmPlan("tree", mul_fmt, plan, tree=tplan, kernel=kernel,
                            inst=inst, fold=b_shared)
    gate = _STREAM_MIN_ELEMS if stream_min is None else stream_min
    stream = _stream_chunk(k) and int(np.prod(batch)) * m * k * n >= gate
    # the layered path's steps; a tree proof keeps each on the device
    fin = None if route_mul(a_fmt, b_fmt, mul_fmt)[0] == "host" \
        else reduce_format(mul_fmt, add_formats, k)
    on_device = tplan is not None or fin is not None and (
        fin == out_fmt
        or route_requant(fmt_interval(fin), fin.frac_bits, out_fmt) != "host")
    return GemmPlan("stream" if stream else "layered", mul_fmt, plan,
                    on_device=on_device)


def _kind(d) -> str:
    """The storage kind of a QTensor's ``data`` for :func:`plan_qgemul`:
    ``QTensor.is_host``, ``is_limb`` and ``is_pair`` in one pass."""
    if isinstance(d, torch.Tensor):
        return "pair" if d.dtype == torch.int64 else "lane"
    return "limb" if isinstance(d, L.LimbArray) else "host"


def _plan_of(a: QTensor, b: QTensor, out_fmt: QFormat, mul_to=None,
             add_formats=(), mul_full_prec: bool = False, batch=(),
             tiers_off: Optional[frozenset] = None) -> GemmPlan:
    """:func:`plan_qgemul` of ``a`` @ ``b`` broadcast to ``batch``, under
    the switches of :func:`force_tiers_off` (or ``tiers_off``)."""
    if isinstance(add_formats, QFormat):
        add_formats = (add_formats,)
    sa, sb = a.data.shape, b.data.shape
    return plan_qgemul(
        a.fmt, b.fmt, _kind(a.data), _kind(b.data), out_fmt, mul_to,
        tuple(add_formats), mul_full_prec, sa[-2], sa[-1], sb[-1], batch,
        len(sb) == 2 or set(sb[:-2]) <= {1},
        "cuda" if getattr(a.data, "is_cuda", False) else "cpu",
        _TIERS_OFF if tiers_off is None else tiers_off,
        _STREAM_GATE_OVERRIDE)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def qgemul(a: QTensor, b: QTensor, out_fmt: QFormat, mul_to=None,
           add_formats=(), transpose_a: bool = False,
           transpose_b: bool = False, mul_full_prec: bool = False,
           epilogue_lut=None, lut_table=None) -> QTensor:
    """C = op(A) @ op(B) with per-product and per-layer quantization.

    Readme-parity API (``readme.md:80-87``): ``mul_to`` ~ QgemulMulArgs,
    ``add_formats`` ~ QgemulAddArgs TypeList, ``transpose_a/b`` ~
    QgemulTransposedA/B.  ``epilogue_lut`` applies a
    :class:`~qublas_tpu_torch.anus.QTable` built for ``out_fmt`` to the
    result; ``lut_table``, its entries already on the operands' device (a
    module's buffer, as ``QTable.__call__``'s ``table``).  Where the
    lossless tier runs on int8 operands into an int8 lane and the table
    has at most 256 entries of a lane format on that device, K1's epilogue
    looks it up before its store (:func:`_k1_lut`); otherwise the table
    runs after the GEMM.  Operands are QTensors (lane, pair or limb
    storage) of at least 2 dims on one device; a CUDA operand runs the
    tier's kernel, a CPU operand its plain version.

    Leading dims broadcast (batch dims that cannot raise ``ValueError``).
    Rows of C are independent, so a batch reaches the 2-D tiers in one of
    two ways, with the bits of one call per matrix:

    * **folded**: when ``b`` is 2-D, or every batch dim of ``b`` is 1 (an
      activation batch against a shared weight), ``a`` is reshaped to
      ``[prod(batch)·M, K]`` and the lossless (K1), limb, int64, hybrid
      (K2h) and tree (K2, K2′) tiers make ONE call (a batch of more than
      ``_FOLD_MAX_ROWS`` rows, which K1's and K2's grids cannot hold, a
      call per that many).  The limb tier's envelope
      (:func:`limb_dot_plan`) is taken at the folded M; a fold outside it
      runs the per-matrix loop instead;
    * **per matrix**: otherwise (``b`` batched, against a 2-D or batched
      ``a``) each tier runs once per element of the batch, on the expanded
      views, so a shared ``a`` is not copied.
    The streaming and layered tiers take the expanded operands whole.  The
    JAX package's limb and int64 tiers are 2-D only, so it sends a batched
    wide configuration to the streaming or layered tier; by the tiers'
    proofs the bits are the same.

    Under a profiler the call is the span ``qublas.qgemul``, and its plan
    (:func:`plan_qgemul`) one ``qublas.plan`` inside it; a table applied
    after the GEMM is a ``qublas.rom`` inside it too.
    """
    with span("qublas.qgemul"):
        if isinstance(out_fmt, QTensor):
            out_fmt = out_fmt.fmt  # readme-style call shape `Qgemul(C, A, B)`
        add_formats = (add_formats,) if isinstance(add_formats, QFormat) \
            else tuple(add_formats)
        a = _swap(a) if transpose_a else a
        b = _swap(b) if transpose_b else b
        batch = _batch(a, b)
        if 0 in batch:
            return _lut_after(zeros(batch + (a.shape[-2], b.shape[-1]),
                                    out_fmt, a.device), False, epilogue_lut,
                              lut_table)
        with span("qublas.plan"):
            p = _plan_of(a, b, out_fmt, mul_to, add_formats, mul_full_prec,
                         batch)
        table = _k1_lut(epilogue_lut, lut_table, a, b, out_fmt) \
            if p.tier == "k1" else None
        if p.tier == "host":
            c = _host_gemm(a, b, out_fmt, mul_to, add_formats, mul_full_prec)
        elif p.tier in ("stream", "layered"):
            run = _stream_gemm_wide if p.tier == "stream" else _layered_gemm
            c = run(_expand(a, batch), _expand(b, batch), out_fmt, mul_to,
                    add_formats, mul_full_prec)
        else:
            c = _over_batch(_matrix_fn(p, out_fmt, table, epilogue_lut), a,
                            b, batch, p.fold)
        return _lut_after(c, table is not None, epilogue_lut, lut_table)


def qgemul_grouped(a: QTensor, offsets, b: QTensor, out_fmt: QFormat,
                   mul_to=None, add_formats=(), epilogue_lut=None,
                   lut_table=None) -> QTensor:
    """The GEMMs of a mixture of experts in one call: rows ``offsets[g]``
    .. ``offsets[g + 1] - 1`` of ``a`` [M, K] times ``b[g]`` of the stack
    ``b`` [G, K, N], each as :func:`qgemul` computes it, into one [M, N]
    result.  ``offsets``: G + 1 host ints from 0 to M, non-decreasing (a
    group may be empty).  ``epilogue_lut`` and ``lut_table`` as there.

    The groups share their formats, K and N, so the call is planned once
    (one ``qublas.plan`` span inside the call's ``qublas.qgemul``); its
    tier must be the lossless one, on int8 lanes: K1's grouped
    instantiation then runs every group with rows in one launch, one row
    included (:func:`~.fused_gemm.fused_int8_gemm_grouped`), the table in
    its epilogue by :func:`_k1_lut`'s rules, else after it."""
    with span("qublas.qgemul"):
        with span("qublas.plan"):
            p = _plan_of(a, b, out_fmt, mul_to, add_formats)
        if (p.tier != "k1" or a.data.dtype != torch.int8
                or b.data.dtype != torch.int8):
            raise ValueError(f"qgemul_grouped runs K1: {a.fmt} x {b.fmt} "
                             f"into {out_fmt} is not a lossless int8 GEMM")
        table = _k1_lut(epilogue_lut, lut_table, a, b, out_fmt)
        fmt = out_fmt if table is None else epilogue_lut.out_fmt
        c = QTensor(fused_int8_gemm_grouped(a.data, b.data, offsets,
                                            p.exact.prod_frac, out_fmt,
                                            table, fmt), fmt)
        return _lut_after(c, table is not None, epilogue_lut, lut_table)


def _k1_lut(lut, entries, a: QTensor, b: QTensor, out_fmt: QFormat):
    """The entries of ``lut`` (a ``QTable``) that K1's epilogue applies to
    the lossless tier's result, or None where the table runs after the
    GEMM.  K1 takes it where the operands are int8 lanes, ``out_fmt``'s
    lane is int8, the table is built for ``out_fmt``'s bits with one int32
    entry a pattern (a lane output format) and its entries (``entries``,
    else its own) already lie on the operands' device: an int8 raw has at
    most 256 patterns, and a lookup copies no entry to the card, as a call
    inside a CUDA graph capture must not."""
    t = getattr(lut, "in_fmt", None)
    if t is None or a.data.dtype != torch.int8 \
            or b.data.dtype != torch.int8 \
            or torch_dtype_for(out_fmt) != torch.int8 \
            or torch_dtype_for(lut.out_fmt) is None:
        return None
    f = out_fmt
    if (f.int_bits, f.frac_bits, f.signed) != (t.int_bits, t.frac_bits,
                                               t.signed):
        return None
    table = lut.table if entries is None else entries
    if (table is None or table.ndim != 1 or table.dtype != torch.int32
            or table.numel() != 1 << f.width
            or table.device != a.data.device):
        return None
    return table


def _lut_after(c: QTensor, looked_up: bool, lut, entries) -> QTensor:
    """``c`` through the table ``lut`` (its entries ``entries`` where
    given), unless there is none or K1's epilogue ``looked_up`` already."""
    if lut is None or looked_up:
        return c
    return lut(c) if entries is None else lut(c, entries)


def _batch(a: QTensor, b: QTensor):
    """The broadcast batch of ``a`` @ ``b``, or ``ValueError``."""
    sa, sb = a.shape, b.shape
    if len(sa) < 2 or len(sb) < 2:
        raise ValueError(f"qgemul takes operands of at least 2 dims, got "
                         f"{sa} @ {sb}")
    if sa[-1] != sb[-2]:
        raise ValueError(f"inner dims mismatch: {sa} @ {sb}")
    if sb[:-2] == sa[:-2]:
        return sa[:-2]
    try:
        return np.broadcast_shapes(sa[:-2], sb[:-2])
    except ValueError as e:
        raise ValueError(f"batch dims do not broadcast: {sa} @ {sb}") from e


def _matrix_fn(p: GemmPlan, out_fmt: QFormat, table=None, lut=None):
    """The 2-D call of ``p``'s tier, K1's with ``lut``'s ``table``."""
    if p.tier == "k1":
        fmt = out_fmt if table is None else lut.out_fmt
        return lambda x, y: QTensor(fused_int8_gemm(
            x.data, y.data, p.exact.prod_frac, out_fmt, table, fmt), fmt)
    if p.tier == "limb":
        return lambda x, y: _fast_gemm_limb(x, y, out_fmt, p.exact, p.limbs)
    if p.tier == "wide":
        return lambda x, y: _fast_gemm_wide(x, y, out_fmt, p.exact)
    if p.tier == "hybrid":
        return lambda x, y: QTensor(tree_gemm_hybrid(
            x.data, y.data, p.hybrid, out_fmt), out_fmt)
    kernel = tree_gemm_stream if p.kernel == "k2s" else tree_gemm
    return lambda x, y: QTensor(kernel(x.data, y.data, p.tree, out_fmt,
                                       p.inst), out_fmt)


def _layered_gemm(a: QTensor, b: QTensor, out_fmt: QFormat, mul_to,
                  add_formats, mul_full_prec) -> QTensor:
    """The layered tier: the quantized products, then the explicit tree
    (``qreduce``), or the host model for products beyond the device."""
    prod = ew.qmul(QTensor(a.data[..., :, :, None], a.fmt),
                   QTensor(b.data[..., None, :, :], b.fmt),
                   to=mul_to, full_prec=mul_full_prec)
    if prod.is_host:
        return _host_gemm(a, b, out_fmt, mul_to, add_formats, mul_full_prec)
    return ew.qcast(qreduce(prod, add_formats, axis=-2), out_fmt)


def _swap(t: QTensor) -> QTensor:
    """``t`` with its last two dims swapped (a view)."""
    data = np.swapaxes(t.data, -1, -2) if t.is_host \
        else t.data.transpose(-1, -2)
    return QTensor(data, t.fmt, t.device)


# rows of one folded call: K1's, K2's and K2′'s grids hold at most 65535
# blocks along M, of at least 16 rows each
_FOLD_MAX_ROWS = 65535 * 16


def _expand(t: QTensor, batch) -> QTensor:
    """``t`` with its batch dims broadcast to ``batch``: a view, stride 0
    along a broadcast dim."""
    if t.shape[:-2] == batch:
        return t
    return QTensor(t.data.expand(batch + t.shape[-2:]), t.fmt)


def _over_batch(fn, a: QTensor, b: QTensor, batch, fold: bool) -> QTensor:
    """``fn`` (2-D QTensors -> QTensor) over the matrices of ``a`` and
    ``b`` broadcast to ``batch``: where ``fold`` (every batch dim of ``b``
    is 1), ``a``'s rows go in folded against ``b``'s one matrix, as many a
    call as ``_FOLD_MAX_ROWS`` hold (one call unless the batch is huge);
    else one call per batch element on expanded views."""
    if not batch:
        return fn(a, b)
    m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
    if fold:
        rows = a.data.reshape(-1, k)
        b2 = QTensor(b.data.reshape(k, n), b.fmt)
        step = max(_FOLD_MAX_ROWS // max(m, 1), 1) * m
        parts = [fn(QTensor(rows[s:s + step], a.fmt), b2)
                 for s in range(0, rows.shape[0], step)]
    else:
        a, b = _expand(a, batch), _expand(b, batch)
        parts = [fn(a[idx], b[idx])
                 for idx in itertools.product(*map(range, batch))]
    data = [p.data for p in parts]
    if len(data) > 1:
        data = [L.LimbArray(torch.cat([d.limbs for d in data], dim=1))
                if isinstance(data[0], L.LimbArray) else torch.cat(data)]
    return QTensor(data[0].reshape(batch + (m, n)), parts[0].fmt)


def _per_batch(fn, *xs: torch.Tensor):
    """``fn`` over the 2-D matrices of operands with equal leading dims: a
    loop over the flattened batch (the JAX package vmaps its kernels).
    ``fn`` returns one matrix or a tuple of them."""
    if xs[0].ndim == 2:
        return fn(*xs)
    batch = xs[0].shape[:-2]
    flat = [x.reshape((-1,) + x.shape[-2:]) for x in xs]
    outs = [fn(*mats) for mats in zip(*flat)]

    def stack(ms):
        return torch.stack(ms).reshape(batch + ms[0].shape)

    if isinstance(outs[0], torch.Tensor):
        return stack(outs)
    return tuple(stack(ms) for ms in zip(*outs))


# ---------------------------------------------------------------------------
# Lossless limb tier: balanced-digit dots (copy of qublas_tpu/ops/gemm.py:
# 491-561)
# ---------------------------------------------------------------------------

# admission caps of the digit dot (static, from formats and shapes): the
# number of int8 digit-pair dots, and the int32 dot elements of all of them
_LIMBDOT_MAX_MATMULS = 2500          # 384-bit x 384-bit operands = 49*49
_LIMBDOT_MAX_DOT_ELEMS = 1 << 28     # 1 GiB of int32 digit dots


def limb_dot_plan(a_fmt: QFormat, b_fmt: QFormat, out_fmt: QFormat,
                  plan: ExactPlan, k: int, m: int, n: int):
    """Working limb count of the digit-domain wide dot, or None when the
    configuration is outside its envelope."""
    from . import limbdot as D

    if storage_kind(out_fmt) is None:
        return None
    iva, ivb = fmt_interval(a_fmt), fmt_interval(b_fmt)
    if D.digit_matmuls(iva, ivb) > _LIMBDOT_MAX_MATMULS:
        return None
    da, db = D.digits_needed(iva), D.digits_needed(ivb)
    nseg = -(-k // D._seg_len(k, min(da, db)))
    if da * db * nseg * m * n > _LIMBDOT_MAX_DOT_ELEMS:
        return None
    if route_requant(plan.dot_interval, plan.prod_frac, out_fmt) == "host":
        return None
    need = max(D.work_bits(iva, ivb, k),
               requant_work_bits(plan.dot_interval, plan.prod_frac,
                                 out_fmt))
    if need > LIMB_INTER_MAX_BITS:
        return None
    return L.bits_to_limbs(need)


def _fast_gemm_limb(a: QTensor, b: QTensor, out_fmt: QFormat,
                    plan: ExactPlan, limbs: int) -> QTensor:
    """The lossless limb tier: the exact stacked-limb dot of
    :func:`~qublas_tpu_torch.ops.limbdot.limb_dot_2d` (one K1 launch a
    k-segment on the card) in ``limbs`` working limbs
    (:func:`limb_dot_plan`) and ONE limb requantize from the raw products'
    scale into any device storage, for 2-D operands.  Bit-exact by the
    losslessness proof, as the int32 tier is."""
    from . import limbdot as D

    acc = D.limb_dot_2d(a.data, b.data, fmt_interval(a.fmt),
                        fmt_interval(b.fmt), limbs)
    return ew._finish(L.requantize_limb(acc, plan.prod_frac, out_fmt),
                      out_fmt)


# ---------------------------------------------------------------------------
# Lossless wide tier: exact int64 dots (copy of qublas_tpu/ops/gemm.py:
# 370-456 and 564-585, on int64 instead of (hi, lo) pairs)
# ---------------------------------------------------------------------------

_PAIR_SEG_MIN = 8    # segment dots only if >= this many products a segment
_PAIR_CHUNK = 64     # otherwise products materialize [m, chunk, n]


def wide_dot_ok(a: QTensor, b: QTensor, out_fmt: QFormat,
                plan: ExactPlan) -> bool:
    """Admission of the int64 dot (``qublas_tpu/ops/gemm.py:wide_dot_ok``):
    2-D lane or pair operands, the dot (and so every partial sum and
    product) in the signed 64-bit domain, and an epilogue that runs there
    too, into lane or pair storage."""
    return a.ndim == 2 and b.ndim == 2 and _wide_epilogue_ok(plan, out_fmt)


def _wide_epilogue_ok(plan: ExactPlan, out_fmt: QFormat) -> bool:
    """The int64 dot's formats: the dot in the signed 64-bit domain and its
    requantize there too, into lane or pair storage."""
    if not plan.dot_interval.fits64:
        return False
    if storage_kind(out_fmt) not in ("lane", "pair"):
        return False
    return route_requant(plan.dot_interval, plan.prod_frac, out_fmt) \
        in ("i32", "pair")


def pair_dot_2d(ad: torch.Tensor, bd: torch.Tensor,
                prod_iv: Interval) -> torch.Tensor:
    """Exact int64 dot of ``ad`` [m, k] @ ``bd`` [k, n] under a losslessness
    proof that bounds the dot and every partial sum by the signed 64-bit
    domain, so any order of summation gives the same value.

    Where every product fits int32 (lane operands), k is cut into segments
    short enough that each segment's dot provably fits int32: each runs on
    K1's :func:`~qublas_tpu_torch.ops.fused_gemm.int_dot` (one launch a
    segment on the card), and the segment dots are summed in int64.
    Otherwise the int64 products of chunks of k are summed elementwise
    (torch has no int64 matmul on CUDA)."""
    m, k = ad.shape
    n = bd.shape[1]
    lanes = ad.dtype != torch.int64 and bd.dtype != torch.int64
    if lanes and prod_iv.fits32:
        mx = max(abs(prod_iv.lo), abs(prod_iv.hi))
        seg = k if mx == 0 else max(min(I32_MAX // mx, k), 1)
        if seg >= _PAIR_SEG_MIN:
            acc = torch.zeros((m, n), dtype=torch.int64, device=ad.device)
            for s0 in range(0, k, seg):
                acc += int_dot(ad[:, s0:s0 + seg], bd[s0:s0 + seg])
            return acc
    acc = torch.zeros((m, n), dtype=torch.int64, device=ad.device)
    for t in range(0, k, _PAIR_CHUNK):
        sl = slice(t, min(t + _PAIR_CHUNK, k))
        acc += mul_wide(ad[:, sl, None], bd[None, sl, :]).sum(dim=1)
    return acc


def _fast_gemm_wide(a: QTensor, b: QTensor, out_fmt: QFormat,
                    plan: ExactPlan) -> QTensor:
    """The lossless wide tier: the exact int64 dot (:func:`pair_dot_2d`)
    requantized once from the raw products' scale, for 2-D operands inside
    :func:`wide_dot_ok`.  Bit-exact by the same argument as the int32
    tier."""
    dot = pair_dot_2d(a.data, b.data, plan.prod_interval)
    raw = requantize_i64(dot, plan.prod_frac, out_fmt)
    return QTensor(raw.to(storage_dtype(out_fmt)), out_fmt)


# ---------------------------------------------------------------------------
# Streaming tier (copy of qublas_tpu/ops/gemm.py:592-702)
# ---------------------------------------------------------------------------

# stream only when the layered [.., m, k, n] products would be large;
# stream_gate lowers the gate
_STREAM_MIN_ELEMS = 1 << 22
_STREAM_CHUNK = 64
_STREAM_MAX_CHUNKS = 1024


def gemm_on_device(a: QTensor, b: QTensor, out_fmt: QFormat, mul_to=None,
                   add_formats=(), mul_full_prec: bool = False) -> bool:
    """Whether :func:`qgemul` of one row of ``a`` and one column of ``b``
    runs on device routes only, as its plan says (nothing computed); a
    call of more rows and columns takes the same routes."""
    if isinstance(add_formats, QFormat):
        add_formats = (add_formats,)
    return plan_qgemul(a.fmt, b.fmt, _kind(a.data), _kind(b.data), out_fmt,
                       mul_to, tuple(add_formats), mul_full_prec, 1,
                       a.shape[-1], 1, tiers_off=_TIERS_OFF).on_device


def _stream_chunk(k: int) -> int:
    """The streaming tier's chunk of products, or 0 where k does not stream
    (fewer than two chunks of 8, or more than ``_STREAM_MAX_CHUNKS``)."""
    chunk = min(1 << (max(k // 2, 1).bit_length() - 1), _STREAM_CHUNK)
    if chunk < 8 or k // chunk < 2 or -(-k // chunk) > _STREAM_MAX_CHUNKS:
        return 0
    return chunk


def _stream_gemm_wide(a: QTensor, b: QTensor, out_fmt: QFormat, mul_to,
                      add_formats, mul_full_prec) -> QTensor:
    """The order-sensitive tree GEMM as a stream of k-chunks of whole
    QTensors, so the elementwise ops route each step to its storage (lane,
    pair or limb).  The schedule is the tree GEMM's binary counter: each chunk's
    ``[.., m, chunk, n]`` products fold through the chunk's complete
    subtree by :func:`qreduce` (layers ``0..log2(chunk)-1``), and the chunk
    values merge at layers ``log2(chunk)+j`` on a slot stack, drained as
    :func:`~qublas_tpu_torch.ops.tree_gemm.drain_ops` says.  A ragged tail
    of ``k % chunk`` products is one subtree of its own, converted at each
    layer up to the chunk level (globally unpaired there), as in the JAX
    package.  For a k that streams (:func:`_stream_chunk`); products that
    need the host take the host model."""
    k = a.shape[-1]
    chunk = _stream_chunk(k)
    nfull = k // chunk
    r = k % chunk
    nchunks = nfull + (1 if r else 0)
    in_levels = chunk.bit_length() - 1

    def at_layer(fmt: QFormat, l: int) -> QFormat:
        lf = layer_format(add_formats, l)
        return lf if lf is not None else add_merge(fmt, fmt)

    slots = {}
    for t in range(nchunks):
        sl = slice(t * chunk, min((t + 1) * chunk, k))
        prod = ew.qmul(QTensor(a.data[..., :, sl, None], a.fmt),
                       QTensor(b.data[..., None, sl, :], b.fmt),
                       to=mul_to, full_prec=mul_full_prec)
        if prod.is_host:
            return _host_gemm(a, b, out_fmt, mul_to, add_formats,
                              mul_full_prec)
        v = qreduce(prod, add_formats, axis=-2)
        if t == nfull:   # the ragged tail, unpaired up to the chunk level
            for l in range(max(r - 1, 0).bit_length(), in_levels):
                v = ew.qcast(v, at_layer(v.fmt, l))
        j = 0
        while t & (1 << j):
            v = ew.qadd(slots.pop(j), v,
                        to=layer_format(add_formats, in_levels + j))
            j += 1
        slots[j] = v

    carry = None
    for op, l in drain_ops(nchunks, max(nchunks.bit_length(), 1)):
        if op == "seed":
            carry = slots[l]
        elif op == "convert":
            carry = ew.qcast(carry, at_layer(carry.fmt, in_levels + l))
        else:   # add: slot l is the earlier (left) subtree
            carry = ew.qadd(slots[l], carry,
                            to=layer_format(add_formats, in_levels + l))
    return ew.qcast(carry, out_fmt)


def qgemv(a: QTensor, x: QTensor, out_fmt: QFormat, mul_to=None,
          add_formats=(), transpose_a: bool = False,
          mul_full_prec: bool = False) -> QTensor:
    """y = op(A) @ x, the matrix-vector case of :func:`qgemul`
    (``qublas_tpu/ops/gemm.py:705-713``).  A batch of vectors ``x``
    [..., K] against a 2-D A is one GEMM whose columns are the vectors
    (outputs are independent, so the bits are those of one product per
    vector): one kernel launch for the batch."""
    if a.ndim == 2 and x.ndim > 1:
        xs = QTensor(x.data.reshape(-1, x.shape[-1]), x.fmt, x.device)
        y = _swap(qgemul(a, xs, out_fmt, mul_to, add_formats,
                         transpose_a=transpose_a, transpose_b=True,
                         mul_full_prec=mul_full_prec))
        return QTensor(y.data.reshape(x.shape[:-1] + y.shape[-1:]), y.fmt,
                       y.device)
    col = QTensor(x.data[..., :, None], x.fmt, x.device)
    y = qgemul(a, col, out_fmt, mul_to, add_formats,
               transpose_a=transpose_a, mul_full_prec=mul_full_prec)
    return QTensor(y.data[..., 0], y.fmt, y.device)


def _host_gemm(a: QTensor, b: QTensor, out_fmt: QFormat, mul_to, add_formats,
               mul_full_prec) -> QTensor:
    """The exact host golden model (``qublas_tpu/ops/gemm.py:769-799``),
    batched over broadcast leading dims: 2-D operands through the native
    engine's tree GEMM where its envelope holds, else ``hostops.qgemul``
    a matrix.  The result takes device storage where it fits one, on
    :func:`~qublas_tpu_torch.qtensor.result_device` of the operands."""
    dev = result_device(a, b)
    if a.ndim == 2 and b.ndim == 2:
        from .. import native

        mul_fmt = mul_merge(a.fmt, b.fmt, mul_to, mul_full_prec)
        got = native.tree_gemm_host(a.raw(), b.raw(), a.fmt, b.fmt, mul_fmt,
                                    tuple(add_formats), out_fmt)
        if got is not None:
            return from_raw(got, out_fmt, dev)
    A = np.asarray(a.raw(), dtype=object)
    B = np.asarray(b.raw(), dtype=object)
    batch = np.broadcast_shapes(A.shape[:-2], B.shape[:-2])
    A = np.broadcast_to(A, batch + A.shape[-2:])
    B = np.broadcast_to(B, batch + B.shape[-2:])
    out = np.empty(batch + (A.shape[-2], B.shape[-1]), dtype=object)
    for idx in np.ndindex(*batch):
        out[idx] = _hostops_gemm(A[idx], B[idx], a.fmt, b.fmt, out_fmt,
                                 mul_to, add_formats, mul_full_prec)
    return from_raw(out, out_fmt, dev)


def _hostops_gemm(A, B, fa: QFormat, fb: QFormat, out_fmt: QFormat, mul_to,
                  add_formats, mul_full_prec):
    """``hostops.qgemul`` of the 2-D raw arrays ``A`` and ``B``: a list of
    rows of Python-int raws."""
    m, k = A.shape
    n = B.shape[1]
    a_rows = [[(int(A[i, p]), fa) for p in range(k)] for i in range(m)]
    b_rows = [[(int(B[p, j]), fb) for j in range(n)] for p in range(k)]
    c = hostops.qgemul(a_rows, b_rows, out_fmt, mul_to, add_formats,
                       mul_full_prec=mul_full_prec)
    return [[v[0] for v in row] for row in c]


def host_qgemul(a: QTensor, b: QTensor, out_fmt: QFormat, mul_to=None,
                add_formats=(), mul_full_prec: bool = False) -> np.ndarray:
    """Raws of the exact host golden model (``qublas_tpu.hostops.qgemul``)
    for the same call: the semantic oracle for checks, one Python-int
    product at a time, so keep the shapes small."""
    dtype = object if storage_kind(out_fmt) in (None, "limb") else np.int64
    return np.array(_hostops_gemm(a.raw(), b.raw(), a.fmt, b.fmt, out_fmt,
                                  mul_to, add_formats, mul_full_prec),
                    dtype=dtype)
