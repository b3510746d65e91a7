"""ANUS — the reference's nonlinear subprograms on torch tensors.

Port of ``qublas_tpu.anus`` (the reference's ``ANUS`` namespace,
``QuBLAS.h:4829-4897``, and the readme's LUTs, ``readme.md:66-78``):

* :func:`qpoly` — Horner form, each level's multiply and add quantized to
  that level's leading coefficient format (QuBLAS.h:4836-4851);
* :func:`qapprox` / :class:`Segment` — the segmented fit: the segment is
  chosen by the input's *double* value against the breakpoints, resolved
  exactly on integer raws by a threshold found on the host
  (:func:`_raw_threshold`), so the device select is a ``torch.where``
  chain on int32 lanes, int64 pairs or stacked limbs; the result is
  requantized into the input's format (QuBLAS.h:4854-4884);
* :class:`QTable` / :func:`qtable` — exact LUTs: every input bit pattern
  mapped through a Python-double function and requantized into the output
  format with the exact host pipeline (``hostint``), exactly as the JAX
  package builds it.  Applying the table is a mask of the input raws and a
  plain index of the table on the tensor's device: int32 entries for a
  lane output format, int64 for a pair-storage one (33..64 bits), a column
  of stacked limbs for a limb-storage one (65..992 bits).  (The JAX
  package's 63-select packed tree exists only because Mosaic has no 1-D
  gather; torch indexes natively.)  A host-storage output format (beyond
  992 bits) or a host input looks its raws up on the host, as Python ints.

Host inputs (``is_host``) evaluate :func:`qpoly` on the host routes of the
elementwise ops, and :func:`qapprox` selects per element by the exact
double value, as the JAX package does.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from . import hostint
from .ops import elementwise as ew
from .ops import limbint as L
from .ops.limbint import LimbArray, ints_from_limbs, limbs_from_ints
from .ops.widths import limb_count, storage_dtype, storage_kind
from .qformat import QFormat
from .qtensor import QTensor, from_raw
from .utils.profiling import span

__all__ = ["qpoly", "qapprox", "Segment", "qtable", "QTable", "build_table",
           "rsqrt_func", "reciprocal_func", "sqrt_func", "sigmoid_func",
           "silu_func"]


# ---------------------------------------------------------------------------
# Polynomial fitting (copy of qublas_tpu/anus.py:51-203)
# ---------------------------------------------------------------------------

def qpoly(x: QTensor, coeffs: Sequence[QTensor]) -> QTensor:
    """Horner evaluation ``a0 + x*(a1 + x*(a2 + ...))`` with per-level
    quantization typed by each level's leading coefficient
    (QuBLAS.h:4836-4851): each level computes
    ``qadd(a_i, qmul(x, inner, to=a_i.fmt), to=a_i.fmt)``.  ``coeffs`` are
    scalar QTensors ``[a0, a1, ..., an]`` on x's device."""
    coeffs = list(coeffs)
    if not coeffs:
        raise ValueError("qpoly needs at least one coefficient")
    acc = coeffs[-1]
    for a in reversed(coeffs[:-1]):
        acc = ew.qadd(a, ew.qmul(x, acc, to=a.fmt), to=a.fmt)
    return acc


class Segment:
    """A breakpoint and its polynomial's coefficients (reference
    ``ANUS::Segment``, QuBLAS.h:4855-4866): applies while
    ``x.toDouble() < breakpoint``; the last segment also covers everything
    above its breakpoint."""

    def __init__(self, breakpoint: float, coeffs: Sequence[QTensor]):
        self.breakpoint = float(breakpoint)
        self.coeffs = list(coeffs)


def _raw_threshold(breakpoint: float, fmt: QFormat, word_bits: int):
    """Largest raw r of the ``word_bits`` word whose ROUNDED double value
    satisfies ``raw_to_double(r, fmt) < breakpoint``, or None when none
    does.  The reference compares ``input.toDouble() < breakpoint``
    (QuBLAS.h:4878), so a raw of more than 53 significant bits is rounded
    first; ``raw_to_double`` is monotone in the raw, so the predicate is a
    prefix and bisection finds its edge."""
    lo = -(1 << (word_bits - 1))
    hi = (1 << (word_bits - 1)) - 1
    if not (hostint.raw_to_double(lo, fmt) < breakpoint):
        return None
    if hostint.raw_to_double(hi, fmt) < breakpoint:
        return hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if hostint.raw_to_double(mid, fmt) < breakpoint:
            lo = mid
        else:
            hi = mid
    return lo


def qapprox(x: QTensor, segments: Sequence[Segment]) -> QTensor:
    """Segmented polynomial fit (reference ``ANUS::Qapprox``,
    QuBLAS.h:4868-4884): per element the first segment whose breakpoint
    exceeds the value applies (the last catches the rest), and its
    :func:`qpoly` is requantized into **x's format** (the
    ``decltype(x){...}`` converting construction).

    Every segment's polynomial is evaluated on all of x; the select walks
    the breakpoints from the last-but-one down, ``x <= threshold`` on the
    raw: lanes widened to int32 and compared with the threshold, a Python
    int inside the int32 word (never the raw int8/int16 lanes, whose word
    would wrap it), pairs as int64, limbs with the limb compare.  No
    tensor is made from the threshold, so a CUDA graph captures the
    select."""
    segments = list(segments)
    if not segments:
        raise ValueError("qapprox needs at least one segment")

    def bcast(br: QTensor) -> QTensor:
        # a constant segment evaluates to a 0-d result
        if br.shape == x.shape:
            return br
        if br.is_host:
            return QTensor(np.broadcast_to(br.data, x.shape), br.fmt,
                           br.device)
        return QTensor(br.data.expand(x.shape), br.fmt)

    branches = [bcast(ew.qcast(qpoly(x, s.coeffs), x.fmt))
                for s in segments]
    if x.is_host or any(br.is_host for br in branches):
        # per element: the first segment whose breakpoint exceeds the
        # exact double value (JAX qublas_tpu/anus.py:144-159)
        flats = [br.raw().reshape(-1) for br in branches]
        out = []
        for i, r in enumerate(x.raw().reshape(-1)):
            val = hostint.raw_to_double(int(r), x.fmt)
            pick = next((j for j, s in enumerate(segments)
                         if val < s.breakpoint), len(segments) - 1)
            out.append(int(flats[pick][i]))
        return from_raw(np.array(out, dtype=object).reshape(x.shape), x.fmt,
                        x.device)
    pairs = list(zip(reversed(segments[:-1]), reversed(branches[:-1])))
    if x.is_limb:
        K = x.data.nlimbs
        xl = x.data.limbs
        result = branches[-1].data.limbs
        for s, br in pairs:
            thr = _raw_threshold(s.breakpoint, x.fmt, 32 * K)
            if thr is None:
                continue  # breakpoint below every storable x: never taken
            tl = L.lconst(thr, K, x.shape, x.device)
            take = L.llt(xl, tl) | L.leq(xl, tl)  # x <= thr
            result = L.lselect(take, br.data.limbs, result)
        return QTensor(LimbArray(result), x.fmt)
    if x.is_pair:
        xv, word = x.data, 64
    else:
        xv, word = x.data.to(torch.int32), 32
    result = branches[-1].data
    for s, br in pairs:
        thr = _raw_threshold(s.breakpoint, x.fmt, word)
        if thr is None:
            continue  # breakpoint below every storable x: never taken
        # thr lies inside xv's word: a Python int compares in xv's dtype
        take = xv <= thr
        result = torch.where(take, br.data, result)
    return QTensor(result, x.fmt)


def rsqrt_func(v: float) -> float:
    """1/sqrt(x) (readme.md:68)."""
    return 1.0 / math.sqrt(v) if v > 0 else math.inf if v == 0 else math.nan


def reciprocal_func(v: float) -> float:
    """1/x (readme.md:71)."""
    return 1.0 / v if v != 0 else math.inf


def sqrt_func(v: float) -> float:
    """sqrt(x) (readme.md:74)."""
    return math.sqrt(v) if v >= 0 else math.nan


def sigmoid_func(v: float) -> float:
    """1 / (1 + exp(-x)): a router's score (DeepSeek-V3's
    ``scoring_func`` sigmoid).  Below x = -709 ``exp`` overflows, which a
    :class:`QTable` stores as 0."""
    return 1.0 / (1.0 + math.exp(-v))


def silu_func(v: float) -> float:
    """x / (1 + exp(-x)): SiLU, a gated FFN's activation (``hidden_act``
    silu), in this one form of the double arithmetic (``x * sigmoid(x)``
    may round otherwise)."""
    return v / (1.0 + math.exp(-v))


MAX_TABLE_BITS = 20  # 1M int32 entries


def _pattern_raw(p: int, fmt: QFormat) -> int:
    """The raw of ``fmt`` whose logical-width bit pattern is ``p``."""
    w = fmt.width
    return p - (1 << w) if fmt.signed and w > 0 and p >= (1 << (w - 1)) \
        else p


class QTable:
    """A precomputed exact LUT: input bit pattern -> output raw value.

    ``table[p]`` holds the output for the input whose logical-width bit
    pattern is ``p``: the pattern is sign-interpreted per the input format,
    mapped through ``func`` in double, and converted with the output
    format's exact pipeline (non-finite -> 0).
    """

    def __init__(self, func: Callable[[float], float], in_fmt: QFormat,
                 out_fmt: Optional[QFormat] = None):
        self.func = func
        self.in_fmt = in_fmt
        self.out_fmt = out_fmt or in_fmt
        w = in_fmt.width
        if w > MAX_TABLE_BITS:
            raise ValueError(
                f"LUT over a {w}-bit input needs 2^{w} entries; cap is "
                f"2^{MAX_TABLE_BITS}.  Use qapprox for wide formats.")
        raws = []
        for p in range(1 << max(w, 0)):
            val = hostint.raw_to_double(_pattern_raw(p, in_fmt), in_fmt)
            try:
                out_val = float(func(val))
            except (ValueError, ZeroDivisionError, OverflowError):
                out_val = math.nan
            raws.append(hostint.double_to_raw(out_val, self.out_fmt))
        self._store(raws)

    def _store(self, raws: list):
        """Hold ``raws`` (entry p the output raw of input pattern p) as
        the output format's storage takes them."""
        w = self.in_fmt.width
        kind = storage_kind(self.out_fmt)
        self._mask = (1 << w) - 1 if w > 0 else 0
        # the entries as Python ints, for host lookups: kept here for host
        # storage, read back from the table on a first host input otherwise
        self._raws = raws if kind is None else None
        if kind is None:
            self.table = None   # host storage: looked up as Python ints
        elif kind == "limb":
            # [K, entries]: entry p is column p
            self.table = limbs_from_ints(raws, limb_count(self.out_fmt))
        else:
            self.table = torch.from_numpy(np.array(
                raws, dtype=np.int64 if kind == "pair" else np.int32))
        self._on_device = {}

    def astype(self, fmt: QFormat) -> "QTable":
        """This table followed by the cast to ``fmt``, as one table of the
        same input: entry p is entry p cast (``QTensor.astype``), so that a
        lookup gives the bits of ``self(x).astype(fmt)`` for every ``x``.
        The cast runs once, here, on the entries; the new table's ``func``
        is None."""
        w = self.in_fmt.width
        x = from_raw(np.array([_pattern_raw(p, self.in_fmt)
                               for p in range(1 << max(w, 0))],
                              dtype=object), self.in_fmt, "cpu")
        raws = [int(r) for r in
                np.asarray(self(x).astype(fmt).raw(), dtype=object)]
        out = QTable.__new__(QTable)
        out.func, out.in_fmt, out.out_fmt = None, self.in_fmt, fmt
        out._store(raws)
        return out

    def to(self, device) -> "QTable":
        """Place the entries on ``device`` (in place; returns the table):
        inputs there index them with no copy.  A caller that runs the
        lookup in a CUDA graph places the table first, or passes entries
        it has placed itself (``__call__``'s ``table``), since an input on
        another device copies the entries there on its first lookup."""
        if self.table is not None:
            self.table = self.table.to(device)
        self._on_device = {}
        return self

    def _table_on(self, device: torch.device) -> torch.Tensor:
        if self.table.device == device:
            return self.table
        t = self._on_device.get(device)
        if t is None:
            t = self._on_device[device] = self.table.to(device)
        return t

    def _host_raws(self) -> list:
        if self._raws is None:
            t = self.table
            self._raws = (list(ints_from_limbs(t)) if t.ndim == 2
                          else t.tolist())
        return self._raws

    def __call__(self, x: QTensor, table: Optional[torch.Tensor] = None
                 ) -> QTensor:
        """The lookup of ``x``.  ``table``: these entries (``self.table``
        placed on ``x``'s device, e.g. a module's buffer) instead of the
        table's own.  The device lookup is the span ``qublas.rom``."""
        # signedness and int_bits change how a bit pattern is interpreted;
        # round/overflow modes do not, so they may differ
        f, t = x.fmt, self.in_fmt
        if (f.int_bits, f.frac_bits, f.signed) != (t.int_bits, t.frac_bits,
                                                   t.signed):
            raise ValueError(f"QTable built for {self.in_fmt}, got {x.fmt}")
        if x.is_host or self.table is None:
            entries = self._host_raws()
            raws = [entries[int(r) & self._mask]
                    for r in x.raw().reshape(-1)]
            return from_raw(np.array(raws, dtype=object).reshape(x.shape),
                            self.out_fmt, x.device)
        with span("qublas.rom"):
            idx = (x.data.to(torch.int32) & self._mask).long()
            if table is None:
                table = self._table_on(x.device)
            if table.ndim == 2:
                return QTensor(LimbArray(table[:, idx]), self.out_fmt)
            return QTensor(table[idx].to(storage_dtype(self.out_fmt)),
                           self.out_fmt)


def build_table(func, in_fmt: QFormat,
                out_fmt: Optional[QFormat] = None) -> QTable:
    return QTable(func, in_fmt, out_fmt)


def qtable(x: QTensor, func, out_fmt: Optional[QFormat] = None) -> QTensor:
    """One-shot LUT application (reference ``ANUS::Qtable<func>(q)``,
    readme.md:66-78).  For repeated use build a :class:`QTable` once."""
    return QTable(func, x.fmt, out_fmt)(x)
