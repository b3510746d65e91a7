"""A mixture-of-experts layer as a fixed-point datapath: DeepSeek-V3's MoE
layer (``modeling_deepseek.py``'s ``MoEGate`` and ``DeepseekV3MoE``:
sigmoid scores, group-limited top-k with a selection bias, normalized and
scaled weights, SwiGLU experts and a shared expert) on raw tensors, bit
for bit as ``gpubench/reference/moe_ffn.py`` states it.

The layer holds the experts ``first .. first + count - 1`` of the
``experts`` its router scores, as one chip of an expert-parallel
deployment does: it routes every row over all of them and computes the
held experts' part and the shared expert's; the absent experts' part is
another chip's.  One forward, under a profiler four spans:

* ``qublas.moe.route``: the router's GEMM (K1 into int16 lanes), the
  sigmoid ROM after it (a 65,536-entry :class:`~.anus.QTable`), the group
  and top-k selection on integer keys that make every tie go to the lower
  group and the lower expert, and the weights (the reciprocal ROM of the
  scores' sum, the scaling);
* ``qublas.moe.dispatch``: a stable sort of the (row, expert) pairs by held
  expert and the copy of the held experts' row counts to the host; then,
  once the shared expert is enqueued, the one host sync (the wait for
  those counts, which size the groups) and the gather of the rows;
* ``qublas.moe.experts``: the shared expert's gate, up and down
  projections through :func:`~.ops.gemm.qgemul`, enqueued before the
  sync so that the card runs them while the host waits; then
  :func:`~.ops.gemm.qgemul_grouped` over the held experts' (the SiLU ROM
  in K1's epilogue of both gate projections);
* ``qublas.moe.combine``: each row's shared output plus its held pairs'
  weighted outputs, summed in int32 (lossless, so in any order), and the
  output's requantize, in one pass (:func:`combine`, kernel C1: a gather
  a row, where a scatter-add would make three passes over an int32
  tensor of every pair's outputs).

Before it a decoder layer normalizes its rows (``DeepseekV3RMSNorm``):
:class:`QuantRMSNorm`, under the span ``qublas.moe.norm``, one pass of
kernel N1 a layer (:func:`rms_norm`).
"""

from __future__ import annotations

import functools
import math

import torch
from torch import nn

from . import _build
from .anus import (QTable, reciprocal_func, rsqrt_func, sigmoid_func,
                   silu_func)
from .ops.elementwise import qadd, qcast, qmul
from .ops.fused_gemm import kmajor
from .ops.gemm import _identity_range, qgemul, qgemul_grouped
from .ops.library import IDENTITY_RQ
from .ops.widths import Interval, fmt_interval, storage_dtype
from .qformat import OverflowMode, RoundMode, qformat
from .qtensor import QTensor, from_float
from .utils.profiling import span

__all__ = ["QuantMoE", "QuantRMSNorm", "moe_formats"]


def moe_formats() -> dict:
    """The layer's formats by name (those of ``moe_ffn``'s reference):
    ``Qu<3,4>`` int8 operands rounded to nearest (``RND::CONV``), the
    RMSNorm's ``Qu<19,8>`` sum of squares, ``Qu<12,3>`` into the rsqrt ROM,
    ``Qu<1,14>`` out of it, the ``Qu<7,8>`` gain, the ``Qu<3,12>`` factor
    and the ``Qu<3,4,RND::CONV>`` normalized rows; ``Qu<20,8>`` lossless
    products and layers, ``Qu<7,8>`` router logits and expert outputs,
    ``Qu<1,14>`` scores, bias, reciprocal and normalized weights,
    ``Qu<2,14>`` choices, ``Qu<4,14>`` the scores' sum (``Qu<4,8>`` into
    the reciprocal ROM), the scaling factor in ``Qu<3,4>``, ``Qu<3,12>``
    weights, ``Qu<3,4,SAT::ZERO>`` gate projections, ``Qu<7,8>`` g·u,
    ``Qu<10,8>`` weighted outputs, the ``Qu<14,8>`` accumulator and the
    ``Qu<3,4,RND::CONV,SAT::ZERO>`` output.  ``TRN::TCPL`` and
    ``SAT::TCPL`` unless stated."""
    sat0, conv = OverflowMode.SAT_ZERO, RoundMode.RND_CONV
    return {"operand": qformat(3, 4, round_mode=conv),
            "sumsq": qformat(19, 8), "sumsq_rom": qformat(12, 3),
            "rsqrt": qformat(1, 14), "norm_gain": qformat(7, 8),
            "norm_scale": qformat(3, 12),
            "normed": qformat(3, 4, round_mode=conv),
            "accumulate": qformat(20, 8),
            "logit": qformat(7, 8), "score": qformat(1, 14),
            "bias": qformat(1, 14), "choice": qformat(2, 14),
            "total": qformat(4, 14), "total_rom": qformat(4, 8),
            "recip": qformat(1, 14), "norm": qformat(1, 14),
            "scale": qformat(3, 4), "weight": qformat(3, 12),
            "gate": qformat(3, 4, overflow_mode=sat0), "gu": qformat(7, 8),
            "down": qformat(7, 8), "pair": qformat(10, 8),
            "acc": qformat(14, 8),
            "out": qformat(3, 4, round_mode=conv, overflow_mode=sat0)}


@functools.lru_cache(maxsize=None)
def _tables():
    """The sigmoid, reciprocal and SiLU ROMs, built once a process."""
    f = moe_formats()
    return (QTable(sigmoid_func, f["logit"], f["score"]),
            QTable(reciprocal_func, f["total_rom"], f["recip"]),
            QTable(silu_func, f["gate"], f["operand"]))


@functools.lru_cache(maxsize=None)
def _rsqrt_table():
    """The RMSNorm's rsqrt ROM (65,536 entries), built once a process."""
    f = moe_formats()
    return QTable(rsqrt_func, f["sumsq_rom"], f["rsqrt"])


def _largest(key: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the ``k`` largest of each row of ``key`` (no two
    alike in a row), largest first: ``k`` argmax passes (``torch.topk``
    on 32,768 rows of 256 took several times as long on the H100)."""
    key = key.clone()
    low = torch.iinfo(key.dtype).min
    out = []
    for _ in range(k):
        i = key.argmax(-1, keepdim=True)
        out.append(i)
        key.scatter_(-1, i, low)
    return torch.cat(out, -1)


def select_experts(c: torch.Tensor, n_group: int, topk_group: int,
                   top_k: int) -> torch.Tensor:
    """The ``top_k`` experts of each row of choices ``c`` [rows, experts]
    (raws): the ``topk_group`` groups with the largest sum of their two
    largest choices, then the largest choices of those groups' experts.
    The keys carry the index below the value (a value times the count,
    plus the count less one less the index), so no two tie and every tie
    of values goes to the lower group and the lower expert.  [rows, top_k]
    expert indices, largest first."""
    rows, e = c.shape
    per = e // n_group
    c = c.long()
    grouped = c.view(rows, n_group, per)
    first, at = grouped.max(-1, keepdim=True)
    second = grouped.scatter(-1, at, torch.iinfo(torch.int64).min).amax(-1)
    best2 = first.squeeze(-1) + second
    down = torch.arange(n_group - 1, -1, -1, device=c.device)
    kept = _largest(best2 * n_group + down, topk_group)
    eligible = torch.zeros(rows, n_group, dtype=torch.bool, device=c.device)
    eligible = eligible.scatter_(1, kept, True).repeat_interleave(per, 1)
    key = c * e + torch.arange(e - 1, -1, -1, device=c.device)
    return _largest(key.masked_fill_(~eligible, torch.iinfo(torch.int64).min),
                    top_k)


def combine(shared: QTensor, d: QTensor, pos: torch.Tensor, w: QTensor,
            pair_fmt, acc_fmt, out_fmt) -> torch.Tensor:
    """Each row's accumulator in ``acc_fmt``, the shared expert's output
    ``shared`` [rows, n] plus ``w * d`` (requantized to ``pair_fmt``) for
    each slot k of the row whose pair ``pos[row, k]`` (a row of ``d``,
    the held experts' outputs; -1 for an expert not held) is here, then
    requantized to ``out_fmt`` (None: the int32 accumulator's raws).
    ``w`` [rows, k]: every slot's weight.

    The sum is taken in int32, exact where every product fits int32 and
    no sum of the k + 1 terms (each inside ``acc_fmt``) leaves int32: both
    are proved here from the formats, so the order of the adds cannot
    show.  One call of the custom op ``qublas::moe_combine``: CPU tensors
    take the plain scatter-add; CUDA tensors launch C1 (``combine.
    launches``), a gather a row, and raise ValueError where C1 cannot
    take the formats (a step but the last that rounds or wraps, lanes
    other than int16, n not a multiple of 8, more than 8 slots)."""
    k = pos.shape[1]
    terms = Interval(*_identity_range(acc_fmt))
    if not (fmt_interval(w.fmt) * fmt_interval(d.fmt)).fits32 or not \
            Interval((k + 1) * terms.lo, (k + 1) * terms.hi).fits32:
        raise ValueError(f"{w.fmt} x {d.fmt}, {k + 1} terms in {acc_fmt}: "
                         f"outgrow int32")
    fin, out_bytes = (IDENTITY_RQ, 4) if out_fmt is None else (
        _build.rq_args(acc_fmt.frac_bits, out_fmt),
        storage_dtype(out_fmt).itemsize)
    params = (_build.rq_args(w.fmt.frac_bits + d.fmt.frac_bits, pair_fmt)
              + _build.rq_args(pair_fmt.frac_bits, acc_fmt)
              + _build.rq_args(shared.fmt.frac_bits, acc_fmt)
              + _build.rq_args(acc_fmt.frac_bits, acc_fmt) + fin)
    return torch.ops.qublas.moe_combine(shared.data, d.data, pos,
                                        w.data.to(torch.int32),
                                        list(params), out_bytes)


combine.launches = 0


def gated(g: QTensor, u: QTensor, mid_fmt, out_fmt) -> QTensor:
    """``qcast(qmul(g, u, to=mid_fmt), out_fmt)`` of same-shape lane
    tensors, bit for bit, in one pass (a SwiGLU expert's ``h``).  The
    product is taken in int32, which every product of ``g``'s and ``u``'s
    formats must fit.  One call of the custom op ``qublas::mul_requant``:
    CPU tensors take the plain version; CUDA tensors launch G1
    (``gated.launches``), and raise ValueError where G1 cannot take them
    (a first step that rounds or wraps, lanes other than int8, a number
    of elements not a multiple of 16)."""
    if g.shape != u.shape or not (fmt_interval(g.fmt)
                                  * fmt_interval(u.fmt)).fits32:
        raise ValueError(f"{g.fmt} {tuple(g.shape)} x {u.fmt} "
                         f"{tuple(u.shape)}: not one int32 product each")
    params = (_build.rq_args(g.fmt.frac_bits + u.fmt.frac_bits, mid_fmt)
              + _build.rq_args(mid_fmt.frac_bits, out_fmt))
    return QTensor(torch.ops.qublas.mul_requant(
        g.data, u.data, list(params), storage_dtype(mid_fmt).itemsize,
        storage_dtype(out_fmt).itemsize), out_fmt)


gated.launches = 0


def rms_norm(x: QTensor, rom: QTable, entries: torch.Tensor, gain: int,
             f: dict) -> QTensor:
    """RMSNorm of the rows of ``x`` (int8 raws) through the rsqrt ROM
    ``rom`` (``entries``: its table as int32 on ``x``'s device), bit for
    bit ``qmul(x, s, to=f["normed"])`` with each row's factor ``s =
    qmul(rom(qcast(ss, f["sumsq_rom"])), gain, to=f["norm_scale"])``,
    ``ss`` the row's sum of squares in ``f["sumsq"]`` (lossless) and
    ``gain`` a raw of ``f["norm_gain"]``.  The sum, both products and the
    formats are proved here to fit int32.  One call of the custom op
    ``qublas::rms_norm``: CPU tensors take the plain version; CUDA tensors
    launch N1 (``rms_norm.launches``), one pass a row, and raise
    ValueError where N1 cannot take them (a lane other than int8, rows
    not a multiple of 16 wide)."""
    n = x.shape[-1]
    sq = f["sumsq"]
    biggest = n * max(x.fmt.raw_min ** 2, x.fmt.raw_max ** 2)
    gains = fmt_interval(f["norm_gain"])
    if (x.data.dtype != torch.int8 or sq.frac_bits != 2 * x.fmt.frac_bits
            or biggest > min(sq.raw_max, 2 ** 31 - 1)
            or (rom.in_fmt, rom.out_fmt) != (f["sumsq_rom"], f["rsqrt"])
            or not (fmt_interval(f["rsqrt"]) * gains).fits32
            or not (fmt_interval(x.fmt)
                    * fmt_interval(f["norm_scale"])).fits32
            or storage_dtype(f["normed"]) != torch.int8):
        raise ValueError(f"RMSNorm of {x.fmt} rows of {n}: outgrows "
                         f"{sq}, int32 or the ROM {rom.in_fmt} -> "
                         f"{rom.out_fmt}")
    params = (_build.rq_args(sq.frac_bits, f["sumsq_rom"])
              + _build.rq_args(f["rsqrt"].frac_bits
                               + f["norm_gain"].frac_bits, f["norm_scale"])
              + _build.rq_args(x.fmt.frac_bits + f["norm_scale"].frac_bits,
                               f["normed"]))
    return QTensor(torch.ops.qublas.rms_norm(x.data, entries, int(gain),
                                             list(params)), f["normed"])


rms_norm.launches = 0


class QuantRMSNorm(nn.Module):
    """RMSNorm on raw tensors (``DeepseekV3RMSNorm`` before a layer's
    router and experts): ``forward`` takes ``Qu<3,4>`` raws [rows,
    hidden] and returns them scaled to an RMS of about ``rms``, in
    ``Qu<3,4,RND::CONV>`` (:func:`rms_norm`, under the span
    ``qublas.moe.norm``).  The norm's weight is one scalar, folded with
    the mean into the gain ``rms * sqrt(hidden)``; its ``eps`` lies below
    the ROM's resolution, and a zero row stays zero (the ROM gives 0 for
    a zero sum)."""

    def __init__(self, hidden: int, rms: float, device=None):
        super().__init__()
        self.f = moe_formats()
        self.rom = _rsqrt_table()
        self.register_buffer("rsqrt_rom", self.rom.table.to(
            device=device, dtype=torch.int32), persistent=False)
        self.gain = int(from_float(rms * math.sqrt(hidden),
                                   self.f["norm_gain"], "cpu").data)

    def forward(self, x_raw: torch.Tensor) -> torch.Tensor:
        with span("qublas.moe.norm"):
            return rms_norm(QTensor(x_raw, self.f["operand"]), self.rom,
                            self.rsqrt_rom, self.gain, self.f).data


def _fetch(t: torch.Tensor):
    """A function that returns ``t``'s values as a list.  On the card
    ``t`` is copied into pinned host memory behind the work enqueued so
    far, and the function waits for that copy alone, so that work
    enqueued after this call keeps the card busy meanwhile."""
    if t.device.type != "cuda":
        return t.tolist
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    copied = torch.cuda.Event()
    copied.record()

    def wait():
        copied.synchronize()
        return host.tolist()
    return wait


class QuantMoE(nn.Module):
    """One MoE layer on raw tensors: ``forward`` takes the raws of ``x``
    [rows, hidden] in ``Qu<3,4>`` and returns the output's raws in
    ``Qu<3,4,SAT::ZERO>`` (``acc=True``: the int32 accumulator's raws in
    ``Qu<14,8>``, before that requantize).

    Weights are int8 ``Qu<3,4>`` raws [K, N] as the GEMMs take them (a
    stack [experts, K, N] for the held experts), stored K-major as
    :class:`~.pipeline.QuantPipeline` stores its own (:func:`kmajor`: no
    copy of a view that is K-major already): ``router`` [hidden,
    experts], ``gate`` and ``up`` [count, hidden, width], ``down`` [count,
    width, hidden], ``shared_gate``, ``shared_up`` [hidden, shared width]
    and ``shared_down`` [shared width, hidden].  ``bias`` [experts]: the
    selection's bias, ``Qu<1,14>`` raws.  ``held = (first, count)``: the
    indices of the experts held here.  A CPU layer runs the kernels'
    plain versions.

    Counters, kept over the layer's calls: ``pairs`` (row, expert) pairs
    routed to the held experts, ``empty`` held experts that a call left
    without rows, ``largest`` the most rows any held expert took in one
    call, ``syncs`` host syncs (one a call).
    """

    def __init__(self, router, bias, gate, up, down, shared_gate, shared_up,
                 shared_down, held, n_group: int = 8, topk_group: int = 4,
                 top_k: int = 8, scale: float = 2.5):
        super().__init__()
        self.f = moe_formats()
        experts = router.shape[1]
        self.first, self.count = (int(v) for v in held)
        if (experts % n_group or not 0 < topk_group <= n_group
                or topk_group * (experts // n_group) < top_k
                or experts // n_group < 2 or self.first < 0
                or self.first + self.count > experts
                or gate.shape[0] != self.count):
            raise ValueError(f"{experts} experts in {n_group} groups, "
                             f"top-{top_k} of {topk_group} groups, held "
                             f"{held} with {gate.shape[0]} stacked")
        self.n_group, self.topk_group, self.top_k = n_group, topk_group, top_k
        for name, w in (("router", router), ("gate", gate), ("up", up),
                        ("down", down), ("shared_gate", shared_gate),
                        ("shared_up", shared_up),
                        ("shared_down", shared_down)):
            self.register_buffer(name, kmajor(w))
        self.register_buffer("bias", bias)
        self.register_buffer("scale", from_float(
            scale, self.f["scale"], router.device).data)
        self.sigmoid, self.recip, self.silu = _tables()
        # the tables' entries placed with the weights, not in the state
        # dict; the SiLU ROM's are what K1's epilogue takes
        for name, t in (("sigmoid_rom", self.sigmoid),
                        ("recip_rom", self.recip), ("silu_rom", self.silu)):
            self.register_buffer(name, t.table.to(router.device),
                                 persistent=False)
        self.pairs = self.empty = self.largest = self.syncs = 0

    def _swiglu(self, x: QTensor, offsets=None) -> QTensor:
        """The held experts on the groups of rows ``offsets`` of ``x``
        (:func:`qgemul_grouped`), or the shared expert on every row."""
        f = self.f
        gemm_args = dict(mul_to=f["accumulate"],
                         add_formats=(f["accumulate"],))
        op = f["operand"]
        if offsets is None:
            w = (self.shared_gate, self.shared_up, self.shared_down)

            def gemm(a, b, out, **kw):
                return qgemul(a, QTensor(b, op), out, **gemm_args, **kw)
        else:
            w = (self.gate, self.up, self.down)

            def gemm(a, b, out, **kw):
                return qgemul_grouped(a, offsets, QTensor(b, op), out,
                                      **gemm_args, **kw)
        g = gemm(x, w[0], f["gate"], epilogue_lut=self.silu,
                 lut_table=self.silu_rom)
        u = gemm(x, w[1], op)
        h = gated(g, u, f["gu"], op)
        return gemm(h, w[2], f["down"])

    def forward(self, x_raw: torch.Tensor, acc: bool = False
                ) -> torch.Tensor:
        f = self.f
        x = QTensor(x_raw, f["operand"])
        with span("qublas.moe.route"):
            logits = qgemul(x, QTensor(self.router, f["operand"]),
                            f["logit"], mul_to=f["accumulate"],
                            add_formats=(f["accumulate"],))
            s = self.sigmoid(logits, self.sigmoid_rom)
            c = qadd(s, QTensor(self.bias, f["bias"]), to=f["choice"])
            idx = select_experts(c.data, self.n_group, self.topk_group,
                                 self.top_k)
            sel = QTensor(s.data.gather(1, idx), f["score"])
            total = QTensor(sel.data.sum(-1, keepdim=True,
                                         dtype=torch.int32), f["total"])
            r = self.recip(qcast(total, f["total_rom"]), self.recip_rom)
            w = qmul(qmul(sel, r, to=f["norm"]),
                     QTensor(self.scale, f["scale"]), to=f["weight"])
        with span("qublas.moe.dispatch"):
            local = idx.flatten() - self.first
            key = torch.where((local >= 0) & (local < self.count), local,
                              self.count)
            key, order = torch.sort(key, stable=True)
            # where each held expert's pairs start in the sorted order
            # (bincount would read its input's maximum on the host)
            starts = _fetch(torch.searchsorted(key, torch.arange(
                self.count + 1, device=key.device)))
        with span("qublas.moe.experts"):
            # needs no counts: the card runs it while the host waits
            shared = self._swiglu(x)
        with span("qublas.moe.dispatch"):
            offsets = starts()
            self.syncs += 1
            sizes = [e - s for s, e in zip(offsets, offsets[1:])]
            pairs = order[:offsets[-1]]
            xs = QTensor(x_raw.index_select(0, pairs // self.top_k),
                         f["operand"])
            self.pairs += offsets[-1]
            self.empty += sizes.count(0)
            self.largest = max([self.largest] + sizes)
        with span("qublas.moe.experts"):
            d = self._swiglu(xs, offsets)
        with span("qublas.moe.combine"):
            pos = torch.full((idx.numel(),), -1, dtype=torch.int32,
                             device=idx.device)
            pos[pairs] = torch.arange(offsets[-1], dtype=torch.int32,
                                      device=idx.device)
            return combine(shared, d, pos.view(idx.shape), w, f["pair"],
                           f["acc"], None if acc else f["out"])
