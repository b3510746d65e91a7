"""Complex quantized GEMM on torch (TFComplexMul / BasicComplexMul per
product).

Port of ``qublas_tpu/ops/cgemm.py``.  The semantics
compose what the reference defines (it has no GEMM of its own, SURVEY.md
§2.14):

* each scalar product A[i,p] * B[p,j] is a complex multiply, Basic
  4-mul/2-add (QuBLAS.h:3376-3446) or TF 3-mul/5-add (:3448-3535), with the
  same per-step tags and tag-default quirks;
* each dot product accumulates through the vector-path tree per part, with
  per-layer formats that are a QFormat (both parts) or a (real, imag) pair;
* the result requantizes into C's per-part formats.

Dispatch, per configuration and before any data is touched:

1. **Fast path.**  When every per-product step and both trees are provably
   lossless (``_fast_plan``, the JAX package's ``_Step`` proof), the GEMM is
   integer dots and exact shift/add: four dots for Basic, and for TF four
   elementary dots on int8 operands (``_tf_int8_distributed``) or three on
   the operand sums otherwise.  Each dot is
   :func:`~qublas_tpu_torch.ops.fused_gemm.int_dot` (kernel K1 with an
   identity epilogue on the card); the combine and the two final
   requantizes are plain torch ops, as they are XLA ops in the JAX package.
   Batched operands with equal leading dims run the same plan per batch
   element.  Where the proof holds but an operand, a dot or an epilogue
   outgrows int32 lanes, the dots run in the **limb domain**, as in the JAX
   package: each a balanced-digit dot on K1
   (:func:`~qublas_tpu_torch.ops.limbdot.limb_dot_2d`, one launch a
   k-segment), the combine exact limb arithmetic, one limb requantize a
   part into any device storage.
2. **Layered path.**  ``cmul``/``cmul_tf`` over the [.., m, k, 1] x
   [.., 1, k, n] broadcast, :func:`~qublas_tpu_torch.ops.reduce.qreduce` per
   part (kernel K3 on the card), then ``qcast``.  Parts in host storage
   (and host-storage outputs) take this path, on the host routes of the
   elementwise ops and ``qreduce``, as in the JAX package.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .. import hostops
from ..qformat import QFormat, add_merge, mul_merge
from ..qtensor import QTensor
from . import elementwise as ew
from . import limbdot as D
from . import limbint as L
from .fused_gemm import int_dot, kmajor
from .gemm import (_LIMBDOT_MAX_DOT_ELEMS, _LIMBDOT_MAX_MATMULS,
                   _lossless_requant, _per_batch, _swap, dot_partial_interval,
                   tree_exact)
from .reduce import qreduce, reduce_format
from .wideint import requantize_i32
from .widths import (LIMB_INTER_MAX_BITS, Interval, fmt_interval,
                     requant_work_bits, route_requant, storage_kind,
                     torch_dtype_for)

__all__ = ["cgemul", "cgemv", "force_fast_off", "cgemul_on_device"]

_FAST_OFF = False


@contextmanager
def force_fast_off():
    """Context manager disabling the fast path, so that a check or a timing
    can run the layered path on a config the proof admits."""
    global _FAST_OFF
    saved = _FAST_OFF
    _FAST_OFF = True
    try:
        yield
    finally:
        _FAST_OFF = saved


# ---------------------------------------------------------------------------
# The lossless proof (copy of qublas_tpu/ops/cgemm.py:61-89)
# ---------------------------------------------------------------------------

class _Step:
    """Lossless symbolic value: interval + format."""

    def __init__(self, iv: Interval, fmt: QFormat):
        self.iv = iv
        self.fmt = fmt


def _s_mul(x: _Step, y: _Step, to) -> Optional[_Step]:
    out = mul_merge(x.fmt, y.fmt, to)
    iv = _lossless_requant(x.iv * y.iv, x.fmt.frac_bits + y.fmt.frac_bits,
                           out)
    return None if iv is None else _Step(iv, out)


def _s_addsub(x: _Step, y: _Step, to, sub: bool) -> Optional[_Step]:
    out = add_merge(x.fmt, y.fmt, to)
    f = max(x.fmt.frac_bits, y.fmt.frac_bits)
    xv = x.iv << (f - x.fmt.frac_bits)
    yv = y.iv << (f - y.fmt.frac_bits)
    iv = _lossless_requant(xv - yv if sub else xv + yv, f, out)
    return None if iv is None else _Step(iv, out)


@dataclass(frozen=True)
class _FastPlan:
    """The fast path of one configuration on int32 lanes: which form of
    ``qublas_tpu/ops/cgemm.py:i32_path`` runs, and its static shifts."""

    form: str                # "basic", "tf4" (distributed) or "tf3"
    shifts: Tuple[int, ...]
    fin_r: QFormat           # the trees' final formats (their frac scales)
    fin_i: QFormat
    orf: QFormat             # the output formats
    oif: QFormat


@dataclass(frozen=True)
class _LimbPlan:
    """The fast path of one configuration in the limb domain
    (``qublas_tpu/ops/cgemm.py:limb_path``): each dot a balanced-digit dot
    on K1 (:func:`~qublas_tpu_torch.ops.limbdot.limb_dot_2d`) into ``Kw``
    limbs, then an exact limb shift/combine and one limb requantize a
    part."""

    algo: str
    Kw: int
    dspecs: Tuple[Tuple[Interval, Interval, int], ...]  # (iv_x, iv_y, shift)
    align: Tuple[int, ...]   # TF: the operand sums' alignment shifts
    fabc: Tuple[int, ...]    # TF: the fractional scales fA, fB, fC
    fin_r: QFormat
    fin_i: QFormat
    orf: QFormat
    oif: QFormat


def _tf_int8_distributed(fmts, k, fal1, fal2, w1, w2, w3, fin_r, fin_i,
                         fA, fB, fC):
    """The shifts of TF's three dots distributed over the FOUR elementary
    int8 dots (copy of the proof in qublas_tpu/ops/cgemm.py:92-154):

        dA = (ar*br)<<p1 + (ai*br)<<p2
        dB = (ai*br)<<p3 + (ai*bi)<<p4
        dC = (ai*bi)<<p5 - (ar*bi)<<p6

    exact under the fast path's proof.  Returns (p1..p6), or None when an
    int32 bound fails (the caller takes the three-dot form)."""
    far, fai, fbr, fbi = fmts
    p1 = fal1 - far.frac_bits + w1
    p2 = fal1 - fai.frac_bits + w1
    p3 = fal2 - fbr.frac_bits + w2
    p4 = fal2 - fbi.frac_bits + w2
    p5 = fal1 - fai.frac_bits + w3
    p6 = fal1 - far.frac_bits + w3
    Drr = dot_partial_interval(fmt_interval(far) * fmt_interval(fbr), k)
    Dir_ = dot_partial_interval(fmt_interval(fai) * fmt_interval(fbr), k)
    Dii = dot_partial_interval(fmt_interval(fai) * fmt_interval(fbi), k)
    Dri = dot_partial_interval(fmt_interval(far) * fmt_interval(fbi), k)
    terms = [Drr << p1, Dir_ << p2, Dir_ << p3, Dii << p4,
             Dii << p5, Dri << p6]
    ivA = terms[0] + terms[1]
    ivB = terms[2] + terms[3]
    ivC = terms[4] - terms[5]
    post = [ivA << (fin_r.frac_bits - fA),
            ivB << (fin_r.frac_bits - fB),
            ivB << (fin_i.frac_bits - fB),
            ivC << (fin_i.frac_bits - fC)]
    if not all(iv.fits32 for iv in terms + [ivA, ivB, ivC] + post):
        return None
    return p1, p2, p3, p4, p5, p6


def _fast_plan(a, b, orf, oif, algo, r_layers, i_layers, mul_tags, k,
               mn: Tuple[int, int]):
    """Prove the configuration lossless (``qublas_tpu/ops/cgemm.py:
    _fast_cgemul``) and return its plan: a :class:`_FastPlan` where
    ``i32_path``'s width gates hold (lane operands, int32 dots and
    epilogues), else a :class:`_LimbPlan` where ``limb_path``'s envelope
    holds (``mn``: the output's rows and columns); None when the proof
    fails or neither domain admits the configuration, so the layered path
    computes it."""
    far, fai = a.real.fmt, a.imag.fmt
    fbr, fbi = b.real.fmt, b.imag.fmt
    ar = _Step(fmt_interval(far), far)
    ai = _Step(fmt_interval(fai), fai)
    br = _Step(fmt_interval(fbr), fbr)
    bi = _Step(fmt_interval(fbi), fbi)

    if algo == "tf":
        t = {n: mul_tags.get(n) for n in
             ("ab", "cd", "ba", "abc", "cdb", "bad", "AB", "BC")}
        fb = hostops.single_tag_default(*t.values())
        g = {n: (v if v is not None else fb) for n, v in t.items()}
        g["ba"] = t["ba"]  # baT never inherits the fallback
        s_ab = _s_addsub(ar, ai, g["ab"], sub=False)
        s_cd = _s_addsub(br, bi, g["cd"], sub=False)
        s_ba = _s_addsub(ai, ar, g["ba"], sub=True)
        if None in (s_ab, s_cd, s_ba):
            return None
        A = _s_mul(s_ab, br, g["abc"])
        B = _s_mul(s_cd, ai, g["bad"])
        C = _s_mul(s_ba, bi, g["cdb"])
        if None in (A, B, C):
            return None
        re_p = _s_addsub(A, B, g["AB"], sub=True)
        im_p = _s_addsub(B, C, g["BC"], sub=True)
    else:
        # the TF steps' names, unused here: bound so that the plans'
        # closures read no empty cell (Dynamo refuses to)
        s_ab = s_cd = s_ba = None
        t = {n: mul_tags.get(n) for n in
             ("ac", "bd", "ad", "bc", "acbd", "adbc")}
        fb = hostops.single_tag_default(*t.values())
        g = {n: (v if v is not None else fb) for n, v in t.items()}
        ac = _s_mul(ar, br, g["ac"])
        bd = _s_mul(ai, bi, g["bd"])
        ad = _s_mul(ar, bi, g["ad"])
        bc = _s_mul(ai, br, g["bc"])
        if None in (ac, bd, ad, bc):
            return None
        re_p = _s_addsub(ac, bd, g["acbd"], sub=True)
        im_p = _s_addsub(ad, bc, g["adbc"], sub=False)
    if re_p is None or im_p is None:
        return None

    fin_r = tree_exact(re_p.iv, re_p.fmt, r_layers, k)
    fin_i = tree_exact(im_p.iv, im_p.fmt, i_layers, k)
    if fin_r is None or fin_i is None:
        return None
    orf = orf or fin_r
    oif = oif or fin_i
    if storage_kind(orf) is None or storage_kind(oif) is None:
        return None                       # host-storage outputs
    re_tot = dot_partial_interval(re_p.iv, k)
    im_tot = dot_partial_interval(im_p.iv, k)
    # final values at tree frac: lossless layers only shift left
    re_tot = re_tot << (fin_r.frac_bits - re_p.fmt.frac_bits)
    im_tot = im_tot << (fin_i.frac_bits - im_p.fmt.frac_bits)
    fr, fi = fin_r.frac_bits, fin_i.frac_bits
    fal1 = fal2 = w1 = w2 = w3 = fA = fB = fC = align = None
    if algo == "tf":
        fal1 = max(far.frac_bits, fai.frac_bits)
        w1 = s_ab.fmt.frac_bits - fal1
        fal2 = max(fbr.frac_bits, fbi.frac_bits)
        w2 = s_cd.fmt.frac_bits - fal2
        w3 = s_ba.fmt.frac_bits - fal1
        fA = s_ab.fmt.frac_bits + fbr.frac_bits
        fB = s_cd.fmt.frac_bits + fai.frac_bits
        fC = s_ba.fmt.frac_bits + fbi.frac_bits
        align = (fal1 - far.frac_bits + w1, fal1 - fai.frac_bits + w1,
                 fal2 - fbr.frac_bits + w2, fal2 - fbi.frac_bits + w2,
                 fal1 - fai.frac_bits + w3, fal1 - far.frac_bits + w3)

    def i32_plan():
        """``i32_path``'s width gates (qublas_tpu/ops/cgemm.py:247-303);
        None when one fails, so the limb domain is tried."""
        if any(t.is_pair or t.is_limb
               for t in (a.real, a.imag, b.real, b.imag)):
            return None
        if torch_dtype_for(orf) is None or torch_dtype_for(oif) is None:
            return None
        if not (re_tot.fits32 and im_tot.fits32):
            return None
        if route_requant(re_tot, fr, orf) != "i32" or \
                route_requant(im_tot, fi, oif) != "i32":
            return None

        def gate(iv_x, iv_y, post_shift):
            # every shifted dot term must itself fit int32, not just the
            # combined difference
            iv = dot_partial_interval(iv_x * iv_y, k)
            return iv.fits32 and (iv << post_shift).fits32

        if algo == "tf":
            # precomputed elementwise operands must fit int32 lanes
            if not (s_ab.iv.fits32 and s_cd.iv.fits32 and s_ba.iv.fits32):
                return None
            # the combine shifts dB by fin_r-fB AND fin_i-fB (and dA, dC by
            # fin_r-fA, fin_i-fC): every static shift must be non-negative
            if min(fr - fA, fr - fB, fi - fB, fi - fC) < 0:
                return None
            p = _tf_int8_distributed((far, fai, fbr, fbi), k, fal1, fal2, w1,
                                     w2, w3, fin_r, fin_i, fA, fB, fC) \
                if _int8_parts(a, b) else None
            if p is not None:
                return _FastPlan("tf4", p + (fA, fB, fC), fin_r, fin_i, orf,
                                 oif)
            if not (gate(s_ab.iv, fmt_interval(fbr), fr - fA)
                    and gate(fmt_interval(fai), s_cd.iv, max(fr, fi) - fB)
                    and gate(s_ba.iv, fmt_interval(fbi), fi - fC)):
                return None
            return _FastPlan("tf3", align + (fA, fB, fC), fin_r, fin_i, orf,
                             oif)
        shifts = (fr - far.frac_bits - fbr.frac_bits,
                  fr - fai.frac_bits - fbi.frac_bits,
                  fi - far.frac_bits - fbi.frac_bits,
                  fi - fai.frac_bits - fbr.frac_bits)
        if not (gate(fmt_interval(far), fmt_interval(fbr), shifts[0])
                and gate(fmt_interval(fai), fmt_interval(fbi), shifts[1])
                and gate(fmt_interval(far), fmt_interval(fbi), shifts[2])
                and gate(fmt_interval(fai), fmt_interval(fbr), shifts[3])):
            return None
        return _FastPlan("basic", shifts, fin_r, fin_i, orf, oif)

    def limb_plan():
        """``limb_path``'s envelope (qublas_tpu/ops/cgemm.py:361-446)."""
        if route_requant(re_tot, fr, orf) == "host" or \
                route_requant(im_tot, fi, oif) == "host":
            return None
        iv_ar, iv_ai = fmt_interval(far), fmt_interval(fai)
        iv_br, iv_bi = fmt_interval(fbr), fmt_interval(fbi)
        if algo == "tf":
            dspecs = ((s_ab.iv, iv_br, fr - fA),
                      (iv_ai, s_cd.iv, max(fr, fi) - fB),
                      (s_ba.iv, iv_bi, fi - fC))
            shifts, fabc = align, (fA, fB, fC)
            extra_bits = [s_ab.iv.bits, s_cd.iv.bits, s_ba.iv.bits]
        else:
            dspecs = ((iv_ar, iv_br, fr - far.frac_bits - fbr.frac_bits),
                      (iv_ai, iv_bi, fr - fai.frac_bits - fbi.frac_bits),
                      (iv_ar, iv_bi, fi - far.frac_bits - fbi.frac_bits),
                      (iv_ai, iv_br, fi - fai.frac_bits - fbr.frac_bits))
            shifts, fabc, extra_bits = (), (), []
        if any(sh < 0 for _, _, sh in dspecs) or any(sh < 0 for sh in shifts):
            return None                   # shift invariant violated
        if algo == "tf" and (fr < fB or fi < fB):
            return None
        need = max(requant_work_bits(re_tot, fr, orf),
                   requant_work_bits(im_tot, fi, oif),
                   re_tot.bits, im_tot.bits, 1, *extra_bits)
        for ivx, ivy, sh in dspecs:
            if D.digit_matmuls(ivx, ivy) > _LIMBDOT_MAX_MATMULS:
                return None
            nd_x, nd_y = D.digits_needed(ivx), D.digits_needed(ivy)
            nseg = -(-k // D._seg_len(k, min(nd_x, nd_y)))
            if nd_x * nd_y * nseg * mn[0] * mn[1] > _LIMBDOT_MAX_DOT_ELEMS:
                return None
            need = max(need, D.work_bits(ivx, ivy, k),
                       (dot_partial_interval(ivx * ivy, k) << sh).bits)
        if need > LIMB_INTER_MAX_BITS:
            return None
        return _LimbPlan(algo, L.bits_to_limbs(need), dspecs, shifts, fabc,
                         fin_r, fin_i, orf, oif)

    fp = i32_plan()
    return fp if fp is not None else limb_plan()


def _limb_run(lp: _LimbPlan, a, b, reduce=None):
    """The raws of both output parts in the limb domain
    (``qublas_tpu/ops/cgemm.py:limb_path``): the dots on
    :func:`~qublas_tpu_torch.ops.limbdot.limb_dot_2d`, each passed through
    ``reduce`` when one is given (the K-sharding hook), the exact limb
    shift/combine and one limb requantize a part, into any device
    storage."""
    Kw, fr, fi = lp.Kw, lp.fin_r.frac_bits, lp.fin_i.frac_bits
    ar, ai, br, bi = a.real.data, a.imag.data, b.real.data, b.imag.data

    def dot(x, y, spec):
        d = D.limb_dot_2d(x, y, spec[0], spec[1], Kw)
        return d if reduce is None else reduce(d)

    if lp.algo == "tf":
        def tolimb(x, shift):
            return L.lshl(D.to_limbs_any(x, Kw), shift)

        al = lp.align
        fA, fB, fC = lp.fabc
        S1 = L.ladd(tolimb(ar, al[0]), tolimb(ai, al[1]))
        S2 = L.ladd(tolimb(br, al[2]), tolimb(bi, al[3]))
        S3 = L.lsub(tolimb(ai, al[4]), tolimb(ar, al[5]))
        dA = dot(L.LimbArray(S1), br, lp.dspecs[0])
        dB = dot(ai, L.LimbArray(S2), lp.dspecs[1])
        dC = dot(L.LimbArray(S3), bi, lp.dspecs[2])
        re = L.lsub(L.lshl(dA, fr - fA), L.lshl(dB, fr - fB))
        im = L.lsub(L.lshl(dB, fi - fB), L.lshl(dC, fi - fC))
    else:
        sp = lp.dspecs
        re = L.lsub(L.lshl(dot(ar, br, sp[0]), sp[0][2]),
                    L.lshl(dot(ai, bi, sp[1]), sp[1][2]))
        im = L.ladd(L.lshl(dot(ar, bi, sp[2]), sp[2][2]),
                    L.lshl(dot(ai, br, sp[3]), sp[3][2]))
    return (L.requantize_limb(re, fr, lp.orf),
            L.requantize_limb(im, fi, lp.oif))


def _fast_run(fp: _FastPlan, ar, ai, br, bi, reduce=None):
    """The raws of both output parts from the 2-D lane tensors of the four
    operand parts (``qublas_tpu/ops/cgemm.py:286-359``): the integer dots on
    :func:`int_dot`, each TF dot term (dA, dB, dC) or Basic dot passed
    through ``reduce`` when one is given (the K-sharding hook), the exact
    shift/add combine and the two requantizes."""
    red = (lambda d: d) if reduce is None else reduce
    fr, fi = fp.fin_r.frac_bits, fp.fin_i.frac_bits
    if fp.form != "tf3" and all(t.dtype == torch.int8
                                for t in (ar, ai, br, bi)):
        # every dot runs K1's tensor-core route, which reads B K-major: one
        # copy of each B part per call instead of one per dot (tf3's dots
        # take int32 sums, whose route reads B row-major)
        br, bi = kmajor(br), kmajor(bi)
    if fp.form == "tf4":
        p1, p2, p3, p4, p5, p6, fA, fB, fC = fp.shifts
        prr = int_dot(ar, br)
        pir = int_dot(ai, br)
        pii = int_dot(ai, bi)
        pri = int_dot(ar, bi)
        dA = (prr << p1) + (pir << p2)
        dB = (pir << p3) + (pii << p4)
        dC = (pii << p5) - (pri << p6)
    if fp.form == "tf3":
        def shifted(x, s):
            y = x.to(torch.int32)
            return y << s if s else y

        s1, s2, s3, s4, s5, s6, fA, fB, fC = fp.shifts
        # the lossless elementwise sums at their step formats
        S1 = shifted(ar, s1) + shifted(ai, s2)
        S2 = shifted(br, s3) + shifted(bi, s4)
        S3 = shifted(ai, s5) - shifted(ar, s6)
        dA = int_dot(S1, br)
        dB = int_dot(ai, S2)
        dC = int_dot(S3, bi)
    if fp.form == "basic":
        sac, sbd, sad, sbc = fp.shifts
        re = (red(int_dot(ar, br)) << sac) - (red(int_dot(ai, bi)) << sbd)
        im = (red(int_dot(ar, bi)) << sad) + (red(int_dot(ai, br)) << sbc)
    else:
        dA, dB, dC = red(dA), red(dB), red(dC)
        re = (dA << (fr - fA)) - (dB << (fr - fB))
        im = (dB << (fi - fB)) - (dC << (fi - fC))
    raw_r = requantize_i32(re, fr, fp.orf).to(torch_dtype_for(fp.orf))
    raw_i = requantize_i32(im, fi, fp.oif).to(torch_dtype_for(fp.oif))
    return raw_r, raw_i


def _int8_parts(a, b) -> bool:
    return all(not t.is_limb and t.data.dtype == torch.int8
               for t in (a.real, a.imag, b.real, b.imag))


def fast_plan(a, b, orf, oif, algo, r_layers, i_layers, mul_tags, k, mn):
    """The plan the fast path runs for operands of ``a``'s and ``b``'s
    formats, storage and dims at contraction length ``k`` and output
    ``mn``: a :class:`_FastPlan`, a :class:`_LimbPlan` (2-D operands
    only), or None where the layered path computes."""
    if a.ndim < 2 or a.ndim != b.ndim or a.shape[:-2] != b.shape[:-2] \
            or any(t.is_host for t in (a.real, a.imag, b.real, b.imag)):
        return None
    fp = _fast_plan(a, b, orf, oif, algo, r_layers, i_layers, mul_tags, k,
                    mn)
    if isinstance(fp, _LimbPlan) and a.ndim != 2:
        return None
    return fp


def cgemul_on_device(a, b, out_fmt, algo: str = "basic", add_formats=(),
                     **mul_tags) -> bool:
    """Whether :func:`cgemul` of one row of ``a`` and one column of ``b``
    (their formats, storage and batch dims, ``a``'s K) runs on device
    routes only: the dispatch of :func:`cgemul` on formats, nothing
    computed."""
    from ..complex import cmul_formats

    if any(t.is_host for t in (a.real, a.imag, b.real, b.imag)):
        return False
    orf, oif = _part_formats(out_fmt)
    r_layers, i_layers = _split_layers(add_formats)
    k = a.shape[-1]
    if not _FAST_OFF and fast_plan(a, b, orf, oif, algo, r_layers, i_layers,
                                   mul_tags, k, (1, 1)) is not None:
        return True
    prods = cmul_formats(a.real.fmt, a.imag.fmt, b.real.fmt, b.imag.fmt,
                         algo, **mul_tags)
    if prods is None:
        return False
    for pf, layers, of in zip(prods, (r_layers, i_layers), (orf, oif)):
        fin = reduce_format(pf, layers, k)
        if fin is None or (of not in (None, fin) and route_requant(
                fmt_interval(fin), fin.frac_bits, of) == "host"):
            return False
    return True


def _fast_cgemul(a, b, orf, oif, algo, r_layers, i_layers, mul_tags,
                 dot_reduce=None, k_total=None, limb_dot_reduce=None,
                 cap_mn=None, info=None):
    """The fast-path result, or None when the proof fails
    (``qublas_tpu/ops/cgemm.py:_fast_cgemul``).  ``info["domain"]`` is set
    to ``"i32"`` or ``"limb"`` where it computes, as the JAX package sets
    it.

    The K-sharding hooks, as in the JAX package: with operands that hold a
    slice of the contraction dim, ``dot_reduce`` (int32 dots) and
    ``limb_dot_reduce`` (limb dots) sum each partial dot over the slices
    before the combine, ``k_total`` is the whole contraction length the
    proof runs at, and ``cap_mn`` the output's rows and columns for the
    limb envelope (so a rank's block decides as the whole call does).  A
    caller with ``dot_reduce`` but no ``limb_dot_reduce`` gets None where
    the limb domain would compute.

    Operands with equal leading dims run one int32 plan per element of the
    flattened batch, as the JAX package vmaps its 2-D fast path; batched
    configurations of the limb domain take the layered path (the same
    bits, by the proof)."""
    from ..complex import QComplexTensor

    k = a.shape[-1] if k_total is None else k_total
    mn = (a.shape[-2], b.shape[-1]) if cap_mn is None else tuple(cap_mn)
    fp = fast_plan(a, b, orf, oif, algo, r_layers, i_layers, mul_tags, k, mn)
    if fp is None:
        return None
    if isinstance(fp, _LimbPlan):
        if dot_reduce is not None and limb_dot_reduce is None:
            return None
        if info is not None:
            info["domain"] = "limb"
        raw_r, raw_i = _limb_run(fp, a, b, limb_dot_reduce)
        return QComplexTensor(ew._finish(raw_r, fp.orf),
                              ew._finish(raw_i, fp.oif))
    if info is not None:
        info["domain"] = "i32"
    raw_r, raw_i = _per_batch(lambda *p: _fast_run(fp, *p, dot_reduce),
                              a.real.data, a.imag.data, b.real.data,
                              b.imag.data)
    return QComplexTensor(QTensor(raw_r, fp.orf), QTensor(raw_i, fp.oif))


def _part_formats(spec):
    if spec is None:
        return None, None
    if isinstance(spec, QFormat):
        return spec, spec
    real, imag = spec
    return real, imag


def _split_layers(add_formats):
    """Per-layer specs: each entry is a QFormat (both parts) or an inner
    ``(real_fmt, imag_fmt)`` pair.  A bare tuple of QFormats is a list of
    LAYERS (as qgemul's add_formats and the hostops.cgemul oracle); a single
    per-part layer is written ``((r, i),)``."""
    if isinstance(add_formats, QFormat):
        add_formats = (add_formats,)
    reals, imags = [], []
    for spec in add_formats:
        r, i = _part_formats(spec)
        reals.append(r)
        imags.append(i)
    return tuple(reals), tuple(imags)


def _ctranspose(c, flag: bool):
    if not flag:
        return c
    from ..complex import QComplexTensor

    return QComplexTensor(_swap(c.real), _swap(c.imag))


def _index(c, idx):
    """Both parts of ``c`` indexed by ``idx`` (host parts too)."""
    from ..complex import QComplexTensor

    return QComplexTensor(*(QTensor(t.data[idx], t.fmt, t.device)
                            for t in (c.real, c.imag)))


def cgemul(a, b, out_fmt, algo: str = "basic", add_formats=(),
           transpose_a: bool = False, transpose_b: bool = False,
           **mul_tags):
    """C = op(A) @ op(B) over complex fixed-point tensors on one device.

    ``out_fmt`` is a QFormat (both parts) or a (real_fmt, imag_fmt) pair.
    ``algo`` selects the per-product multiply: ``"basic"`` or ``"tf"``;
    ``mul_tags`` are its per-step formats (``ac``/``bd``/... or
    ``ab``/``cd``/``ba``/...; tag-default quirks included).
    """
    from ..complex import QComplexTensor, cmul, cmul_tf

    a = _ctranspose(a, transpose_a)
    b = _ctranspose(b, transpose_b)
    if a.shape[-1] != b.shape[-2]:
        raise ValueError(f"inner dims mismatch: {a.shape} @ {b.shape}")
    orf, oif = _part_formats(out_fmt)
    r_layers, i_layers = _split_layers(add_formats)

    if not _FAST_OFF:
        fast = _fast_cgemul(a, b, orf, oif, algo, r_layers, i_layers,
                            mul_tags)
        if fast is not None:
            return fast

    mulfn = cmul_tf if algo == "tf" else cmul
    prod = mulfn(_index(a, (..., slice(None), slice(None), None)),
                 _index(b, (..., None, slice(None), slice(None))), **mul_tags)
    real = qreduce(prod.real, r_layers, axis=-2)
    imag = qreduce(prod.imag, i_layers, axis=-2)
    return QComplexTensor(ew.qcast(real, orf or real.fmt),
                          ew.qcast(imag, oif or imag.fmt))


def cgemv(a, x, out_fmt, algo: str = "basic", add_formats=(),
          transpose_a: bool = False, **mul_tags):
    """y = op(A) @ x, complex matrix-vector."""
    y = cgemul(a, _index(x, (..., slice(None), None)), out_fmt, algo,
               add_formats, transpose_a=transpose_a, **mul_tags)
    return _index(y, (..., 0))
