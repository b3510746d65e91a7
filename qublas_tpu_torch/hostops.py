"""Exact golden model of every quantized op, on (raw int, QFormat) pairs.

These functions define the semantics that the torch and CUDA device paths
must reproduce bit-for-bit.  The port's own copy of ``qublas_tpu/hostops.py``,
pinned to it by ``tests/test_torch_copies.py``.  Each op follows the reference's 3-stage pipeline
**widen-exact → round → saturate** (reference ``include/QuBLAS.h:3142-3370``).

A value is a ``(raw, fmt)`` pair: ``raw`` is the two's-complement storage
integer (arbitrary precision), ``fmt`` a :class:`~qublas_tpu_torch.qformat.QFormat`.
Complex values are ``((raw_re, fmt_re), (raw_im, fmt_im))`` pairs.
"""

from __future__ import annotations

from .hostint import frac_convert, int_convert, requantize, trunc_div
from .qformat import QFormat, add_merge, mul_merge

__all__ = [
    "qmul", "qadd", "qsub", "qdiv", "qabs", "qneg", "qcmp", "qeq",
    "convert", "qreduce_list", "qreduce_args", "qgemul", "qgemv",
    "complex_mul_basic", "complex_mul_tf", "complex_add", "complex_sub",
]


def convert(v, fmt: QFormat):
    """Cross-format conversion = requantize with the *destination*'s modes
    (reference converting ctor, QuBLAS.h:2398-2411)."""
    raw, from_fmt = v
    if from_fmt == fmt:
        return (raw, fmt)
    return (requantize(raw, from_fmt.frac_bits, fmt), fmt)


def qmul(a, b, to=None, full_prec: bool = False):
    """Quantized multiply (reference Qmul_s::mul, QuBLAS.h:3146-3171)."""
    (ra, fa), (rb, fb) = a, b
    out = mul_merge(fa, fb, to, full_prec)
    full = ra * rb  # exact product at fa.frac + fb.frac fractional bits
    return (requantize(full, fa.frac_bits + fb.frac_bits, out), out)


def _align(a, b):
    (ra, fa), (rb, fb) = a, b
    f = max(fa.frac_bits, fb.frac_bits)
    return ra << (f - fa.frac_bits), rb << (f - fb.frac_bits), f


def qadd(a, b, to=None, full_prec: bool = False):
    """Quantized add (QuBLAS.h:3177-3204): align fracs exactly, add, requantize."""
    out = add_merge(a[1], b[1], to, full_prec)
    xa, xb, f = _align(a, b)
    return (requantize(xa + xb, f, out), out)


def qsub(a, b, to=None, full_prec: bool = False):
    """Quantized subtract (QuBLAS.h:3210-3235)."""
    out = add_merge(a[1], b[1], to, full_prec)
    xa, xb, f = _align(a, b)
    return (requantize(xa - xb, f, out), out)


def qdiv(a, b, to=None, full_prec: bool = False):
    """Quantized divide (QuBLAS.h:3241-3266).

    Semantic warts replicated from the reference: division by zero returns a
    zero-valued result (QuBLAS.h:3252-3255); the quotient is truncated toward
    zero by integer division with **no** frac_convert stage — only the
    overflow stage runs (QuBLAS.h:3257-3259).  Output format from AddMerger.
    """
    (ra, fa), (rb, fb) = a, b
    out = add_merge(fa, fb, to, full_prec)
    if rb == 0:
        return (0, out)
    shift_a = max(fb.frac_bits - fa.frac_bits, 0)
    shift_b = max(fa.frac_bits - fb.frac_bits, 0)
    # staticShiftLeft with a negative total delegates to an arithmetic right
    # shift (QuBLAS.h:1582-1587) — reachable when out.frac_bits < 0.
    s = shift_a + out.frac_bits
    num = (ra << s) if s >= 0 else (ra >> (-s))
    full = trunc_div(num, rb << shift_b)
    return (int_convert(full, out), out)


def qabs(a):
    """Absolute value (QuBLAS.h:3273-3300): unsigned passes through; signed
    widens int_bits by 1 and negates the raw value if negative (no requant)."""
    raw, fmt = a
    if not fmt.signed:
        return a
    out = QFormat(fmt.int_bits + 1, fmt.frac_bits, fmt.signed,
                  fmt.round_mode, fmt.overflow_mode)
    return (-raw if raw < 0 else raw, out)


def qneg(a):
    """Negation (QuBLAS.h:3307-3317): widens int_bits by 1, keeps signedness."""
    raw, fmt = a
    out = QFormat(fmt.int_bits + 1, fmt.frac_bits, fmt.signed,
                  fmt.round_mode, fmt.overflow_mode)
    return (-raw, out)


def qcmp(a, b) -> int:
    """Three-way compare after exact frac alignment (QuBLAS.h:3332-3345).
    Returns -1 / 0 / +1."""
    xa, xb, _ = _align(a, b)
    return (xa > xb) - (xa < xb)


def qeq(a, b) -> bool:
    """Equality after exact frac alignment (QuBLAS.h:3347-3359)."""
    xa, xb, _ = _align(a, b)
    return xa == xb


# --------------------------------------------------------------------------
# Tree reduction (reference Reducer, QuBLAS.h:4903-5018)
# --------------------------------------------------------------------------

def _layer_fmt(layer_formats, layer: int):
    """Per-layer output format: TypeAt<min(layer, len-1)> (QuBLAS.h:4913)."""
    if not layer_formats:
        return None
    return layer_formats[min(layer, len(layer_formats) - 1)]


def qreduce_list(values, layer_formats=()):
    """Vector-path tree reduction (QuBLAS.h:4960-4990).

    Per layer: pair (2i, 2i+1) with ``qadd`` quantized to the layer format;
    an odd tail element is *copied* into the next layer — which is a
    converting assignment (requantize) when the layer format differs from the
    element's format (QuBLAS.h:4977-4980).  N-D tensors reduce over their
    row-major flattening (QuBLAS.h:4992-5001).
    """
    if isinstance(layer_formats, QFormat):
        layer_formats = (layer_formats,)
    vals = list(values)
    if not vals:
        raise ValueError("qreduce of empty sequence")
    layer = 0
    while len(vals) > 1:
        fmt = _layer_fmt(layer_formats, layer)
        nxt = [qadd(vals[2 * i], vals[2 * i + 1], to=fmt)
               for i in range(len(vals) // 2)]
        if len(vals) % 2:
            tail = vals[-1]
            # converting assignment into the layer's result vector
            nxt.append(tail if fmt is None else convert(tail, fmt))
        vals = nxt
        layer += 1
    return vals[0]


def qreduce_args(values, layer_formats=()):
    """Variadic-path tree reduction (QuBLAS.h:4924-4957).

    Deviates from the vector path for odd counts: the leftover element is
    added to the *final* result of the even part, quantized with the current
    layer's format (QuBLAS.h:4943-4949).  Replicated exactly.
    """
    if isinstance(layer_formats, QFormat):
        layer_formats = (layer_formats,)

    def rec(vals, layer):
        if len(vals) == 1:
            return vals[0]
        fmt = _layer_fmt(layer_formats, layer)
        pairs = [qadd(vals[2 * i], vals[2 * i + 1], to=fmt)
                 for i in range(len(vals) // 2)]
        res = rec(pairs, layer + 1)
        if len(vals) % 2:
            res = qadd(res, vals[-1], to=fmt)
        return res

    vals = list(values)
    if not vals:
        raise ValueError("qreduce of empty sequence")
    return rec(vals, 0)


# --------------------------------------------------------------------------
# GEMM / GEMV golden model (readme-only API: readme.md:80-87; semantics
# reconstructed per SURVEY.md §2.14 — per-product quantization + Qreduce
# vector-path tree accumulation + converting assignment into C's format)
# --------------------------------------------------------------------------

def qgemul(a_rows, b_rows, out_fmt: QFormat, mul_to=None, add_formats=(),
           transpose_a: bool = False, transpose_b: bool = False,
           mul_full_prec: bool = False):
    """C = op(A) @ op(B) on nested lists of (raw, fmt) pairs.

    Each scalar product is quantized per ``mul_to`` (default: MulMerger
    inference), each dot product accumulates through the vector-path tree
    with per-layer ``add_formats``, and the result is requantized into
    ``out_fmt`` (the converting-assignment into C).
    """
    A = _maybe_transpose(a_rows, transpose_a)
    B = _maybe_transpose(b_rows, transpose_b)
    m, k = len(A), len(A[0])
    k2, n = len(B), len(B[0])
    assert k == k2, f"shape mismatch {k} vs {k2}"
    out = []
    for i in range(m):
        row = []
        for j in range(n):
            prods = [qmul(A[i][p], B[p][j], to=mul_to, full_prec=mul_full_prec)
                     for p in range(k)]
            acc = qreduce_list(prods, add_formats)
            row.append(convert(acc, out_fmt))
        out.append(row)
    return out


def qgemv(a_rows, x_vec, out_fmt: QFormat, mul_to=None, add_formats=(),
          transpose_a: bool = False, mul_full_prec: bool = False):
    """y = op(A) @ x — matrix-vector case of :func:`qgemul`."""
    col = [[v] for v in x_vec]
    res = qgemul(a_rows, col, out_fmt, mul_to, add_formats,
                 transpose_a=transpose_a, mul_full_prec=mul_full_prec)
    return [r[0] for r in res]


def _maybe_transpose(rows, t: bool):
    if not t:
        return rows
    return [list(col) for col in zip(*rows)]


# --------------------------------------------------------------------------
# Complex ops (QuBLAS.h:3374-3739)
# --------------------------------------------------------------------------

def complex_add(a, b, real_to=None, imag_to=None):
    """Complex add with optional per-part output formats (QuBLAS.h:3549-3562).
    realT/imagT use the same extraction pattern as the multiply algorithms,
    so :func:`single_tag_default` propagation applies: supplying exactly one
    part's format applies it to both parts."""
    fb = single_tag_default(real_to, imag_to)
    real_to = real_to if real_to is not None else fb
    imag_to = imag_to if imag_to is not None else fb
    (ar, ai), (br, bi) = a, b
    return (qadd(ar, br, to=real_to), qadd(ai, bi, to=imag_to))


def complex_sub(a, b, real_to=None, imag_to=None):
    """Complex sub (QuBLAS.h:3570-3584); same tag-default propagation as
    :func:`complex_add`."""
    fb = single_tag_default(real_to, imag_to)
    real_to = real_to if real_to is not None else fb
    imag_to = imag_to if imag_to is not None else fb
    (ar, ai), (br, bi) = a, b
    return (qsub(ar, br, to=real_to), qsub(ai, bi, to=imag_to))


def single_tag_default(*specs):
    """The reference's tag-default propagation quirk.

    Each per-step type is extracted as ``tagExtractor<Tag<toArgs...>,
    toArgs...>::type::list``: when ``Tag`` is absent from the pack, the
    default is ``Tag<toArgs...>`` — and tagExtractor's single-payload default
    specialization **strips the outer template** (QuBLAS.h:157-161,
    ``tagExtractor<Tag<T>> { using type = T; }`` wins partial ordering over
    the pack version when the pack has exactly one element).  Net effect:
    with exactly ONE tag supplied, every omitted step resolves to that tag's
    payload; with zero or ≥2 tags supplied, omitted steps resolve to default
    merger inference.  Verified against the compiled reference
    (tests/golden_data/cmul.json "tf_ba_quirk").
    """
    given = [s for s in specs if s is not None]
    return given[0] if len(given) == 1 else None


def cgemul(a_rows, b_rows, out_fmts, algo="basic", add_formats=(),
           **mul_tags):
    """Complex GEMM golden model: per-product complex multiply (basic/TF)
    + per-part vector-path tree accumulation + per-part converting
    assignment.  ``a_rows``/``b_rows`` are nested lists of complex pairs
    ``((re_raw, re_fmt), (im_raw, im_fmt))``; ``out_fmts`` a (real, imag)
    format pair (single QFormat = both).  See ops/cgemm.py for the design
    rationale (the reference defines the pieces, not the composition)."""
    from .qformat import QFormat as _QF

    if isinstance(out_fmts, _QF):
        out_fmts = (out_fmts, out_fmts)
    layers_r, layers_i = [], []
    for spec in ((add_formats,) if isinstance(add_formats, _QF)
                 else add_formats):
        if isinstance(spec, _QF):
            layers_r.append(spec)
            layers_i.append(spec)
        else:
            layers_r.append(spec[0])
            layers_i.append(spec[1])
    mulfn = complex_mul_tf if algo == "tf" else complex_mul_basic
    m, k = len(a_rows), len(a_rows[0])
    n = len(b_rows[0])
    out = []
    for i in range(m):
        row = []
        for j in range(n):
            prods = [mulfn(a_rows[i][p], b_rows[p][j], **mul_tags)
                     for p in range(k)]
            acc_r = qreduce_list([p[0] for p in prods], tuple(layers_r))
            acc_i = qreduce_list([p[1] for p in prods], tuple(layers_i))
            row.append((convert(acc_r, out_fmts[0]),
                        convert(acc_i, out_fmts[1])))
        out.append(row)
    return out


def complex_mul_basic(a, b, ac=None, bd=None, ad=None, bc=None,
                      acbd=None, adbc=None):
    """4-mul/2-add complex multiply: (ac-bd) + (ad+bc)i, each intermediate op
    independently quantized (reference BasicComplexMul, QuBLAS.h:3376-3446).
    This is the default for complex ``Qmul`` with no algorithm tag.
    Omitted step formats follow :func:`single_tag_default`."""
    fb = single_tag_default(ac, bd, ad, bc, acbd, adbc)
    ac, bd, ad, bc, acbd, adbc = (x if x is not None else fb
                                  for x in (ac, bd, ad, bc, acbd, adbc))
    (f1r, f1i), (f2r, f2i) = a, b
    real = qsub(qmul(f1r, f2r, to=ac), qmul(f1i, f2i, to=bd), to=acbd)
    imag = qadd(qmul(f1r, f2i, to=ad), qmul(f1i, f2r, to=bc), to=adbc)
    return (real, imag)


def complex_mul_tf(a, b, ab=None, cd=None, ba=None, abc=None, cdb=None,
                   bad=None, AB=None, BC=None):
    """3-mul/5-add Karatsuba-style complex multiply (reference TFComplexMul,
    QuBLAS.h:3448-3535):

        A = (a+b)c,  B = (c+d)b,  C = (b-a)d
        re = A - B,  im = B - C

    with eight optional per-step quantization formats.

    Parity quirks, verified against the compiled reference
    (tests/golden_data/cmul.json "tf_ba_quirk" + probe programs):

    * Omitted step tags follow :func:`single_tag_default` propagation.
    * ``baT`` is extracted without ``::list`` (QuBLAS.h:3515).  When
      *supplied* with a single format, tagExtractor's single-param match
      unwraps the payload, so ``ba`` applies to its own (b-a) step normally;
      when *absent*, the wrapped default survives un-expanded and the step
      always uses default AddMerger inference — it never inherits the
      single-tag fallback the ``::list`` steps get.
    """
    fb = single_tag_default(ab, cd, ba, abc, cdb, bad, AB, BC)
    ab, cd, abc, cdb, bad, AB, BC = (x if x is not None else fb
                                     for x in (ab, cd, abc, cdb, bad, AB, BC))
    (f1r, f1i), (f2r, f2i) = a, b
    A = qmul(qadd(f1r, f1i, to=ab), f2r, to=abc)
    B = qmul(qadd(f2r, f2i, to=cd), f1i, to=bad)
    C = qmul(qsub(f1i, f1r, to=ba), f2i, to=cdb)
    real = qsub(A, B, to=AB)
    imag = qsub(B, C, to=BC)
    return (real, imag)
