"""The host-route gates of the sharded strategies, held to the ops.

``ops.gemm.gemm_on_device``, ``ops.cgemm.cgemul_on_device``,
``ops.reduce.reduce_format`` and ``complex.cmul_formats`` decide from
formats and storage alone whether ``qgemul``, ``cgemul``, ``qreduce`` and
``cmul``/``cmul_tf`` take a host route; the sharded strategies refuse such
a configuration with ``ValueError`` as the JAX package's trace-time probe
does.  Each gate is held, on configurations drawn from a seed across lane,
pair, limb and host widths and every rounding and overflow mode, to the op
itself run on the CPU with its host routes replaced by a raise.  The GEMM
gate of the strategies is also held to the JAX package's traced probe
(``qublas_tpu.parallel.sharding._check_traceable``).
"""

import random

import numpy as np
import pytest

from qublas_tpu_torch import complex as CX
from qublas_tpu_torch.ops import cgemm as CG
from qublas_tpu_torch.ops import elementwise as ew
from qublas_tpu_torch.ops import gemm as G
from qublas_tpu_torch.ops import reduce as R
from qublas_tpu_torch.qformat import QFormat, RoundMode, OverflowMode
from qublas_tpu_torch.qtensor import from_raw


class HostRoute(Exception):
    """A host route was entered."""


@pytest.fixture
def no_host(monkeypatch):
    """Every host route of the ops raises :class:`HostRoute`."""
    def refuse(*args, **kwargs):
        raise HostRoute

    for mod, name in ((G, "_host_gemm"), (R, "_qreduce_host"),
                      (ew, "_host_binary"), (ew, "_host_unary"),
                      (ew, "_host_compare")):
        monkeypatch.setattr(mod, name, refuse)


# integer and fractional bits: lane (storage <= 32), pair (33..64) and limb
# (65..992) widths, the widest near the limb working envelope (1024 bits);
# HOST is beyond limb storage
INT_BITS = (1, 3, 7, 12, 20, 30, 44, 250, 480)
FRAC_BITS = (0, 2, 4, 8, 15, 28)
HOST = (500, 500)


def _fmt(r: random.Random, host_share: float = 0.0):
    """A format spec (int_bits, frac_bits, round, overflow)."""
    ib, fb = (HOST if r.random() < host_share
              else (r.choice(INT_BITS), r.choice(FRAC_BITS)))
    return (ib, fb, r.randrange(7), r.randrange(5))


def _port(spec):
    return None if spec is None else QFormat(
        spec[0], spec[1], True, RoundMode(spec[2]), OverflowMode(spec[3]))


def _raws(fmt, shape, r: random.Random):
    n = int(np.prod(shape))
    return np.array([r.randint(fmt.raw_min, fmt.raw_max) for _ in range(n)],
                    dtype=object).reshape(shape)


def _gemm_cases(n: int = 40, seed: int = 14):
    r = random.Random(seed)
    cases = []
    for i in range(n):
        fa, fb = _fmt(r), _fmt(r)
        mul_to = None if r.random() < 0.4 else _fmt(r, 0.1)
        add = tuple(_fmt(r, 0.05) for _ in range(r.choice((0, 0, 1, 2))))
        out = _fmt(r, 0.1)
        k = r.choice((1, 2, 3, 5, 8, 13))
        cases.append((f"g{i}", fa, fb, mul_to, add, out, k,
                      r.random() < 0.2))
    # lane operands into lane formats that the int32, hybrid and tree tiers
    # take, and a host-width output (the JAX package's own refusal case)
    cases += [("k1", (3, 4, 0, 0), (3, 4, 0, 0), (20, 8, 0, 0),
               ((20, 8, 0, 0),), (3, 4, 0, 1), 16, False),
              ("canonical", (8, 8, 5, 1), (8, 8, 5, 1), None, (),
               (8, 8, 5, 1), 9, False),
              ("host out", (3, 4, 0, 0), (3, 4, 0, 0), None, (),
               (600, 600, 0, 0), 4, False),
              # a narrow product format, but a product wider than the limb
              # working envelope: the multiply itself takes the host route
              ("wide product", (480, 480, 0, 0), (480, 480, 0, 0),
               (20, 8, 0, 0), (), (20, 8, 0, 0), 3, False)]
    return cases


GEMM_CASES = _gemm_cases()


def _gemm_operands(case):
    cid, fa, fb, mul_to, add, out, k, full = case
    r = random.Random(cid)
    pa, pb = _port(fa), _port(fb)
    a = from_raw(_raws(pa, (1, k), r), pa, "cpu")
    b = from_raw(_raws(pb, (k, 1), r), pb, "cpu")
    return a, b, _port(out), _port(mul_to), tuple(map(_port, add)), full


@pytest.mark.parametrize("case", GEMM_CASES, ids=[c[0] for c in GEMM_CASES])
def test_gemm_on_device_matches_qgemul(case, no_host):
    a, b, out, mul_to, add, full = _gemm_operands(case)
    want = G.gemm_on_device(a, b, out, mul_to, add, mul_full_prec=full)
    try:
        G.qgemul(a, b, out, mul_to, add, mul_full_prec=full)
        got = True
    except HostRoute:
        got = False
    assert got == want, case


@pytest.mark.parametrize("case", GEMM_CASES, ids=[c[0] for c in GEMM_CASES])
def test_gemm_gate_matches_jax_probe(case):
    """The strategies' gate refuses what the JAX package's traced 1-row x
    1-col probe refuses."""
    from qublas_tpu.parallel.sharding import _check_traceable as jax_check
    from qublas_tpu.qformat import QFormat as JQFormat
    from qublas_tpu.qformat import OverflowMode as JOverflow
    from qublas_tpu.qformat import RoundMode as JRound
    from qublas_tpu.qtensor import from_raw as jax_from_raw
    from qublas_tpu_torch.parallel.sharding import _traceable

    def jfmt(spec):
        return None if spec is None else JQFormat(
            spec[0], spec[1], True, JRound(spec[2]), JOverflow(spec[3]))

    a, b, out, mul_to, add, full = _gemm_operands(case)
    _, fa, fb, jmul, jadd, jout, _k, _ = case
    ja = jax_from_raw(a.raw(), jfmt(fa))
    jb = jax_from_raw(b.raw(), jfmt(fb))
    try:
        jax_check(ja, jb, jfmt(jout), jfmt(jmul), tuple(map(jfmt, jadd)),
                  dict(mul_full_prec=full), "test")
        jax_ok = True
    except ValueError:
        jax_ok = False
    assert _traceable(a, b, out, mul_to, add, full) == jax_ok, case


def _reduce_cases(n: int = 30, seed: int = 15):
    r = random.Random(seed)
    return [(f"r{i}", _fmt(r, 0.05),
             tuple(_fmt(r, 0.05) for _ in range(r.choice((0, 1, 2, 3)))),
             r.choice((1, 2, 3, 5, 7, 8, 12)))
            for i in range(n)]


REDUCE_CASES = _reduce_cases()


@pytest.mark.parametrize("case", REDUCE_CASES,
                         ids=[c[0] for c in REDUCE_CASES])
def test_reduce_format_matches_qreduce(case, no_host):
    """``reduce_format`` is None exactly where ``qreduce`` takes a host
    route, and otherwise the format of its result."""
    cid, spec, layers, n = case
    fmt, layers = _port(spec), tuple(map(_port, layers))
    x = from_raw(_raws(fmt, (n, 2), random.Random(cid)), fmt, "cpu")
    want = R.reduce_format(fmt, layers, n)
    try:
        got = R.qreduce(x, layers, axis=0).fmt
    except HostRoute:
        got = None
    assert got == want, case


_CTAGS = {"basic": ("ac", "bd", "ad", "bc", "acbd", "adbc"),
          "tf": ("ab", "cd", "ba", "abc", "cdb", "bad", "AB", "BC")}


def _complex_cases(n: int = 24, seed: int = 16):
    r = random.Random(seed)
    cases = []
    for i in range(n):
        algo = r.choice(("basic", "tf"))
        parts = [_fmt(r) for _ in range(4)]
        tags = {t: _fmt(r, 0.05) for t in _CTAGS[algo] if r.random() < 0.3}
        add = tuple(_fmt(r, 0.05) for _ in range(r.choice((0, 1, 2))))
        out = None if r.random() < 0.3 else (_fmt(r, 0.1), _fmt(r, 0.1))
        cases.append((f"c{i}", algo, parts, tags, add, out,
                      r.choice((1, 2, 3, 5, 8))))
    return cases


COMPLEX_CASES = _complex_cases()


def _complex_operands(case):
    cid, algo, parts, tags, add, out, k = case
    r = random.Random(cid)
    far, fai, fbr, fbi = map(_port, parts)
    a = CX.QComplexTensor(from_raw(_raws(far, (1, k), r), far, "cpu"),
                          from_raw(_raws(fai, (1, k), r), fai, "cpu"))
    b = CX.QComplexTensor(from_raw(_raws(fbr, (k, 1), r), fbr, "cpu"),
                          from_raw(_raws(fbi, (k, 1), r), fbi, "cpu"))
    out = None if out is None else tuple(map(_port, out))
    return (a, b, out, tuple(map(_port, add)),
            {t: _port(v) for t, v in tags.items()})


@pytest.mark.parametrize("case", COMPLEX_CASES,
                         ids=[c[0] for c in COMPLEX_CASES])
def test_cgemul_on_device_matches_cgemul(case, no_host):
    algo = case[1]
    a, b, out, add, tags = _complex_operands(case)
    want = CG.cgemul_on_device(a, b, out, algo, add, **tags)
    try:
        CG.cgemul(a, b, out, algo=algo, add_formats=add, **tags)
        got = True
    except HostRoute:
        got = False
    assert got == want, case


@pytest.mark.parametrize("case", COMPLEX_CASES,
                         ids=[c[0] for c in COMPLEX_CASES])
def test_cmul_formats_match_cmul(case, no_host):
    """``cmul_formats`` runs ``cmul``'s (or ``cmul_tf``'s) steps on
    formats: None where a step takes a host route, else the part formats
    of the product."""
    algo = case[1]
    a, b, _, _, tags = _complex_operands(case)
    want = CX.cmul_formats(a.real.fmt, a.imag.fmt, b.real.fmt, b.imag.fmt,
                           algo, **tags)
    mul = CX.cmul_tf if algo == "tf" else CX.cmul
    try:
        p = mul(a, b, **tags)
        got = (p.real.fmt, p.imag.fmt)
    except HostRoute:
        got = None
    assert got == want, case


# ---------------------------------------------------------------------------
# plan_qgemul: the one choice of tier that qgemul and its readers share
# ---------------------------------------------------------------------------

# the entry point that runs each tier of a 2-D CPU call
TIER_ENTRY = {"host": "_host_gemm", "k1": "fused_int8_gemm",
              "limb": "_fast_gemm_limb", "wide": "_fast_gemm_wide",
              "hybrid": "tree_gemm_hybrid", "tree": "tree_gemm",
              "stream": "_stream_gemm_wide", "layered": "_layered_gemm"}


@pytest.mark.parametrize("case", GEMM_CASES, ids=[c[0] for c in GEMM_CASES])
def test_plan_names_the_tier_qgemul_runs(case, monkeypatch):
    """For each configuration, the tier of plan_qgemul is the one whose
    entry point qgemul enters first."""
    a, b, out, mul_to, add, full = _gemm_operands(case)
    entered = []
    for name in set(TIER_ENTRY.values()):
        def spy(*args, _fn=getattr(G, name), _name=name, **kw):
            entered.append(_name)
            return _fn(*args, **kw)
        monkeypatch.setattr(G, name, spy)
    plan = G._plan_of(a, b, out, mul_to, add, full)
    G.qgemul(a, b, out, mul_to, add, mul_full_prec=full)
    assert entered[:1] == [TIER_ENTRY[plan.tier]], (case, plan.tier, entered)


# the limb tier's configuration of test_torch_gemm's broadcast cases:
# 15-bit products summed 5 at a time, beyond int32 and inside int64
LIMB_CALL = (QFormat(15, 0), QFormat(40, 0), (QFormat(40, 0),), 5)


def _limb_plan(m, n, batch):
    f, wide, adds, k = LIMB_CALL
    return G.plan_qgemul(f, f, "lane", "lane", f, wide, adds, False, m, k, n,
                         batch)


def test_plan_takes_the_limb_envelope_at_the_folded_rows():
    """A batch against a shared b folds while the limb tier's digit
    dots hold the folded rows, runs a call a matrix past that, and goes on
    to the int64 tier past one matrix's envelope."""
    from qublas_tpu_torch.ops import limbdot as D

    f, _, _, k = LIMB_CALL
    iv = G.fmt_interval(f)
    digits = D.digits_needed(iv)
    n = 64
    row = digits * digits * -(-k // D._seg_len(k, digits)) * n
    most = G._LIMBDOT_MAX_DOT_ELEMS // row     # rows of one call's envelope
    folded = _limb_plan(most // 2, n, (2,))
    assert (folded.tier, folded.fold) == ("limb", True)
    per_matrix = _limb_plan(most // 2 + 1, n, (2,))
    assert (per_matrix.tier, per_matrix.fold) == ("limb", False)
    assert per_matrix.limbs == folded.limbs
    assert _limb_plan(most, n, ()).tier == "limb"
    past = _limb_plan(most + 1, n, (2,))
    assert past.tier == "wide" and past.exact == folded.exact


def test_k1_call_proves_no_later_tier(monkeypatch):
    """A call that K1 takes runs exact_plan only: no envelope of the
    limb tier, no hybrid or tree planner."""
    case = next(c for c in GEMM_CASES if c[0] == "k1")
    a, b, out, mul_to, add, full = _gemm_operands(case)

    def refuse(*args, **kwargs):
        raise AssertionError("a later tier's proof ran")

    for name in ("plan_hybrid", "plan_tree", "limb_dot_plan",
                 "_wide_epilogue_ok"):
        monkeypatch.setattr(G, name, refuse)
    assert G._plan_of(a, b, out, mul_to, add, full).tier == "k1"
    G.qgemul(a, b, out, mul_to, add, mul_full_prec=full)


def _fmt_fields(f):
    return (f.int_bits, f.frac_bits, f.signed, int(f.round_mode),
            int(f.overflow_mode))


def _crc(*vals):
    import zlib
    return zlib.crc32(repr(vals).encode())


def _k1_draw(t):
    from qublas_tpu_torch import fuzz as F

    c = F.k1_case(t)
    lut = c["lut"]
    return _crc(c["kind"], _fmt_fields(c["fa"]), _fmt_fields(c["fb"]),
                _fmt_fields(c["mul_to"]), tuple(map(_fmt_fields, c["layers"])),
                _fmt_fields(c["out"]), c["plan"].prod_frac,
                c["plan"].dot_interval.lo, c["plan"].dot_interval.hi,
                c["A"].tolist(), c["B"].tolist(),
                None if lut is None else (lut[0], _fmt_fields(lut[1])),
                c["views"], c["batch"], c["trans"])


def _limb_draw(t):
    from qublas_tpu_torch import fuzz as F

    c = F.limbwide_case(t)
    if c is None:
        return None
    fa, fb, mul_to, layers, out, k, A, B = c
    return _crc(_fmt_fields(fa), _fmt_fields(fb), _fmt_fields(mul_to),
                tuple(map(_fmt_fields, layers)), _fmt_fields(out), k,
                A.tolist(), B.tolist())


# checksums of the configurations (formats, plan, shapes, raws, views) that
# the fuzz's K1 generator and its limb trial drew for seeds 0-49 when they
# aimed with the proofs themselves, before they read plan_qgemul
K1_DRAWS = [
    257849857, 3980400488, 3269315983, 1826858391, 1387057846, 4131137912,
    4090201239, 2672092550, 2043257146, 4151174726, 1380478061, 3262761018,
    2812557353, 1717554222, 2380725150, 3729610662, 780848549, 3320534964,
    46672300, 2038275998, 464422277, 1484354829, 1445069898, 1028230371,
    2790882881, 2117146843, 2800621536, 686005086, 120480715, 466262050,
    3784622933, 2646760505, 3766604481, 3474979652, 3204025308, 4160207265,
    446526661, 2119860982, 89630733, 1770988933, 3078727969, 3407513782,
    3119979788, 2764835697, 1206300670, 2763413128, 335211012, 1656362559,
    3375121068, 3380108415]
LIMB_DRAWS = [
    2701482030, 3134830561, 1665314370, 3408991909, 2317291488, 389680790,
    1259089605, 3794652071, 2394118752, 1632231138, 2279509399, 71379393,
    148704400, 1038949559, 2131560893, 1469901850, 2413342707, 2323416879,
    465547308, 3029032414, 133941468, 3146465203, 1089515659, 2129219960,
    3766923112, 60648613, 802276046, 3590892443, 2475963320, 3924451061,
    2848916151, 518926885, 1111672180, 902231565, 621915918, 4023210499,
    3336002994, 3305426098, 3443606005, 2148923950, 471847485, 735299720,
    2225883, 750517770, 257717175, 2668260703, 3727927029, 1686535108,
    3763602242, None]


@pytest.mark.parametrize("gen", ["k1", "limb"])
def test_fuzz_generators_draw_what_they_drew(gen):
    """The fuzz's K1 generator and limb trial aim with plan_qgemul's
    tier and draw, seed for seed, the configurations they drew before."""
    draw, want = {"k1": (_k1_draw, K1_DRAWS),
                  "limb": (_limb_draw, LIMB_DRAWS)}[gen]
    assert [draw(t) for t in range(50)] == want
