"""Randomized differential sweeps of the port against its host oracle.

    python -m qublas_tpu_torch.fuzz [trials] [--device cuda|cpu]
                                    [--family NAME]

runs every family (or the named ones) on the card, or with ``--device cpu``
on the CPU, prints a ``FAIL`` line with a one-line repro for each mismatch
or crash, and exits 1 if there was any (2 without a card and without
``--device cpu``: there is no quiet fallback to the CPU).  ``trials``
(default 1000) scales each family as the JAX package's ``tools/deep_fuzz.py``
scales it (:func:`trial_counts`).  The module imports torch and the port,
never JAX and nothing of the JAX package.

The families:

* the sweeps of ``tools/deep_fuzz.py``, under its names
  (``sweep_elementwise`` ... ``sweep_bitwise``): trial ``t`` of a family
  draws its configuration from :func:`rng_for` with :func:`rand_fmt` and
  :func:`rand_raws` as deep_fuzz does, so it is the same configuration in
  both packages.  Each is held bit for bit to the port's ``hostops`` (the
  sharded ones to the single-device call, in one spawned world of
  :data:`WORLD` ranks: Gloo, on the card through host memory);
* ``routes``: the curated cases of ``tools/tpu_differential.py``, one a
  device route (elementwise and casts on lane, pair and limb storage, the
  layered reduce, ``qgemul``'s int32, int64, digit-dot, tree and
  streaming tiers, ``cgemul``'s int32 and limb domains, a ROM, the bitwise
  surface, and the sharded strategies, here on a (1, 2) mesh in the same
  world as the sharded sweeps);
* the kernel families ``k1``, ``k2``, ``k2s``, ``k2h``, ``k3`` and ``p1``:
  random formats seldom land where a kernel runs, so each draws its
  configurations inside one kernel's envelope (``exact_plan``'s lossless
  plans for K1, ``plan_tree``'s for K2, K2′ and P1, ``plan_hybrid``'s for
  K2h, ``plan_reduce``'s for K3), with every mode pair, each of the
  kernel's instantiations in turn, shapes from 1 to a few thousand with
  the tile edges, and operands as contiguous, transposed, strided and
  offset views.  A trial calls the kernel's wrapper on the device, holds
  it to the plain version on CPU copies of the same operands, and holds
  the plain version to ``hostops`` (on a corner of the output where the
  whole would cost the oracle too much), so a fault falls on the kernel,
  the plain version or the proof.

On the card the wrappers count their launches and record each launch's
instantiation and mode pairs (``_build.record``); :func:`gate` fails the
sweep when a kernel it steers into launched fewer than
:data:`MIN_LAUNCHES` times, when K1's epilogue, K2's run-time
instantiations or K3 saw fewer than :data:`MIN_PAIRS` distinct (round,
overflow) pairs, or when one of K2's six instantiations never launched.
"""

from __future__ import annotations

import argparse
import operator
import random
import sys
import time
import zlib
from collections import Counter
from contextlib import nullcontext

import numpy as np
import torch

from . import anus, bitstream, bitwise, hostint, hostops
from .complex import QComplexTensor, cmul, cmul_tf
from .ops import elementwise as ew
from .ops import gemm as G
from .ops import tree_gemm as TG
from .ops.cgemm import cgemul
from .ops.chain_probe import chain_probe
from .ops.fused_gemm import fused_int8_gemm
from .ops.reduce import plan_reduce, qreduce, qreduce_kernel
from .ops.widths import fmt_interval, torch_dtype_for
from .qformat import OverflowMode, QFormat, RoundMode, mul_merge, qformat
from .qtensor import QTensor, from_raw, scalar

__all__ = ["Sweep", "rng_for", "rand_fmt", "rand_raws", "trial_counts",
           "run", "gate", "main", "FAMILIES", "KERNELS"]

WORLD = 2             # ranks of the world that runs the sharded families
MIN_LAUNCHES = 20     # launches each kernel must see in a sweep on the card
MIN_PAIRS = 10        # distinct (round, overflow) pairs the gate asks for
P1_MAX_PAST = 0.10    # share of P1's sampled chains that may leave the proof
ORACLE_PRODUCTS = 4096  # products of a GEMM trial checked whole by hostops
TILE_EDGES = (1, 63, 64, 65, 127, 128, 129)
MODES = [(r, o) for r in RoundMode for o in OverflowMode]


class Sweep:
    """One run of families on ``device``: its failures and their repro
    lines (printed as they come when ``echo``)."""

    def __init__(self, device, echo: bool = True):
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self.echo = echo
        self.fails = 0
        self.crashes = 0
        self.refusals = 0   # clean ValueErrors of the sharded strategies
        self.lines = []
        self.notes = {}     # family -> what its line adds
        # P1's sampled chains: held to hostint, or past the proof (no oracle)
        self.p1_held = self.p1_past = 0

    def fail(self, *msg):
        self.fails += 1
        if msg and msg[0] == "CRASH":
            self.crashes += 1
        line = "FAIL " + " ".join(str(m) for m in msg)
        self.lines.append(line)
        if self.echo:
            print(line, flush=True)

    def q(self, raws, fmt) -> QTensor:
        return from_raw(raws, fmt, device=self.device)


class NoCase(Exception):
    """A kernel family's generator found no configuration in its envelope."""


def draw(sw: Sweep, tag, t, gen):
    """Trial ``t`` of family ``tag``: ``gen(t)``, or None once a failure
    with its repro is counted, where the generator found no case or
    raised."""
    try:
        return gen(t)
    except NoCase as e:
        sw.fail(f"{tag}[{t}]", "the generator found no case:", str(e))
    except Exception as e:  # noqa: BLE001
        sw.fail("CRASH", f"{tag}[{t}] drawing its case", type(e).__name__,
                str(e)[:200])
    return None


def rng_for(tag, t):
    """Trial ``t`` of family ``tag``'s generator (``tools/deep_fuzz.py``)."""
    return np.random.RandomState(zlib.crc32(f"{tag}:{t}".encode()) % (2**31))


def rand_fmt(rng, mx, mn=0):
    while True:
        i = int(rng.randint(-8, mx))
        f = int(rng.randint(-8, mx))
        if mn <= i + f <= mx:
            break
    return qformat(i, f, bool(rng.randint(0, 2)),
                   RoundMode(rng.randint(0, 7)),
                   OverflowMode(rng.randint(0, 5)))


def rand_raws(rng, fmt, n):
    lo = max(fmt.raw_min, -(1 << 62))
    hi = min(fmt.raw_max, (1 << 62) - 1)
    if hi < lo:
        hi = lo
    return np.array([int(rng.randint(lo, hi + 1)) for _ in range(n)],
                    dtype=object)


def ints(x):
    """The raws of a QTensor (or an integer tensor) as a flat list of
    Python ints."""
    if isinstance(x, torch.Tensor):
        return [int(v) for v in x.cpu().reshape(-1).tolist()]
    return [int(v) for v in np.asarray(x.raw(), dtype=object).reshape(-1)]


# ---------------------------------------------------------------------------
# the sweeps of tools/deep_fuzz.py
# ---------------------------------------------------------------------------

def sweep_elementwise(sw: Sweep, trials):
    for t in range(trials):
        rng = rng_for("ew", t)
        mx = [24, 48, 90][t % 3]
        fa, fb = rand_fmt(rng, mx), rand_fmt(rng, mx)
        to = None if rng.randint(0, 2) else rand_fmt(rng, mx)
        op = ["qmul", "qadd", "qsub", "qdiv", "qabs", "qneg",
              "qcmp", "qeq"][rng.randint(0, 8)]
        n = 16
        A, B = rand_raws(rng, fa, n), rand_raws(rng, fb, n)
        if op == "qdiv":
            B = np.array([v if v else 1 for v in B], dtype=object)
            B[3] = 0
        try:
            a, b = sw.q(A, fa), sw.q(B, fb)
            if op in ("qcmp", "qeq"):
                dev = ints(getattr(ew, op)(a, b))
                for x, y, g in zip(A, B, dev):
                    want = getattr(hostops, op)((int(x), fa), (int(y), fb))
                    if (g if op == "qcmp" else bool(g)) != want:
                        sw.fail(op, fa, fb, int(x), int(y), g, want)
            elif op in ("qabs", "qneg"):
                dev = getattr(ew, op)(a)
                for x, g in zip(A, ints(dev)):
                    want, wf = getattr(hostops, op)((int(x), fa))
                    if g != want or dev.fmt != wf:
                        sw.fail(op, fa, int(x), g, want)
            else:
                dev = getattr(ew, op)(a, b, to=to)
                for x, y, g in zip(A, B, ints(dev)):
                    want, wf = getattr(hostops, op)((int(x), fa),
                                                    (int(y), fb), to=to)
                    if g != want or dev.fmt != wf:
                        sw.fail(op, fa, fb, to, int(x), int(y), g, want)
        except Exception as e:  # noqa: BLE001 - report and continue
            sw.fail("CRASH", op, fa, fb, to, type(e).__name__, str(e)[:150])


def sweep_reduce(sw: Sweep, trials):
    for t in range(trials):
        rng = rng_for("red", t)
        mx = [24, 48, 90][t % 3]
        fa = rand_fmt(rng, min(mx, 40))
        n = int(rng.randint(1, 24))
        layers = tuple(rand_fmt(rng, mx) for _ in range(rng.randint(0, 3)))
        A = rand_raws(rng, fa, n)
        try:
            dev = qreduce(sw.q(A, fa), layers)
            want, wf = hostops.qreduce_list([(int(v), fa) for v in A], layers)
            g = ints(dev)[0]
            if g != want or dev.fmt != wf:
                sw.fail("reduce", fa, layers, n, g, want)
        except Exception as e:  # noqa: BLE001
            sw.fail("CRASH", "reduce", fa, layers, n, type(e).__name__,
                    str(e)[:150])


def _host_gemm(A, B, fa, fb, out, mul_to, layers, rows=None, cols=None):
    """hostops.qgemul of the raws A [m, k], B [k, n] (rows and cols of the
    output only, where given): nested lists of (raw, fmt)."""
    rows = range(len(A)) if rows is None else rows
    cols = range(len(B[0])) if cols is None else cols
    k = len(B)
    return hostops.qgemul(
        [[(int(A[i][p]), fa) for p in range(k)] for i in rows],
        [[(int(B[p][j]), fb) for j in cols] for p in range(k)],
        out, mul_to=mul_to, add_formats=layers)


def sweep_gemm(sw: Sweep, trials):
    for t in range(trials):
        rng = rng_for("gemm", t)
        mx = [20, 40, 70][t % 3]
        fa, fb = rand_fmt(rng, mx), rand_fmt(rng, 16)
        out = rand_fmt(rng, mx)
        mul_to = None if rng.randint(0, 2) else rand_fmt(rng, mx + 10)
        layers = tuple(rand_fmt(rng, mx + 10)
                       for _ in range(rng.randint(0, 2)))
        # every 4th trial stretches k into streaming territory with the
        # size gate lowered, so the general-k stream and the int64 wide
        # tier engage
        stream_trial = t % 4 == 3
        m, n2 = 2, 2
        k = int(rng.randint(16, 90)) if stream_trial else \
            int(rng.randint(1, 10))
        A = rand_raws(rng, fa, m * k).reshape(m, k)
        B = rand_raws(rng, fb, k * n2).reshape(k, n2)
        try:
            with G.stream_gate(0) if stream_trial else nullcontext():
                dev = G.qgemul(sw.q(A, fa), sw.q(B, fb), out, mul_to=mul_to,
                               add_formats=layers)
            host = _host_gemm(A, B, fa, fb, out, mul_to, layers)
            gr = np.asarray(dev.raw(), dtype=object)
            for i in range(m):
                for j in range(n2):
                    if int(gr[i][j]) != host[i][j][0]:
                        sw.fail("gemm", fa, fb, out, mul_to, layers, k,
                                int(gr[i][j]), host[i][j][0])
        except Exception as e:  # noqa: BLE001
            sw.fail("CRASH", "gemm", fa, fb, out, mul_to, layers,
                    type(e).__name__, str(e)[:150])


def sweep_gemm_limbwide(sw: Sweep, trials):
    """Proof-lossless configurations whose dot outgrows the 64-bit domain:
    the limb tier (digit dots on K1) against the oracle and against the
    next tier with the limb tier off.  Configurations outside the limb
    tier's envelope are not counted."""
    done = 0
    for t in range(trials):
        rng = rng_for("glimb", t)
        fa = qformat(int(rng.randint(18, 40)), int(rng.randint(4, 32)),
                     bool(rng.randint(0, 2)))
        fb = qformat(int(rng.randint(18, 40)), int(rng.randint(4, 32)),
                     bool(rng.randint(0, 2)))
        pf = fa.frac_bits + fb.frac_bits
        k = int(rng.randint(2, 40))
        mul_to = qformat(fa.int_bits + fb.int_bits + 2, pf)
        layers = (qformat(fa.int_bits + fb.int_bits + k.bit_length() + 3,
                          pf),)
        out = rand_fmt(rng, 60)
        m, n2 = 2, 2
        mul_fmt = mul_merge(fa, fb, mul_to, False)
        plan = G.exact_plan(fa, fb, mul_fmt, layers, k)
        if plan is None or plan.dot_interval.fits64:
            continue
        if G.limb_dot_plan(fa, fb, out, plan, k, m, n2) is None:
            continue
        A = rand_raws(rng, fa, m * k).reshape(m, k)
        B = rand_raws(rng, fb, k * n2).reshape(k, n2)
        try:
            ta, tb = sw.q(A, fa), sw.q(B, fb)
            dev = G.qgemul(ta, tb, out, mul_to=mul_to, add_formats=layers)
            with G.force_tiers_off("limb"):
                prev = G.qgemul(ta, tb, out, mul_to=mul_to,
                                add_formats=layers)
            host = _host_gemm(A, B, fa, fb, out, mul_to, layers)
            gr = np.asarray(dev.raw(), dtype=object)
            pr = np.asarray(prev.raw(), dtype=object)
            for i in range(m):
                for j in range(n2):
                    if int(gr[i][j]) != host[i][j][0] \
                            or int(pr[i][j]) != host[i][j][0]:
                        sw.fail("gemm_limbwide", fa, fb, out, mul_to, layers,
                                k, int(gr[i][j]), int(pr[i][j]),
                                host[i][j][0])
            done += 1
        except Exception as e:  # noqa: BLE001
            sw.fail("CRASH", "gemm_limbwide", fa, fb, out, mul_to, layers,
                    type(e).__name__, str(e)[:150])
    return done


BASIC_TAGS = ["ac", "bd", "ad", "bc", "acbd", "adbc"]
TF_TAGS = ["ab", "cd", "ba", "abc", "cdb", "bad", "AB", "BC"]


def sweep_complex(sw: Sweep, trials):
    for t in range(trials):
        rng = rng_for("cplx", t)
        fr, fi = rand_fmt(rng, 20), rand_fmt(rng, 20)
        gr, gi = rand_fmt(rng, 20), rand_fmt(rng, 20)
        n = 6
        ar, ai = rand_raws(rng, fr, n), rand_raws(rng, fi, n)
        br, bi = rand_raws(rng, gr, n), rand_raws(rng, gi, n)
        algo = ["basic", "tf"][rng.randint(0, 2)]
        names = BASIC_TAGS if algo == "basic" else TF_TAGS
        tags = {nm: rand_fmt(rng, 20) for nm in names
                if rng.randint(0, 3) == 0}
        fn = cmul if algo == "basic" else cmul_tf
        hfn = hostops.complex_mul_basic if algo == "basic" \
            else hostops.complex_mul_tf
        try:
            a = QComplexTensor(sw.q(ar, fr), sw.q(ai, fi))
            b = QComplexTensor(sw.q(br, gr), sw.q(bi, gi))
            dev = fn(a, b, **tags)
            dr, di = ints(dev.real), ints(dev.imag)
            for j in range(n):
                (wr, wrf), (wi, wif) = hfn(
                    ((int(ar[j]), fr), (int(ai[j]), fi)),
                    ((int(br[j]), gr), (int(bi[j]), gi)), **tags)
                if dr[j] != wr or di[j] != wi \
                        or dev.real.fmt != wrf or dev.imag.fmt != wif:
                    sw.fail("cmul", algo, tags, j, dr[j], wr, di[j], wi)
        except NotImplementedError:
            pass
        except Exception as e:  # noqa: BLE001
            sw.fail("CRASH", "cmul", algo, tags, type(e).__name__,
                    str(e)[:150])


def _crows(c: QComplexTensor):
    re = np.asarray(c.real.raw(), dtype=object)
    im = np.asarray(c.imag.raw(), dtype=object)
    return [[((int(re[i, j]), c.real.fmt), (int(im[i, j]), c.imag.fmt))
             for j in range(re.shape[1])] for i in range(re.shape[0])]


def sweep_cgemul(sw: Sweep, trials):
    for t in range(trials):
        rng = rng_for("cg", t)
        mul_tags = {}
        if t % 3 == 2:
            # a lossless wide configuration, so that the limb-domain
            # complex fast path stays in the sweep beside the layered path
            fr = qformat(int(rng.randint(10, 30)), int(rng.randint(4, 16)),
                         bool(rng.randint(0, 2)))
            fi = qformat(int(rng.randint(10, 30)), int(rng.randint(4, 16)),
                         bool(rng.randint(0, 2)))
            ib = max(fr.int_bits, fi.int_bits) + 1
            pf = max(fr.frac_bits, fi.frac_bits) * 2
            k = int(rng.randint(1, 20))
            w = qformat(2 * ib + 2, pf)
            acc = qformat(2 * ib + 3, pf)
            mul_tags = dict(ac=w, bd=w, ad=w, bc=w, acbd=acc, adbc=acc)
            layers = (qformat(2 * ib + k.bit_length() + 4, pf),)
            out = (rand_fmt(rng, 55), rand_fmt(rng, 55))
            algo = "basic"
            m, n2 = 2, 2
        else:
            fr, fi = rand_fmt(rng, 8), rand_fmt(rng, 8)
            m, k, n2 = 2, int(rng.randint(1, 6)), 2
            out = (rand_fmt(rng, 10), rand_fmt(rng, 10))
            layers = tuple(rand_fmt(rng, 14) if rng.randint(0, 2)
                           else (rand_fmt(rng, 14), rand_fmt(rng, 14))
                           for _ in range(rng.randint(0, 3)))
            algo = ["basic", "tf"][rng.randint(0, 2)]

        def rc(r, c):
            return QComplexTensor(
                sw.q(rand_raws(rng, fr, r * c).reshape(r, c), fr),
                sw.q(rand_raws(rng, fi, r * c).reshape(r, c), fi))

        try:
            a, b = rc(m, k), rc(k, n2)
            dev = cgemul(a, b, out, algo=algo, add_formats=layers,
                         **mul_tags)
            host = hostops.cgemul(_crows(a), _crows(b), out, algo=algo,
                                  add_formats=layers, **mul_tags)
            dr = np.asarray(dev.real.raw(), dtype=object)
            di = np.asarray(dev.imag.raw(), dtype=object)
            for i in range(m):
                for j in range(n2):
                    if int(dr[i][j]) != host[i][j][0][0] \
                            or int(di[i][j]) != host[i][j][1][0]:
                        sw.fail("cgemul", algo, fr, fi, out, layers,
                                mul_tags, k, i, j)
        except Exception as e:  # noqa: BLE001
            sw.fail("CRASH", "cgemul", algo, layers, type(e).__name__,
                    str(e)[:150])


def sweep_anus(sw: Sweep, trials):
    def host_qpoly(xp, cps):
        acc = cps[-1]
        for a in reversed(cps[:-1]):
            m = hostops.qmul(xp, acc, to=a[1])
            acc = hostops.qadd(a, m, to=a[1])
        return acc

    for t in range(trials):
        rng = rng_for("poly", t)
        mx = [20, 44, 80][t % 3]
        fx = rand_fmt(rng, mx)
        X = rand_raws(rng, fx, 8)
        cvals = [(float(rng.randn() * (2.0 ** rng.randint(-3, 4))),
                  rand_fmt(rng, 20)) for _ in range(rng.randint(1, 4))]
        try:
            coeffs = [scalar(v, f, device=sw.device) for v, f in cvals]
            dev = anus.qpoly(sw.q(X, fx), coeffs)
            hc = [(ints(c)[0], c.fmt) for c in coeffs]
            for v, g in zip(X, ints(dev)):
                want, wf = host_qpoly((int(v), fx), hc)
                if g != want or dev.fmt != wf:
                    sw.fail("qpoly", fx, [c.fmt for c in coeffs], int(v), g,
                            want)
        except Exception as e:  # noqa: BLE001
            sw.fail("CRASH", "qpoly", fx, type(e).__name__, str(e)[:150])

    for t in range(trials):
        rng = rng_for("appx", t)
        mx = [20, 44, 80][t % 3]
        while True:
            fx = rand_fmt(rng, mx, mn=4)
            if fx.int_bits >= 3 and fx.frac_bits >= 0:
                break
        X = rand_raws(rng, fx, 8)
        nseg = int(rng.randint(2, 4))
        bps = []
        for _ in range(nseg - 1):
            if rng.randint(0, 2):
                bps.append(float(rng.randn()
                                 * (2.0 ** rng.randint(0, min(mx + 6, 40)))))
            else:
                v = int(X[rng.randint(0, 8)])
                bps.append(hostint.raw_to_double(
                    v + int(rng.randint(-1, 2)), fx))
        bps = sorted(bps) + [float("inf")]
        try:
            segs = [anus.Segment(bp, [scalar(float(i + 1), fx,
                                             device=sw.device)])
                    for i, bp in enumerate(bps)]
            dev = anus.qapprox(sw.q(X, fx), segs)
            host = anus.qapprox(sw.q(X, QFormat(300, fx.frac_bits)), segs)
            for v, g, h in zip(X, ints(dev), ints(host)):
                if g != h:
                    sw.fail("qapprox", fx, bps[:-1], int(v), g, h)
        except Exception as e:  # noqa: BLE001
            sw.fail("CRASH", "qapprox", fx, type(e).__name__, str(e)[:150])


def sweep_cast(sw: Sweep, trials):
    """Direct cross-format conversion (astype / converting assignment)."""
    for t in range(trials):
        rng = rng_for("cast", t)
        mx = [24, 48, 90][t % 3]
        fa, fb = rand_fmt(rng, mx), rand_fmt(rng, [24, 48, 90][(t + 1) % 3])
        A = rand_raws(rng, fa, 16)
        try:
            dev = sw.q(A, fa).astype(fb)
            for v, g in zip(A, ints(dev)):
                want = hostops.convert((int(v), fa), fb)[0]
                if g != want:
                    sw.fail("cast", fa, fb, int(v), g, want)
        except Exception as e:  # noqa: BLE001
            sw.fail("CRASH", "cast", fa, fb, type(e).__name__, str(e)[:150])


def sweep_bitstream(sw: Sweep, trials):
    """BitStream round trips with random chunk orders (representable
    raws)."""
    for t in range(trials):
        rng = rng_for("bits", t)
        fx = rand_fmt(rng, 40)
        if fx.width <= 0:
            continue
        n = int(rng.randint(1, 9))
        lo = max(-(1 << (fx.width - 1)) if fx.signed and fx.width > 0 else 0,
                 -(1 << 62))
        hi = min((1 << (fx.width - (1 if fx.signed else 0))) - 1
                 if fx.width > 0 else 0, (1 << 62) - 1)
        if hi < lo:
            continue
        A = np.array([int(rng.randint(lo, hi + 1)) for _ in range(n)],
                     dtype=object)

        def order(chunk_ok):
            c = rng.randint(0, 3)
            if c == 0:
                return None
            if c == 1:
                return bitstream.l2r
            d = int(rng.randint(1, 4))
            return bitstream.r2l(d) if chunk_ok % d == 0 else None

        t_ord = order(n)
        e_ord = order(fx.width)
        try:
            s = bitstream.to_bits(sw.q(A, fx), tensor_order=t_ord,
                                  elem_order=e_ord)
            back = bitstream.from_bits(s, fx, (n,), tensor_order=t_ord,
                                       elem_order=e_ord,
                                       twos_complement=True,
                                       device=sw.device)
            if ints(back) != [int(v) for v in A]:
                sw.fail("bits", fx, t_ord, e_ord, list(A), ints(back))
        except Exception as e:  # noqa: BLE001
            sw.fail("CRASH", "bits", fx, type(e).__name__, str(e)[:150])


def sweep_bitwise(sw: Sweep, trials):
    """The raw-bitwise surface (qand/qor/qxor/qnot) across random
    mixed-width formats and storage kinds against Python's
    two's-complement ints, and decimal round trips."""
    ops = [("qand", operator.and_), ("qor", operator.or_),
           ("qxor", operator.xor)]
    for t in range(trials):
        rng = rng_for("bitw", t)
        mx = [12, 30, 60, 120, 400, 1100][t % 6]
        fa, fb = rand_fmt(rng, mx), rand_fmt(rng, mx // (1 + t % 3) + 2)
        n = 6

        def dense(fmt):
            # full-width raws (rand_raws clamps to +/-2^62); every 4th
            # trial adds a raw beyond the declared range (stored as given)
            w = max(fmt.storage_bits, 2)
            vals = [int(rng.randint(0, 2)) * -1 ^
                    int.from_bytes(bytes(rng.randint(0, 256, (w + 14) // 8,
                                                     dtype=np.int64)
                                         .astype(np.uint8)), "little")
                    for _ in range(n)]
            vals = [max(min(v, fmt.raw_max), fmt.raw_min) for v in vals]
            if t % 4 == 0 and fmt.storage_bits <= 24:
                vals[0] = fmt.raw_max * 3 + 7
            return np.array(vals, dtype=object)

        A, B = dense(fa), dense(fb)
        wide = fa if fa.storage_bits >= fb.storage_bits else fb
        try:
            a, b = sw.q(A, fa), sw.q(B, fb)
            name, op = ops[t % 3]
            got = getattr(bitwise, name)(a, b)
            if got.fmt != wide or \
                    ints(got) != [op(int(x), int(y)) for x, y in zip(A, B)]:
                sw.fail("bitwise", name, fa, fb)
            if ints(bitwise.qnot(a)) != [~int(x) for x in A]:
                sw.fail("bitwise_not", fa)
            rt = bitwise.from_decimal(bitwise.to_decimal(a), fa,
                                      device=sw.device)
            if ints(rt) != [int(x) for x in A]:
                sw.fail("bitwise_decimal_rt", fa)
        except Exception as e:  # noqa: BLE001
            sw.fail("CRASH", "bitwise", fa, fb, type(e).__name__,
                    str(e)[:150])
    return trials


# ---------------------------------------------------------------------------
# the sharded sweeps: ranks of one world
# ---------------------------------------------------------------------------

def sweep_sharded(sw: Sweep, trials, mesh):
    """Auto-routed sharded GEMM against the single-device call; odd trials
    also through the ppermute ring of the regime the plans pick."""
    from .parallel import shard_qgemul
    from .parallel.sharding import _k_limb_plan, _k_wide_plan

    tp = mesh.shape["tp"]
    for t in range(trials):
        rng = rng_for("shard", t)
        m = 4
        k = int(rng.choice([4, 8, 12, 16]))
        n2 = 8
        if t % 4 == 3:
            # a lossless wide configuration: auto's k_wide and k_limb
            fa = qformat(int(rng.randint(14, 34)), int(rng.randint(4, 20)),
                         bool(rng.randint(0, 2)))
            fb = qformat(int(rng.randint(14, 34)), int(rng.randint(4, 20)),
                         bool(rng.randint(0, 2)))
            pf = fa.frac_bits + fb.frac_bits
            mul_to = qformat(fa.int_bits + fb.int_bits + 2, pf)
            layers = (qformat(fa.int_bits + fb.int_bits
                              + k.bit_length() + 3, pf),)
            out = rand_fmt(rng, 60)
        else:
            mx = [16, 20, 40][t % 3]
            fa, fb = rand_fmt(rng, mx), rand_fmt(rng, 12)
            out = rand_fmt(rng, mx)
            mul_to = None if rng.randint(0, 2) else rand_fmt(rng, mx + 8)
            layers = tuple(rand_fmt(rng, mx + 8)
                           for _ in range(rng.randint(0, 2)))
        A = rand_raws(rng, fa, m * k).reshape(m, k)
        B = rand_raws(rng, fb, k * n2).reshape(k, n2)
        try:
            ta, tb = sw.q(A, fa), sw.q(B, fb)
            ref = G.qgemul(ta, tb, out, mul_to=mul_to, add_formats=layers)
            got = shard_qgemul(ta, tb, out, mesh, mul_to=mul_to,
                               add_formats=layers)
            if got.fmt != ref.fmt or ints(got) != ints(ref):
                sw.fail("shard", fa, fb, out, mul_to, layers, k)
            if t % 2:
                if _k_limb_plan(ta, tb, out, mul_to, layers, False,
                                tp) is not None:
                    strat = "k_limb_pipelined"
                elif _k_wide_plan(ta, tb, out, mul_to, layers, False,
                                  tp) is not None:
                    strat = "k_wide_pipelined"
                else:
                    strat = "k_pipelined"
                try:
                    gp = shard_qgemul(ta, tb, out, mesh, mul_to=mul_to,
                                      add_formats=layers, strategy=strat)
                    if gp.fmt != ref.fmt or ints(gp) != ints(ref):
                        sw.fail("shard_pipelined", strat, fa, fb, out,
                                mul_to, layers, k)
                except ValueError:
                    sw.refusals += 1  # outside the strategy's gate
        except ValueError:
            sw.refusals += 1  # a host-route or configuration refusal
        except Exception as e:  # noqa: BLE001
            sw.fail("CRASH", "shard", fa, fb, out, mul_to, layers,
                    type(e).__name__, str(e)[:150])
    return trials


def sweep_sharded_ktree(sw: Sweep, trials, meshes):
    """Subtree-aligned K-sharding of order-sensitive tree GEMMs (and the
    reduce and complex analogues) against the single-device call, over
    random k (power of two, ragged, odd)."""
    from .parallel import (sharded_cgemul_k_tree, sharded_qgemul_k_tree,
                           sharded_qreduce_k_tree)

    for t in range(trials):
        rng = rng_for("ktree", t)
        mesh = meshes[t % 2]
        m, n2 = 3, 4
        k = int(rng.choice([7, 8, 12, 16, 17, 24, 32, 33, 40, 64]))
        mx = [12, 16, 24][t % 3]
        fa, fb = rand_fmt(rng, mx), rand_fmt(rng, 12)
        out = rand_fmt(rng, mx)
        mul_to = None if rng.randint(0, 2) else rand_fmt(rng, mx + 6)
        layers = tuple(rand_fmt(rng, mx + 6)
                       for _ in range(rng.randint(0, 3)))
        A = rand_raws(rng, fa, m * k).reshape(m, k)
        B = rand_raws(rng, fb, k * n2).reshape(k, n2)
        try:
            ta, tb = sw.q(A, fa), sw.q(B, fb)
            got = sharded_qgemul_k_tree(ta, tb, out, mesh, mul_to=mul_to,
                                        add_formats=layers)
            ref = G.qgemul(ta, tb, out, mul_to=mul_to, add_formats=layers)
            if got.fmt != ref.fmt or ints(got) != ints(ref):
                sw.fail("ktree", fa, fb, out, mul_to, layers, k, t % 2)
            if t % 3 == 2:
                xv = sw.q(A[0], fa)
                gr = sharded_qreduce_k_tree(xv, layers, mesh=mesh)
                rr = qreduce(xv, layers)
                if gr.fmt != rr.fmt or ints(gr) != ints(rr):
                    sw.fail("ktree_reduce", fa, layers, k, t % 2)
            if t % 5 == 4:
                algo = "tf" if t % 2 else "basic"
                ca = QComplexTensor(ta, sw.q(rand_raws(rng, fa, m * k)
                                             .reshape(m, k), fa))
                cb = QComplexTensor(tb, sw.q(rand_raws(rng, fb, k * n2)
                                             .reshape(k, n2), fb))
                gc = sharded_cgemul_k_tree(ca, cb, out, mesh, algo=algo,
                                           add_formats=layers)
                rc = cgemul(ca, cb, out, algo=algo, add_formats=layers)
                for part in ("real", "imag"):
                    gp, wp = getattr(gc, part), getattr(rc, part)
                    if gp.fmt != wp.fmt or ints(gp) != ints(wp):
                        sw.fail("ktree_cgemul", algo, fa, fb, out, layers, k)
        except ValueError:
            sw.refusals += 1  # a host-route refusal
        except Exception as e:  # noqa: BLE001
            sw.fail("CRASH", "ktree", fa, fb, out, mul_to, layers, k,
                    type(e).__name__, str(e)[:150])
    return trials


# ---------------------------------------------------------------------------
# the curated route cases of tools/tpu_differential.py
# ---------------------------------------------------------------------------

def _raws(fmt, n, seed):
    rng = random.Random(f"tpudiff:{seed}:{fmt.storage_bits}:{n}")
    lo = max(fmt.raw_min, -(1 << 62))
    hi = min(fmt.raw_max, (1 << 62) - 1)
    return np.array([rng.randint(lo, max(hi, lo)) for _ in range(n)],
                    dtype=object)


def _route(sw: Sweep, name, fn, want):
    """``fn()``'s raws against the oracle's ints ``want``."""
    try:
        got = fn()
    except Exception as e:  # noqa: BLE001 - a crash is a failure
        sw.fail("CRASH", name, type(e).__name__, str(e)[:200])
        return
    if got != want:
        sw.fail(name, "diverges from the oracle: got", got, "want", want)


def route_elementwise(sw: Sweep):
    cases = [
        ("ew.lane", qformat(7, 8), qformat(7, 8),
         qformat(10, 10, round_mode=RoundMode.RND_CONV)),
        ("ew.pair", qformat(30, 9), qformat(7, 8),
         qformat(36, 10, overflow_mode=OverflowMode.SAT_TCPL)),
        ("ew.limb", qformat(40, 30), qformat(8, 6),
         qformat(45, 30, round_mode=RoundMode.RND_ZERO)),
    ]
    for tag, fa, fb, to in cases:
        n = 8
        A, B = _raws(fa, n, tag + "a"), _raws(fb, n, tag + "b")
        B = np.array([v if v else 1 for v in B], dtype=object)
        B[3] = 0                      # divide by zero -> 0 in the mix
        for op in ("qadd", "qsub", "qmul", "qdiv"):
            want = [getattr(hostops, op)((int(x), fa), (int(y), fb),
                                         to=to)[0] for x, y in zip(A, B)]
            _route(sw, f"{tag}.{op}", lambda op=op: ints(getattr(ew, op)(
                sw.q(A, fa), sw.q(B, fb), to=to)), want)


def route_casts(sw: Sweep):
    cases = [
        ("cast.lane->pair", qformat(7, 8),
         qformat(40, 10, round_mode=RoundMode.RND_CONV)),
        ("cast.pair->lane", qformat(30, 9),
         qformat(10, 5, overflow_mode=OverflowMode.SAT_ZERO)),
        ("cast.pair->limb", qformat(30, 9),
         qformat(60, 20, round_mode=RoundMode.RND_NEG_INF)),
        ("cast.limb->lane", qformat(40, 30),
         qformat(10, 5, round_mode=RoundMode.TRN_SMGN,
                 overflow_mode=OverflowMode.SAT_SMGN)),
        ("cast.limb->limb", qformat(40, 30),
         qformat(50, 40, overflow_mode=OverflowMode.WRP_TCPL)),
        ("cast.limb->pair", qformat(40, 30),
         qformat(33, 20, overflow_mode=OverflowMode.WRP_TCPL_SAT)),
    ]
    for tag, fa, fb in cases:
        A = _raws(fa, 8, tag)
        want = [hostops.convert((int(v), fa), fb)[0] for v in A]
        _route(sw, tag, lambda: ints(sw.q(A, fa).astype(fb)), want)


def route_reduce(sw: Sweep):
    cases = [
        ("reduce.lane", qformat(7, 8), (qformat(12, 8), qformat(16, 8))),
        ("reduce.pair", qformat(28, 0), (qformat(36, 0),)),
        ("reduce.limb", qformat(40, 28), (qformat(78, 28),)),
    ]
    for tag, fa, layers in cases:
        A = _raws(fa, 16, tag)
        want, _ = hostops.qreduce_list([(int(v), fa) for v in A], layers)
        _route(sw, tag, lambda: ints(qreduce(sw.q(A, fa), layers)), [want])


def _route_gemm(sw: Sweep, tag, fa, fb, out, mul_to, layers, m, k, n,
                stream=False):
    A = _raws(fa, m * k, tag + "a").reshape(m, k)
    B = _raws(fb, k * n, tag + "b").reshape(k, n)
    want = [r for row in _host_gemm(A, B, fa, fb, out, mul_to, layers)
            for (r, _) in row]

    def fn():
        with G.stream_gate(0) if stream else nullcontext():
            return ints(G.qgemul(sw.q(A, fa), sw.q(B, fb), out,
                                 mul_to=mul_to, add_formats=layers))

    _route(sw, tag, fn, want)


def route_gemm(sw: Sweep):
    f34 = qformat(3, 4)
    w = qformat(20, 8)
    # the int32 tier (K1)
    _route_gemm(sw, "gemm.mxu_i32", f34, f34,
                qformat(3, 4, overflow_mode=OverflowMode.SAT_ZERO),
                w, (w,), 4, 16, 4)
    # the int64 tier: lane operands, a dot beyond int32 (int_dot segments)
    _route_gemm(sw, "gemm.pair_wide", qformat(13, 0), qformat(13, 0),
                qformat(25, 0, overflow_mode=OverflowMode.SAT_TCPL),
                qformat(27, 0), (qformat(33, 0),), 4, 64, 4)
    # the limb tier: pair operands, a dot beyond 64 bits (digit dots)
    _route_gemm(sw, "gemm.limb_digit", qformat(25, 15), qformat(25, 15),
                qformat(60, 20, round_mode=RoundMode.RND_CONV,
                        overflow_mode=OverflowMode.SAT_TCPL),
                qformat(51, 30), (qformat(57, 30),), 3, 16, 4)
    # the order-sensitive tree (K2)
    f88z = qformat(8, 8, overflow_mode=OverflowMode.SAT_ZERO)
    _route_gemm(sw, "gemm.tree", f88z, f88z, f88z, None, (), 4, 8, 4)
    # the general-k stream (odd k, ragged tail subtree)
    _route_gemm(sw, "gemm.stream", f88z, f88z, f88z, None, (), 2, 33, 2,
                stream=True)


def route_cgemm(sw: Sweep):
    fa = qformat(3, 4)
    w = qformat(20, 8)
    mid = qformat(5, 4)
    out = (qformat(3, 4, overflow_mode=OverflowMode.SAT_ZERO),) * 2
    f40 = qformat(25, 15)
    w51 = qformat(51, 30)
    acc = qformat(52, 30)
    s26 = qformat(26, 15)
    p52 = qformat(52, 30)
    outw = (qformat(60, 20, round_mode=RoundMode.RND_CONV,
                    overflow_mode=OverflowMode.SAT_TCPL),) * 2
    cases = [
        ("cgemm.basic", fa, out, "basic",
         dict(ac=mid, bd=mid, ad=mid, bc=mid, acbd=w, adbc=w,
              add_formats=(w,))),
        ("cgemm.tf", fa, out, "tf",
         dict(ab=mid, cd=mid, ba=mid, abc=w, cdb=w, bad=w, AB=w, BC=w,
              add_formats=(w,))),
        # the limb domain: 40-bit pair operands, 80-bit products
        ("cgemm.basic_wide", f40, outw, "basic",
         dict(ac=w51, bd=w51, ad=w51, bc=w51, acbd=acc, adbc=acc,
              add_formats=(qformat(58, 30),))),
        ("cgemm.tf_wide", f40, outw, "tf",
         dict(ab=s26, cd=s26, ba=s26, abc=p52, cdb=p52, bad=p52,
              AB=qformat(53, 30), BC=qformat(53, 30),
              add_formats=(qformat(58, 30),))),
    ]
    m, k, n = 2, 4, 2
    for tag, fop, outf, algo, kw in cases:
        parts = [_raws(fop, r * c, tag + s).reshape(r, c)
                 for s, (r, c) in zip("abcd", ((m, k), (m, k), (k, n),
                                                (k, n)))]
        ca = QComplexTensor(sw.q(parts[0], fop), sw.q(parts[1], fop))
        cb = QComplexTensor(sw.q(parts[2], fop), sw.q(parts[3], fop))
        host = hostops.cgemul(_crows(ca), _crows(cb), outf, algo=algo, **kw)
        want = [v[0][0] for row in host for v in row] \
            + [v[1][0] for row in host for v in row]

        def fn(ca=ca, cb=cb, outf=outf, algo=algo, kw=kw):
            r = cgemul(ca, cb, outf, algo=algo, **kw)
            return ints(r.real) + ints(r.imag)

        _route(sw, tag, fn, want)


def route_bitwise(sw: Sweep):
    fp, fl = qformat(30, 9), qformat(50, 29)
    A, B = _raws(fp, 8, "bwa"), _raws(fl, 8, "bwb")
    _route(sw, "bitwise.pair_xor_limb",
           lambda: ints(bitwise.qxor(sw.q(A, fp), sw.q(B, fl))),
           [int(x) ^ int(y) for x, y in zip(A, B)])


def route_anus(sw: Sweep):
    """A ROM (select tree) on the device against the same ROM on the CPU
    and against the table's own entries."""
    mid = qformat(3, 4, overflow_mode=OverflowMode.SAT_ZERO)
    table = anus.build_table(anus.sqrt_func, mid, mid)
    X = _raws(mid, 16, "lut")
    want = ints(table(from_raw(X, mid, device="cpu")))
    entries = [hostint.double_to_raw(anus.sqrt_func(
        hostint.raw_to_double(int(v), mid)), mid) for v in X]
    if want != entries:
        sw.fail("anus.lut_select_tree", "plain", want, "!= table entries",
                entries)
    _route(sw, "anus.lut_select_tree", lambda: ints(table(sw.q(X, mid))),
           want)


def route_sharded(sw: Sweep, mesh):
    """The strategies of ``tools/tpu_differential.py``'s ``run_sharded``
    (there on a 1x1 mesh of the chip), each against the oracle."""
    from .parallel import shard_qgemul

    sz = OverflowMode.SAT_ZERO
    f88z = qformat(8, 8, overflow_mode=sz)
    lk = (qformat(25, 15), qformat(25, 15),
          qformat(60, 20, round_mode=RoundMode.RND_CONV,
                  overflow_mode=OverflowMode.SAT_TCPL),
          qformat(51, 30), (qformat(57, 30),), 3, 16, 8)
    wk = (qformat(30, 9), qformat(7, 8), qformat(20, 6, overflow_mode=sz),
          qformat(40, 17), (qformat(45, 17),), 4, 16, 8)
    ik = (qformat(3, 4), qformat(3, 4), qformat(3, 4, overflow_mode=sz),
          qformat(20, 8), (qformat(20, 8),), 4, 16, 4)
    cases = [("shard.k", "k", *ik), ("shard.k_pipelined", "k_pipelined", *ik),
             ("shard.k_wide", "k_wide", *wk),
             ("shard.k_wide_pipelined", "k_wide_pipelined", *wk),
             ("shard.k_limb", "k_limb", *lk),
             ("shard.k_limb_pipelined", "k_limb_pipelined", *lk),
             ("shard.k_tree", "k_tree", f88z, f88z, f88z, None, (f88z,),
              4, 16, 4),
             ("shard.k_tree_ragged", "k_tree", f88z, f88z, f88z, None,
              (qformat(9, 6, round_mode=RoundMode.RND_CONV),), 3, 21, 4)]
    for tag, strat, fa, fb, out, mul_to, layers, m, k, n in cases:
        A = _raws(fa, m * k, tag + "a").reshape(m, k)
        B = _raws(fb, k * n, tag + "b").reshape(k, n)
        want = [r for row in _host_gemm(A, B, fa, fb, out, mul_to, layers)
                for (r, _) in row]
        _route(sw, tag, lambda: ints(shard_qgemul(
            sw.q(A, fa), sw.q(B, fb), out, mesh, mul_to=mul_to,
            add_formats=layers, strategy=strat)), want)
    route_sharded_ktree_complex(sw, mesh)


def route_sharded_ktree_complex(sw: Sweep, mesh):
    """The complex and reduce k_tree strategies against the single-device
    calls."""
    from .parallel import sharded_cgemul_k_tree, sharded_qreduce_k_tree

    f = qformat(4, 4, overflow_mode=OverflowMode.SAT_ZERO)
    out = (f, qformat(5, 3, round_mode=RoundMode.RND_CONV))
    kw = dict(algo="tf", add_formats=(qformat(6, 4),))
    try:
        ca = QComplexTensor(sw.q(_raws(f, 96, "ckta").reshape(3, 32), f),
                            sw.q(_raws(f, 96, "cktb").reshape(3, 32), f))
        cb = QComplexTensor(sw.q(_raws(f, 128, "cktc").reshape(32, 4), f),
                            sw.q(_raws(f, 128, "cktd").reshape(32, 4), f))
        got = sharded_cgemul_k_tree(ca, cb, out, mesh, **kw)
        ref = cgemul(ca, cb, out, **kw)
        ok = (ints(got.real) == ints(ref.real)
              and ints(got.imag) == ints(ref.imag))
        xv = sw.q(_raws(f, 32, "ckte"), f)
        gr = sharded_qreduce_k_tree(xv, (f,), mesh=mesh)
        rr = qreduce(xv, (f,))
        ok = ok and ints(gr) == ints(rr) and gr.fmt == rr.fmt
    except Exception as e:  # noqa: BLE001
        sw.fail("CRASH", "shard.cgemul+reduce_k_tree", type(e).__name__,
                str(e)[:200])
        return
    if not ok:
        sw.fail("shard.cgemul+reduce_k_tree", "diverges from the "
                "single-device calls")


def sweep_routes(sw: Sweep, trials=1):
    """The curated cases of tools/tpu_differential.py that run on one
    device (the sharded ones run in the world, :func:`_world_rank`)."""
    for fn in (route_elementwise, route_casts, route_reduce, route_gemm,
               route_cgemm, route_anus, route_bitwise):
        fn(sw)
    return 1


# ---------------------------------------------------------------------------
# the kernel families: generators steered into each kernel's envelope
# ---------------------------------------------------------------------------

def lane_fmt(rng, lo, hi, modes=None, signed=None):
    """A format of lo..hi storage bits (sign included), int bits from -2
    up, with random or given modes."""
    while True:
        w = int(rng.randint(lo, hi + 1))
        s = bool(rng.randint(0, 2)) if signed is None else signed
        body = w - int(s)
        i = int(rng.randint(-2, body + 3))
        f = body - i
        if body >= 1 and -2 <= f:
            break
    rm, om = MODES[rng.randint(0, len(MODES))] if modes is None else modes
    return qformat(i, f, s, rm, om)


def rand_dim(rng, hi=200):
    """1..hi, a tile edge in a third of the draws."""
    if rng.randint(0, 3) == 0:
        return int(rng.choice([e for e in TILE_EDGES if e <= hi] or [hi]))
    return int(rng.randint(1, hi + 1))


def rand_k(rng, s=16, hi=2100):
    """1..hi, s 2^j +- 1 in a third of the draws."""
    if rng.randint(0, 3) == 0:
        j = int(rng.randint(0, max((hi // s).bit_length(), 1)))
        return int(min(max(s * (1 << j) + rng.randint(-1, 2), 1), hi))
    return int(rng.randint(1, hi + 1))


def raws_array(rng, fmt, shape):
    """Uniform raws of a lane or pair format as an int64 array."""
    return rng.randint(fmt.raw_min, fmt.raw_max + 1, size=shape,
                       dtype=np.int64)


VIEWS = ("contig", "transposed", "strided", "offset16", "offset1")


def place(x: np.ndarray, dtype, device, view: str) -> torch.Tensor:
    """The 2-D raws ``x`` as a ``dtype`` tensor on ``device`` in one of
    :data:`VIEWS`: contiguous rows, the transpose of a contiguous tensor,
    rows of a wider tensor, or a contiguous tensor whose base is 16 bytes
    (or one element) past an allocation's."""
    t = torch.from_numpy(np.ascontiguousarray(x)).to(dtype)
    r, c = t.shape
    if view == "transposed":
        return t.t().contiguous().to(device).t()
    if view == "strided":
        buf = torch.zeros((r, c + 3), dtype=dtype, device=device)
        buf[:, :c] = t.to(device)
        return buf[:, :c]
    if view in ("offset16", "offset1"):
        off = 16 // t.element_size() if view == "offset16" else 1
        buf = torch.zeros(off + r * c, dtype=dtype, device=device)
        v = buf[off:].view(r, c)
        v.copy_(t.to(device))
        return v
    return t.to(device)


def _corner(m, n, k, limit=ORACLE_PRODUCTS):
    """The output positions that hostops checks: all of them while m n k
    stays within ``limit`` products, else corners, as many as ``limit``
    products allow (one at least)."""
    if m * n * k <= limit:
        return [(i, j) for i in range(m) for j in range(n)]
    pos = []
    for p in ((0, 0), (m - 1, n - 1), (0, n - 1), (m - 1, 0)):
        if p not in pos:
            pos.append(p)
    return pos[:max(limit // k, 1)]


def _oracle_at(A, B, fa, fb, out, mul_to, layers, pos):
    """hostops.qgemul's raws at the output positions ``pos``."""
    return [_host_gemm(A[i:i + 1], B[:, j:j + 1], fa, fb, out, mul_to,
                       layers)[0][0][0] for i, j in pos]


def _grid(x):
    """A 2-D result (a QTensor, or an integer tensor) as nested lists of
    Python ints."""
    if isinstance(x, QTensor):
        return [[int(v) for v in row]
                for row in np.asarray(x.raw(), dtype=object)]
    return x.cpu().tolist()


def _hold(sw: Sweep, what, dev_out, cpu_out, want, pos):
    """The kernel's output against the plain version's (on the card), and
    the plain version's raws at the positions ``pos`` against the
    oracle's ``want``.  The outputs are integer tensors or QTensors
    (formats compared too)."""
    if sw.on_card:
        if isinstance(cpu_out, torch.Tensor):
            d = dev_out.cpu()
            same = d.dtype == cpu_out.dtype and d.shape == cpu_out.shape \
                and torch.equal(d, cpu_out)
        else:
            same = dev_out.fmt == cpu_out.fmt \
                and _grid(dev_out) == _grid(cpu_out)
        if not same:
            sw.fail(what, "kernel != plain")
            return
    g = _grid(cpu_out)
    got = [g[r][c] for r, c in pos]
    if got != want:
        first = next(i for i, (x, y) in enumerate(zip(got, want)) if x != y)
        sw.fail(what, "plain != hostops at", pos[first], got[first],
                want[first])


# -- K1 ---------------------------------------------------------------------

def k1_case(t):
    """A lossless K1 configuration: ``exact_plan`` proves it and its
    epilogue runs on int32 lanes, with any of the 35 output mode pairs.
    Kinds by t % 6: 0-2 the kernel called directly on random views (int8
    lanes, the s32 instantiation at t % 12 == 2, the largest shapes at
    t % 12 == 1), 3 ``qgemul`` with a batch dim and transposes, 4 the int64
    tier's segment dots, 5 the limb tier's digit dots (both on ``int_dot``)."""
    rng = rng_for("k1", t)
    kind = ("gemm", "gemm", "gemm", "qgemul", "wide", "limb")[t % 6]
    for _ in range(400):
        if kind == "wide":
            # 11..15-bit lane operands, a dot beyond int32 within int64
            fa = lane_fmt(rng, 11, 15, signed=True)
            fb = lane_fmt(rng, 11, 15, signed=True)
            k = int(rng.randint(64, 400))
            out = lane_fmt(rng, 20, 60)
        elif kind == "limb":
            fa = qformat(int(rng.randint(20, 30)), int(rng.randint(4, 14)))
            fb = qformat(int(rng.randint(20, 30)), int(rng.randint(4, 14)))
            k = int(rng.randint(2, 40))
            out = lane_fmt(rng, 40, 90)
        else:
            wide_lane = t % 12 == 2
            hi = 14 if wide_lane else 8
            fa = lane_fmt(rng, 9 if wide_lane else 2, hi)
            fb = lane_fmt(rng, 2, hi)
            k = rand_k(rng, 16, 2100 if t % 12 == 1 else 300)
            if rng.randint(0, 2):
                k = max(k // 16, 1) * 16   # what TMA reads in place
            out = lane_fmt(rng, 2, 31)
        pf = fa.frac_bits + fb.frac_bits
        mul_to = qformat(fa.int_bits + fb.int_bits + 2,
                         pf + int(rng.randint(0, 3)), True,
                         *MODES[rng.randint(0, len(MODES))])
        layers = (qformat(mul_to.int_bits + k.bit_length() + 1,
                          mul_to.frac_bits, True,
                          *MODES[rng.randint(0, len(MODES))]),)
        plan = G.exact_plan(fa, fb, mul_merge(fa, fb, mul_to, False), layers,
                            k)
        if plan is None:
            continue
        if kind in ("gemm", "qgemul"):
            ok = G._device_epilogue_ok(plan, out)
        elif kind == "wide":
            ok = not plan.dot_interval.fits32 \
                and G._wide_epilogue_ok(plan, out)
        else:
            ok = not plan.dot_interval.fits64 \
                and G.limb_dot_plan(fa, fb, out, plan, k, 3, 3) is not None
        if ok:
            break
    if plan is None:
        raise NoCase("no exact_plan plan in 400 draws")
    if t % 12 == 1:
        m, n = rand_dim(rng, 200), rand_dim(rng, 200)
    else:
        m, n = rand_dim(rng, 40), rand_dim(rng, 40)
    if kind == "limb":
        m, n = int(rng.randint(1, 4)), int(rng.randint(1, 4))
    elif kind == "wide":
        m, n = int(rng.randint(1, 9)), int(rng.randint(1, 9))
    A, B = raws_array(rng, fa, (m, k)), raws_array(rng, fb, (k, n))
    return dict(kind=kind, fa=fa, fb=fb, mul_to=mul_to, layers=layers,
                out=out, plan=plan, A=A, B=B,
                views=(VIEWS[rng.randint(0, len(VIEWS))],
                       VIEWS[rng.randint(0, len(VIEWS))]),
                batch=int(rng.choice([1, 2, 3])),
                trans=(bool(rng.randint(0, 2)), bool(rng.randint(0, 2))))


def k1_operands(case, device):
    """The case's A and B on ``device`` as K1 reads them: lane tensors in
    the case's views (B as the transposed view of a K-major tensor where
    its view is "transposed")."""
    a = place(case["A"], torch_dtype_for(case["fa"]), device, case["views"][0])
    b = place(case["B"], torch_dtype_for(case["fb"]), device, case["views"][1])
    return a, b


def k1_check(sw: Sweep, case, t):
    kind, fa, fb, out = case["kind"], case["fa"], case["fb"], case["out"]
    mul_to, layers, A, B = (case["mul_to"], case["layers"], case["A"],
                            case["B"])
    plan = case["plan"]
    what = f"k1[{t}] {kind} {fa} {fb} {out} {layers} {A.shape}@{B.shape}"
    try:
        m, k = A.shape
        n = B.shape[1]
        pos = _corner(m, n, k)
        want = _oracle_at(A, B, fa, fb, out, mul_to, layers, pos)
        if kind == "gemm":
            ac, bc = k1_operands(case, "cpu")
            cpu = fused_int8_gemm(ac, bc, plan.prod_frac, out)
            dev = None
            if sw.on_card:
                a, b = k1_operands(case, sw.device)
                dev = fused_int8_gemm(a, b, plan.prod_frac, out)
            _hold(sw, what, dev, cpu, want, pos)
            return

        def call(device):
            if kind == "qgemul":
                bsz = case["batch"] if m % case["batch"] == 0 else 1
                ta, tb = case["trans"]
                a = torch.from_numpy(A.reshape(bsz, m // bsz, k))
                b = torch.from_numpy(B)
                a = a.transpose(-1, -2).contiguous() if ta else a
                b = b.t().contiguous() if tb else b
                r = G.qgemul(QTensor(a.to(torch_dtype_for(fa)).to(device), fa),
                             QTensor(b.to(torch_dtype_for(fb)).to(device), fb),
                             out, mul_to=mul_to, add_formats=layers,
                             transpose_a=ta, transpose_b=tb)
                return r.data.reshape(m, n)
            with G.force_tiers_off("limb") if kind == "wide" \
                    else nullcontext():
                return G.qgemul(from_raw(A, fa, device=device),
                                from_raw(B, fb, device=device), out,
                                mul_to=mul_to, add_formats=layers)

        _hold(sw, what, call(sw.device) if sw.on_card else None, call("cpu"),
              want, pos)
    except Exception as e:  # noqa: BLE001
        sw.fail("CRASH", what, type(e).__name__, str(e)[:200])


def sweep_k1(sw: Sweep, trials):
    for t in range(trials):
        case = draw(sw, "k1", t, k1_case)
        if case is not None:
            k1_check(sw, case, t)
    return trials


# -- K2 and K2′ ---------------------------------------------------------------

TZ = (RoundMode.TRN_TCPL, OverflowMode.SAT_ZERO)
# K2's six instantiations (csrc/tree_gemm_tiled_{8,32}_{0,1,2}.cu): an
# 8-level slot stack below k = 4096 or 32 levels, modes read at run time
# (0) or (TRN::TCPL, SAT::ZERO) compiled in with the int32 (1) or 64-bit
# (2) product routes
K2_INSTANCES = tuple(f"tiled_{top}_{m}" for top in (8, 32) for m in (0, 1, 2))


def tree_config(rng, modes, pair_route, k):
    """Formats of a tree GEMM configuration for ``plan_tree``: lane
    operands, a product format and 1-3 layer formats with the pair
    ``modes`` (random pairs where None), the product on the 64-bit route
    where ``pair_route``, any output lane."""
    if pair_route:
        fa, fb = lane_fmt(rng, 22, 26), lane_fmt(rng, 12, 16)
        mul_to = lane_fmt(rng, 18, 25, modes)
    else:
        fa, fb = lane_fmt(rng, 2, 12), lane_fmt(rng, 2, 12)
        mul_to = lane_fmt(rng, 4, 20, modes)
    layers = tuple(lane_fmt(rng, 6, 24, modes)
                   for _ in range(rng.randint(1, 4)))
    out = lane_fmt(rng, 2, 31)
    plan = TG.plan_tree(fa, fb, mul_merge(fa, fb, mul_to, False), layers, k,
                        out)
    # a product whose requantize needs limbs is no plan of the kernels'
    if plan is not None and plan.prod_route not in TG.ROUTES:
        plan = None
    return fa, fb, mul_to, layers, out, plan


def k2_case(t, tag="k2"):
    """A ``plan_tree`` configuration aimed, by t % 6, at K2's instantiation
    ``K2_INSTANCES[t % 6]``: k from 4096 for the 32-level stack, the modes
    of every step (TRN::TCPL, SAT::ZERO) for the compiled ones (the 64-bit
    product route for ``*_2``), random modes (and either route) for the
    run-time ones.  Up to 400 draws; the last valid one where none hits."""
    rng = rng_for(tag, t)
    target = K2_INSTANCES[t % 6]
    top, modes = int(target.split("_")[1]), int(target.split("_")[2])
    best = None
    for _ in range(400):
        # from k = 4096 mostly whole 16-product blocks (the plain version
        # folds blocks of the largest power of two dividing k), a ragged k
        # in a quarter of the trials
        k = (4096 + 16 * int(rng.randint(0, 13))
             + (int(rng.randint(1, 16)) if t % 4 == 3 else 0)) \
            if top == 32 else rand_k(rng, 16)
        pair = modes == 2 or (modes == 0 and rng.randint(0, 3) == 0)
        fa, fb, mul_to, layers, out, plan = tree_config(
            rng, TZ if modes else None, pair, k)
        if plan is None:
            continue
        best = (fa, fb, mul_to, layers, out, plan, k)
        if TG.k2_modes(plan) == modes:
            break
    if best is None:
        raise NoCase("no plan_tree plan in 400 draws")
    fa, fb, mul_to, layers, out, plan, k = best
    if top == 32:
        m, n = int(rng.randint(1, 7)), int(rng.randint(1, 7))
    elif t % 12 == 5:
        m, n = rand_dim(rng, 200), rand_dim(rng, 200)
    else:
        m, n = rand_dim(rng, 48), rand_dim(rng, 48)
    return dict(fa=fa, fb=fb, mul_to=mul_to, layers=layers, out=out,
                plan=plan, A=raws_array(rng, fa, (m, k)),
                B=raws_array(rng, fb, (k, n)),
                views=(VIEWS[rng.randint(0, len(VIEWS))],
                       VIEWS[rng.randint(0, len(VIEWS))]))


def k2s_case(t):
    """A ``plan_tree`` configuration for K2′: by t % 4, the canonical
    ``Qu<8,8,TRN::TCPL,SAT::ZERO>`` plan (the instantiation of
    ``K2S_PLANS``, k2s_plan 1) at any k, a plan at k from 4096 (the
    32-level stack), or random plans at any k (steps read at run time)."""
    if t % 4 == 0:
        rng = rng_for("k2s", t)
        f = qformat(8, 8, True, *MODES[rng.randint(0, len(MODES))])
        z = qformat(8, 8, True, *TZ)
        k = rand_k(rng, 32, 2100)
        for _ in range(400):
            out = lane_fmt(rng, 2, 31)
            plan = TG.plan_tree(f, f, mul_merge(f, f, z, False), (z,), k,
                                out)
            if plan is not None:
                break
        else:
            raise NoCase("no plan_tree plan in 400 draws")
        m, n = rand_dim(rng, 64), rand_dim(rng, 64)
        return dict(fa=f, fb=f, mul_to=z, layers=(z,), out=out, plan=plan,
                    A=raws_array(rng, f, (m, k)), B=raws_array(rng, f, (k, n)),
                    views=(VIEWS[rng.randint(0, len(VIEWS))],
                           VIEWS[rng.randint(0, len(VIEWS))]))
    # k2_case's run-time targets: the 32-level stack at t % 4 == 1, else
    # the 8-level one
    return k2_case(6 * t + (3 if t % 4 == 1 else 0), "k2s")


def tree_operands(case, device):
    a = place(case["A"], torch_dtype_for(case["fa"]), device, case["views"][0])
    b = place(case["B"], torch_dtype_for(case["fb"]), device, case["views"][1])
    return a, b


def _tree_check(sw: Sweep, case, t, kernel, name):
    fa, fb, out = case["fa"], case["fb"], case["out"]
    A, B, plan = case["A"], case["B"], case["plan"]
    what = (f"{name}[{t}] {fa} {fb} mul_to={case['mul_to']} "
            f"{case['layers']} {out} {A.shape}@{B.shape} {case['views']}")
    try:
        m, k = A.shape
        pos = _corner(m, B.shape[1], k)
        want = _oracle_at(A, B, fa, fb, out, case["mul_to"], case["layers"],
                          pos)
        dev = None
        if sw.on_card:
            a, b = tree_operands(case, sw.device)
            dev = kernel(a, b, plan, out)
        ac, bc = tree_operands(case, "cpu")
        _hold(sw, what, dev, kernel(ac, bc, plan, out), want, pos)
    except Exception as e:  # noqa: BLE001
        sw.fail("CRASH", what, type(e).__name__, str(e)[:200])


def _sweep_tree(sw: Sweep, trials, tag, gen, kernel):
    for t in range(trials):
        case = draw(sw, tag, t, gen)
        if case is not None:
            _tree_check(sw, case, t, kernel, tag)
    return trials


def sweep_k2(sw: Sweep, trials):
    return _sweep_tree(sw, trials, "k2", k2_case, TG.tree_gemm)


def sweep_k2s(sw: Sweep, trials):
    return _sweep_tree(sw, trials, "k2s", k2s_case, TG.tree_gemm_stream)


# -- K2h ----------------------------------------------------------------------

# the tail modes of K2h's compiled instantiations (tree_gemm.K2H_MODES):
# (tree level L's pair, the pair of every level above it)
K2H_TAILS = (None, (TZ, TZ),
             ((RoundMode.TRN_TCPL, OverflowMode.SAT_TCPL), TZ))


def k2h_case(t):
    """A ``plan_hybrid`` configuration: by t % 2 int8 x int8 lanes (the
    tensor-core kernel) or an int16 operand (the IMAD kernel); a lossless
    prefix of L = 3..5 layers (s = 2^L) whose fraction grows by dl = 0..2
    bits; a lossy tail with, by (t // 2) % 3, random modes or the modes of
    one of the tensor-core kernel's compiled instantiations; k = s times an
    odd block count (so no multiple of 2s) in two trials of three."""
    rng = rng_for("k2h", t)
    mma = t % 2 == 0
    tail_modes = K2H_TAILS[(t // 2) % 3]
    best = None
    for _ in range(400):
        fa = lane_fmt(rng, 2, 8) if mma else lane_fmt(rng, 9, 12)
        fb = lane_fmt(rng, 2, 8)
        L, dl = int(rng.randint(3, 6)), int(rng.randint(0, 3))
        pf = fa.frac_bits + fb.frac_bits
        mul_to = qformat(fa.int_bits + fb.int_bits + 1, pf + dl, True,
                         *MODES[rng.randint(0, len(MODES))])
        prefix = [qformat(mul_to.int_bits + l + 1, mul_to.frac_bits, True,
                          *MODES[rng.randint(0, len(MODES))])
                  for l in range(L)]
        top = prefix[-1]
        tail = []
        for j in range(int(rng.randint(1, 3))):
            pair = MODES[rng.randint(0, len(MODES))] if tail_modes is None \
                else tail_modes[min(j, 1)]
            tail.append(qformat(int(rng.randint(max(top.int_bits - 6, 1),
                                                top.int_bits + 2)),
                                int(rng.randint(min(top.frac_bits, 0),
                                                max(top.frac_bits, 0) + 1)),
                                True, *pair))
        if tail_modes is not None and len(tail) == 1:
            tail.append(qformat(tail[0].int_bits, tail[0].frac_bits, True,
                                *tail_modes[1]))
        layers = tuple(prefix + tail)
        s = 1 << L
        nb = int(rng.randint(1, max(2100 // s, 2)))
        if t % 3:
            nb |= 1
        k = s * nb
        out = lane_fmt(rng, 2, 24)
        hp = TG.plan_hybrid(fa, fb, mul_merge(fa, fb, mul_to, False), layers,
                            k, out)
        if hp is None:
            continue
        best = (fa, fb, mul_to, layers, out, hp, k)
        if not mma or TG.k2h_modes(hp, k) == (t // 2) % 3:
            break
    if best is None:
        raise NoCase("no plan_hybrid plan in 400 draws")
    fa, fb, mul_to, layers, out, hp, k = best
    m, n = (rand_dim(rng, 160), rand_dim(rng, 160)) if t % 8 == 3 \
        else (rand_dim(rng, 40), rand_dim(rng, 40))
    return dict(fa=fa, fb=fb, mul_to=mul_to, layers=layers, out=out,
                plan=hp, A=raws_array(rng, fa, (m, k)),
                B=raws_array(rng, fb, (k, n)),
                views=(VIEWS[rng.randint(0, len(VIEWS))],
                       VIEWS[rng.randint(0, len(VIEWS))]))


def sweep_k2h(sw: Sweep, trials):
    return _sweep_tree(sw, trials, "k2h", k2h_case, TG.tree_gemm_hybrid)


# -- K3 ---------------------------------------------------------------------

# storage bits of formats in lanes of 1, 2 and 4 bytes
K3_WIDTHS = ((2, 8), (9, 16), (17, 24))
# the layer modes of K3's compiled instantiations (reduce.K3_MODES):
# (layer 0's pair, the pair of every layer above it)
K3_TAILS = (((RoundMode.RND_CONV, OverflowMode.SAT_ZERO),
             (RoundMode.TRN_TCPL, OverflowMode.SAT_TCPL)), (TZ, TZ))


def k3_case(t):
    """A ``plan_reduce`` configuration: by t % 3 rows for the warp kernel
    (32 | n; a base 16 bytes off an allocation in a third of them), for
    the thread kernel (32 does not divide n), or a middle axis for the
    columns kernel; lanes of 1, 2 or 4 bytes by (t // 3) % 3; the layers'
    modes those of a compiled instantiation at t % 5 < 2, else random.
    Every 8th trial is instead the layered GEMM (``qgemul``'s [m, k, n]
    products reduced over k, then cast to a pair-storage output)."""
    rng = rng_for("k3", t)
    if t % 8 == 7:
        return k3_layered_case(rng)
    route = ("warp", "thread", "columns")[t % 3]
    widths = K3_WIDTHS[(t // 3) % 3]
    tails = K3_TAILS[t % 5] if t % 5 < 2 else None
    for _ in range(400):
        fmt = lane_fmt(rng, *widths)
        nl = int(rng.randint(1, 4))
        layers = tuple(lane_fmt(rng, 8, 30, None if tails is None
                                else tails[min(j, 1)]) for j in range(nl))
        if route == "warp":
            n = 32 * int(rng.randint(1, 66))
        elif route == "thread":
            n = int(rng.randint(2, 2100))
            n += n % 32 == 0
        else:
            n = int(rng.randint(2, 300))
        plan = plan_reduce(fmt, layers, n)
        if plan is not None and (tails is None or plan.modes):
            break
    if plan is None:
        raise NoCase("no plan_reduce lane plan in 400 draws")
    rows = int(rng.randint(1, 65))
    inner = int(rng.randint(2, 9)) if route == "columns" else 1
    view = "offset16" if route == "warp" and rng.randint(0, 3) == 0 \
        else "contig"
    return dict(kind="kernel", fmt=fmt, layers=layers, plan=plan, view=view,
                X=raws_array(rng, fmt, (rows, n, inner) if inner > 1
                             else (rows, n)))


def k3_layered_case(rng):
    """A GEMM that qgemul sends to its layered tier with K3 reducing over
    k: a product that rounds (so no lossless tier or the hybrid takes it),
    lane-proven layers (``plan_reduce``), an output in pair storage
    (which ``plan_tree`` refuses)."""
    for _ in range(400):
        fa, fb = lane_fmt(rng, 2, 8), lane_fmt(rng, 2, 8)
        pf = fa.frac_bits + fb.frac_bits
        mul_to = qformat(fa.int_bits + fb.int_bits,
                         max(pf - 1 - rng.randint(0, 3), -2), True,
                         *MODES[rng.randint(0, len(MODES))])
        layers = tuple(lane_fmt(rng, 8, 24) for _ in range(rng.randint(1, 3)))
        out = lane_fmt(rng, 34, 60)
        k = int(rng.randint(2, 80))
        if plan_reduce(mul_merge(fa, fb, mul_to, False), layers, k) \
                is not None:
            break
    m, n = int(rng.randint(1, 12)), int(rng.randint(1, 12))
    return dict(kind="layered", fa=fa, fb=fb, mul_to=mul_to, layers=layers,
                out=out, A=raws_array(rng, fa, (m, k)),
                B=raws_array(rng, fb, (k, n)))


def k3_operand(case, device):
    """The case's x on ``device``, and the axis K3 reduces."""
    X, dt = case["X"], torch_dtype_for(case["fmt"])
    if X.ndim == 3:
        return torch.from_numpy(X).to(dt).to(device), 1
    return place(X, dt, device, case["view"]), 1


def k3_check(sw: Sweep, case, t):
    if case["kind"] == "layered":
        fa, fb, out = case["fa"], case["fb"], case["out"]
        A, B = case["A"], case["B"]
        what = (f"k3[{t}] layered {fa} {fb} mul_to={case['mul_to']} "
                f"{case['layers']} {out} {A.shape}@{B.shape}")
        try:
            pos = _corner(A.shape[0], B.shape[1], A.shape[1])
            want = _oracle_at(A, B, fa, fb, out, case["mul_to"],
                              case["layers"], pos)

            def call(device):
                r = G.qgemul(from_raw(A, fa, device=device),
                             from_raw(B, fb, device=device), out,
                             mul_to=case["mul_to"],
                             add_formats=case["layers"])
                return r.data

            _hold(sw, what, call(sw.device) if sw.on_card else None,
                  call("cpu"), want, pos)
        except Exception as e:  # noqa: BLE001
            sw.fail("CRASH", what, type(e).__name__, str(e)[:200])
        return
    fmt, layers, plan, X = case["fmt"], case["layers"], case["plan"], case["X"]
    what = f"k3[{t}] {fmt} {layers} {X.shape} {case['view']}"
    try:
        xc, axis = k3_operand(case, "cpu")
        cpu = qreduce_kernel(xc, axis, plan)
        if sw.on_card and not torch.equal(
                qreduce_kernel(k3_operand(case, sw.device)[0], axis,
                               plan).cpu(), cpu):
            sw.fail(what, "kernel != plain")
            return
        pos = [(0, 0), (X.shape[0] - 1, X.shape[2] - 1 if X.ndim == 3 else 0)]
        for r, c in pos:
            col = X[r, :, c] if X.ndim == 3 else X[r]
            want, _ = hostops.qreduce_list([(int(v), fmt) for v in col],
                                           layers)
            got = int(cpu[r, c] if X.ndim == 3 else cpu[r])
            if got != want:
                sw.fail(what, "plain != hostops at", (r, c), got, want)
    except Exception as e:  # noqa: BLE001
        sw.fail("CRASH", what, type(e).__name__, str(e)[:200])


def sweep_k3(sw: Sweep, trials):
    for t in range(trials):
        case = draw(sw, "k3", t, k3_case)
        if case is not None:
            k3_check(sw, case, t)
    return trials


# -- P1 -----------------------------------------------------------------------

P1_STEPS = (0, 1, 7, 33, 101, 255)


def p1_case(t):
    """A ``plan_tree`` plan whose layer 0 writes the x operand's own
    format, so that a chain's v stays an x raw, inside the plan's proof,
    unless an overflow mode leaves raws beyond the format (``WRP::
    TCPL_SAT`` wraps at the storage word): the canonical plan
    (``K2S_PLANS``, p1_plan 1) at t % 3 == 0, else random lanes and modes
    (steps read at run time); steps 0, 1, odd and large by (t // 3) % 6;
    tiles from 1 x 1 to ``measured_chain_prods``' 128 x 256."""
    rng = rng_for("p1", t)
    for _ in range(400):
        if t % 3 == 0:
            fa = fb = qformat(8, 8, True, *MODES[rng.randint(0, len(MODES))])
            mul_to = layer0 = qformat(8, 8, True, *TZ)
        else:
            fa, fb = lane_fmt(rng, 2, 16), lane_fmt(rng, 2, 16)
            mul_to = lane_fmt(rng, 4, 24)
            layer0 = qformat(fa.int_bits, fa.frac_bits, fa.signed,
                             *MODES[rng.randint(0, len(MODES))])
        plan = TG.plan_tree(fa, fb, mul_merge(fa, fb, mul_to, False),
                            (layer0,), int(rng.randint(2, 64)), layer0)
        if plan is not None and plan.prod_route in TG.ROUTES:
            break
    else:
        raise NoCase("no plan_tree plan on a lane route in 400 draws")
    shape = (128, 256) if t % 10 == 9 else (int(rng.randint(1, 70)),
                                            int(rng.randint(1, 70)))
    return dict(fa=fa, fb=fb, plan=plan, steps=P1_STEPS[(t // 3) % 6],
                programs=int(rng.randint(1, 4)),
                X=raws_array(rng, fa, shape), Y=raws_array(rng, fb, shape))


def p1_oracle(plan, x: int, y: int, steps: int, x_iv):
    """One chain on Python ints: ``steps`` requantized products v y, each
    added to itself and requantized into layer 0 (``hostint``); None once
    v leaves ``x_iv``, the x operand's interval in the plan's proof.
    Beyond it the chain is the kernels' int32 lanes, which the plain
    version (held to the JAX package's ``_product``/``_merge`` loop by
    ``tests/test_torch_chain_probe.py``) defines and Python ints do not
    model."""
    v = x
    for _ in range(steps):
        if not x_iv.lo <= v <= x_iv.hi:
            return None
        p = hostint.requantize(v * y, plan.prod_frac, plan.mul_fmt)
        v = hostint.requantize(p + p, plan.level_fmts[0].frac_bits,
                               plan.merge_fmts[0])
    return v


def p1_check(sw: Sweep, case, t):
    plan, X, Y = case["plan"], case["X"], case["Y"]
    steps, programs = case["steps"], case["programs"]
    what = (f"p1[{t}] {case['fa']} {case['fb']} {plan.mul_fmt} "
            f"{plan.merge_fmts[0]} steps={steps} programs={programs} "
            f"{X.shape}")
    try:
        def call(device):
            return chain_probe(
                torch.from_numpy(X).to(torch_dtype_for(case["fa"])).to(device),
                torch.from_numpy(Y).to(torch_dtype_for(case["fb"])).to(device),
                plan, steps, programs)

        cpu = call("cpu")
        if sw.on_card and not torch.equal(call(sw.device).cpu(), cpu):
            sw.fail(what, "kernel != plain")
            return
        flat_x, flat_y = X.reshape(-1), Y.reshape(-1)
        got = cpu.reshape(programs, -1)
        x_iv = fmt_interval(case["fa"])
        for i in sorted({0, 1, 2, flat_x.size - 1} & set(range(flat_x.size))):
            want = p1_oracle(plan, int(flat_x[i]), int(flat_y[i]), steps,
                             x_iv)
            if want is None:
                sw.p1_past += 1
                continue
            sw.p1_held += 1
            if any(int(got[p, i]) != want for p in range(programs)):
                sw.fail(what, "plain != hostint at", i, int(got[0, i]), want)
    except Exception as e:  # noqa: BLE001
        sw.fail("CRASH", what, type(e).__name__, str(e)[:200])


def sweep_p1(sw: Sweep, trials):
    """P1's trials; fails where more than :data:`P1_MAX_PAST` of the
    sampled chains left the proof, which would leave the plain version
    without its oracle."""
    held, past = sw.p1_held, sw.p1_past
    for t in range(trials):
        case = draw(sw, "p1", t, p1_case)
        if case is not None:
            p1_check(sw, case, t)
    held, past = sw.p1_held - held, sw.p1_past - past
    sw.notes["p1"] = (f"{held} chains held to hostint, {past} past the "
                      f"proof")
    if past > P1_MAX_PAST * (held + past):
        sw.fail(f"p1[0:{trials}]", f"{past} of {held + past} sampled "
                f"chains left the proof (more than {P1_MAX_PAST:.0%})")
    return trials


# ---------------------------------------------------------------------------
# the run: families, the world, the gate
# ---------------------------------------------------------------------------

# (name, function): the families run in this process, in order
FAMILIES = (
    ("routes", sweep_routes),
    ("elementwise", sweep_elementwise),
    ("cast", sweep_cast),
    ("reduce", sweep_reduce),
    ("gemm", sweep_gemm),
    ("gemm_limbwide", sweep_gemm_limbwide),
    ("complex", sweep_complex),
    ("cgemul", sweep_cgemul),
    ("anus", sweep_anus),
    ("bitstream", sweep_bitstream),
    ("bitwise", sweep_bitwise),
    ("k1", sweep_k1),
    ("k2", sweep_k2),
    ("k2s", sweep_k2s),
    ("k2h", sweep_k2h),
    ("k3", sweep_k3),
    ("p1", sweep_p1),
)
# the families that run in the world of WORLD ranks
WORLD_FAMILIES = ("routes_sharded", "sharded", "sharded_ktree")
FAMILY_NAMES = tuple(n for n, _ in FAMILIES) + WORLD_FAMILIES

# the rows of chip_smoke.py's kernels line: (name, wrapper, its launch
# count, the family steered into it, the prefix of the row's
# instantiations in the wrapper's ``seen``)
KERNELS = (
    ("fused_int8_gemm", fused_int8_gemm, "launches", "k1", ""),
    ("tree_gemm", TG.tree_gemm, "launches", "k2", ""),
    ("tree_gemm_stream", TG.tree_gemm_stream, "launches", "k2s", ""),
    ("qreduce_kernel", qreduce_kernel, "launches", "k3", ""),
    ("chain_probe", chain_probe, "launches", "p1", ""),
    ("tree_gemm_hybrid_mma", TG.tree_gemm_hybrid, "mma_launches", "k2h",
     "mma"),
    ("tree_gemm_hybrid", TG.tree_gemm_hybrid, "imad_launches", "k2h",
     "imad"),
)


def trial_counts(trials: int) -> dict:
    """Trials a family for ``trials`` a family: ``tools/deep_fuzz.py``'s
    scaling for its families, one pass of the route cases, and
    max(trials // 25, 48) for each kernel family."""
    kern = max(trials // 25, 48)
    return {"routes": 1, "routes_sharded": 1,
            "elementwise": trials, "cast": trials,
            "reduce": max(trials // 4, 50), "gemm": max(trials // 6, 50),
            "gemm_limbwide": max(trials // 6, 50),
            "complex": max(trials // 2, 50), "cgemul": max(trials // 6, 50),
            "anus": max(trials // 3, 50), "bitstream": trials,
            "sharded": max(trials // 10, 30),
            "sharded_ktree": max(trials // 10, 30),
            "bitwise": max(trials // 4, 50),
            "k1": kern, "k2": kern, "k2s": kern, "k2h": kern, "k3": kern,
            "p1": kern}


def _world_rank(jobs, device):
    """One rank of the sharded families: every rank runs every trial on
    its meshes and returns its counts and repro lines."""
    from .parallel import make_mesh

    sw = Sweep(device, echo=False)
    stats = []
    for name, trials in jobs:
        f0, c0, r0 = sw.fails, sw.crashes, sw.refusals
        t0 = time.perf_counter()
        if name == "routes_sharded":
            route_sharded(sw, make_mesh(1, WORLD, device))
            done = 1
        elif name == "sharded":
            done = sweep_sharded(sw, trials, make_mesh(1, WORLD, device))
        else:
            done = sweep_sharded_ktree(sw, trials,
                                       [make_mesh(1, WORLD, device),
                                        make_mesh(WORLD, 1, device)])
        stats.append((name, done, sw.fails - f0, sw.crashes - c0,
                      time.perf_counter() - t0, sw.refusals - r0))
    return {"stats": stats, "lines": sw.lines}


def reset_counts():
    """Every kernel's launch counts to 0 and its launch record emptied."""
    for _, owner, attr, _, _ in KERNELS:
        setattr(owner, attr, 0)
        owner.seen = Counter()
    TG.tree_gemm_hybrid.launches = 0


def mode_pairs(owner, prefix="", suffix=""):
    """The distinct (round, overflow) pairs of the launches of ``owner``
    whose instantiation starts with ``prefix`` and ends with ``suffix``."""
    pairs = set()
    for (inst, ps), _ in owner.seen.items():
        if inst.startswith(prefix) and inst.endswith(suffix):
            pairs.update(ps)
    return pairs


def kernel_report() -> list:
    """One dict a kernel row: launches, distinct mode pairs (K1's on its
    epilogue), launches by instantiation."""
    rows = []
    for name, owner, attr, _, prefix in KERNELS:
        inst = Counter()
        for (i, _), c in owner.seen.items():
            if i.startswith(prefix):
                inst[i] += c
        pairs = mode_pairs(owner, "gemm/" if owner is fused_int8_gemm
                           else prefix)
        rows.append({"name": name, "launches": getattr(owner, attr),
                     "mode_pairs": len(pairs),
                     "instances": dict(sorted(inst.items()))})
    return rows


def gate(families) -> list:
    """What the card run of ``families`` failed to reach (see the module's
    docstring); empty when it reached everything."""
    bad = []
    for name, owner, attr, fam, _ in KERNELS:
        if fam in families and getattr(owner, attr) < MIN_LAUNCHES:
            bad.append(f"{name}: {getattr(owner, attr)} launches < "
                       f"{MIN_LAUNCHES}")
    checks = (("k1", "fused_int8_gemm epilogue", fused_int8_gemm, "gemm/",
               ""),
              ("k2", "tree_gemm run-time instantiations", TG.tree_gemm, "",
               "_0"),
              ("k3", "qreduce_kernel", qreduce_kernel, "", ""))
    for fam, what, owner, prefix, suffix in checks:
        n = len(mode_pairs(owner, prefix, suffix))
        if fam in families and n < MIN_PAIRS:
            bad.append(f"{what}: {n} mode pairs < {MIN_PAIRS}")
    if "k2" in families:
        got = {inst for inst, _ in TG.tree_gemm.seen}
        for inst in K2_INSTANCES:
            if inst not in got:
                bad.append(f"tree_gemm: instantiation {inst} never launched")
    return bad


def run(counts: dict, device, timeout: float = 1800.0) -> dict:
    """Run the families of ``counts`` ({name: trials}) on ``device``:
    the world's families in a world of :data:`WORLD` Gloo ranks started
    first, the others in this process meanwhile.  Prints a line a family
    and, on the card, a line a kernel; returns the counts, the kernels'
    report and the gate's findings."""
    from .parallel.launch import start_world

    sw = Sweep(device)
    reset_counts()
    t_all = time.perf_counter()
    jobs = [(n, counts[n]) for n in WORLD_FAMILIES if n in counts]
    world = start_world(WORLD, "gloo", _world_rank, (jobs, str(sw.device)),
                        timeout) if jobs else None
    stats = {}
    for name, fn in FAMILIES:
        if name not in counts:
            continue
        f0, c0, t0 = sw.fails, sw.crashes, time.perf_counter()
        done = fn(sw, counts[name])
        done = counts[name] if done is None else done
        stats[name] = (done, sw.fails - f0, sw.crashes - c0,
                       time.perf_counter() - t0)
        note = f"; {sw.notes[name]}" if name in sw.notes else ""
        print(f"family {name}: {done} trials, {stats[name][1]} mismatches "
              f"and crashes ({stats[name][2]} crashes), "
              f"{stats[name][3]:.2f} s{note}", flush=True)
    if world is not None:
        try:
            ranks = world.join()
        except RuntimeError as e:
            sw.fail("CRASH", "world", str(e)[-2000:])
            ranks = []
        for r, res in enumerate(ranks):
            for line in res["lines"]:
                sw.fails += 1
                print(f"rank {r}: {line}", flush=True)
        for j, (name, done, nf, nc, secs, nr) in enumerate(
                ranks[0]["stats"] if ranks else ()):
            nf = max(res["stats"][j][2] for res in ranks)
            stats[name] = (done, nf, nc, secs)
            print(f"family {name}: {done} trials, {nf} mismatches and "
                  f"crashes ({nc} crashes), {nr} refused by a strategy's "
                  f"gate, {secs:.2f} s (rank 0 of {WORLD})", flush=True)
    report, findings = [], []
    if sw.on_card:
        torch.cuda.synchronize()
        report = kernel_report()
        for row in report:
            print(f"kernel {row['name']}: {row['launches']} launches, "
                  f"{row['mode_pairs']} mode pairs, {row['instances']}",
                  flush=True)
        findings = gate(set(counts))
        for f in findings:
            print(f"GATE {f}", flush=True)
    secs = time.perf_counter() - t_all
    total = sum(s[0] for s in stats.values())
    print(f"sweep: {total} trials, {sw.fails} mismatches and crashes, "
          f"{len(findings)} gate findings, {secs:.2f} s on {sw.device}",
          flush=True)
    return {"stats": stats, "fails": sw.fails, "kernels": report,
            "gate": findings, "seconds": secs, "trials": total}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m qublas_tpu_torch.fuzz",
        description="Randomized differential sweeps of the port against "
                    "its host oracle (exit 1 on any mismatch or crash).")
    p.add_argument("trials", nargs="?", type=int, default=1000,
                   help="trials a family, scaled as tools/deep_fuzz.py "
                        "scales them (default 1000)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--family", action="append", choices=FAMILY_NAMES,
                   help="run this family only (repeatable)")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("qublas_tpu_torch.fuzz: no CUDA device "
              "(torch.cuda.is_available() is False); --device cpu sweeps "
              "the plain versions", file=sys.stderr)
        return 2
    counts = trial_counts(args.trials)
    if args.family:
        counts = {n: c for n, c in counts.items() if n in args.family}
    res = run(counts, args.device)
    return 1 if res["fails"] or res["gate"] else 0


if __name__ == "__main__":
    sys.exit(main())
