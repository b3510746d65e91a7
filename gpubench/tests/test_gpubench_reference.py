"""The benchmark's plain reference (``gpubench/reference``) on hand-worked
corners, and against the port's exact host model (``hostint``,
``hostops``) on small random cases.  CPU only."""

import math
import random

import pytest
import torch

import qublas_tpu_torch as qt
from qublas_tpu_torch import hostint, hostops

from gpubench.reference import fixedpoint as fp
from gpubench.reference.fixedpoint import Fmt

SAT0 = dict(round="TRN_TCPL", overflow="SAT_ZERO")


def port(f: Fmt):
    return qt.qformat(f.int_bits, f.frac_bits, f.signed,
                      qt.RoundMode[f.round], qt.OverflowMode[f.overflow])


def ints(*v):
    return torch.tensor(v, dtype=torch.int64)


@pytest.mark.parametrize("mode,want", [
    # -5 and 5 at 1 fractional bit (-2.5, 2.5), and -7, 7 (-3.5, 3.5)
    ("TRN_TCPL", [-3, 2, -4, 3]),
    ("TRN_SMGN", [-2, 2, -3, 3]),
    ("RND_POS_INF", [-2, 3, -3, 4]),
    ("RND_NEG_INF", [-3, 2, -4, 3]),
    ("RND_ZERO", [-2, 2, -3, 3]),
    ("RND_INF", [-3, 3, -4, 4]),
    ("RND_CONV", [-2, 2, -4, 4]),
])
def test_round_half_ulp_corners(mode, want):
    assert fp.round_shift(ints(-5, 5, -7, 7), 1, 0, mode).tolist() == want


@pytest.mark.parametrize("overflow,want", [
    ("SAT_TCPL", [-8, -8, 7, 7, 0]),
    ("SAT_ZERO", [0, -8, 7, 0, 0]),
    ("SAT_SMGN", [-7, -7, 7, 7, 0]),
    ("WRP_TCPL", [7, -8, 7, -8, 0]),
])
def test_overflow_corners(overflow, want):
    f = Fmt(3, 0, overflow=overflow)            # 4-bit storage [-8, 7]
    assert fp.saturate(ints(-9, -8, 7, 8, 0), f).tolist() == want


def test_product_truncates_then_saturates_to_zero():
    f = Fmt(8, 8, **SAT0)                        # Qu<8,8,TRN,SAT::ZERO>
    a, b = ints(300, -300, 65535), ints(300, 300, 65535)
    got = fp.requantize(a * b, 16, f).tolist()
    # 90000/256 = 351.56 -> 351; -351.56 -> -352 (toward -inf); the last
    # product is far outside 17 bits -> 0
    assert got == [351, -352, 0]


def test_tree_odd_tails_saturate_to_zero():
    # Qu<2,0,SAT::ZERO>: raws in [-4, 3].  Products 3,3,3,1,1; level 0:
    # 3+3=6 -> 0, 3+1=4 -> 0, the tail 1 is carried; level 1: 0+0, tail 1;
    # level 2: 0+1 = 1.  The exact dot (11) would saturate to 0.
    f = Fmt(2, 0, **SAT0)
    a = ints(1, 1, 1, 1, 1)[None]
    b = ints(3, 3, 3, 1, 1)[:, None]
    assert fp.gemm(a, b, f, f, f).tolist() == [[1]]
    assert hostops.qgemul([[(1, port(f))] * 5],
                          [[(v, port(f))] for v in (3, 3, 3, 1, 1)],
                          port(f))[0][0][0] == 1


def test_sqrt_rom_entries():
    out = Fmt(3, 4, **SAT0)
    table = fp.rom_table("sqrt", out, out)
    assert table.numel() == 256
    for p in range(256):
        raw = p - 256 if p >= 128 else p
        want = math.isqrt(16 * raw) if raw >= 0 else 0
        assert int(table[p]) == want, (p, raw)
    assert fp.rom_lookup(torch.tensor([16, 127, -1, 0], dtype=torch.int8),
                         table).tolist() == [16, 45, 0, 0]


def test_rom_matches_the_port_table():
    out = Fmt(3, 4, **SAT0)
    ours = fp.rom_table("sqrt", out, out)
    theirs = qt.build_table(qt.sqrt_func, port(out), port(out)).table
    assert ours.tolist() == theirs.tolist()


@pytest.mark.parametrize("seed", range(40))
def test_requantize_matches_hostint(seed):
    rnd = random.Random(seed)
    frac = rnd.randint(0, 10)
    f = Fmt(rnd.randint(-min(frac, 2), 10), frac, rnd.random() < 0.8,
            rnd.choice(fp.ROUND_MODES), rnd.choice(fp.OVERFLOW_MODES[:4]))
    frm = rnd.randint(0, 14)
    vals = [rnd.randint(-(1 << 20), 1 << 20) for _ in range(64)]
    got = fp.requantize(torch.tensor(vals), frm, f).tolist()
    assert got == [hostint.requantize(v, frm, port(f)) for v in vals]


def test_double_to_raw_matches_hostint():
    for mode in fp.ROUND_MODES:
        for ovf in ("SAT_TCPL", "SAT_ZERO"):
            f = Fmt(3, 4, round=mode, overflow=ovf)
            for x in (0.0, 1.03125, -1.03125, 2.5 / 16, -2.5 / 16, 7.99,
                      -8.5, 9.0, math.sqrt(2.0), math.nan, math.inf):
                assert fp.double_to_raw(x, f) == \
                    hostint.double_to_raw(x, port(f)), (mode, ovf, x)


CASES = [
    # lossless: the exact product (float64) path
    (Fmt(3, 4), Fmt(3, 4), Fmt(3, 4, **SAT0), Fmt(20, 8), (Fmt(20, 8),),
     7, 33, 5),
    # order-sensitive: every product and layer requantizes, odd k
    (Fmt(8, 8, **SAT0), Fmt(8, 8, **SAT0), Fmt(8, 8, **SAT0), None, (),
     3, 13, 4),
    # layer formats that change, rounding modes that differ
    (Fmt(4, 4), Fmt(4, 4, round="RND_CONV"), Fmt(5, 2, round="RND_INF"),
     Fmt(6, 5, round="RND_ZERO", overflow="SAT_ZERO"),
     (Fmt(7, 4, round="RND_CONV"), Fmt(8, 3, overflow="SAT_SMGN")), 4, 11, 3),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_gemm_matches_hostops(case):
    fa, fb, out, mul_to, add, m, k, n = CASES[case]
    g = torch.Generator().manual_seed(case)
    a = torch.randint(fa.raw_min, fa.raw_max + 1, (m, k), generator=g)
    b = torch.randint(fb.raw_min, fb.raw_max + 1, (k, n), generator=g)
    got = fp.gemm(a, b, fa, fb, out, mul_to, add)
    want = hostops.qgemul(
        [[(int(v), port(fa)) for v in row] for row in a.tolist()],
        [[(int(v), port(fb)) for v in row] for row in b.tolist()],
        port(out), mul_to=port(mul_to) if mul_to else None,
        add_formats=tuple(port(f) for f in add))
    assert got.tolist() == [[r for r, _ in row] for row in want]


def test_lossless_proof():
    f = Fmt(3, 4)
    assert fp.lossless(f, f, Fmt(20, 8),
                       fp.level_formats(Fmt(20, 8), (Fmt(20, 8),), 4096),
                       4096)
    z = Fmt(8, 8, **SAT0)
    assert not fp.lossless(z, z, z, fp.level_formats(z, (), 1024), 1024)


def test_controls_differ():
    # the narrower precision changes the answer at these formats
    z = Fmt(8, 8, **SAT0)
    g = torch.Generator().manual_seed(3)
    a = torch.randint(-4096, 4097, (4, 64), generator=g)
    b = torch.randint(-4096, 4097, (64, 5), generator=g)
    assert not torch.equal(fp.gemm(a, b, z, z, z),
                           fp.gemm(a, b, z, z, z, control=True))
    f, mid, acc = Fmt(3, 4), Fmt(3, 4, **SAT0), Fmt(20, 8)
    a = torch.randint(-16, 17, (8, 1024), generator=g)
    b = torch.randint(-4, 5, (1024, 16), generator=g)
    assert not torch.equal(fp.gemm(a, b, f, f, mid, acc, (acc,)),
                           fp.gemm(a, b, f, f, mid, acc, (acc,),
                                   control=True))
