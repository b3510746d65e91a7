"""The port's sharded strategies against the JAX package's, on the CPU.

``qublas_tpu_torch.parallel`` shards over a (dp, tp) mesh of processes
joined by ``torch.distributed``; ``qublas_tpu.parallel`` shards over a JAX
mesh.  Every case runs both on the same numpy inputs, made from a seed:
the JAX side on the virtual 8-device CPU mesh of ``tests/conftest.py`` in
this process, the port side in a Gloo world of 2 or 4 ranks spawned once
for the module (``launch.start_world``, the ranks running
``parallel.dryrun.run_cases``: they import the port, never JAX).  The
results must agree Δ=0, raws and formats and storage kind, on every rank,
and where the JAX function raises ``ValueError`` the port must raise it
too.  The worlds run while this process computes the JAX side.

Beside the cases: ``auto``'s choice (``choose_strategy`` and
``choose_cgemul_strategy`` against the strategy the JAX ``auto`` calls),
the int64 pair psum and the limb psum against the JAX package's 16-bit
column psums (``_psum_pair``, ``_psum_limbs``) on the same per-device
values, the tp bound of those psums, and the world of one process.
"""

import functools
import random

import numpy as np
import pytest

import jax

import qublas_tpu_torch as qt
from qublas_tpu.qformat import OverflowMode, RoundMode, qformat

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs the virtual 8-device mesh")

WORLD_TIMEOUT = 240.0

F34 = qformat(3, 4)
WIDE = qformat(20, 8)
MID = qformat(3, 4, overflow_mode=OverflowMode.SAT_ZERO)
F88Z = qformat(8, 8, overflow_mode=OverflowMode.SAT_ZERO)
F44Z = qformat(4, 4, overflow_mode=OverflowMode.SAT_ZERO)
RL = (qformat(9, 6, round_mode=RoundMode.RND_CONV),
      qformat(10, 5, round_mode=RoundMode.RND_CONV,
              overflow_mode=OverflowMode.SAT_TCPL))
GK = dict(mul_to=WIDE, add_formats=(WIDE,))
# pair-storage A (30, 9) x int16-lane B: a dot in the 64-bit domain
FA_W, FB_W = qformat(30, 9), qformat(7, 8)
WKW = dict(mul_to=qformat(40, 17), add_formats=(qformat(45, 17),))
# 40-bit x 40-bit operands: 80-bit products, beyond the 64-bit domain
F40 = qformat(25, 15)
LKW = dict(mul_to=qformat(51, 30), add_formats=(qformat(57, 30),))
CMID = qformat(5, 4)
CTF = dict(algo="tf", add_formats=(WIDE,), ab=CMID, cd=CMID, ba=CMID,
           abc=WIDE, cdb=WIDE, bad=WIDE, AB=WIDE, BC=WIDE)


def lut(fin, fout=None):
    return ("lut", fin, fout or fin)


def q(fmt, shape, seed):
    """("q", raws, fmt): uniform raws of ``fmt`` from a seed."""
    n = int(np.prod(shape))
    if fmt.storage_bits <= 62:
        r = np.random.RandomState(seed)
        raws = r.randint(fmt.raw_min, fmt.raw_max + 1, size=n)
    else:
        r = random.Random(f"{seed}:{fmt.storage_bits}:{n}")
        raws = np.array([r.randint(fmt.raw_min, fmt.raw_max)
                         for _ in range(n)], dtype=object)
    return ("q", raws.reshape(shape), fmt)


def c(fmt, shape, seed):
    """("c", re, im, fr, fi): a complex operand."""
    re, im = q(fmt, shape, seed), q(fmt, shape, seed + 1)
    return ("c", re[1], im[1], fmt, fmt)


# (id, world, function, (dp, tp), args, kwargs); ``raises``: JAX raises
# ValueError there and so must the port
CASES = []


def case(cid, world, fn, mesh, args, kw=None, raises=False):
    CASES.append((cid, world, fn, mesh, tuple(args), dict(kw or {}), raises))


# -- K: psum, reduce-scatter, the ring, the ROM ------------------------------
case("k psum", 2, "sharded_qgemul_k", (1, 2),
     (q(F34, (8, 16), 0), q(F34, (16, 12), 1), MID), GK)
case("k reduce-scatter tp4", 4, "sharded_qgemul_k", (1, 4),
     (q(F34, (6, 16), 2), q(F34, (16, 12), 3), MID),
     dict(GK, reduce_scatter=True))
case("k reduce-scatter lut dp2", 4, "sharded_qgemul_k", (2, 2),
     (q(F34, (4, 8), 4), q(F34, (8, 8), 5), MID),
     dict(GK, reduce_scatter=True, epilogue_lut=lut(MID, qformat(4, 3))))
case("k psum lut", 2, "sharded_qgemul_k", (2, 1),
     (q(F34, (8, 16), 6), q(F34, (16, 12), 7), MID),
     dict(GK, epilogue_lut=lut(MID)))
case("k pipelined tp4", 4, "sharded_qgemul_k_pipelined", (1, 4),
     (q(F34, (8, 32), 8), q(F34, (32, 8), 9), MID), GK)
case("k pipelined lut", 2, "sharded_qgemul_k_pipelined", (1, 2),
     (q(F34, (4, 8), 10), q(F34, (8, 8), 11), MID),
     dict(GK, epilogue_lut=lut(MID)))
case("k rejects order-sensitive", 2, "sharded_qgemul_k", (1, 2),
     (q(F88Z, (4, 8), 12), q(F88Z, (8, 4), 13), F88Z), raises=True)
case("k rejects k % tp", 4, "sharded_qgemul_k", (1, 4),
     (q(F34, (4, 6), 14), q(F34, (6, 4), 15), MID), GK, raises=True)
case("k rejects n % tp with reduce-scatter", 4, "sharded_qgemul_k", (1, 4),
     (q(F34, (4, 8), 16), q(F34, (8, 6), 17), MID),
     dict(GK, reduce_scatter=True), raises=True)
case("k pipelined rejects n % tp", 2, "sharded_qgemul_k_pipelined", (1, 2),
     (q(F34, (4, 8), 18), q(F34, (8, 3), 19), MID), GK, raises=True)

# -- M/N and DP --------------------------------------------------------------
case("mn canonical dp2 tp2", 4, "sharded_qgemul_mn", (2, 2),
     (q(F88Z, (8, 8), 20), q(F88Z, (8, 8), 21), F88Z))
case("mn pair operands", 2, "sharded_qgemul_mn", (2, 1),
     (q(FA_W, (4, 8), 22), q(F34, (8, 4), 23), qformat(33, 9)))
case("mn limb operands", 2, "sharded_qgemul_mn", (1, 2),
     (q(qformat(40, 28), (2, 6), 24), q(F34, (6, 4), 25),
      qformat(50, 30, round_mode=RoundMode.RND_CONV,
              overflow_mode=OverflowMode.SAT_TCPL)),
     dict(mul_to=qformat(48, 40)))
case("mn host-route output", 2, "sharded_qgemul_mn", (1, 2),
     (q(F34, (2, 4), 26), q(F34, (4, 2), 27), qformat(600, 600)),
     raises=True)
case("mn rows do not split", 4, "sharded_qgemul_mn", (2, 2),
     (q(F88Z, (3, 4), 28), q(F88Z, (4, 4), 29), F88Z), raises=True)
case("dp batched lhs, shared rhs", 4, "sharded_qgemul_dp", (2, 2),
     (q(F34, (8, 4, 8), 30), q(F34, (8, 6), 31), MID),
     dict(GK, use_pallas=False))
case("dp batched rhs, order-sensitive", 2, "sharded_qgemul_dp", (1, 2),
     (q(F88Z, (4, 3, 5), 32), q(F88Z, (4, 5, 2), 33), F88Z))
case("dp rejects 2-D", 2, "sharded_qgemul_dp", (1, 2),
     (q(F34, (4, 8), 34), q(F34, (8, 4), 35), MID), GK, raises=True)

# -- K tree: order-sensitive trees ------------------------------------------
case("k_tree pow2, butterfly auto", 4, "sharded_qgemul_k_tree", (1, 4),
     (q(F88Z, (4, 64), 40), q(F88Z, (64, 6), 41), F88Z),
     dict(add_formats=(F88Z,)))
case("k_tree pow2, butterfly=False", 4, "sharded_qgemul_k_tree", (1, 4),
     (q(F88Z, (4, 64), 40), q(F88Z, (64, 6), 41), F88Z),
     dict(add_formats=(F88Z,), butterfly=False))
case("k_tree butterfly=True, rounding layers", 2, "sharded_qgemul_k_tree",
     (1, 2), (q(F88Z, (4, 64), 42), q(F88Z, (64, 6), 43), F88Z),
     dict(add_formats=RL, butterfly=True))
case("k_tree multi-subtree k=24", 4, "sharded_qgemul_k_tree", (2, 2),
     (q(F44Z, (5, 24), 44), q(F44Z, (24, 7), 45), F44Z),
     dict(add_formats=RL))
case("k_tree multi-subtree k=40, pad nodes", 4, "sharded_qgemul_k_tree",
     (1, 4), (q(F44Z, (5, 40), 46), q(F44Z, (40, 7), 47), F44Z),
     dict(add_formats=RL))
case("k_tree ragged k=17", 4, "sharded_qgemul_k_tree", (1, 4),
     (q(F44Z, (3, 17), 48), q(F44Z, (17, 5), 49), F44Z),
     dict(add_formats=RL))
case("k_tree ragged k=52", 2, "sharded_qgemul_k_tree", (1, 2),
     (q(F44Z, (3, 52), 50), q(F44Z, (52, 5), 51), F44Z),
     dict(add_formats=RL))
case("k_tree default merger formats", 2, "sharded_qgemul_k_tree", (1, 2),
     (q(F34, (4, 32), 52), q(F34, (32, 4), 53),
      qformat(5, 4, round_mode=RoundMode.RND_POS_INF)))
case("k_tree quantized products", 4, "sharded_qgemul_k_tree", (1, 4),
     (q(qformat(4, 4), (4, 64), 54), q(qformat(4, 4), (64, 4), 55),
      qformat(7, 5, overflow_mode=OverflowMode.SAT_ZERO)),
     dict(mul_to=qformat(6, 5, round_mode=RoundMode.RND_INF),
          add_formats=(qformat(7, 5, overflow_mode=OverflowMode.SAT_ZERO),)))
case("k_tree pair nodes", 2, "sharded_qgemul_k_tree", (1, 2),
     (q(qformat(15, 10), (3, 32), 56), q(qformat(15, 10), (32, 3), 57),
      qformat(20, 10, round_mode=RoundMode.RND_CONV,
              overflow_mode=OverflowMode.SAT_ZERO)),
     dict(add_formats=(qformat(40, 20), qformat(30, 12))))
case("k_tree pair nodes, butterfly", 4, "sharded_qgemul_k_tree", (2, 2),
     (q(qformat(15, 10), (3, 32), 58), q(qformat(15, 10), (32, 3), 59),
      qformat(20, 8, overflow_mode=OverflowMode.SAT_ZERO)),
     dict(add_formats=(qformat(40, 12, round_mode=RoundMode.RND_CONV),
                       qformat(42, 10)), butterfly=True))
case("k_tree lut", 2, "sharded_qgemul_k_tree", (1, 2),
     (q(F34, (4, 32), 60), q(F34, (32, 4), 61), MID),
     dict(add_formats=(MID,), epilogue_lut=lut(MID, qformat(4, 3))))
case("k_tree butterfly=True on a ragged split", 4, "sharded_qgemul_k_tree",
     (1, 4), (q(F44Z, (3, 21), 62), q(F44Z, (21, 4), 63), F44Z),
     dict(add_formats=RL, butterfly=True), raises=True)

# -- wide K: int64 dots ------------------------------------------------------
case("k_wide pair operand, lane out", 2, "sharded_qgemul_k_wide", (1, 2),
     (q(FA_W, (3, 16), 70), q(FB_W, (16, 5), 71),
      qformat(20, 6, round_mode=RoundMode.RND_CONV,
              overflow_mode=OverflowMode.SAT_ZERO)), WKW)
case("k_wide pair out, reduce-scatter", 4, "sharded_qgemul_k_wide", (1, 4),
     (q(FA_W, (2, 16), 72), q(qformat(8, 8), (16, 8), 73),
      qformat(36, 10, round_mode=RoundMode.RND_POS_INF,
              overflow_mode=OverflowMode.SAT_TCPL)),
     dict(WKW, reduce_scatter=True))
case("k_wide lane segment dots, lut", 4, "sharded_qgemul_k_wide", (2, 2),
     (q(qformat(13, 0), (4, 64), 74), q(qformat(13, 0), (64, 4), 75), MID),
     dict(mul_to=qformat(27, 0), add_formats=(qformat(33, 0),),
          epilogue_lut=lut(MID)))
case("k_wide WRP_TCPL_SAT out", 2, "sharded_qgemul_k_wide", (1, 2),
     (q(FA_W, (2, 16), 76), q(FB_W, (16, 3), 77),
      qformat(20, 6, overflow_mode=OverflowMode.WRP_TCPL_SAT)), WKW)
case("k_wide rejects order-sensitive", 2, "sharded_qgemul_k_wide", (1, 2),
     (q(FA_W, (2, 8), 78), q(FA_W, (8, 2), 79), FA_W), raises=True)
case("k_wide pipelined, pair out", 4, "sharded_qgemul_k_wide_pipelined",
     (1, 4), (q(FA_W, (2, 16), 80), q(FB_W, (16, 8), 81),
              qformat(40, 12, overflow_mode=OverflowMode.SAT_TCPL)), WKW)
case("k_wide pipelined, lut", 2, "sharded_qgemul_k_wide_pipelined", (1, 2),
     (q(FA_W, (2, 8), 82), q(FB_W, (8, 4), 83), MID),
     dict(WKW, epilogue_lut=lut(MID)))
case("k_wide pipelined rejects n % tp", 2,
     "sharded_qgemul_k_wide_pipelined", (1, 2),
     (q(FA_W, (2, 8), 84), q(FB_W, (8, 3), 85), MID), WKW, raises=True)

# -- limb K: digit dots ------------------------------------------------------
case("k_limb pair operands, limb out", 2, "sharded_qgemul_k_limb", (1, 2),
     (q(F40, (3, 16), 90), q(F40, (16, 2), 91),
      qformat(60, 20, round_mode=RoundMode.RND_CONV,
              overflow_mode=OverflowMode.SAT_TCPL)), LKW)
case("k_limb limb operand, lane out, reduce-scatter", 4,
     "sharded_qgemul_k_limb", (1, 4),
     (q(qformat(40, 30), (2, 16), 92), q(qformat(10, 8), (16, 8), 93),
      qformat(30, 10, overflow_mode=OverflowMode.SAT_ZERO)),
     dict(mul_to=qformat(51, 38), add_formats=(qformat(57, 38),),
          reduce_scatter=True))
case("k_limb pair out", 2, "sharded_qgemul_k_limb", (2, 1),
     (q(F40, (2, 8), 94), q(F40, (8, 3), 95),
      qformat(40, 20, round_mode=RoundMode.RND_NEG_INF,
              overflow_mode=OverflowMode.SAT_TCPL)), LKW)
case("k_limb lut", 2, "sharded_qgemul_k_limb", (1, 2),
     (q(F40, (2, 8), 96), q(F40, (8, 3), 97), MID),
     dict(LKW, epilogue_lut=lut(MID)))
case("k_limb rejects order-sensitive", 2, "sharded_qgemul_k_limb", (1, 2),
     (q(F40, (2, 8), 98), q(F40, (8, 2), 99), F40), raises=True)
case("k_limb rejects k % tp", 4, "sharded_qgemul_k_limb", (1, 4),
     (q(F40, (2, 6), 100), q(F40, (6, 2), 101),
      qformat(60, 20, overflow_mode=OverflowMode.SAT_TCPL)), LKW,
     raises=True)
case("k_limb pipelined, limb out", 4, "sharded_qgemul_k_limb_pipelined",
     (1, 4), (q(F40, (3, 16), 102), q(F40, (16, 8), 103),
              qformat(60, 20, overflow_mode=OverflowMode.SAT_TCPL)), LKW)
case("k_limb pipelined, limb operand, lane out, lut", 2,
     "sharded_qgemul_k_limb_pipelined", (1, 2),
     (q(qformat(40, 30), (2, 8), 104), q(qformat(10, 8), (8, 4), 105),
      MID),
     dict(mul_to=qformat(51, 38), add_formats=(qformat(57, 38),),
          epilogue_lut=lut(MID)))

# -- shard_qgemul: auto end to end ------------------------------------------
case("auto -> k", 4, "shard_qgemul", (1, 4),
     (q(F34, (8, 64), 110), q(F34, (64, 8), 111), MID), GK)
case("auto -> mn (lossy, shallow split)", 2, "shard_qgemul", (1, 2),
     (q(F88Z, (8, 27), 112), q(F88Z, (27, 8), 113), F88Z),
     dict(add_formats=(F88Z,)))
case("auto -> k_tree (deep split)", 4, "shard_qgemul", (1, 4),
     (q(F88Z, (4, 64), 114), q(F88Z, (64, 4), 115), F88Z),
     dict(add_formats=(F88Z,)))
case("auto -> k_limb", 2, "shard_qgemul", (1, 2),
     (q(F40, (2, 16), 116), q(F40, (16, 3), 117),
      qformat(60, 20, overflow_mode=OverflowMode.SAT_TCPL)), LKW)
case("auto -> dp", 2, "shard_qgemul", (2, 1),
     (q(F34, (4, 4, 8), 118), q(F34, (8, 6), 119), MID), GK)
case("strategy k_wide by name", 2, "shard_qgemul", (1, 2),
     (q(FA_W, (2, 16), 120), q(FB_W, (16, 3), 121),
      qformat(20, 6, overflow_mode=OverflowMode.SAT_ZERO)),
     dict(WKW, strategy="k_wide"))
case("unknown strategy", 2, "shard_qgemul", (1, 2),
     (q(F34, (2, 4), 122), q(F34, (4, 2), 123), MID),
     dict(strategy="nope"), raises=True)

# -- complex -----------------------------------------------------------------
COUT_Z = (MID, MID)
COUT_R = (F44Z, qformat(5, 3, round_mode=RoundMode.RND_CONV))
case("cgemul_mn order-sensitive TF", 4, "sharded_cgemul_mn", (2, 2),
     (c(F44Z, (4, 6), 130), c(F44Z, (6, 8), 132), COUT_R),
     dict(algo="tf", add_formats=(qformat(6, 4),)))
case("cgemul_mn basic inferred formats", 2, "sharded_cgemul_mn", (1, 2),
     (c(F34, (4, 4), 134), c(F34, (4, 8), 136), (None, None)),
     dict(algo="basic", add_formats=(WIDE,), ac=WIDE, bd=WIDE, ad=WIDE,
          bc=WIDE, acbd=WIDE, adbc=WIDE))
case("cgemul_k TF", 2, "sharded_cgemul_k", (1, 2),
     (c(F34, (4, 16), 138), c(F34, (16, 8), 140), COUT_Z), CTF)
case("cgemul_k basic, reduce-scatter", 4, "sharded_cgemul_k", (1, 4),
     (c(F34, (3, 8), 142), c(F34, (8, 8), 144),
      (qformat(22, 8), qformat(22, 8))),
     dict(algo="basic", add_formats=(qformat(22, 8),), ac=qformat(22, 8),
          bd=qformat(22, 8), ad=qformat(22, 8), bc=qformat(22, 8),
          acbd=qformat(22, 8), adbc=qformat(22, 8), reduce_scatter=True))
case("cgemul_k limb domain", 2, "sharded_cgemul_k", (1, 2),
     (c(F40, (2, 16), 146), c(F40, (16, 4), 148),
      (qformat(60, 20, overflow_mode=OverflowMode.SAT_TCPL),) * 2),
     dict(algo="basic", add_formats=(qformat(58, 30),), ac=qformat(51, 30),
          bd=qformat(51, 30), ad=qformat(51, 30), bc=qformat(51, 30),
          acbd=qformat(52, 30), adbc=qformat(52, 30)))
case("cgemul_k rejects lossy", 4, "sharded_cgemul_k", (2, 2),
     (c(F44Z, (4, 8), 150), c(F44Z, (8, 4), 152), (F44Z, F44Z)),
     dict(algo="tf"), raises=True)
case("cgemul auto -> k", 4, "sharded_cgemul", (2, 2),
     (c(F34, (4, 16), 154), c(F34, (16, 8), 156), COUT_Z), CTF)
case("cgemul auto -> mn (lossy)", 4, "sharded_cgemul", (2, 2),
     (c(F44Z, (4, 8), 158), c(F44Z, (8, 8), 160), (F44Z, F44Z)),
     dict(algo="tf"))
case("cgemul auto -> k_tree (n < tp)", 4, "sharded_cgemul", (1, 4),
     (c(F44Z, (3, 64), 162), c(F44Z, (64, 3), 164), (F44Z, F44Z)),
     dict(algo="tf"))
case("cgemul auto, unaligned batch", 4, "sharded_cgemul", (2, 2),
     (c(F34, (3, 4, 16), 166), c(F34, (3, 16, 8), 168), COUT_Z), CTF)
case("cgemul_dp", 4, "sharded_cgemul_dp", (2, 2),
     (c(F34, (8, 2, 4), 170), c(F34, (8, 4, 3), 172), COUT_Z), CTF)
case("cgemul_dp rejects batch % devices", 4, "sharded_cgemul_dp", (2, 2),
     (c(F34, (3, 2, 4), 174), c(F34, (3, 4, 3), 176), COUT_Z), CTF,
     raises=True)
case("cgemul_k_tree basic k=21 (s=0)", 4, "sharded_cgemul_k_tree", (1, 4),
     (c(F44Z, (3, 21), 178), c(F44Z, (21, 4), 180), COUT_R),
     dict(algo="basic", add_formats=(qformat(6, 4),)))
case("cgemul_k_tree tf k=40 (q>1)", 4, "sharded_cgemul_k_tree", (1, 4),
     (c(F44Z, (3, 40), 182), c(F44Z, (40, 4), 184), COUT_R),
     dict(algo="tf", add_formats=(qformat(6, 4),)))
case("cgemul_k_tree butterfly, local cgemul", 4, "sharded_cgemul_k_tree",
     (1, 4), (c(F44Z, (3, 64), 186), c(F44Z, (64, 4), 188), COUT_R),
     dict(algo="basic", add_formats=(qformat(6, 4),), butterfly=True))
case("cgemul_k_tree gather, local fast path", 2, "sharded_cgemul_k_tree",
     (1, 2), (c(F34, (3, 64), 190), c(F34, (64, 4), 192), COUT_Z),
     dict(CTF, add_formats=(qformat(9, 8),), butterfly=False))

# -- Qreduce -----------------------------------------------------------------
QRL = (qformat(5, 3, round_mode=RoundMode.RND_CONV,
               overflow_mode=OverflowMode.SAT_ZERO), qformat(6, 2))
case("qreduce batch, odd reduce length", 4, "sharded_qreduce", (2, 2),
     (q(qformat(4, 4), (16, 21), 200), QRL), dict(axis=1))
case("qreduce batch_axis=1, axis=0", 2, "sharded_qreduce", (1, 2),
     (q(qformat(4, 4), (8, 16), 201), (qformat(8, 4),)),
     dict(axis=0, batch_axis=1))
case("qreduce limb values", 2, "sharded_qreduce", (2, 1),
     (q(qformat(40, 28), (4, 6), 202), (qformat(44, 28),)), dict(axis=1))
case("qreduce rejects batch % devices", 4, "sharded_qreduce", (2, 2),
     (q(F34, (10, 8), 203), ()), dict(axis=1), raises=True)
case("qreduce_k lossless i32", 4, "sharded_qreduce_k", (2, 2),
     (q(F34, (64,), 204), (qformat(20, 4),)))
case("qreduce_k rejects lossy", 2, "sharded_qreduce_k", (1, 2),
     (q(F44Z, (64,), 205), (F44Z,)), raises=True)
case("qreduce_k rejects n % tp", 4, "sharded_qreduce_k", (1, 4),
     (q(F34, (30,), 206), (qformat(20, 4),)), raises=True)
case("qreduce_k pair regime, lane values", 4, "sharded_qreduce_k", (1, 4),
     (q(qformat(28, 0), (32,), 207), (qformat(36, 0),)))
case("qreduce_k pair values", 2, "sharded_qreduce_k", (1, 2),
     (q(FA_W, (32,), 208), (qformat(38, 9),)))
case("qreduce_k limb values", 2, "sharded_qreduce_k", (1, 2),
     (q(qformat(40, 28), (8,), 209), (qformat(75, 28),)))
case("qreduce_k pair values, sum beyond 64 bits", 4, "sharded_qreduce_k",
     (1, 4), (q(qformat(60, 0), (32,), 210), (qformat(66, 0),)))
case("qreduce_k rejects host values", 2, "sharded_qreduce_k", (1, 2),
     (("q", np.arange(1, 9).astype(object), qformat(1000, 0)),
      (qformat(1100, 0),)), raises=True)
case("qreduce_k_tree n=64, butterfly auto", 4, "sharded_qreduce_k_tree",
     (1, 4), (q(F44Z, (64,), 211), RL))
case("qreduce_k_tree n=64, butterfly=False", 4, "sharded_qreduce_k_tree",
     (1, 4), (q(F44Z, (64,), 211), RL), dict(butterfly=False))
case("qreduce_k_tree n=40", 4, "sharded_qreduce_k_tree", (1, 4),
     (q(F44Z, (40,), 212), RL))
case("qreduce_k_tree n=17", 4, "sharded_qreduce_k_tree", (1, 4),
     (q(F44Z, (17,), 213), RL))
case("qreduce_k_tree n=100", 2, "sharded_qreduce_k_tree", (1, 2),
     (q(F44Z, (100,), 214), RL))
case("qreduce_k_tree default formats", 2, "sharded_qreduce_k_tree", (1, 2),
     (q(F34, (32,), 215),))
case("qreduce_k_tree pair nodes", 4, "sharded_qreduce_k_tree", (2, 2),
     (q(qformat(15, 10), (24,), 216),
      (qformat(40, 12, round_mode=RoundMode.RND_CONV),)))
case("qreduce_k_tree butterfly=True on n=17", 4, "sharded_qreduce_k_tree",
     (1, 4), (q(F44Z, (17,), 213), RL), dict(butterfly=True), raises=True)


# ---------------------------------------------------------------------------
# both sides
# ---------------------------------------------------------------------------

def _is_fmt(v):
    return hasattr(v, "int_bits") and hasattr(v, "overflow_mode")


def to_port(v):
    """A case's values with every JAX-package format as the port's."""
    if _is_fmt(v):
        return qt.port_format(v)
    if isinstance(v, np.ndarray):
        return v
    if isinstance(v, tuple):
        return tuple(to_port(x) for x in v)
    if isinstance(v, list):
        return [to_port(x) for x in v]
    if isinstance(v, dict):
        return {k: to_port(x) for k, x in v.items()}
    return v


def to_jax(v):
    """A case's values as the JAX package's objects."""
    from qublas_tpu.anus import build_table, sqrt_func
    from qublas_tpu.complex import QComplexTensor
    from qublas_tpu.qtensor import from_raw

    if isinstance(v, tuple) and v and v[0] == "q":
        return from_raw(v[1], v[2])
    if isinstance(v, tuple) and v and v[0] == "c":
        return QComplexTensor(from_raw(v[1], v[3]), from_raw(v[2], v[4]))
    if isinstance(v, tuple) and v and v[0] == "lut":
        return build_table(sqrt_func, v[1], v[2])
    if isinstance(v, tuple) and v and v[0] == "per_device":
        return v[1]
    if isinstance(v, (tuple, list)):
        return type(v)(to_jax(x) for x in v)
    if isinstance(v, dict):
        return {k: to_jax(x) for k, x in v.items()}
    return v


def fmt_key(f):
    return (int(f.int_bits), int(f.frac_bits), bool(f.signed),
            int(f.round_mode), int(f.overflow_mode))


def norm(res):
    """A result of either side as plain Python values."""
    if isinstance(res, tuple) and res and res[0] == "q":
        _, fmt, raws, is_limb, is_pair = res
        return ("q", fmt_key(fmt), np.shape(raws),
                [int(v) for v in np.asarray(raws, dtype=object).reshape(-1)],
                is_limb, is_pair)
    if isinstance(res, tuple) and res and res[0] == "c":
        return ("c", norm(res[1]), norm(res[2]))
    if hasattr(res, "imag"):
        return ("c", norm_jax(res.real), norm_jax(res.imag))
    if hasattr(res, "fmt"):
        return norm_jax(res)
    return res


def norm_jax(t):
    return norm(("q", t.fmt, np.asarray(t.raw(), dtype=object),
                 bool(t.is_limb), bool(t.is_pair)))


def _jax_mesh(shape):
    from qublas_tpu.parallel import make_mesh

    dp, tp = shape
    return make_mesh(dp=dp, tp=tp, devices=jax.devices()[:dp * tp])


def _run_jax(fn_name, shape, args, kw):
    from qublas_tpu.parallel import sharding as S

    try:
        res = getattr(S, fn_name)(*to_jax(args), mesh=_jax_mesh(shape),
                                  **to_jax(kw))
        return ("ok", norm(res))
    except ValueError as e:
        return ("raise", ["ValueError"], str(e))


def _world_cases(world):
    cases = [(fn, shape, to_port(args), to_port(kw))
             for _, w, fn, shape, args, kw, _ in CASES if w == world]
    psum_fn = {"pair": "_psum_pair", "limb": "_psum_limbs"}
    return cases + [(psum_fn[kind], (1, tp),
                     (("per_rank", _psum_values(kind, tp)),),
                     dict(scatter=scatter))
                    for kind, tp, scatter in PSUMS if tp == world]


@pytest.fixture(scope="module")
def results():
    """Both sides of every case: the worlds start first and run while this
    process computes the JAX side; then their results are collected (each
    spawn with its own timeout: a rank that fails or hangs fails the
    module)."""
    from qublas_tpu_torch.parallel.dryrun import run_cases
    from qublas_tpu_torch.parallel.launch import start_world

    worlds = {w: start_world(w, "gloo", run_cases, (_world_cases(w), "cpu"),
                             timeout=WORLD_TIMEOUT) for w in (2, 4)}
    try:
        jax_side = [_run_jax(fn, shape, args, kw)
                    for _, _, fn, shape, args, kw, _ in CASES]
        ranks = {w: world.join() for w, world in worlds.items()}
    finally:
        for world in worlds.values():
            world.stop()
    port_side, at = [], {2: 0, 4: 0}
    for _, w, *_ in CASES:
        per_rank = [r[at[w]] for r in ranks[w]]
        at[w] += 1
        port_side.append([(s, norm(v)) if s == "ok" else (s, v, m)
                          for s, v, *m in per_rank])
    psums = []
    for _, tp, _ in PSUMS:
        psums.append([(r[at[tp]][0], r[at[tp]][1]) for r in ranks[tp]])
        at[tp] += 1
    return jax_side, port_side, psums


@pytest.mark.parametrize("idx", range(len(CASES)),
                         ids=[f"{cs[0]} [w{cs[1]}]" for cs in CASES])
def test_port_matches_jax(results, idx):
    cid, world, fn, shape, _, _, raises = CASES[idx]
    jax_res, port = results[0][idx], results[1][idx]
    assert len(port) == world
    if raises:
        assert jax_res[0] == "raise", f"{cid}: JAX did not raise"
        for r, got in enumerate(port):
            assert got[0] == "raise" and "ValueError" in got[1], \
                f"{cid}: rank {r} gave {got[:2]}, JAX raised {jax_res[2]}"
        return
    assert jax_res[0] == "ok", f"{cid}: JAX raised {jax_res[2]}"
    for r, got in enumerate(port):
        assert got[0] == "ok", f"{cid}: rank {r} raised {got[1:]}"
        assert got[1] == jax_res[1], f"{cid}: rank {r} != JAX"


# ---------------------------------------------------------------------------
# auto's choice, in this process (the port's choice communicates nothing)
# ---------------------------------------------------------------------------

def _jax_choice(entry, names, args, kw, shape):
    """The strategy the JAX package's ``auto`` calls: its strategy
    functions replaced by recorders for the call."""
    from qublas_tpu.parallel import sharding as S

    taken = []
    saved = {n: getattr(S, n) for n in names}
    try:
        for n in names:
            setattr(S, n, (lambda n: lambda *a, **k: taken.append(n))(n))
        getattr(S, entry)(*to_jax(args), mesh=_jax_mesh(shape),
                          **to_jax(kw))
    finally:
        for n, f in saved.items():
            setattr(S, n, f)
    assert len(taken) == 1, taken
    return taken[0]


QG_NAMES = ["sharded_qgemul_k", "sharded_qgemul_k_pipelined",
            "sharded_qgemul_k_tree", "sharded_qgemul_k_wide",
            "sharded_qgemul_k_wide_pipelined", "sharded_qgemul_k_limb",
            "sharded_qgemul_k_limb_pipelined", "sharded_qgemul_mn",
            "sharded_qgemul_dp"]
CG_NAMES = ["sharded_cgemul_k", "sharded_cgemul_k_tree", "sharded_cgemul_mn",
            "sharded_cgemul_dp"]

CHOICES = [
    ("k", (1, 8), (q(F34, (8, 64), 300), q(F34, (64, 8), 301), MID), GK),
    ("mn: k % tp", (1, 8), (q(F34, (8, 12), 302), q(F34, (12, 8), 303),
                            MID), GK),
    ("mn: lossy", (2, 4), (q(F88Z, (8, 8), 304), q(F88Z, (8, 8), 305),
                           F88Z), {}),
    ("mn: shallow split", (1, 8), (q(F88Z, (8, 27), 306),
                                   q(F88Z, (27, 8), 307), F88Z),
     dict(add_formats=(F88Z,))),
    ("k_tree: deep split", (1, 8), (q(F88Z, (4, 64), 308),
                                    q(F88Z, (64, 4), 309), F88Z),
     dict(add_formats=(F88Z,))),
    ("k_tree: mn infeasible", (2, 4), (q(F44Z, (3, 32), 310),
                                       q(F44Z, (32, 3), 311), F44Z),
     dict(add_formats=RL)),
    ("mn: host route refuses k_tree", (1, 8),
     (q(F88Z, (2, 64), 312), q(F88Z, (64, 2), 313), qformat(600, 600)), {}),
    ("k_limb over k_wide", (2, 4), (q(qformat(13, 0), (4, 96), 314),
                                    q(qformat(13, 0), (96, 4), 315),
                                    qformat(25, 0)),
     dict(mul_to=qformat(27, 0), add_formats=(qformat(40, 0),))),
    ("k_limb", (2, 4), (q(F40, (2, 16), 316), q(F40, (16, 3), 317),
                        qformat(60, 20,
                                overflow_mode=OverflowMode.SAT_TCPL)), LKW),
    ("k_wide", (2, 4), (q(FA_W, (2, 16), 318), q(FB_W, (16, 3), 319),
                        qformat(20, 6, overflow_mode=OverflowMode.SAT_ZERO)),
     WKW),
    ("dp", (2, 4), (q(F34, (8, 4, 8), 320), q(F34, (8, 6), 321), MID), GK),
    ("transposed operands", (1, 8), (q(F34, (64, 8), 322),
                                     q(F34, (8, 64), 323), MID),
     dict(GK, transpose_a=True, transpose_b=True)),
]


@pytest.mark.parametrize("cid,shape,args,kw", CHOICES,
                         ids=[ch[0] for ch in CHOICES])
def test_choose_strategy_matches_jax(cid, shape, args, kw):
    from qublas_tpu_torch.parallel import choose_strategy
    from qublas_tpu_torch.parallel.dryrun import _decode
    from qublas_tpu_torch.ops.gemm import _swap

    want = _jax_choice("shard_qgemul", QG_NAMES, args, kw, shape)
    a, b, out = _decode(to_port(args), "cpu")
    pkw = to_port(kw)
    if pkw.pop("transpose_a", False):
        a = _swap(a)
    if pkw.pop("transpose_b", False):
        b = _swap(b)
    got = choose_strategy(a, b, out, {"dp": shape[0], "tp": shape[1]},
                          **pkw)
    assert "sharded_qgemul_" + got == want, (cid, got, want)


CCHOICES = [
    ("k", (2, 4), (c(F34, (4, 16), 330), c(F34, (16, 8), 332), COUT_Z),
     CTF),
    ("mn: lossy", (2, 4), (c(F44Z, (4, 8), 334), c(F44Z, (8, 8), 336),
                           (F44Z, F44Z)), dict(algo="tf")),
    ("k_tree: n < tp", (1, 8), (c(F44Z, (3, 64), 338), c(F44Z, (64, 3), 340),
                                (F44Z, F44Z)), dict(algo="tf")),
    ("mn: k % tp", (1, 8), (c(F34, (4, 12), 342), c(F34, (12, 8), 344),
                            COUT_Z), CTF),
    ("dp", (2, 4), (c(F34, (8, 2, 4), 346), c(F34, (8, 4, 3), 348),
                    COUT_Z), CTF),
]


@pytest.mark.parametrize("cid,shape,args,kw", CCHOICES,
                         ids=[ch[0] for ch in CCHOICES])
def test_choose_cgemul_strategy_matches_jax(cid, shape, args, kw):
    from qublas_tpu_torch.parallel import choose_cgemul_strategy
    from qublas_tpu_torch.parallel.dryrun import _decode

    want = _jax_choice("sharded_cgemul", CG_NAMES, args, kw, shape)
    a, b, out = _decode(to_port(args), "cpu")
    got = choose_cgemul_strategy(a, b, out, {"dp": shape[0],
                                             "tp": shape[1]},
                                 **to_port(kw))
    assert "sharded_cgemul_" + got == want, (cid, got, want)


# ---------------------------------------------------------------------------
# the pair and limb psums against the JAX package's column psums
# ---------------------------------------------------------------------------

def _jax_column_psum(kind, tp, scatter):
    """The JAX package's ``_psum_pair`` or ``_psum_limbs`` under shard_map
    over tp devices, device d holding entry d of ``_psum_values``: the
    global result."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from qublas_tpu.parallel import sharding as S

    mesh = _jax_mesh((1, tp))
    vals = _psum_values(kind, tp)
    if kind == "pair":
        hi = jnp.asarray((vals >> 32).astype(np.int32))
        lo = jnp.asarray((vals & 0xFFFFFFFF).astype(np.uint32))
        out = P(None, "tp") if scatter else P(None, None)

        @functools.partial(jax.shard_map, mesh=mesh,
                           in_specs=(P("tp"), P("tp")), out_specs=(out, out))
        def block(h, lw):
            return S._psum_pair(h[0], lw[0], scatter)

        h, lw = block(hi, lo)
        return (np.asarray(h).astype(np.int64) << 32) \
            | np.asarray(lw).astype(np.int64)
    out = P(None, None, "tp") if scatter else P(None, None, None)

    @functools.partial(jax.shard_map, mesh=mesh, in_specs=(P("tp"),),
                       out_specs=out)
    def block_l(x):
        return S._psum_limbs(x[0], scatter)

    return np.asarray(block_l(jnp.asarray(vals.astype(np.uint32)))) \
        .astype(np.int64)


def _pair_values(tp, seed):
    r = np.random.RandomState(seed)
    v = r.randint(-(1 << 62), 1 << 62, size=(tp, 3, 4), dtype=np.int64) * 2
    v[0, 0, 0] = np.iinfo(np.int64).max      # the sum wraps mod 2^64
    v[1, 0, 0] = 5
    return v


def _limb_values(tp, seed, kw=3):
    r = np.random.RandomState(seed)
    v = r.randint(0, 1 << 32, size=(tp, kw, 3, 4), dtype=np.int64)
    v[:, 0, 0, 0] = 0xFFFFFFFF                # carries through every limb
    v[:, 1, 0, 0] = 0xFFFFFFFF
    return v


# (kind, tp, scatter): the port's _psum_pair / _psum_limbs in the world of
# tp ranks, rank d holding entry d of the values
PSUMS = [("pair", 4, False), ("limb", 4, False), ("limb", 2, True)]


def _psum_values(kind, tp):
    return _pair_values(tp, 400 + tp) if kind == "pair" \
        else _limb_values(tp, 500 + tp)


@pytest.mark.parametrize("pi", range(len(PSUMS)),
                         ids=[f"{k}-tp{t}-{'scatter' if s else 'psum'}"
                              for k, t, s in PSUMS])
def test_psum_bits_equal_jax_columns(results, pi):
    """The port's pair psum (one int64 psum, mod 2^64) and limb psum
    (int64 sums of the 32-bit limbs, one carry pass), run in a world,
    give on every rank the bits of the JAX package's 16-bit-column psums
    with their carry passes, on the same per-device values: a sum that
    wraps, and carries through every limb.  With ``scatter`` each rank
    holds its N-block of the sum."""
    kind, tp, scatter = PSUMS[pi]
    want = _jax_column_psum(kind, tp, scatter)
    per_rank = results[2][pi]
    assert len(per_rank) == tp
    blk = want.shape[-1] // tp
    for r, (status, got) in enumerate(per_rank):
        assert status == "ok", got
        ref = want[..., r * blk:(r + 1) * blk] if scatter else want
        assert got[0] == "t" and np.array_equal(got[1], ref), (kind, r)


def test_psum_tp_bound_guard():
    """tp >= 2^15 is refused by the wide and limb strategies, as in the
    JAX package."""
    from qublas_tpu.parallel.sharding import _check_psum_tp as jax_check
    from qublas_tpu_torch.parallel.sharding import (_PSUM_COLS_MAX_TP,
                                                    _check_psum_tp)

    class FakeMesh:
        shape = {"tp": _PSUM_COLS_MAX_TP}

    with pytest.raises(ValueError, match="2\\^15"):
        jax_check(FakeMesh())
    with pytest.raises(ValueError, match="2\\^15"):
        _check_psum_tp(FakeMesh())
    FakeMesh.shape = {"tp": _PSUM_COLS_MAX_TP - 1}
    jax_check(FakeMesh())
    _check_psum_tp(FakeMesh())


def test_exports_match_the_jax_package():
    import qublas_tpu.parallel as jp
    import qublas_tpu_torch.parallel as tp_

    assert set(jp.__all__) <= set(tp_.__all__)
    assert "dryrun_multichip" in tp_.__all__
    for name in tp_.__all__:
        assert callable(getattr(tp_, name)), name


def test_k_tree_split_geometry_matches_jax():
    from qublas_tpu.parallel.sharding import _k_tree_split as jax_split
    from qublas_tpu_torch.parallel.sharding import _k_tree_split

    for k in range(1, 130):
        for tp in (1, 2, 3, 4, 8):
            assert _k_tree_split(k, tp) == jax_split(k, tp), (k, tp)


def test_world_of_one_and_mesh_shape():
    """A world of one process: ``make_mesh`` refuses a grid that does not
    hold the world, as the JAX package's refuses one that does not hold
    its devices, and the dry run passes on a (1, 1) mesh in a spawned
    world of one."""
    import torch.distributed as dist

    from qublas_tpu_torch.parallel import (dryrun_multichip,
                                           init_distributed, make_mesh)

    assert init_distributed(backend="gloo") == 1
    try:
        with pytest.raises(ValueError, match="devices"):
            make_mesh(1, 2, "cpu")
        mesh = make_mesh(1, 1, "cpu")
        assert mesh.shape == {"dp": 1, "tp": 1}
        assert mesh.get_local_rank("tp") == 0
    finally:
        dist.destroy_process_group()
    done = dryrun_multichip(1, backend="gloo", devices="cpu", timeout=120)
    assert "k psum" in done and "mn limb operands" in done
