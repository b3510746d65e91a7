"""Wide formats on the device and sharded execution, end to end.

The port of the JAX package's ``examples/wide_formats_and_sharding.py``: a
40-bit accumulator datapath (the reference's multiword ArbiInt territory,
QuBLAS.h:566-912).

1. 33..64-bit formats live on the device in one int64 a value (pair
   storage): the elementwise ops, reductions and GEMMs run there
   bit-exactly.
2. 65..992-bit formats also live on the device, as stacked 32-bit limbs
   (``ops/limbint.py``); only wider formats (and raws beyond the storage
   word) take exact host ints, served by the native engine.
3. The same GEMM and reduction shard over a mesh of ranks
   (``qublas_tpu_torch.parallel``), each rank bit-identical to the
   single-device call.

    python -m qublas_tpu_torch.examples.wide_formats_and_sharding \\
        [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

import qublas_tpu_torch as q
from qublas_tpu_torch import refrand
from qublas_tpu_torch.examples._world import run_sharded
from qublas_tpu_torch.qformat import OverflowMode, QFormat


def sharded_rank(device):
    """One rank of part 3: the K-sharded GEMM and the batch-sharded
    reduction on the world's mesh, each against the single-device call."""
    from qublas_tpu_torch.parallel import make_mesh, shard_qgemul, \
        sharded_qreduce

    mesh = make_mesh(dp=1, devices=device)
    tp = mesh.shape["tp"]
    fa = q.qformat(3, 4)
    wide32 = q.qformat(20, 8)
    out = q.qformat(3, 4, overflow_mode=OverflowMode.SAT_ZERO)
    A = q.random_fill((8, 8 * tp), fa, seed=1, device=device)
    B = q.random_fill((8 * tp, 8 * tp), fa, seed=2, device=device)
    C = shard_qgemul(A, B, out, mesh, mul_to=wide32,
                     add_formats=(wide32,))  # auto: K-psum (lossless)
    ref = q.qgemul(A, B, out, mul_to=wide32, add_formats=(wide32,))
    xr = q.random_fill((tp * 2, 16), fa, seed=3, device=device)
    rr = sharded_qreduce(xr, (wide32,), axis=1, mesh=mesh)
    rref = q.qreduce(xr, (wide32,), axis=1)
    return (dict(mesh.shape),
            np.array_equal(np.asarray(C.raw()), np.asarray(ref.raw())),
            np.array_equal(np.asarray(rr.raw()), np.asarray(rref.raw())))


def main(device="cuda"):
    # the rank function by its import path, which spawned ranks import
    # (run as __main__, this file's own functions would not pickle so)
    from qublas_tpu_torch.examples import wide_formats_and_sharding as me

    print("device:", device)

    # -- 1. a 40-bit-storage format, on the device in pair storage --------
    acc40 = QFormat(30, 9)               # 40-bit storage
    x = refrand.reference_fill((4, 8), acc40, gen=refrand.MT19937(1),
                               device=device)
    print(f"\n40-bit tensor: is_pair={x.is_pair} (int64 pair storage)")

    small = q.qformat(3, 4)
    w = q.from_float(np.linspace(-2.0, 2.0, 8), small, device)
    y = q.qmul(x, w, to=QFormat(38, 10))         # pair x lane
    print("wide qmul out fmt:", y.fmt, "| first row:", y.to_double()[0][:3])

    r = q.qreduce(y, (QFormat(44, 10),), axis=1)  # wide tree reduce
    print("wide qreduce:", r.to_double())

    # -- 2. 141-bit formats: stacked 32-bit limbs on the device -----------
    wide = QFormat(100, 40)
    a = q.from_raw(np.array([(1 << 90) + 12345, -(1 << 95)], dtype=object),
                   wide, device)
    print(f"\n141-bit tensor: is_limb={a.is_limb} (limb storage)")
    b = q.from_float([2.0, 0.5], q.qformat(3, 4), device)
    p = q.qmul(a, b, to=QFormat(110, 40))
    print(f"141-bit qmul (limbs): {p.raw()}")

    # -- 2b. a wide GEMM (pair x lane operands; at scale qgemul streams
    # over k-chunks, peak memory [m, 64, n])
    ga = refrand.reference_fill((4, 48), acc40, gen=refrand.MT19937(7),
                                device=device)
    gb = refrand.reference_fill((48, 4), small, gen=refrand.MT19937(8),
                                device=device)
    big = q.qgemul(ga, gb, QFormat(34, 9))
    print("wide GEMM out fmt:", big.fmt, "| [0,0] =", big.to_double()[0][0])

    # -- 3. sharded execution over a world of ranks ------------------------
    for shape, gemm_ok, reduce_ok in run_sharded(me.sharded_rank,
                                                 (str(device),), device):
        assert gemm_ok and reduce_ok
    print(f"\nsharded GEMM over {shape}: bit-exact = {gemm_ok}")
    print("sharded qreduce bit-exact =", reduce_ok)
    return big


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    main(p.parse_args().device)
