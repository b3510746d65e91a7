"""End-to-end sharded deployment walkthrough.

The port of the JAX package's ``examples/sharded_deployment.py``: a
quantized datapath (GEMM + ANUS ROM + complex GEMM + tree reduction) over
a mesh of ranks with each sharding regime of ``qublas_tpu_torch.parallel``,
every result bit-identical to the single-device call, then a checkpoint of
the results.  The ranks run in a world spawned by
``qublas_tpu_torch.parallel.launch``: one NCCL rank on the card, two Gloo
ranks on the CPU.

    python -m qublas_tpu_torch.examples.sharded_deployment \\
        [--device cpu] [--checkpoint PATH]
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from qublas_tpu_torch import anus, checkpoint
from qublas_tpu_torch.complex import QComplexTensor
from qublas_tpu_torch.examples._world import run_sharded, world_for
from qublas_tpu_torch.ops.cgemm import cgemul
from qublas_tpu_torch.ops.gemm import qgemul
from qublas_tpu_torch.ops.reduce import qreduce
from qublas_tpu_torch.qformat import OverflowMode, qformat
from qublas_tpu_torch.qtensor import from_raw

FA = qformat(3, 4)
WIDE = qformat(20, 8)
MID = qformat(3, 4, overflow_mode=OverflowMode.SAT_ZERO)
F88Z = qformat(8, 8, overflow_mode=OverflowMode.SAT_ZERO)
M5 = qformat(5, 4)
CKW = dict(algo="tf", add_formats=(WIDE,), ab=M5, cd=M5, ba=M5, abc=WIDE,
           cdb=WIDE, bad=WIDE, AB=WIDE, BC=WIDE)


def operands(tp: int) -> dict:
    """The walkthrough's raws, from ``RandomState(0)``, for tp ranks."""
    rng = np.random.RandomState(0)

    def rand(fmt, shape):
        return rng.randint(fmt.raw_min, fmt.raw_max + 1, shape)

    return {"a": rand(FA, (8, 8 * tp)), "w1": rand(FA, (8 * tp, 8 * tp)),
            "at": rand(F88Z, (8, 8 * tp)), "bt": rand(F88Z, (8 * tp, 4)),
            "car": rand(FA, (4, 8 * tp)), "cai": rand(FA, (4, 8 * tp)),
            "cbr": rand(FA, (8 * tp, 2 * tp)),
            "cbi": rand(FA, (8 * tp, 2 * tp)), "xv": rand(F88Z, (8 * tp,))}


def deployment_rank(ops, device):
    """One rank: each step sharded, held to the single-device call; the
    lines to print and the raws of the results to checkpoint."""
    from qublas_tpu_torch.parallel import (make_mesh, shard_qgemul,
                                           sharded_cgemul,
                                           sharded_qreduce_k_tree)

    mesh = make_mesh(dp=1, devices=device)
    tp = mesh.shape["tp"]
    lines = [f"mesh: dp=1 x tp={tp} over {tp} rank(s)"]

    def t(name, fmt):
        return from_raw(ops[name], fmt, device)

    # 1) lossless int8 GEMM and an ANUS ROM: auto picks K-sharding (a psum)
    #    because the accumulation proves lossless
    table = anus.build_table(anus.rsqrt_func, MID, MID)
    a, w1 = t("a", FA), t("w1", FA)
    h = shard_qgemul(a, w1, MID, mesh, mul_to=WIDE, add_formats=(WIDE,),
                     epilogue_lut=table)
    ref_h = qgemul(a, w1, MID, mul_to=WIDE, add_formats=(WIDE,),
                   epilogue_lut=table)
    np.testing.assert_array_equal(np.asarray(h.raw()),
                                  np.asarray(ref_h.raw()))
    lines.append("lossless GEMM + ROM: K-sharded, bit-exact")

    # 2) order-sensitive (saturating per layer) GEMM: the k_tree split
    #    shards the contraction dim with no losslessness requirement
    at, bt = t("at", F88Z), t("bt", F88Z)
    y = shard_qgemul(at, bt, F88Z, mesh, add_formats=(F88Z,),
                     strategy="k_tree")
    ref_y = qgemul(at, bt, F88Z, add_formats=(F88Z,))
    np.testing.assert_array_equal(np.asarray(y.raw()),
                                  np.asarray(ref_y.raw()))
    lines.append("order-sensitive GEMM: k_tree-sharded, bit-exact")

    # 3) complex GEMM (TF algorithm with its per-step tags), auto-sharded
    ca = QComplexTensor(t("car", FA), t("cai", FA))
    cb = QComplexTensor(t("cbr", FA), t("cbi", FA))
    cy = sharded_cgemul(ca, cb, (MID, MID), mesh, **CKW)
    ref_c = cgemul(ca, cb, (MID, MID), **CKW)
    for part in ("real", "imag"):
        np.testing.assert_array_equal(
            np.asarray(getattr(cy, part).raw()),
            np.asarray(getattr(ref_c, part).raw()))
    lines.append("TF complex GEMM: auto-sharded, bit-exact")

    # 4) order-sensitive tree reduction, sharded along its axis (k_tree)
    xv = t("xv", F88Z)
    rv = sharded_qreduce_k_tree(xv, (F88Z,), mesh=mesh)
    ref_r = qreduce(xv, (F88Z,))
    assert int(np.asarray(rv.raw())) == int(np.asarray(ref_r.raw()))
    lines.append("order-sensitive Qreduce: k_tree-sharded, bit-exact")
    return lines, np.asarray(h.raw()), h.fmt, np.asarray(y.raw()), y.fmt


def main(device="cuda", path=None):
    """Run the walkthrough on ``device``; the checkpoint goes to ``path``
    (a temporary directory's file when None)."""
    # the rank function by its import path, which spawned ranks import
    # (run as __main__, this file's own functions would not pickle so)
    from qublas_tpu_torch.examples import sharded_deployment as me

    ranks, _ = world_for(device)
    res = run_sharded(me.deployment_rank, (operands(ranks), str(device)),
                      device)
    lines, h_raw, h_fmt, y_raw, y_fmt = res[0]
    for other in res[1:]:
        assert np.array_equal(other[1], h_raw) \
            and np.array_equal(other[3], y_raw)
    for line in lines:
        print(line)

    # 5) checkpoint the results (raw-exact npz tree) and restore
    h, y = from_raw(h_raw, h_fmt, device), from_raw(y_raw, y_fmt, device)
    with tempfile.TemporaryDirectory() as tmp:
        path = path or os.path.join(tmp, "deployment_ckpt.npz")
        checkpoint.save(path, {"h": h, "y": y})
        back = checkpoint.load(path, device)
    np.testing.assert_array_equal(np.asarray(back["y"].raw()),
                                  np.asarray(y.raw()))
    print("checkpoint round-trip: bit-exact")
    print("sharded deployment example OK")
    return y


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--checkpoint", default=None,
                   help="where the results' checkpoint goes (.npz)")
    a = p.parse_args()
    main(a.device, a.checkpoint)
