"""Worked example: simulating a fixed-point ASIC datapath on the GPU.

The QuBLAS workflow (pick formats, run the quantized datapath bit-exactly,
inspect where precision is lost, export golden vectors for RTL comparison)
end to end on ``qublas_tpu_torch``: the port of the JAX package's
``examples/asic_datapath_sim.py``, with the same inputs and the same bits.

    python -m qublas_tpu_torch.examples.asic_datapath_sim \\
        [--device cpu] [--checkpoint PATH]
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

import qublas_tpu_torch as q
from qublas_tpu_torch import OverflowMode, RoundMode, qformat
from qublas_tpu_torch.examples._world import run_sharded, world_for


def formats():
    """8-bit activations and weights, a 20-bit accumulator, convergent
    rounding back to 8 bits with overflow to zero (a common ASIC "flag
    overflow loudly" choice): (act, wgt, acc, out)."""
    return (qformat(3, 4), qformat(1, 6), qformat(12, 8),
            qformat(3, 4, round_mode=RoundMode.RND_CONV,
                     overflow_mode=OverflowMode.SAT_ZERO))


def scale_out(x_raws, w_raws, device):
    """One rank of step 8: the GEMM sharded over the world's mesh."""
    from qublas_tpu_torch.parallel import make_mesh, shard_qgemul

    act, wgt, acc, out = formats()
    mesh = make_mesh(dp=1, devices=device)
    ys = shard_qgemul(q.from_raw(x_raws, act, device),
                      q.from_raw(w_raws, wgt, device), out, mesh,
                      mul_to=acc, add_formats=(acc,))
    return np.asarray(ys.raw())


def main(device="cuda", checkpoint=None):
    """Run the datapath on ``device``; the checkpoint of step 7 goes to
    ``checkpoint`` (a temporary directory's file when None)."""
    # the rank function by its import path, which spawned ranks import
    # (run as __main__, this file's own functions would not pickle so)
    from qublas_tpu_torch.examples import asic_datapath_sim as me

    rng = np.random.RandomState(1)

    # 1. Datapath formats
    act, wgt, acc, out = formats()

    # 2. Inputs: exact double -> fixed conversion (bit-identical to the
    #    reference's 2400-bit constructor path)
    x = q.from_float(rng.randn(64, 128) * 0.8, act, device)
    w = q.from_float(rng.randn(128, 64) * 0.4, wgt, device)

    # 3. The quantized GEMM: per-product quantization to `acc`, tree
    #    accumulation at `acc`, converting assignment into `out`.  The
    #    exactness proof routes it to K1, the int8 tensor-core GEMM with
    #    one fused shift-round-saturate epilogue.
    y = q.qgemul(x, w, out, mul_to=acc, add_formats=(acc,))
    print("GEMM out:", y)

    # 4. Where is precision going?
    stats = q.requant_stats(x, qformat(1, 4))
    print(f"requant act->Q1.4: {int(stats.saturated)}/{int(stats.total)} "
          f"saturate, {int(stats.rounded)} round")
    print("range report:", q.format_range_report(y))

    # 5. A LUT nonlinearity (ASIC ROM) applied to the GEMM's output
    table = q.build_table(q.sqrt_func, out, out)
    y_act = q.qgemul(x, w, out, mul_to=acc, add_formats=(acc,),
                     epilogue_lut=table)
    print("with fused sqrt ROM:", y_act)

    # 6. Golden vectors for RTL comparison: the BitStream wire format
    record = q.dumps_bits(y[:2, :4])
    print("BitStream record:", record.splitlines()[0],
          record.splitlines()[1][:48] + "...")
    back = q.loads_bits(record, device)
    assert (np.asarray(back.raw()) == np.asarray(y[:2, :4].raw())).all()

    # 7. Checkpoint the whole state
    with tempfile.TemporaryDirectory() as tmp:
        path = checkpoint or os.path.join(tmp, "datapath_ckpt.npz")
        q.save(path, {"x": x, "w": w, "y": y})
        restored = q.load(path, device)
    assert (np.asarray(restored["y"].raw()) == np.asarray(y.raw())).all()
    print("checkpoint round-trip OK")

    # 8. Scale out: the same GEMM sharded over a world of ranks
    ranks, backend = world_for(device)
    for ys in run_sharded(me.scale_out, (np.asarray(x.raw()),
                                         np.asarray(w.raw()), str(device)),
                          device):
        assert (ys == np.asarray(y.raw())).all()
    print(f"sharded over {ranks} rank(s) ({backend}): bit-identical")
    return y


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--checkpoint", default=None,
                   help="where step 7 writes its checkpoint (.npz)")
    a = p.parse_args()
    main(a.device, a.checkpoint)
