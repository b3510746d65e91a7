"""One quantized GEMM through ``qublas_tpu_torch.qgemul``."""

from __future__ import annotations

import qublas_tpu_torch as qt

from .ffn_pipeline import qformat


def build(config: dict, traffic: dict, weights: dict):
    if traffic.get("compile"):
        raise ValueError("the qgemul datapath runs eagerly")
    f = config["formats"]
    fa, fb, out = (qformat(f[k]) for k in ("a", "b", "out"))
    mul_to = qformat(f["mul_to"]) if f.get("mul_to") else None
    add = tuple(qformat(x) for x in f["add"])
    b = qt.QTensor(weights["b"], fb)

    def gemm(a):
        return qt.qgemul(qt.QTensor(a, fa), b, out, mul_to=mul_to,
                         add_formats=add).data
    return gemm
