"""Reference of one quantized GEMM, ``qgemul(a, b, out, mul_to, add)``,
at one of a configuration's FFN projections: ``fc1`` is
[rows, hidden] @ [hidden, intermediate], ``fc2`` [rows, intermediate] @
[intermediate, hidden].  The pooled input is ``a``; ``b`` is the weight.
"""

from __future__ import annotations

from .fixedpoint import Fmt, gemm

POOLED = "a"


def formats(config):
    f = config["formats"]
    return (Fmt.of(f["a"]), Fmt.of(f["b"]), Fmt.of(f["out"]),
            Fmt.of(f.get("mul_to")), tuple(Fmt.of(x) for x in f["add"]))


def _dims(config, traffic):
    rows = traffic["sequences"] * traffic["seq_len"]
    h, i = config["hidden_size"], config["intermediate_size"]
    k, n = {"fc1": (h, i), "fc2": (i, h)}[traffic["projection"]]
    return rows, k, n


def operands(config, traffic):
    fa, fb = formats(config)[:2]
    rows, k, n = _dims(config, traffic)
    return {"a": ((rows, k), fa), "b": ((k, n), fb)}


def work(config, traffic):
    fa, fb, out = formats(config)[:3]
    rows, k, n = _dims(config, traffic)
    return {"products": rows * k * n,
            "bytes": fa.storage_bytes * rows * k + fb.storage_bytes * k * n
            + out.storage_bytes * rows * n}


def forward(a, weights, config, control=False):
    fa, fb, out, mul_to, add = formats(config)
    return gemm(a, weights["b"], fa, fb, out, mul_to, add, control)
