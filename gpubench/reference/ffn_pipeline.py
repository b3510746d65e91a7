"""Reference of the FFN datapath: ``num_hidden_layers`` blocks of
``entry()``'s pipeline at a configuration's widths, each block

    y = qgemul(rom(qgemul(x, w1, out, mul_to=acc, add=(acc,))).cast(operand),
               w2, out, mul_to=acc, add=(acc,))

x [rows, hidden] @ w1 [hidden, intermediate] -> the ROM of ``out`` onto
itself -> the cast back to the operand format -> @ w2 [intermediate,
hidden].  A block's output raws are the next block's input raws (``out``
and the operand format differ in their overflow mode only).  The pooled
input is ``x``; ``w1`` [layers, hidden, intermediate] and ``w2`` [layers,
intermediate, hidden] are the blocks' weights.
"""

from __future__ import annotations

from .fixedpoint import Fmt, gemm, requantize, rom_lookup, rom_table

POOLED = "x"


def formats(config):
    f = config["formats"]
    return Fmt.of(f["operand"]), Fmt.of(f["accumulate"]), Fmt.of(f["out"])


def operands(config, traffic):
    """name -> (shape, format) of every operand; ``POOLED`` is the one
    that changes from batch to batch."""
    fa = formats(config)[0]
    rows = traffic["sequences"] * traffic["seq_len"]
    h, i = config["hidden_size"], config["intermediate_size"]
    n = config["num_hidden_layers"]
    return {"x": ((rows, h), fa), "w1": ((n, h, i), fa),
            "w2": ((n, i, h), fa)}


def work(config, traffic):
    """Per batch: products (sum of M*N*K over its GEMMs) and the bytes
    that any implementation reads and writes once (x, every block's w1
    and w2, and y)."""
    fa, _, out = formats(config)
    rows = traffic["sequences"] * traffic["seq_len"]
    h, i = config["hidden_size"], config["intermediate_size"]
    n = config["num_hidden_layers"]
    return {"products": 2 * n * rows * h * i,
            "bytes": fa.storage_bytes * (rows * h + 2 * n * h * i)
            + out.storage_bytes * rows * h}


def forward(x, weights, config, control=False):
    fa, acc, out = formats(config)
    rom = rom_table(config["rom"], out, out)
    for w1, w2 in zip(weights["w1"], weights["w2"]):
        h = gemm(x, w1, fa, fa, out, acc, (acc,), control)
        h = requantize(rom_lookup(h, rom), out.frac_bits, fa)
        x = gemm(h, w2, fa, fa, out, acc, (acc,), control)
    return x
