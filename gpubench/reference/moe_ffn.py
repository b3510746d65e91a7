"""Reference of the MoE datapath: ``num_hidden_layers`` DeepSeek-V3 MoE
layers (``modeling_deepseek.py``'s ``DeepseekV3RMSNorm`` before its
``MoEGate`` and ``DeepseekV3MoE``, as a decoder layer's
``post_attention_layernorm`` and ``mlp``) on fixed-point raws, each
layer's output raws the next one's input raws.

One layer, formats by their names in the configuration's ``formats``,
on the layer's input raws ``y`` (``operand``) of ``hidden`` columns:

    ss     = sum of y^2 over the row    ``sumsq``, lossless
    r      = rsqrt ROM(ss cast to ``sumsq_rom``)               ``rsqrt``
    s      = r * (norm_rms * sqrt(hidden) in ``norm_gain``) -> ``norm_scale``
    x      = y * s                      ``normed`` (RMSNorm: rows at RMS
                                        ``norm_rms``; same raws as
                                        ``operand``, rounded to nearest)
    logits = x @ wr                     lossless dot into ``logit``
    s      = sigmoid ROM(logits)        ``score``
    c      = s + bias                   ``choice``, lossless
    each of ``n_group`` groups is scored by the sum of its 2 largest c and
    the ``topk_group`` best are kept; idx = the ``num_experts_per_tok``
    largest c among the kept groups' experts
    t      = sum of s over idx          ``total``, lossless
    r      = reciprocal ROM(t cast to ``total_rom``)       ``recip``
    w      = ((s * r -> ``norm``) * routed_scaling_factor) -> ``weight``
    for each held expert e and the rows routed to it, and for the shared
    expert on every row (SwiGLU):
        g = SiLU ROM(x_e @ wg_e -> ``gate``)                ``operand``
        u = x_e @ wu_e                                      ``operand``
        h = (g * u -> ``gu``) cast to ``operand``
        d = h @ wd_e                                        ``down``
    acc    = shared d + sum over the held pairs of (w * d -> ``pair``),
             lossless in ``acc``
    y      = acc -> ``out``

Every GEMM is ``qgemul(a, b, out, mul_to=accumulate, add=(accumulate,))``,
lossless, so an exact float64 product (``fixedpoint.gemm``).

Departures from ``modeling_deepseek.py``, each a choice of the simulated
datapath: fixed-point formats in place of bfloat16 and float32; exact ROMs
(``Qtable``) in place of the float sigmoid, SiLU and the division by the
sum (a reciprocal of the sum cast to ``total_rom``, no 1e-20 term: a zero
sum gives r = 0); ties in either selection go to the lower group index and
the lower expert index (``torch.topk`` promises no order among ties); only
the kept groups' experts can be chosen; the combine sums requantized
products losslessly in an integer format, where the model sums bfloat16
products; RMSNorm's weight is one scalar, folded into ``norm_gain``
with its mean (``norm_rms`` is the rows' RMS after it) and its ``eps``
below the ROM's resolution (a zero row stays zero: the rsqrt ROM gives
0 for a zero sum); attention and the residual are not simulated.

Expert parallelism: the configuration holds ``n_routed_experts`` experts,
indices ``held_first`` on, of the ``router_experts`` that the router scores.
The layer routes over all of them and computes the held experts' part and
the shared expert's; the part of absent experts is left out, in the
program and here alike, and that partial result goes on to the next layer.

Operands, each [out, in] per projection as ``torch.nn.Linear`` stores its
weight (K-major): ``x`` [rows, hidden] (pooled), ``wr`` [layers,
router_experts, hidden], ``bias`` [layers, router_experts], ``wg`` and
``wu`` [layers, held, width, hidden], ``wd`` [layers, held, hidden,
width], ``sg`` and ``su`` [layers, shared width, hidden], ``sd`` [layers,
hidden, shared width].  ``forward`` runs blocks of ``BLOCK_ROWS`` rows
through all the layers, so that it fits beside what a run keeps; each
block converts every expert's weights to float64 once a layer.
"""

from __future__ import annotations

import functools
import math

import torch

from . import fixedpoint as fp
from .fixedpoint import Fmt, gemm, requantize, rom_lookup

POOLED = "x"
BLOCK_ROWS = 32768
WORK = "_work"   # the configuration's key for work()'s counts

# this datapath's ROMs, by name in fixedpoint's table of ROM functions
ROMS = {
    "sigmoid": lambda v: 1.0 / (1.0 + math.exp(-v)),
    "silu": lambda v: v / (1.0 + math.exp(-v)),
    "reciprocal": lambda v: 1.0 / v if v != 0 else math.inf,
    "rsqrt": lambda v: 1.0 / math.sqrt(v) if v > 0 else (
        math.inf if v == 0 else math.nan),
}
for _name, _fn in ROMS.items():
    fp.ROM_FUNCTIONS.setdefault(_name, _fn)

FORMATS = ("operand", "sumsq", "sumsq_rom", "rsqrt", "norm_gain",
           "norm_scale", "normed", "accumulate", "logit", "score", "bias", "choice",
           "total", "total_rom", "recip", "norm", "scale", "weight", "gate",
           "gu", "down", "pair", "acc", "out")


def formats(config) -> dict:
    return {k: Fmt.of(config["formats"][k]) for k in FORMATS}


@functools.lru_cache(maxsize=None)
def rom(func: str, in_fmt: Fmt, out_fmt: Fmt) -> torch.Tensor:
    """``fixedpoint.rom_table``, built once a process (the sigmoid's has
    65,536 entries)."""
    return fp.rom_table(func, in_fmt, out_fmt)


def _dims(config, traffic):
    rows = traffic["sequences"] * traffic["seq_len"]
    return (rows, config["hidden_size"], config["moe_intermediate_size"],
            config["n_shared_experts"] * config["moe_intermediate_size"],
            config["router_experts"], config["n_routed_experts"],
            config["num_hidden_layers"])


def operands(config, traffic):
    """name -> (shape, format) of every operand; ``POOLED`` is the one
    that changes from batch to batch."""
    f = formats(config)
    op = f["operand"]
    rows, h, w, ws, e_all, held, n = _dims(config, traffic)
    return {"x": ((rows, h), op), "wr": ((n, e_all, h), op),
            "bias": ((n, e_all), f["bias"]),
            "wg": ((n, held, w, h), op), "wu": ((n, held, w, h), op),
            "wd": ((n, held, h, w), op),
            "sg": ((n, ws, h), op), "su": ((n, ws, h), op),
            "sd": ((n, h, ws), op)}


def expected_pairs(config, traffic) -> float:
    """(row, expert) pairs a batch routes to the held experts, a layer:
    rows * top_k where every expert is held, else their expected count if
    the router spreads rows evenly, rows * top_k * held / experts."""
    rows, *_ = _dims(config, traffic)
    return (rows * config["num_experts_per_tok"] * config["n_routed_experts"]
            / config["router_experts"])


class Work(dict):
    """``work()``'s counts a batch.  The routed experts' GEMMs take the
    pairs that the data routes to the held experts, which ``forward``
    counts: ``routed(pairs)`` adds one batch's pairs over its layers, and
    ``products`` and ``expert_products`` then count the mean over the
    batches routed so far."""

    def __init__(self, router, shared, per_pair, pairs, **counts):
        super().__init__(counts)
        self.router, self.shared, self.per_pair = router, shared, per_pair
        self.batches, self.pairs = 0, 0
        self._count(pairs)

    def _count(self, pairs):
        self["expert_products"] = self.shared + self.per_pair * pairs
        self["products"] = self.router + self["expert_products"]

    def routed(self, pairs: int):
        self.batches += 1
        self.pairs += pairs
        self._count(self.pairs / self.batches)


def work(config, traffic):
    """Per batch: products (sum of M*N*K over its GEMMs) and the bytes
    that any implementation reads and writes once (x, every layer's
    weights, y); the experts' share of both (``expert_products``,
    ``expert_bytes``: the held and the shared experts' three projections).

    The routed GEMMs' M is the pairs that a batch routes to the held
    experts, which its data sets (a seed's pool routes up to about 1%
    more or fewer than ``expected_pairs``).  The counts are kept in ``config[WORK]``,
    where ``forward`` adds the pairs of each batch it routes, so that they
    count the mean over the batches it has run since this call: before a
    run's metrics are read, the check has run ``forward`` once on every
    pool entry, which the window's batches cycle through.  Until then
    they count ``expected_pairs``."""
    f = formats(config)
    op = f["operand"].storage_bytes
    rows, h, w, ws, e_all, held, n = _dims(config, traffic)
    expert_bytes = n * 3 * h * (held * w + ws) * op
    counts = Work(
        router=n * (rows * h * e_all), shared=n * 3 * h * rows * ws,
        per_pair=3 * h * w, pairs=n * expected_pairs(config, traffic),
        bytes=op * rows * h + f["out"].storage_bytes * rows * h
        + expert_bytes + n * e_all * (h * op + f["bias"].storage_bytes),
        expert_bytes=expert_bytes)
    config[WORK] = counts
    return counts


def select(c, config):
    """The routed experts of each row of choices ``c`` [rows, experts]:
    the groups ranked by the sum of their two largest choices, the
    ``topk_group`` best kept, then the ``num_experts_per_tok`` largest
    choices of the kept groups' experts.  Stable sorts rank them, so equal
    scores keep their index order: ties go to the lower group and the
    lower expert.  [rows, top_k] expert indices."""
    rows, e = c.shape
    groups = config["n_group"]
    per = e // groups
    best2 = torch.sort(c.view(rows, groups, per), dim=-1,
                       descending=True).values[..., :2].sum(-1)
    kept = torch.sort(best2, dim=-1, descending=True,
                      stable=True).indices[:, :config["topk_group"]]
    eligible = torch.zeros(rows, groups, dtype=torch.bool, device=c.device)
    eligible = eligible.scatter(1, kept, True).repeat_interleave(per, dim=1)
    masked = torch.where(eligible, c, c.min() - 1)
    return torch.sort(masked, dim=-1, descending=True,
                      stable=True).indices[:, :config["num_experts_per_tok"]]


def norm(y, config):
    """RMSNorm of the rows ``y`` (``operand`` raws): ``normed`` raws
    (int64) at about ``norm_rms``, through the rsqrt ROM of each row's sum
    of squares."""
    f = formats(config)
    op = f["operand"]
    ss = requantize((y.long() ** 2).sum(-1), 2 * op.frac_bits, f["sumsq"])
    r = rom_lookup(requantize(ss, f["sumsq"].frac_bits, f["sumsq_rom"]),
                   rom("rsqrt", f["sumsq_rom"], f["rsqrt"]))
    gain = fp.double_to_raw(config["norm_rms"]
                            * math.sqrt(config["hidden_size"]),
                            f["norm_gain"])
    s = requantize(r * gain, f["rsqrt"].frac_bits
                   + f["norm_gain"].frac_bits, f["norm_scale"])
    return requantize(y.long() * s[:, None],
                      op.frac_bits + f["norm_scale"].frac_bits, f["normed"])


def route(x, wr, bias, config, control=False):
    """(idx, w): each row's routed experts [rows, top_k] and their weights'
    raws in ``weight``."""
    f = formats(config)
    op, wide = f["operand"], f["accumulate"]
    logits = gemm(x, wr.t(), op, op, f["logit"], wide, (wide,), control)
    s = rom_lookup(logits, rom("sigmoid", f["logit"], f["score"]))
    c = requantize((s << (f["choice"].frac_bits - f["score"].frac_bits))
                   + (bias.long() << (f["choice"].frac_bits
                                      - f["bias"].frac_bits)),
                   f["choice"].frac_bits, f["choice"])
    idx = select(c, config)
    sel = s.gather(1, idx)
    t = requantize(sel.sum(-1), f["score"].frac_bits, f["total"])
    r = rom_lookup(requantize(t, f["total"].frac_bits, f["total_rom"]),
                   rom("reciprocal", f["total_rom"], f["recip"]))
    norm = requantize(sel * r[:, None],
                      f["score"].frac_bits + f["recip"].frac_bits, f["norm"])
    scale = fp.double_to_raw(config["routed_scaling_factor"], f["scale"])
    w = requantize(norm * scale, f["norm"].frac_bits + f["scale"].frac_bits,
                   f["weight"])
    return idx, w


def swiglu(x, wg, wu, wd, config, control=False):
    """One expert on rows ``x``: ``down`` raws (int64)."""
    f = formats(config)
    op, wide = f["operand"], f["accumulate"]
    g = gemm(x, wg.t(), op, op, f["gate"], wide, (wide,), control)
    g = rom_lookup(g, rom("silu", f["gate"], op))
    u = gemm(x, wu.t(), op, op, op, wide, (wide,), control)
    h = requantize(requantize(g * u, 2 * op.frac_bits, f["gu"]),
                   f["gu"].frac_bits, op)
    return gemm(h, wd.t(), op, op, f["down"], wide, (wide,), control)


def layer(x, lw: dict, config, first: int, control=False, pairs=None):
    """One layer's accumulator (``acc`` raws, int64) on rows ``x``: the
    shared expert and the part of the experts ``first`` ..
    ``first + len(lw["wg"]) - 1``.  ``lw``: one layer's operands.  The
    pairs routed to those experts are appended to the list ``pairs``,
    where one is given."""
    f = formats(config)
    acc_f = f["acc"]
    idx, w = route(x, lw["wr"], lw["bias"], config, control)
    acc = requantize(swiglu(x, lw["sg"], lw["su"], lw["sd"], config,
                            control), f["down"].frac_bits, acc_f)
    routed = 0
    for j in range(lw["wg"].shape[0]):
        tok, slot = (idx == first + j).nonzero(as_tuple=True)
        routed += tok.numel()
        if tok.numel() == 0:
            continue
        d = swiglu(x[tok], lw["wg"][j], lw["wu"][j], lw["wd"][j], config,
                   control)
        p = requantize(w[tok, slot][:, None] * d,
                       f["weight"].frac_bits + f["down"].frac_bits,
                       f["pair"])
        acc.index_add_(0, tok, requantize(p, f["pair"].frac_bits, acc_f))
    if pairs is not None:
        pairs.append(routed)
    return fp.saturate(acc, acc_f)


def forward(x, weights, config, control=False):
    """``num_hidden_layers`` layers on ``x``'s raws: ``out`` raws (int64),
    a block of rows at a time.  Outside the control, the pairs routed to
    the held experts go to ``config[WORK]``, where ``work()`` left it."""
    f = formats(config)
    names = ("wr", "bias", "wg", "wu", "wd", "sg", "su", "sd")
    parts, pairs = [], []
    for i in range(0, x.shape[0], BLOCK_ROWS):
        y = x[i:i + BLOCK_ROWS]
        for n in range(config["num_hidden_layers"]):
            lw = {k: weights[k][n] for k in names}
            acc = layer(norm(y, config), lw, config, config["held_first"],
                        control, pairs)
            y = requantize(acc, f["acc"].frac_bits, f["out"])
        parts.append(y)
    if not control and WORK in config:
        config[WORK].routed(sum(pairs))
    return torch.cat(parts)
