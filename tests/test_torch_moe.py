"""The port's MoE layer (``QuantMoE``), the RMSNorm before it
(``QuantRMSNorm``) and its grouped GEMM (``qgemul_grouped``) on the CPU,
bit for bit against the benchmark's plain reference
(``gpubench/reference/moe_ffn.py``): seeded layers in a chain, the
selection's ties, the expert-parallel share of a layer, the norm, the
grouped entry against a ``qgemul`` a group, and the ROMs' tables."""

import json
from pathlib import Path

import pytest
import torch

import qublas_tpu_torch as qt
from gpubench import inputs
from gpubench.reference import fixedpoint as fp
from gpubench.reference import moe_ffn as ref
from qublas_tpu_torch.moe import gated, rms_norm, select_experts

ROOT = Path(__file__).resolve().parent.parent
CONFIG = json.loads(
    (ROOT / "gpubench" / "configs" / "dsv3_moe_int8.json").read_text())
# 16 experts in 4 groups, top-4 over the top-2 groups, 4 held, 1 shared;
# rows normalized and weights wide enough at hidden 64 that the outputs
# are not all zero
SMALL = dict(hidden_size=64, moe_intermediate_size=32, router_experts=16,
             n_group=4, topk_group=2, num_experts_per_tok=4,
             n_routed_experts=4, held_first=4, num_hidden_layers=2,
             norm_rms=1.0)
WIDE = {"x": {"low": -64, "high": 64}, "wr": {"low": -8, "high": 8},
        **{k: {"low": -8, "high": 8}
           for k in ("wg", "wu", "wd", "sg", "su", "sd")}}
TRAFFIC = {"sequences": 2, "seq_len": 40, "pool": 1}


def small_config(**kw):
    cfg = json.loads(json.dumps(CONFIG))
    cfg.update(SMALL, **kw)
    cfg["operands"].update(WIDE)
    return cfg


def layers(cfg, w):
    """The port's MoE layers on the reference's operands ([out, in]
    storage: the transposed views are the [K, N] operands)."""
    return [qt.QuantMoE(
        w["wr"][n].t(), w["bias"][n], w["wg"][n].transpose(1, 2),
        w["wu"][n].transpose(1, 2), w["wd"][n].transpose(1, 2),
        w["sg"][n].t(), w["su"][n].t(), w["sd"][n].t(),
        (cfg["held_first"], cfg["n_routed_experts"]), cfg["n_group"],
        cfg["topk_group"], cfg["num_experts_per_tok"],
        cfg["routed_scaling_factor"])
        for n in range(cfg["num_hidden_layers"])]


def layer_weights(w, n, first=0, count=None):
    """Layer n's operands, the experts first .. first + count - 1 of
    them."""
    lw = {k: w[k][n] for k in ("wr", "bias", "wg", "wu", "wd", "sg", "su",
                               "sd")}
    end = None if count is None else first + count
    for k in ("wg", "wu", "wd"):
        lw[k] = lw[k][first:end]
    return lw


def moe(lw, first, count, cfg):
    return qt.QuantMoE(
        lw["wr"].t(), lw["bias"], lw["wg"].transpose(1, 2),
        lw["wu"].transpose(1, 2), lw["wd"].transpose(1, 2), lw["sg"].t(),
        lw["su"].t(), lw["sd"].t(), (first, count), cfg["n_group"],
        cfg["topk_group"], cfg["num_experts_per_tok"])


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11, 977])
def test_layers_match_the_reference(seed):
    """(a) A chain of two layers, each an RMSNorm and an MoE layer
    holding experts 4-7 of 16, equals the reference bit for bit, and
    routes some rows to its experts."""
    cfg = small_config()
    w, pool = inputs.make(ref, cfg, TRAFFIC, seed, "cpu")
    want = ref.forward(pool[0], w, cfg)
    x = pool[0]
    stack = layers(cfg, w)
    norm = qt.QuantRMSNorm(cfg["hidden_size"], cfg["norm_rms"])
    for layer in stack:
        x = layer(norm(x))
    assert x.dtype == torch.int8
    assert torch.equal(x.long(), want)
    assert want.count_nonzero() > want.numel() // 4
    assert all(m.syncs == 1 and m.pairs > 0 for m in stack)
    assert sum(m.pairs for m in stack) <= 2 * 80 * 4


def test_ties_go_to_the_lower_index():
    """(b) Equal choices in and across groups: both selections keep the
    lower group and pick the lower expert."""
    # 8 experts in 4 groups of 2; groups 1 and 2 tie on their sum (10),
    # group 3 (12) is best; experts 2, 3, 4 tie at 5 with 6 and 7's 6
    c = torch.tensor([[1, 1, 5, 5, 5, 5, 6, 6],
                      [7, 7, 7, 7, 7, 7, 7, 7],
                      [0, 9, 9, 0, 0, 9, 9, 0]])
    cfg = dict(n_group=4, topk_group=2, num_experts_per_tok=3)
    want = [[6, 7, 2], [0, 1, 2], [1, 2, 0]]
    got_ref = ref.select(c, cfg).tolist()
    got = select_experts(c.to(torch.int32), 4, 2, 3).tolist()
    assert got_ref == want
    assert [sorted(r) for r in got] == [sorted(r) for r in want]


@pytest.mark.parametrize("first", [0, 4, 12])
def test_a_layer_of_ties_matches_the_reference(first):
    """(b) A zero router and bias: every score and group ties, so every row
    takes the experts of the lowest indices, in the port and the
    reference alike."""
    cfg = small_config(num_hidden_layers=1, held_first=first)
    w, pool = inputs.make(ref, cfg, TRAFFIC, 5, "cpu")
    w["wr"].zero_()
    w["bias"].zero_()
    layer = layers(cfg, w)[0]
    x = qt.QuantRMSNorm(cfg["hidden_size"], cfg["norm_rms"])(pool[0])
    assert torch.equal(layer(x).long(), ref.forward(pool[0], w, cfg))
    # experts 0-3 take every row's 4 pairs: only the layer holding them
    assert layer.pairs == (80 * 4 if first == 0 else 0)
    assert layer.largest == (80 if first == 0 else 0)
    assert layer.empty == (0 if first == 0 else 4)


def test_shares_add_up_to_the_whole_layer():
    """(c) The accumulators of four disjoint held ranges, the shared
    expert counted once, add up to the uncut reference's accumulator of
    the whole layer."""
    cfg = small_config(n_routed_experts=16, held_first=0,
                       num_hidden_layers=1)
    w, pool = inputs.make(ref, cfg, TRAFFIC, 8, "cpu")
    x = pool[0]
    whole = ref.layer(x, layer_weights(w, 0), cfg, 0)
    shared = moe(layer_weights(w, 0, 0, 0), 0, 0, cfg)(x, acc=True)
    parts = [moe(layer_weights(w, 0, f, 4), f, 4, cfg)(x, acc=True)
             for f in (0, 4, 8, 12)]
    assert all(p.dtype == torch.int32 for p in parts)
    assert torch.equal(sum(p.long() for p in parts) - 3 * shared.long(),
                       whole)
    assert not torch.equal(parts[0], shared)


SEGMENTS = [0, 1, 127, 300]


@pytest.mark.parametrize("table", [False, True])
def test_grouped_entry_matches_qgemul_a_group(table, monkeypatch):
    """(d) ``qgemul_grouped`` over groups of 0, 1, 127 and 300 rows equals
    ``qgemul`` a group, with and without the SiLU table, which K1's
    epilogue takes (no lookup after the GEMM) where ``_k1_lut`` allows."""
    f = qt.moe_formats()
    op, wide = f["operand"], f["accumulate"]
    g = torch.Generator().manual_seed(41)
    a = torch.randint(-8, 9, (sum(SEGMENTS), 96), generator=g,
                      dtype=torch.int8)
    b = torch.randint(-3, 4, (len(SEGMENTS), 40, 96), generator=g,
                      dtype=torch.int8).transpose(1, 2)
    offsets = [0]
    for n in SEGMENTS:
        offsets.append(offsets[-1] + n)
    silu = qt.QTable(qt.silu_func, f["gate"], op) if table else None
    kw = dict(mul_to=wide, add_formats=(wide,), epilogue_lut=silu)
    want = [qt.qgemul(qt.QTensor(a[s:e], op), qt.QTensor(b[i], op),
                      f["gate"], **kw).data
            for i, (s, e) in enumerate(zip(offsets, offsets[1:]))]
    looked_up = []
    monkeypatch.setattr(qt.QTable, "__call__",
                        lambda self, x, table=None: looked_up.append(x))
    got = qt.qgemul_grouped(qt.QTensor(a, op), offsets, qt.QTensor(b, op),
                            f["gate"], **kw)
    assert looked_up == []
    assert got.fmt == (op if table else f["gate"])
    assert torch.equal(got.data, torch.cat(want))
    # an int16 result: the table runs after the GEMM, once for all groups
    out16 = qt.qformat(7, 4)
    qt.qgemul_grouped(qt.QTensor(a, op), offsets, qt.QTensor(b, op), out16,
                      mul_to=wide, add_formats=(wide,),
                      epilogue_lut=qt.QTable(qt.sqrt_func, out16))
    assert len(looked_up) == 1 and looked_up[0].shape == (428, 40)


def test_grouped_entry_of_no_rows():
    f = qt.moe_formats()
    op = f["operand"]
    a = torch.zeros((0, 32), dtype=torch.int8)
    for groups in (0, 3):
        b = torch.zeros((groups, 32, 16), dtype=torch.int8)
        got = qt.qgemul_grouped(qt.QTensor(a, op), [0] * (groups + 1),
                                qt.QTensor(b, op), f["down"],
                                mul_to=f["accumulate"],
                                add_formats=(f["accumulate"],))
        assert got.shape == (0, 16) and got.data.dtype == torch.int16
    # a GEMM K1 cannot run (products that round): refused
    f88 = qt.qformat(8, 8)
    with pytest.raises(ValueError, match="lossless int8"):
        qt.qgemul_grouped(qt.QTensor(a, op), [0, 0], qt.QTensor(
            torch.zeros((1, 32, 16), dtype=torch.int8), op), f88,
            mul_to=qt.qformat(3, 4))


@pytest.mark.parametrize("func,fin,fout", [
    ("sigmoid", "logit", "score"), ("silu", "gate", "operand"),
    ("reciprocal", "total_rom", "recip"), ("rsqrt", "sumsq_rom", "rsqrt")])
def test_rom_tables_match_the_reference(func, fin, fout):
    """(e) ``sigmoid_func``, ``silu_func``, ``reciprocal_func`` and
    ``rsqrt_func`` as ``QTable`` entries equal ``fixedpoint.rom_table``'s."""
    port = {"sigmoid": qt.sigmoid_func, "silu": qt.silu_func,
            "reciprocal": qt.reciprocal_func, "rsqrt": qt.rsqrt_func}[func]
    f, rf = qt.moe_formats(), ref.formats(CONFIG)
    table = qt.QTable(port, f[fin], f[fout]).table
    want = fp.rom_table(func, rf[fin], rf[fout])
    assert table.numel() == want.numel() == 1 << (rf[fin].bits)
    assert torch.equal(table.long(), want)


@pytest.mark.parametrize("mid,out", [
    ("gu", "operand"),
    (dict(int_bits=3, frac_bits=6, round_mode=qt.RoundMode.RND_CONV,
          overflow_mode=qt.OverflowMode.WRP_TCPL),
     dict(int_bits=2, frac_bits=3, overflow_mode=qt.OverflowMode.SAT_ZERO))])
def test_gated_is_qmul_then_qcast(mid, out):
    """``gated`` (G1's plain version on the CPU) equals ``qmul`` into the
    middle format, then ``qcast``: the layer's formats, and a rounding,
    wrapping middle format into a saturating one."""
    f = qt.moe_formats()
    mid = f[mid] if isinstance(mid, str) else qt.qformat(**mid)
    out = f[out] if isinstance(out, str) else qt.qformat(**out)
    g = torch.Generator().manual_seed(17)
    a, b = (qt.QTensor(torch.randint(-128, 128, (64, 48), generator=g,
                                     dtype=torch.int8), f["operand"])
            for _ in range(2))
    want = qt.qcast(qt.qmul(a, b, to=mid), out)
    got = gated(a, b, mid, out)
    assert got.fmt == out and torch.equal(got.data, want.data)


@pytest.mark.parametrize("hidden,rms", [(64, 1.0), (7168, 0.125)])
def test_norm_matches_the_reference_and_the_elementwise_ops(hidden, rms):
    """``QuantRMSNorm`` (N1's plain version on the CPU) equals the
    reference's norm and the elementwise ops it stands for: ``qcast`` of
    the lossless sum of squares, the rsqrt ``QTable``, two ``qmul``s.  Rows
    of small, typical and saturated raws, a zero row and one of -128s."""
    f = qt.moe_formats()
    cfg = dict(CONFIG, hidden_size=hidden, norm_rms=rms)
    g = torch.Generator().manual_seed(hidden)
    x = torch.cat([torch.randint(lo, hi + 1, (4, hidden), generator=g,
                                 dtype=torch.int8)
                   for lo, hi in ((-1, 1), (-3, 3), (-40, 40),
                                  (-128, 127))]
                  + [torch.zeros((1, hidden), dtype=torch.int8),
                     torch.full((1, hidden), -128, dtype=torch.int8)])
    norm = qt.QuantRMSNorm(hidden, rms)
    got = norm(x)
    assert got.dtype == torch.int8
    assert torch.equal(got.long(), ref.norm(x, cfg))
    assert not got[-2].any()
    op = qt.QTensor(x, f["operand"])
    ss = qt.QTensor((x.long() ** 2).sum(-1, keepdim=True).to(torch.int32),
                    f["sumsq"])
    r = qt.QTable(qt.rsqrt_func, f["sumsq_rom"], f["rsqrt"])(
        qt.qcast(ss, f["sumsq_rom"]))
    s = qt.qmul(r, qt.QTensor(torch.tensor(norm.gain, dtype=torch.int16),
                              f["norm_gain"]), to=f["norm_scale"])
    want = qt.qmul(op, qt.QTensor(s.data.expand(x.shape), s.fmt),
                   to=f["normed"])
    assert torch.equal(got, want.data)
    # rows of typical raws come out at about the RMS asked for
    typical = got[4:8].double().pow(2).mean().sqrt() / 16
    assert abs(typical - rms) < 0.05 * rms
    with pytest.raises(ValueError, match="RMSNorm"):
        rms_norm(qt.QTensor(x.to(torch.int16), qt.qformat(7, 8)), norm.rom,
                 norm.rsqrt_rom, norm.gain, f)
