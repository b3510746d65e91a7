"""The MoE datapath's reference (``gpubench/reference/moe_ffn.py``): its
work a batch, and, on the card at the published widths, its control
(bfloat16 GEMMs) against itself.  The work runs anywhere; the control
skips without a CUDA device:

    python -m pytest --noconftest -p no:cacheprovider gpubench/tests -q
"""

import json
from pathlib import Path

import pytest
import torch

from gpubench import inputs
from gpubench.reference import moe_ffn as ref

ROOT = Path(__file__).resolve().parents[2]
CONFIG = json.loads(
    (ROOT / "gpubench" / "configs" / "dsv3_moe_int8.json").read_text())
TRAFFIC = json.loads(
    (ROOT / "gpubench" / "traffic" / "prefill.json").read_text())


def test_work_counts_every_pair():
    """4 layers of 32,768 rows: the router's 256 outputs, the shared
    expert on every row and the 32 held experts (one routing group of 8)
    on the pairs an even router sends them, 4/8 of the rows taking the
    group and then 2 of their 8 experts: 32,768 pairs a layer; 3
    projections of 7168 x 2048 each; the bytes of x and y, and each
    layer's 33 experts, router and bias."""
    rows, h, f = 32768, 7168, 2048
    work = ref.work(dict(CONFIG), TRAFFIC)
    assert ref.expected_pairs(CONFIG, TRAFFIC) == rows
    assert work["expert_products"] == 4 * 3 * h * f * 2 * rows
    assert work["products"] == 4 * rows * h * (256 + 6 * f)
    assert round(work["products"] / 1e12, 2) == 11.79
    assert work["bytes"] == 2 * rows * h + 4 * (33 * 3 * h * f + 256 * h
                                                + 256 * 2)
    # all 256 experts held: every row's 8 pairs
    assert ref.expected_pairs(dict(CONFIG, n_routed_experts=256),
                              TRAFFIC) == 8 * rows


@pytest.mark.parametrize("seed", [5, 2 ** 32 + 3])
def test_work_counts_the_pairs_forward_routes(seed):
    """Once ``forward`` has run, the routed GEMMs count the mean of the
    pairs its batches sent to the held experts, as ``route`` picks them;
    the control's batches are not counted.  16 experts in 4 groups, 4
    held, one layer at hidden 64."""
    cfg = json.loads(json.dumps(CONFIG))
    cfg.update(hidden_size=64, moe_intermediate_size=32, router_experts=16,
               n_group=4, topk_group=2, num_experts_per_tok=4,
               n_routed_experts=4, held_first=4, num_hidden_layers=1,
               norm_rms=1.0)
    cfg["operands"].update(x={"low": -64, "high": 64},
                           wr={"low": -8, "high": 8})
    traffic = {"sequences": 2, "seq_len": 40, "pool": 3}
    w, pool = inputs.make(ref, cfg, traffic, seed, "cpu")
    work = ref.work(cfg, traffic)
    expected = dict(work)
    per_pair = 3 * 64 * 32
    assert expected["products"] == 80 * 64 * (16 + 3 * 32) + per_pair * 80
    ref.forward(pool[0], w, cfg, control=True)
    assert work == expected
    pairs = []
    for x in pool:
        idx, _ = ref.route(ref.norm(x, cfg), w["wr"][0], w["bias"][0], cfg)
        pairs.append(int(((idx >= 4) & (idx < 8)).sum()))
        ref.forward(x, w, cfg)
    assert len(set(pairs)) > 1
    mean = sum(pairs) / len(pairs)
    assert work["expert_products"] == 80 * 3 * 64 * 32 + per_pair * mean
    assert work["products"] == work["expert_products"] + 80 * 64 * 16
    assert work["bytes"] == expected["bytes"]


@pytest.mark.cuda
def test_control_mismatches_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = dict(CONFIG, num_hidden_layers=2)
    w, pool = inputs.make(ref, cfg, {"sequences": 1, "seq_len": 256,
                                     "pool": 1}, 2 ** 31 + 17, "cuda")
    want = ref.forward(pool[0], w, cfg)
    control = ref.forward(pool[0], w, cfg, control=True)
    assert want.shape == control.shape == (256, 7168)
    assert (want != control).sum() > want.numel() // 10
