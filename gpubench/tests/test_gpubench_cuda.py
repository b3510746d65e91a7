"""The benchmark's runs on the card at a small size: every cell sound,
the control and a planted fault not.  Without a CUDA device every test
skips; on the card:

    python -m pytest --noconftest -p no:cacheprovider gpubench/tests -q
"""

import json
import time
from pathlib import Path

import pytest
import torch

from gpubench import harness

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def small(cell_name):
    cell = next(w for w in BENCH["workloads"] if w["name"] == cell_name)
    entry = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / entry["file"]).read_text())
    config.update(hidden_size=256, intermediate_size=512)
    traffic = json.loads((ROOT / "gpubench" / "traffic" /
                          f"{cell['traffic']}.json").read_text())
    traffic.update(sequences=2, seq_len=64)
    return cell, config, traffic


def run_small(cuda, cell_name, **kw):
    cell, config, traffic = small(cell_name)
    return harness.run(cell, config, traffic, BENCH, 2 ** 31 + 5, 0.5,
                       False, cuda, time.perf_counter(), **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_card(cuda, cell):
    res, checks = run_small(cuda, cell)
    assert res["correct"] is True, checks
    assert res["device"]["platform"] == "gpu"


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cuda, cell):
    res, checks = run_small(cuda, cell, control=True)
    assert res["correct"] is False and \
        checks["mismatched_elements"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_altered_answer_fails_on_the_card(cuda, cell):
    def alter(fn):
        def broken(x):
            y = fn(x).clone()
            y.view(-1)[7] += 1
            return y
        return broken
    res, _ = run_small(cuda, cell, hook=alter)
    assert res["correct"] is False
