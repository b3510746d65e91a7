"""The FFN datapath: ``num_hidden_layers`` blocks, each a
``qublas_tpu_torch.QuantPipeline``, eager or as one compiled program
(``traffic["compile"]`` is ``torch.compile``'s mode)."""

from __future__ import annotations

import torch

import qublas_tpu_torch as qt


def qformat(spec: dict):
    return qt.qformat(spec["int_bits"], spec["frac_bits"],
                      spec.get("signed", True),
                      qt.RoundMode[spec.get("round", "TRN_TCPL")],
                      qt.OverflowMode[spec.get("overflow", "SAT_TCPL")])


class Stack(torch.nn.Module):
    """The blocks in order: each block's output raws are the next one's
    input raws."""

    def __init__(self, w1: torch.Tensor, w2: torch.Tensor):
        super().__init__()
        self.blocks = torch.nn.ModuleList(
            qt.QuantPipeline(a, b) for a, b in zip(w1, w2))

    def forward(self, x):
        for block in self.blocks:
            x = block(x)
        return x


def build(config: dict, traffic: dict, weights: dict):
    """The callable x -> y that the window drives."""
    f = config["formats"]
    want = tuple(qformat(f[k]) for k in ("operand", "accumulate", "out"))
    if want != tuple(qt.pipeline_formats()) or config["rom"] != "sqrt":
        raise ValueError(f"QuantPipeline runs {qt.pipeline_formats()} with "
                         f"the sqrt ROM, the configuration asks for {want}")
    pipe = Stack(weights["w1"], weights["w2"])
    mode = traffic.get("compile")
    if not mode:
        return pipe
    compiled = torch.compile(pipe, fullgraph=True, dynamic=False, mode=mode)

    def replay(x):
        # a replay overwrites the last one's output: take it first
        torch.compiler.cudagraph_mark_step_begin()
        return compiled(x).clone()
    return replay
