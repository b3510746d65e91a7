"""The MoE datapath: ``num_hidden_layers`` layers, each a
``qublas_tpu_torch.QuantRMSNorm`` and a ``qublas_tpu_torch.QuantMoE``
holding the configuration's experts, eager."""

from __future__ import annotations

import torch

import qublas_tpu_torch as qt

from .ffn_pipeline import qformat


class Stack(torch.nn.Module):
    """The modules in order: each one's output raws are the next one's
    input raws."""

    def __init__(self, layers):
        super().__init__()
        self.layers = torch.nn.ModuleList(layers)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


def build(config: dict, traffic: dict, weights: dict):
    """The callable x -> y that the window drives: each layer's RMSNorm,
    then its MoE.  The weights are stored [out, in], so their transposed
    views are the K-major [K, N] operands that ``QuantMoE`` keeps without
    a copy."""
    if traffic.get("compile"):
        raise ValueError("the MoE datapath runs eagerly")
    layer = tuple(config[k] for k in ("scoring_func", "topk_method",
                                      "hidden_act", "norm_topk_prob"))
    if layer != ("sigmoid", "noaux_tc", "silu", True):
        raise ValueError(f"QuantMoE is DeepSeek-V3's layer (sigmoid, "
                         f"noaux_tc, silu, normalized), not {layer}")
    want = {k: qformat(v) for k, v in config["formats"].items()}
    if want != qt.moe_formats():
        raise ValueError(f"QuantMoE runs {qt.moe_formats()}, the "
                         f"configuration asks for {want}")
    held = (config["held_first"], config["n_routed_experts"])
    w = weights
    modules = []
    for n in range(config["num_hidden_layers"]):
        modules.append(qt.QuantRMSNorm(config["hidden_size"],
                                       config["norm_rms"], w["wr"].device))
        modules.append(qt.QuantMoE(
            w["wr"][n].t(), w["bias"][n], w["wg"][n].transpose(1, 2),
            w["wu"][n].transpose(1, 2), w["wd"][n].transpose(1, 2),
            w["sg"][n].t(), w["su"][n].t(), w["sd"][n].t(), held,
            config["n_group"], config["topk_group"],
            config["num_experts_per_tok"],
            config["routed_scaling_factor"]))
    return Stack(modules)
