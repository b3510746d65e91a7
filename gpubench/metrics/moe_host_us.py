"""The MoE layers' host time: µs a traced batch inside the port's
``qublas.moe.*`` spans (their union: the norm, the route, the dispatch,
the experts and the combine), the wait of each layer's host sync for its
row counts included (device trace, none without such a span)."""

from gpubench import outer_spans

NAMES = {"qublas.moe.norm", "qublas.moe.route", "qublas.moe.dispatch",
         "qublas.moe.experts", "qublas.moe.combine"}


def read(run):
    return outer_spans.host_us(run, NAMES)
