"""Routing: the device ms a traced batch of the rows launched inside the
port's ``qublas.moe.route`` spans (the router's K1, the sigmoid ROM, the
group and top-k selection, the weights; device trace, none without such
a span or where the rows cannot be paired)."""

from gpubench import outer_spans


def read(run):
    return outer_spans.device_ms(run, {"qublas.moe.route"})
