"""Moving rows: the device ms a traced batch of the rows launched inside
the port's ``qublas.moe.dispatch`` (the sort, the row counts' copy to the
host, the gather) and ``qublas.moe.combine`` spans (the weighted outputs,
the scatter-add, the output's requantize; device trace, none without such
a span or where the rows cannot be paired)."""

from gpubench import outer_spans


def read(run):
    return outer_spans.device_ms(
        run, {"qublas.moe.dispatch", "qublas.moe.combine"})
