"""Entry and dispatch: the host's microseconds a traced batch inside the
port's ``qublas.qgemul`` spans, one around each ``qgemul`` call from entry
to return (the spans' union; device trace, none without such a span)."""

from gpubench import spans


def read(run):
    return spans.host_us(run, "qublas.qgemul")
