"""Entry and dispatch: the host's microseconds a traced batch inside the
port's ``qublas.plan`` spans, one around each proof or planner that
``qgemul`` runs before a tier's launch (``exact_plan``, ``plan_hybrid``,
``plan_tree``, ...), each inside a ``qublas.qgemul`` span (the spans'
union; device trace, none without such a span)."""

from gpubench import spans


def read(run):
    return spans.host_us(run, "qublas.plan")
