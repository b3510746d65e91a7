"""Plain-torch glue: device milliseconds a batch of the traced rows that
are not the port's hand-written kernels (``kernels/*.txt``): copies, the
ROM's index, casts, Inductor's kernels (device trace)."""


def read(run):
    t = run.trace
    if t is None or not t.rows or not t.batches or run.port_kernels is None:
        return None
    glue = [r for r in t.rows if not run.port_kernels.search(r[0])]
    return t.busy_s(glue) / t.batches * 1e3
