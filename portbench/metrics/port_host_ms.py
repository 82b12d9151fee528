"""Host milliseconds a query inside the outermost `clo.op:*` spans, less
their `clo.sync:*` spans: the port's host dispatch."""

from portbench import port_trace


def read(t):
    p = port_trace.of(t)
    return p["host_s"] * 1e3 / t["queries"] if p and p["ops"] else None
