"""Device milliseconds a query of the kernels whose innermost port span is
`clo.sort`: the bitonic sorts' padding copy, passes and cut-back, under
whichever operator runs them."""

from portbench import port_trace


def read(t):
    p = port_trace.of(t)
    if p is None or not p["sorts"]:
        return None
    return p["kind_s"].get("sort", 0.0) * 1e3 / t["queries"]
