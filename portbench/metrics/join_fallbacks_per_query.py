"""Merge probes run after a band overflow, a query: `clo.join:fallback`
spans (0.0 where joins ran and none overflowed)."""

from portbench import port_trace


def read(t):
    p = port_trace.of(t)
    if p is None or not p["ops"].get("join"):
        return None
    return p["fallbacks"] / t["queries"]
