"""The port's own host reads of device flags a query: `clo.sync:*` spans
(0.0 where the port's operators ran and read none)."""

from portbench import port_trace


def read(t):
    p = port_trace.of(t)
    return p["syncs"] / t["queries"] if p and p["ops"] else None
