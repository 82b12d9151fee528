"""The share of the sorted row slots, in percent, that are padding: 100 x
sum(padded - n) / sum(padded) over the window's `clo.sort` spans."""

from portbench import port_trace


def read(t):
    p = port_trace.of(t)
    if p is None or not p["sort_padded"]:
        return None
    return 100.0 * (p["sort_padded"] - p["sort_rows"]) / p["sort_padded"]
