"""The share of the traced window, in percent, in which the device is idle
while the host is inside an outermost `clo.op:*` span: idle time the
port's own host code causes."""

from portbench import port_trace


def read(t):
    p = port_trace.of(t)
    if p is None or not p["ops"] or t["window_s"] <= 0:
        return None
    return 100.0 * p["idle_s"] / t["window_s"]
