"""The share of the traced window, in percent, that no kernel, copy or set
covers on the device: from the union of their intervals."""


def read(t):
    if t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
