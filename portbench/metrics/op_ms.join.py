"""Device milliseconds a query in the join operator's spans."""


def read(t):
    s = t["layer_s"].get("join")
    return None if s is None else s * 1e3 / t["queries"]
