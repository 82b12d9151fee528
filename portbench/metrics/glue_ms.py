"""Device milliseconds a query of the plan's own torch ops: kernels
launched in a query's span but in no operator's span."""


def read(t):
    s = t["layer_s"].get("glue")
    return None if s is None else s * 1e3 / t["queries"]
