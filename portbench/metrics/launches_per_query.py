"""Device kernels a query, counted by the profiler."""


def read(t):
    return t["kernels"] / t["queries"] if t["kernels"] else None
