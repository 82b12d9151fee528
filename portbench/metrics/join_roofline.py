"""The join operator's share of its roofline, in percent: the least time
its calls' bytes take at the published peak (portbench/roofline.py, from
the shapes and the reference's counts) over the device time in its
spans."""


def read(t):
    dev, bound = t["layer_s"].get("join"), t["bound_s"].get("join")
    if not dev or not bound:
        return None
    return 100.0 * bound / dev
