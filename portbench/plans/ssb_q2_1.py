"""SSB Q2.1: p_category = 'MFGR#12' AND s_region = 'AMERICA'."""

from portbench.plans import _ssb_q2


def run(t, params, span):
    return _ssb_q2.run(t, t["part"]["p_category"] == 12, 1, span)


def work(sizes, k, params):
    return _ssb_q2.work(sizes, k)
