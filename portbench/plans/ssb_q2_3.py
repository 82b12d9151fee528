"""SSB Q2.3: p_brand1 = 'MFGR#2239' AND s_region = 'EUROPE'."""

from portbench.plans import _ssb_q2


def run(t, params, span):
    return _ssb_q2.run(t, t["part"]["p_brand1"] == 2239, 3, span)


def work(sizes, k, params):
    return _ssb_q2.work(sizes, k)
