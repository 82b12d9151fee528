"""SSB Q2.2: p_brand1 BETWEEN 'MFGR#2221' AND 'MFGR#2228' AND
s_region = 'ASIA'."""

from portbench.plans import _ssb_q2


def run(t, params, span):
    b = t["part"]["p_brand1"]
    return _ssb_q2.run(t, (b >= 2221) & (b <= 2228), 2, span)


def work(sizes, k, params):
    return _ssb_q2.work(sizes, k)
