from portbench.reference import _ssb_q2


def answer(t, params, exact=True):
    return _ssb_q2.answer(t, t["part"]["p_category"] == 12, 1, exact)
