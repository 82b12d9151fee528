from portbench.reference import _ssb_q1


def answer(t, params, exact=True):
    return _ssb_q1.answer(t, t["date"]["d_year"] == 1993, (1, 3), (1, 24),
                          exact)
