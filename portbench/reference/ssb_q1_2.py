from portbench.reference import _ssb_q1


def answer(t, params, exact=True):
    return _ssb_q1.answer(t, t["date"]["d_yearmonthnum"] == 199401, (4, 6),
                          (26, 35), exact)
