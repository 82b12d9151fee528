"""SSB Q1.3: d_weeknuminyear = 6 AND d_year = 1994, lo_discount BETWEEN 5
AND 7, lo_quantity BETWEEN 26 AND 35."""

from portbench.plans import _ssb_q1


def run(t, params, span):
    d = t["date"]
    return _ssb_q1.run(t, (d["d_weeknuminyear"] == 6) & (d["d_year"] == 1994),
                       (5, 7), (26, 35), span)


def work(sizes, k, params):
    return _ssb_q1.work(sizes, k)
