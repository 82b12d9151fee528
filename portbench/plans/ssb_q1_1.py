"""SSB Q1.1: d_year = 1993, lo_discount BETWEEN 1 AND 3,
lo_quantity < 25."""

from portbench.plans import _ssb_q1


def run(t, params, span):
    return _ssb_q1.run(t, t["date"]["d_year"] == 1993, (1, 3), (1, 24), span)


def work(sizes, k, params):
    return _ssb_q1.work(sizes, k)
