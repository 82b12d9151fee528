"""SSB Q1.2: d_yearmonthnum = 199401, lo_discount BETWEEN 4 AND 6,
lo_quantity BETWEEN 26 AND 35."""

from portbench.plans import _ssb_q1


def run(t, params, span):
    return _ssb_q1.run(t, t["date"]["d_yearmonthnum"] == 199401, (4, 6),
                       (26, 35), span)


def work(sizes, k, params):
    return _ssb_q1.work(sizes, k)
