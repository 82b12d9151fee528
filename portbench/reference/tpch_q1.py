"""TPC-H Q1 in plain PyTorch (the SQL is in plans/tpch_q1.py)."""

import torch

from portbench.data.common import day
from portbench.reference.common import as_int, dec, group_sum


def answer(t, params, exact=True):
    li = t["lineitem"]
    dt = dec(exact)
    ok = li["l_shipdate"] <= day(1998, 12, 1) - params["delta"]
    price = li["l_extendedprice"][ok].to(dt)
    disc = li["l_discount"][ok].to(dt)
    disc_price = price * (100 - disc)
    charge = disc_price * (100 + li["l_tax"][ok].to(dt))
    qty = li["l_quantity"][ok]
    key = li["l_returnflag"][ok] * 2 + li["l_linestatus"][ok]
    groups, sums, n = group_sum(key, [qty, price, disc_price, charge, disc],
                                dt)
    mean = torch.float64 if exact else torch.float32
    avgs = [s.to(mean) / n.to(mean) for s in (sums[0], sums[1], sums[4])]
    rows = [groups // 2, groups % 2, *(as_int(s) for s in sums[:4]),
            *(a.double() for a in avgs), n]
    return {"rows": rows, "counts": {"groups": groups.numel()}}
