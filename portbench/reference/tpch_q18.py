"""TPC-H Q18 in plain PyTorch (the SQL is in plans/tpch_q18.py)."""

import torch

from portbench.reference.common import as_int, dec, group_sum, lookup


def answer(t, params, exact=True):
    li, o, cu = t["lineitem"], t["orders"], t["customer"]
    dt = dec(exact)
    okeys, (sums,), _ = group_sum(li["l_orderkey"], [li["l_quantity"]], dt)
    qual = sums > params["quantity"] * 100
    hit, at = lookup(okeys[qual], o["o_orderkey"])
    orow = torch.nonzero(hit).flatten()          # the orders table's order
    osum = sums[qual][at[orow]]
    ocust = o["o_custkey"][orow]
    cfound, crow = lookup(cu["c_custkey"], ocust)
    date = o["o_orderdate"][orow]
    price = o["o_totalprice"][orow].to(dt)
    by_date = torch.sort(date, stable=True).indices
    top = by_date[torch.sort(price[by_date], descending=True,
                             stable=True).indices][:100]
    rows = [cu["c_name"][crow[top]], ocust[top], o["o_orderkey"][orow][top],
            date[top], as_int(price[top]), as_int(osum[top])]
    counts = {"groups": okeys.numel(), "having": int(qual.sum()),
              "orders": orow.numel(), "customers": int(cfound.sum()),
              "limit": top.numel()}
    return {"rows": rows, "counts": counts}
