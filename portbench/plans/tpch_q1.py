"""TPC-H Q1, pricing summary report:

    SELECT l_returnflag, l_linestatus, sum(l_quantity),
           sum(l_extendedprice), sum(l_extendedprice * (1 - l_discount)),
           sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)),
           avg(l_quantity), avg(l_extendedprice), avg(l_discount), count(*)
    FROM lineitem WHERE l_shipdate <= date '1998-12-01' - :delta days
    GROUP BY l_returnflag, l_linestatus ORDER BY l_returnflag, l_linestatus

One group_aggregate_cols call in its fused-WHERE form. Prices are cents,
discount and tax percent, so disc_price is in units of 1e-4 and charge of
1e-6: every sum is an exact int64, every avg the float64 quotient.
"""

import torch

from cl_ops_tpu_torch.ops.exec import group_aggregate_cols
from portbench import roofline as rf
from portbench.data.common import day

AGGS = ("sum", "sum", "sum", "sum", "mean", "mean", "mean", "count")
GROUPS = 6                # returnflag (3) x linestatus (2)


def run(t, params, span):
    li = t["lineitem"]
    ok = li["l_shipdate"] <= day(1998, 12, 1) - params["delta"]
    key = li["l_returnflag"] * 2 + li["l_linestatus"]
    qty = li["l_quantity"].to(torch.int64)
    price = li["l_extendedprice"].to(torch.int64)
    disc = li["l_discount"].to(torch.int64)
    disc_price = price * (100 - disc)
    charge = disc_price * (100 + li["l_tax"].to(torch.int64))
    with span("groupby"):
        gk, tables, ng = group_aggregate_cols(
            key, (qty, price, disc_price, charge, qty, price, disc, qty),
            AGGS, num_groups=GROUPS, valid_mask=ok, key_bits=3)
    ng = int(ng)
    return {"rows": [gk[:ng] // 2, gk[:ng] % 2, *(x[:ng] for x in tables)],
            "counts": {"groups": ng}}


def work(sizes, k, params):
    return [("groupby", rf.groupby_bytes(sizes["lineitem"], 4, (8,) * 5,
                                         k["groups"], (8,) * 7 + (4,),
                                         mask=1))]
