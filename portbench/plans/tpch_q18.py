"""TPC-H Q18, large volume customer:

    SELECT c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice,
           sum(l_quantity)
    FROM customer, orders, lineitem
    WHERE o_orderkey IN (SELECT l_orderkey FROM lineitem GROUP BY l_orderkey
                         HAVING sum(l_quantity) > :quantity)
      AND c_custkey = o_custkey AND o_orderkey = l_orderkey
    GROUP BY c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
    ORDER BY o_totalprice DESC, o_orderdate LIMIT 100

The GROUP BY of lineitem by order key (15M groups) sums the quantities in
64 bits; HAVING compacts the qualifying orders; they are few, so they are
the build side of the join that picks their rows out of orders, and those
rows probe the customer table. Ties of (totalprice, orderdate) keep the
orders table's row order.
"""

import torch

from cl_ops_tpu_torch.ops.exec import (filter_compact, group_aggregate_cols,
                                       hash_join, top_k)
from portbench import roofline as rf

LIMIT = 100
DATE_SPAN = 4096          # day numbers are below it


def run(t, params, span):
    li, o, cu = t["lineitem"], t["orders"], t["customer"]
    dev = o["o_orderkey"].device
    n_orders, n_cust = o["o_orderkey"].numel(), cu["c_custkey"].numel()
    having = params["quantity"] * 100                     # cents
    qty = li["l_quantity"].to(torch.int64)
    with span("groupby"):
        gk, (sums,), ng = group_aggregate_cols(
            li["l_orderkey"], (qty,), ("sum",), num_groups=n_orders)
    with span("filter"):
        nq, qkeys, qsums = filter_compact(gk, lambda _: sums > having, sums)
    nq = int(nq)
    with span("join"):        # qkeys come out ascending: the build is sorted
        found, osum = hash_join(qkeys[:nq], qsums[:nq], o["o_orderkey"],
                                build_sorted=True)
    rows = torch.arange(n_orders, dtype=torch.int32, device=dev)
    with span("filter"):
        nm, orow = filter_compact(rows, lambda _: found)
    nm = int(nm)
    orow = orow[:nm].long()
    ocust, okey = o["o_custkey"][orow], o["o_orderkey"][orow]
    odate, oprice = o["o_orderdate"][orow], o["o_totalprice"][orow]
    osum = osum[orow]
    crows = torch.arange(n_cust, dtype=torch.int32, device=dev)
    with span("join"):
        cfound, crow = hash_join(cu["c_custkey"], crows, ocust)
    order_key = oprice * DATE_SPAN + (DATE_SPAN - 1 - odate)
    pos = torch.arange(nm, dtype=torch.int32, device=dev)
    with span("topk"):
        _, top = top_k(order_key, LIMIT, pos, largest=True)
    top = top.long()
    name = cu["c_name"][crow[top].long()]
    return {"rows": [name, ocust[top], okey[top], odate[top], oprice[top],
                     osum[top]],
            "counts": {"groups": ng, "having": nq, "orders": nm,
                       "customers": cfound.sum(), "limit": top.numel()}}


def work(sizes, k, params):
    """(layer, bytes) of each operator call: inputs read once, outputs
    written once, from the shapes and the reference's counts."""
    n_o = sizes["orders"]
    return [("groupby", rf.groupby_bytes(sizes["lineitem"], 4, (8,),
                                         k["groups"], (8,))),
            ("filter", rf.filter_bytes(n_o, (4, 8), k["having"])),
            ("join", rf.join_bytes(k["having"], 4, 8, n_o, 8)),
            ("filter", rf.filter_bytes(n_o, (4,), k["orders"])),
            ("join", rf.join_bytes(sizes["customer"], 4, 4, k["orders"], 4)),
            ("topk", rf.topk_bytes(k["orders"], 8 + 4, k["limit"]))]
