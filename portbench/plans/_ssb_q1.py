"""The plan of SSB Q1.1-Q1.3:

    SELECT sum(lo_extendedprice * lo_discount) AS revenue
    FROM lineorder, date
    WHERE lo_orderdate = d_datekey AND <date predicate>
      AND lo_discount BETWEEN :dlo AND :dhi AND lo_quantity <range>

lo_orderdate probes the 2,556-row date dimension through the direct band
probe (the dimension fits one window), carrying whether the date passes;
then the discount and quantity masks and the 64-bit revenue sum. No sort,
no GROUP BY.
"""

import torch

from cl_ops_tpu_torch.ops.exec import hash_join
from portbench import roofline as rf


def run(t, date_ok, disc, qty, span):
    lo, d = t["lineorder"], t["date"]
    date_ok = date_ok.to(torch.int32)
    with span("join"):
        found, ok = hash_join(d["d_datekey"], date_ok, lo["lo_orderdate"],
                              probe_impl="direct")
    dc, q = lo["lo_discount"], lo["lo_quantity"]
    mask = (found & (ok != 0) & (dc >= disc[0]) & (dc <= disc[1])
            & (q >= qty[0]) & (q <= qty[1]))
    revenue = torch.where(mask, lo["lo_extendedprice"].to(torch.int64)
                          * dc.to(torch.int64), 0).sum()
    return {"rows": [revenue.reshape(1)],
            "counts": {"dates": date_ok.sum(), "date_matches": found.sum(),
                       "kept": mask.sum()}}


def work(sizes, k):
    return [("join", rf.join_bytes(sizes["date"], 4, 4, sizes["lineorder"],
                                   4))]
