"""The plan of SSB Q2.1-Q2.3:

    SELECT sum(lo_revenue), d_year, p_brand1
    FROM lineorder, date, part, supplier
    WHERE lo_orderdate = d_datekey AND lo_partkey = p_partkey
      AND lo_suppkey = s_suppkey AND <part predicate> AND s_region = :region
    GROUP BY d_year, p_brand1 ORDER BY d_year, p_brand1

The dimension predicates compact part and supplier; both foreign keys of
lineorder probe them; the rows that match both are compacted, probe the
date dimension, and GROUP BY (d_year, p_brand1) sums their revenue in 64
bits, in key order.
"""

import torch

from cl_ops_tpu_torch.ops.exec import (filter_compact, group_aggregate_cols,
                                       hash_join)
from portbench import roofline as rf

BRAND_SPAN = 8192         # p_brand1 codes are below it
GROUPS = 7 * 1000         # years x brands: the table's capacity


def run(t, part_mask, region, span):
    lo, p, s, d = t["lineorder"], t["part"], t["supplier"], t["date"]
    n_lo = lo["lo_partkey"].numel()
    with span("filter"):
        n_p, pkey, pbrand = filter_compact(p["p_partkey"], lambda _: part_mask,
                                           p["p_brand1"])
    n_p = int(n_p)
    with span("filter"):
        n_s, skey = filter_compact(s["s_suppkey"],
                                   lambda _: s["s_region"] == region)
    n_s = int(n_s)
    with span("join"):
        pfound, brand = hash_join(pkey[:n_p], pbrand[:n_p], lo["lo_partkey"])
    with span("join"):
        sfound = hash_join(skey[:n_s], skey[:n_s], lo["lo_suppkey"],
                           join_type="semi")
    both = pfound & sfound
    rows = torch.arange(n_lo, dtype=torch.int32, device=both.device)
    with span("filter"):
        n_k, krow = filter_compact(rows, lambda _: both)
    n_k = int(n_k)
    krow = krow[:n_k].long()
    odate, obrand = lo["lo_orderdate"][krow], brand[krow]
    orev = lo["lo_revenue"][krow].to(torch.int64)
    with span("join"):
        dfound, year = hash_join(d["d_datekey"], d["d_year"], odate)
    gkey = (year - 1992) * BRAND_SPAN + obrand
    with span("groupby"):
        gk, (rev,), ng = group_aggregate_cols(gkey, (orev,), ("sum",),
                                              num_groups=GROUPS)
    ng = int(ng)
    gk = gk[:ng]
    return {"rows": [gk // BRAND_SPAN + 1992, gk % BRAND_SPAN, rev[:ng]],
            "counts": {"parts": n_p, "suppliers": n_s,
                       "part_matches": pfound.sum(),
                       "supplier_matches": sfound.sum(), "kept": n_k,
                       "date_matches": dfound.sum(), "groups": ng}}


def work(sizes, k):
    n_lo = sizes["lineorder"]
    return [("filter", rf.filter_bytes(sizes["part"], (4, 4), k["parts"])),
            ("filter", rf.filter_bytes(sizes["supplier"], (4,),
                                       k["suppliers"])),
            ("join", rf.join_bytes(k["parts"], 4, 4, n_lo, 4)),
            ("join", rf.join_bytes(k["suppliers"], 4, 0, n_lo, 0)),
            ("filter", rf.filter_bytes(n_lo, (4,), k["kept"])),
            ("join", rf.join_bytes(sizes["date"], 4, 4, k["kept"], 4)),
            ("groupby", rf.groupby_bytes(k["kept"], 4, (8,), k["groups"],
                                         (8,)))]
