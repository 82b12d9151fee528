"""SSB Q2.x in plain PyTorch (the SQL is in plans/_ssb_q2.py)."""

import torch

from portbench.reference.common import as_int, dec, group_sum, lookup


def answer(t, part_mask, region, exact):
    lo, p, s, d = t["lineorder"], t["part"], t["supplier"], t["date"]
    pfound, prow = lookup(p["p_partkey"][part_mask], lo["lo_partkey"])
    skeys = s["s_suppkey"][s["s_region"] == region]
    sfound = torch.isin(lo["lo_suppkey"], skeys)
    krow = torch.nonzero(pfound & sfound).flatten()
    brand = p["p_brand1"][part_mask][prow[krow]]
    dfound, drow = lookup(d["d_datekey"], lo["lo_orderdate"][krow])
    year = d["d_year"][drow]
    keys, (rev,), _ = group_sum(year.long() * 10000 + brand,
                                [lo["lo_revenue"][krow]], dec(exact))
    counts = {"parts": int(part_mask.sum()), "suppliers": skeys.numel(),
              "part_matches": int(pfound.sum()),
              "supplier_matches": int(sfound.sum()), "kept": krow.numel(),
              "date_matches": int(dfound.sum()), "groups": keys.numel()}
    return {"rows": [keys // 10000, keys % 10000, as_int(rev)],
            "counts": counts}
