"""SSB Q1.x in plain PyTorch (the SQL is in plans/_ssb_q1.py)."""


from portbench.reference.common import as_int, dec, lookup


def answer(t, date_ok, disc, qty, exact):
    lo, d = t["lineorder"], t["date"]
    found, row = lookup(d["d_datekey"], lo["lo_orderdate"])
    dc, q = lo["lo_discount"], lo["lo_quantity"]
    mask = (found & date_ok[row] & (dc >= disc[0]) & (dc <= disc[1])
            & (q >= qty[0]) & (q <= qty[1]))
    dt = dec(exact)
    revenue = (lo["lo_extendedprice"][mask].to(dt) * dc[mask].to(dt)).sum()
    return {"rows": [as_int(revenue.reshape(1))],
            "counts": {"dates": int(date_ok.sum()),
                       "date_matches": int(found.sum()),
                       "kept": int(mask.sum())}}
