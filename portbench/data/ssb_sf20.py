"""Star Schema Benchmark tables at scale factor 20 (O'Neil et al., rev. 3),
every table and column of its section 2, made on the device from `--seed`.

Fixed draw (the configuration's `fixed_seed`): every lineorder's part,
supplier, order date, quantity and discount, every part's brand (and so
category and manufacturer) and every supplier's region, each an exact
histogram: every part key appears 120 times, every supplier key 3,000
times, every brand on 1,000 parts, every region on 8,000 suppliers.
`--seed`: the part, supplier and date key bijections, the row order of
every table, the prices and revenues, and every column no query reads
(`common.fill`).
"""

from __future__ import annotations

import torch

from portbench.data import common as c

DATE_ROWS = 2556                       # dbgen's date table: 1992-01-01 on
LAST_ORDER_DAY = c.day(1998, 12, 31) - 151
REGIONS = ("AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST")
BRANDS = 1000                           # 5 manufacturers x 5 categories x 40


def generate(config: dict, seed: int, device, scale: float = 1.0) -> dict:
    rows = config["tables"]
    n_supp = c.rows(config, "supplier", scale)
    n_part = n_supp * (rows["part"]["rows"] // rows["supplier"]["rows"])
    n_lo = n_part * (rows["lineorder"]["rows"] // rows["part"]["rows"])

    # --- the fixed draw ------------------------------------------------
    g = c.generator(config["fixed_seed"], device)
    b = c.histogram(n_part, BRANDS, g, device)
    category = (b // 200 + 1) * 10 + (b // 40) % 5 + 1     # MFGR#11 .. #55
    brand = category * 100 + b % 40 + 1                    # MFGR#1101 ..
    region = c.histogram(n_supp, len(REGIONS), g, device)
    partkey = c.histogram(n_lo, n_part, g, device)
    suppkey = c.histogram(n_lo, n_supp, g, device)
    orderdate = c.histogram(n_lo, LAST_ORDER_DAY + 1, g, device)
    qty = c.histogram(n_lo, 50, g, device) + 1
    disc = c.histogram(n_lo, 11, g, device)

    # --- the seeded draw -----------------------------------------------
    g = c.generator(seed, device)
    pmap = c.perm(n_part, g, device)
    smap = c.perm(n_supp, g, device)
    dmap = c.perm(DATE_ROWS, g, device)
    price = qty * c.uniform(n_lo, 90000, 209900, g, device)   # cents
    revenue = (price.long() * (100 - disc) // 100).to(torch.int32)

    cal = {k: torch.from_numpy(v).to(device)
           for k, v in c.calendar(DATE_ROWS).items()}
    weekday = torch.arange(DATE_ROWS, device=device, dtype=torch.int32)
    date = {"d_datekey": dmap.to(torch.int32), "d_year": cal["year"],
            "d_yearmonthnum": cal["year"] * 100 + cal["month"],
            # 1992-01-01 was a Wednesday: day 4 of a week from Sunday
            "d_daynuminweek": (weekday + 3) % 7 + 1,
            "d_daynuminmonth": cal["dom"], "d_daynuminyear": cal["doy"],
            "d_monthnuminyear": cal["month"],
            "d_weeknuminyear": (cal["doy"] - 1) // 7 + 1}
    part = {"p_partkey": pmap.to(torch.int32), "p_category": category,
            "p_brand1": brand}
    supplier = {"s_suppkey": smap.to(torch.int32), "s_region": region}
    lineorder = {"lo_orderdate": c.relabel(orderdate, dmap),
                 "lo_partkey": c.relabel(partkey, pmap),
                 "lo_suppkey": c.relabel(suppkey, smap),
                 "lo_quantity": qty, "lo_discount": disc,
                 "lo_extendedprice": price, "lo_revenue": revenue}
    made = {"lineorder": c.shuffle_rows(lineorder, g, device),
            "part": c.shuffle_rows(part, g, device),
            "supplier": c.shuffle_rows(supplier, g, device),
            "date": c.shuffle_rows(date, g, device)}
    # orders of 4 adjacent lines, in the shuffled rows' order
    row = torch.arange(n_lo, device=device, dtype=torch.int32)
    made["lineorder"].update(lo_orderkey=row // 4, lo_linenumber=row % 4 + 1)
    del row
    return c.fill(made, config, scale, g, device)
