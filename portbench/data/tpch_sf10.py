"""TPC-H tables at scale factor 10 (TPC-H v3, clause 4.2.3), every table
and column of clause 1.4, made on the device from `--seed`.

Fixed draw (the configuration's `fixed_seed`): lines per order (an exact
histogram of 1-7, mean 4), which customer places each order, the order
dates, and per line the quantity, ship and receipt offsets and the
return flag's coin. So every count Q1 and Q18 take is the same for every
seed. `--seed`: the order and customer key bijections, the row order of
every table, the prices, discounts, taxes, total prices and commit
dates, and every column no query reads (`common.fill`).
"""

from __future__ import annotations

import torch

from portbench.data import common as c

CURRENT = c.day(1995, 6, 17)          # TPC-H CURRENTDATE
LAST_ORDER_DAY = c.day(1998, 12, 31) - 151   # ENDDATE - 151 days
RF_A, RF_N, RF_R = 0, 1, 2            # l_returnflag codes, in 'A' < 'N' < 'R' order
LS_F, LS_O = 0, 1                     # l_linestatus codes, 'F' < 'O'


def generate(config: dict, seed: int, device, scale: float = 1.0) -> dict:
    n_orders = c.rows(config, "orders", scale)
    n_cust = c.rows(config, "customer", scale)
    n_part = c.rows(config, "part", scale)
    n_supp = c.rows(config, "supplier", scale)

    # --- the fixed draw ------------------------------------------------
    g = c.generator(config["fixed_seed"], device)
    # lines per order: 1..7 equally often, the remainder with 4 lines, so
    # lineitem holds exactly 4 lines an order
    per = n_orders // 7
    counts = torch.full((n_orders,), 4, dtype=torch.int64, device=device)
    counts[:7 * per] = torch.arange(7 * per, device=device) // per + 1
    counts = counts[c.perm(n_orders, g, device)]
    orderdate = c.histogram(n_orders, LAST_ORDER_DAY + 1, g, device)
    active = torch.arange(n_cust, device=device)
    active = active[active % 3 != 0]       # a third of customers order nothing
    cust = active[c.histogram(n_orders, active.numel(), g, device).long()]
    order_of_line = torch.repeat_interleave(
        torch.arange(n_orders, device=device), counts)
    n_lines = order_of_line.numel()
    first = torch.cumsum(counts, 0) - counts
    linenumber = (torch.arange(n_lines, device=device)
                  - first[order_of_line] + 1).to(torch.int32)
    del first
    qty = c.histogram(n_lines, 50, g, device) + 1
    ship = orderdate[order_of_line] + c.histogram(n_lines, 121, g, device) + 1
    receipt = ship + c.histogram(n_lines, 30, g, device) + 1
    coin = c.histogram(n_lines, 2, g, device)
    flag = torch.where(receipt <= CURRENT, torch.where(coin == 0, RF_R, RF_A),
                       RF_N).to(torch.int32)
    status = torch.where(ship > CURRENT, LS_O, LS_F).to(torch.int32)
    n_open = torch.zeros(n_orders, dtype=torch.int64, device=device)
    n_open.index_add_(0, order_of_line, status.long())
    ostatus = torch.where(n_open == 0, ord("F"), torch.where(
        n_open == counts, ord("O"), ord("P"))).to(torch.uint8)[:, None]
    del coin, n_open

    # --- the seeded draw -----------------------------------------------
    g = c.generator(seed, device)
    okey = c.perm(n_orders, g, device)
    ckey = c.perm(n_cust, g, device)
    price = qty * c.uniform(n_lines, 90000, 209900, g, device)   # cents
    disc = c.uniform(n_lines, 0, 10, g, device)
    tax = c.uniform(n_lines, 0, 8, g, device)
    charge = price.long() * (100 + tax.long()) * (100 - disc.long())
    total = torch.zeros(n_orders, dtype=torch.int64, device=device)
    total.index_add_(0, order_of_line, charge)
    total = total // 10000
    commit = orderdate[order_of_line] + c.uniform(n_lines, 30, 90, g, device)

    lineitem = {"l_orderkey": c.relabel(order_of_line, okey),
                "l_linenumber": linenumber,
                "l_quantity": qty * 100, "l_extendedprice": price,
                "l_discount": disc, "l_tax": tax, "l_returnflag": flag,
                "l_linestatus": status, "l_shipdate": ship,
                "l_commitdate": commit, "l_receiptdate": receipt}
    del order_of_line, charge, linenumber, commit, receipt
    orders = {"o_orderkey": okey.to(torch.int32),
              "o_custkey": c.relabel(cust, ckey), "o_orderstatus": ostatus,
              "o_orderdate": orderdate, "o_totalprice": total}
    customer = {"c_custkey": ckey.to(torch.int32)}
    # 4 suppliers a part, distinct: (partkey + i * suppliers / 4) mod
    # suppliers (clause 4.2.3's formula, on dense keys)
    ps_row = torch.arange(c.rows(config, "partsupp", scale), device=device)
    ps_part = ps_row % n_part
    ps_supp = (ps_part + ps_row // n_part * max(1, n_supp // 4)) % n_supp
    partsupp = {"ps_partkey": ps_part.to(torch.int32),
                "ps_suppkey": ps_supp.to(torch.int32)}
    made = {"lineitem": c.shuffle_rows(lineitem, g, device),
            "orders": c.shuffle_rows(orders, g, device),
            "customer": c.shuffle_rows(customer, g, device),
            "partsupp": partsupp}
    return c.fill(made, config, scale, g, device)
