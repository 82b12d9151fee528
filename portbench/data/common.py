"""Building blocks of the table generators.

Every generator splits its columns in two kinds:

* columns that decide a count (filter columns, join keys, group keys,
  HAVING measures) come from one fixed draw, seeded by the configuration
  file's `fixed_seed`, and never from `--seed`. Their value histograms are
  exact (`histogram`), so the row counts follow the spec's distributions
  without sampling noise;
* `--seed` permutes the rows of every table, relabels every key domain by a
  bijection applied alike to a dimension's keys and the foreign keys that
  point at them, and draws the columns that are only summed or returned.

So every filter, join, GROUP BY, HAVING and LIMIT keeps the same number of
rows for every seed, while the answers change from seed to seed.

Every other column and table of the configuration (what no query reads)
is drawn from `--seed` by `fill`, from the column's entry in the
configuration file, so the tables on the device hold the whole schema at
its widths.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch

EPOCH = datetime.date(1992, 1, 1)   # day number 0 of every date column


def day(year: int, month: int, dom: int) -> int:
    """Day number of a calendar date (days since 1992-01-01)."""
    return (datetime.date(year, month, dom) - EPOCH).days


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def scaled(rows: int, scale: float) -> int:
    """Row count at a fraction of the configuration's scale (tests), at
    least 1."""
    return max(1, int(round(rows * scale)))


def rows(config: dict, table: str, scale: float) -> int:
    """A table's row count at `scale`; tables marked `"scales": false`
    (nation, region, date) keep theirs."""
    t = config["tables"][table]
    return scaled(t["rows"], scale) if t.get("scales", True) else t["rows"]


def row_bytes(column: dict) -> int:
    """Bytes a row of a column holds on the device."""
    return {"int32": 4, "int64": 8}.get(column["type"]) or column["width"]


def resident_bytes(config: dict, scale: float = 1.0) -> int:
    """Bytes of every table of the configuration at `scale`."""
    return sum(rows(config, name, scale) * row_bytes(col)
               for name, t in config["tables"].items()
               for col in t["columns"].values())


def _draw(column: dict, n: int, config: dict, scale: float,
          g: torch.Generator, device) -> torch.Tensor:
    d = column["draw"]
    if column["type"] == "char":          # random letters, full width
        return torch.randint(97, 123, (n, column["width"]), generator=g,
                             device=device, dtype=torch.uint8)
    dtype = getattr(torch, column["type"])
    if d == "perm":
        return perm(n, g, device).to(dtype)
    if isinstance(d, str) and d.startswith("key:"):
        return uniform(n, 0, rows(config, d[4:], scale) - 1, g, device,
                       dtype)
    return uniform(n, d[0], d[1], g, device, dtype)


def fill(tables: dict, config: dict, scale: float, g: torch.Generator,
         device) -> dict:
    """Every table and column of the configuration: those the generator
    made, and the rest drawn by their `draw` entries, in the file's
    column order."""
    out = {}
    for name, t in config["tables"].items():
        made = tables.get(name, {})
        n = next(iter(made.values())).shape[0] if made else \
            rows(config, name, scale)
        out[name] = {c: made[c] if c in made else
                     _draw(col, n, config, scale, g, device)
                     for c, col in t["columns"].items()}
        extra = set(made) - set(t["columns"])
        if extra:
            raise ValueError(f"{name}: columns {sorted(extra)} are not in "
                             "the configuration")
    return out


def perm(n: int, g: torch.Generator, device) -> torch.Tensor:
    """A uniform permutation of range(n) as int64."""
    return torch.randperm(n, generator=g, device=device)


def histogram(n: int, k: int, g: torch.Generator, device) -> torch.Tensor:
    """n int32 values in [0, k), each appearing n // k or n // k + 1 times
    (the first n % k values once more), in random order."""
    vals = torch.arange(n, device=device, dtype=torch.int64) % k
    return vals[perm(n, g, device)].to(torch.int32)


def uniform(n: int, lo: int, hi: int, g: torch.Generator, device,
            dtype=torch.int32) -> torch.Tensor:
    """n independent draws from [lo, hi] (inclusive)."""
    return torch.randint(lo, hi + 1, (n,), generator=g, device=device,
                         dtype=dtype)


def relabel(keys: torch.Tensor, mapping: torch.Tensor) -> torch.Tensor:
    """Apply the key bijection `mapping` (a permutation of the domain) to a
    key column."""
    return mapping[keys.long()].to(torch.int32)


def shuffle_rows(table: dict, g: torch.Generator, device) -> dict:
    """The same random row order for every column of a table."""
    n = next(iter(table.values())).shape[0]
    p = perm(n, g, device)
    return {k: v[p] for k, v in table.items()}


def calendar(days: int) -> dict:
    """year, month, day of month and day of year (1-based) of day numbers
    0 .. days - 1, as int32 numpy arrays."""
    d = np.datetime64("1992-01-01") + np.arange(days)
    y = d.astype("datetime64[Y]")
    m = d.astype("datetime64[M]")
    return {"year": (y.astype(int) + 1970).astype(np.int32),
            "month": ((m - y).astype(int) + 1).astype(np.int32),
            "dom": ((d - m).astype(int) + 1).astype(np.int32),
            "doy": ((d - y).astype(int) + 1).astype(np.int32)}

