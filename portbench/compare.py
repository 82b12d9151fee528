"""The comparison that decides `correct`: a query's full result and the row
count of each of its operator calls, against the reference's, exactly.
Both sides are host values: numpy columns and integer counts."""

import numpy as np

# One exact comparison: the configurations state exact integer answers
# (and float64 averages that are the quotients of exact sums). Result rows
# and operator row counts are one number, since only together does the
# control (float32 decimals) move it: no decimal decides a count.
LIMITS = {"mismatches": 0}


def rows_wrong(got: list, want: list) -> int:
    """Rows that differ in any column, plus rows one side lacks. A column
    may be 2-D (a text column: a row of bytes)."""
    n_got = max((len(c) for c in got), default=0)
    n_want = max((len(c) for c in want), default=0)
    if len(got) != len(want):
        return max(n_got, n_want)
    n = min(n_got, n_want)
    bad = np.zeros(n, dtype=bool)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        if len(g) < n or len(w) < n or g.shape[1:] != w.shape[1:]:
            return max(n_got, n_want)
        bad |= (g[:n] != w[:n]).reshape(n, -1).any(axis=1)
    return int(bad.sum()) + abs(n_got - n_want)


def counts_wrong(got: dict, want: dict) -> int:
    """Operator row counts that differ or that one side lacks."""
    return sum(got.get(k) != want.get(k) for k in set(got) | set(want))


def check(results: list, references: dict) -> dict:
    """Judge every (query, host result) of a window against its query's
    reference. Returns the compared number, `mismatches` (result rows and
    operator row counts that differ, over all results), and the number of
    results with any mismatch."""
    out = {"mismatches": 0, "failed": 0}
    for query, got in results:
        want = references[query]
        m = (rows_wrong(got["rows"], want["rows"])
             + counts_wrong(got["counts"], want["counts"]))
        out["mismatches"] += m
        out["failed"] += m > 0
    return out
