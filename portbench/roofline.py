"""The yardstick of every `<op>_roofline` metric: the bytes an operator
call has to move, and the published peak it moves them at.

An operator's bound is its inputs' bytes read once plus its outputs' bytes
written once, counted from the shapes and from the row counts that the
reference computes: never from launches, passes or padding. So it reads
the same work whatever implements the operator, and the least time any
implementation can take is bytes / PEAK_BYTES_S.
"""

PEAK_BYTES_S = 3.35e12    # H100 SXM, HBM3: NVIDIA's data sheet
COUNT = 8                 # a returned row count


def filter_bytes(n, col_bytes, kept, mask=1):
    """filter_compact over n rows of columns `col_bytes` wide, keeping
    `kept`: the columns and the mask read, the kept rows and the count
    written."""
    w = sum(col_bytes)
    return n * (w + mask) + kept * w + COUNT


def groupby_bytes(n, key, values, groups, tables, mask=0):
    """GROUP BY of n rows (a key `key` bytes wide, the distinct measure
    columns `values`, a validity mask of `mask` bytes a row) into `groups`
    groups: the inputs read, a key and one entry of each table in `tables`
    written a group, and the count."""
    return n * (key + sum(values) + mask) + groups * (key + sum(tables)) \
        + COUNT


def join_bytes(nb, key, val, m, out_val):
    """A probe of m keys against a build side of nb (key, value) rows: both
    read, a found flag and an `out_val`-byte value written a probe."""
    return nb * (key + val) + m * key + m * (1 + out_val)


def topk_bytes(n, row, k):
    """top-k of n rows `row` bytes wide: the rows read, k rows written."""
    return n * row + k * row
