"""Raw-column bitonic sort for the exec operators.

Counterpart of `cl_ops_tpu/ops/exec/psort.py`. The query operators sort
tuples of 4-byte COLUMNS (normalized key limbs, or `flag*n + position`
ranks) through the fused bitonic schedule directly, without a Sorter.

Comparator: rows order by signed-i32 lexicographic comparison of all
columns, or of the first `num_keys`. Callers make the leading column(s)
unique (e.g. by mixing in the row position) so the rest are inert payload.
"""

from __future__ import annotations

import os

import torch

from cl_ops_tpu_torch.ops.sort import bitonic as _bt
from cl_ops_tpu_torch.ops.sort import bitonic_kernels as bk
from cl_ops_tpu_torch.utils.bits import nlpo2
from cl_ops_tpu_torch.utils.profiling import named

# i32 max pads sort after every real row (see sort_i32_cols for the tie).
_PAD = 0x7FFFFFFF


def cols_sortable(*cols) -> bool:
    """True when every column is 4-byte (rides the i32 kernels directly)."""
    return all(c.dtype.itemsize == 4 for c in cols)


def as_i32(c: torch.Tensor) -> torch.Tensor:
    """Reinterpret any 4-byte column as int32 (identity for int32)."""
    return c if c.dtype == torch.int32 else c.view(torch.int32)


def from_i32(c: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of as_i32."""
    return c if dtype == torch.int32 else c.view(dtype)


def flag_pos_key(flag_i32: torch.Tensor, n: int) -> torch.Tensor:
    """`flag * n + position`: one unique i32 key whose ascending sort is a
    STABLE partition. Requires 2n < 2^31 (the callers check it)."""
    pos = torch.arange(n, dtype=torch.int32, device=flag_i32.device)
    return flag_i32 * n + pos


def cols_encodable(*cols) -> bool:
    """True when every column has a cols_to_i32 encoding (int/uint/float of
    1/2/4/8 bytes; bool and complex have none)."""
    return all(c.dtype != torch.bool and not c.dtype.is_complex
               and c.dtype.itemsize in (1, 2, 4, 8) for c in cols)


def cols_to_i32(cols):
    """Encode PAYLOAD columns of any width as int32 columns.

    4-byte columns reinterpret 1:1; 8-byte columns split into (low, high)
    word columns; 1/2-byte columns zero-extend. Returns (encoded tuple,
    spec) for cols_from_i32. The encodings do not order like the originals.
    """
    enc, spec = [], []
    for c in cols:
        dt = c.dtype
        if not cols_encodable(c):
            raise ValueError(f"unsupported payload dtype {dt}")
        if dt.itemsize == 4:
            enc.append(as_i32(c))
        elif dt.itemsize == 8:
            pair = c.view(torch.int32).view(-1, 2)  # little-endian words
            enc += [pair[:, 0].contiguous(), pair[:, 1].contiguous()]
        elif dt.itemsize == 2:
            enc.append(c.view(torch.int16).to(torch.int32) & 0xFFFF)
        else:
            enc.append(c.view(torch.uint8).to(torch.int32))
        spec.append(dt)
    return tuple(enc), tuple(spec)


def cols_from_i32(enc, spec):
    """Inverse of cols_to_i32."""
    out, i = [], 0
    for dt in spec:
        if dt.itemsize == 4:
            out.append(from_i32(enc[i], dt))
            i += 1
        elif dt.itemsize == 8:
            pair = torch.stack([enc[i], enc[i + 1]], dim=-1)
            out.append(pair.view(dt).view(-1))
            i += 2
        else:
            small = torch.int16 if dt.itemsize == 2 else torch.uint8
            out.append(enc[i].to(small).view(dt))
            i += 1
    return tuple(out)


def sort_traffic_bytes(n: int, n_cols: int) -> int:
    """Bytes-moved model of sort_i32_cols: the abitonic sorter's schedule
    and padded copy."""
    return _bt.abitonic_traffic_bytes(n, n_cols)


def sort_i32_cols(cols, *, num_keys: int | None = None,
                  pad_safe: bool = False, block_elems: int | None = None,
                  merge_elems: int | None = None):
    """Sort rows ascending by lexicographic comparison of 4-byte columns.

    num_keys compares only the first num_keys columns; the rest ride as
    payload (moved, never compared; rows stay whole). Rows tied on the
    prefix come out in unspecified relative order. The columns are copied
    into buffers padded to a power of two with i32-max rows, sorted there in
    place, and sliced back. With num_keys the pad rows must still sort last
    on the prefix alone, which fails only for real rows whose prefix is all
    i32-max: callers whose prefix cannot reach that (a position or rank
    column in it) pass pad_safe=True; otherwise padding falls back to the
    total comparator.

    Rows wider than the kernels' MAX_COLS columns, with a num_keys prefix
    narrower than that, sort the prefix with a row index, and the payload
    columns follow by one gather.

    block_elems and merge_elems override the geometry (bitonic.py). With
    CL_OPS_PSORT_AUTOTUNE=1 in the environment the rest of it comes from
    the on-card tuner (autotune.py, cached per device, length and column
    count), the single-launch sort included; CPU tensors are not tuned.
    Returns the reordered columns (same dtypes and lengths).
    """
    n = cols[0].shape[0]
    if num_keys is not None and len(cols) > bk.MAX_COLS > num_keys:
        idx = torch.arange(n, dtype=torch.int32, device=cols[0].device)
        out = sort_i32_cols((*cols[:num_keys], idx), num_keys=num_keys,
                            pad_safe=pad_safe, block_elems=block_elems,
                            merge_elems=merge_elems)
        perm = out[-1]
        return (*out[:-1], *(from_i32(as_i32(c)[perm], c.dtype)
                             for c in cols[num_keys:]))
    dts = [c.dtype for c in cols]
    with named("clo.sort", n=n, padded=nlpo2(n), cols=len(cols)):
        bufs, padded = bk.pad_and_reshape([as_i32(c) for c in cols],
                                          [_PAD] * len(cols))
        if num_keys is not None and (num_keys >= len(cols) or
                                     (padded != n and not pad_safe)):
            num_keys = None  # total comparator: no payload, or pad-tie risk
        opts = {k: str(v) for k, v in (("block_elems", block_elems),
                                       ("merge_elems", merge_elems))
                if v is not None}
        if os.environ.get("CL_OPS_PSORT_AUTOTUNE") == "1":
            opts["autotune"] = "1"
        b, m, sl = _bt.sort_plan(padded, len(bufs), opts, bufs[0].device)
        bk.bitonic_sort_2d(bufs, block_elems=b, merge_elems=m,
                           num_keys=num_keys, single_launch=sl)
        return tuple(from_i32(a[:n], dt) for a, dt in zip(bufs, dts))
