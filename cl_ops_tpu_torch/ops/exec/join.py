"""Join: fact-table probe against a keyed build side.

Counterpart of `cl_ops_tpu/ops/exec/join.py` (BASELINE.json: "Distributed
hash join: 1B-row fact x 100M-row dim"; this is its single-device
operator). The strategy is sort + search, as in the JAX package: the build
side is sorted once, and each probe finds its searchsorted-right count in
it. Keys are tuples of order-preserving int32 limbs (`ops/sort/keys.py`: 1
for <=32-bit keys, 2 for 64-bit keys); values ride as int32 columns (one
for <=4-byte values, two words for 8-byte ones).

Probe strategies (`probe_impl`):
  * "direct" — build sides of <= DIRECT_MAX rows: the probe_band kernel
    searches the probes in their original order (no probe sort).
  * "banded" — the probes are sorted once, searched block by block in
    windows of the sorted build side (bandprobe.py), and restored to their
    original order with one more sort unless `sorted_output`. A window
    overflow (extreme skew) falls back to "merge", after one host read of
    the flag per pass, or is returned as a flag with `defer_overflow`.
  * "merge" — sort the probes, bitonic-merge them with the build side
    (bitonic_merge_2d), rank, and restore: exact for any skew.
  * "auto" — direct for small build sides, banded otherwise (banded also
    when sorted_output, since direct keeps the original order).

Semantics:
  * unique build keys (dimension tables): (found, vals) per probe.
  * non-unique build keys: (match_count, first_vals) per probe.
  * hash_join_expand: all matching pairs under a static capacity.
  * join_type "inner" | "semi" | "anti": semi/anti return only the mask.

The JAX option use_pallas has no counterpart: every strategy runs the
port's kernels. The JAX package's lax.sort merge (`_merge_rank_xla`), which
it takes when the packed restore key would wrap i32, has none either: the
merge path here restores through a two-column sort instead.
"""

from __future__ import annotations

import contextlib
import functools

import torch

from cl_ops_tpu_torch import interop
from cl_ops_tpu_torch.core.errors import BadArgsError
from cl_ops_tpu_torch.ops.exec import bandprobe, psort
from cl_ops_tpu_torch.ops.sort import bitonic as _bt
from cl_ops_tpu_torch.ops.sort import bitonic_kernels as bk
from cl_ops_tpu_torch.ops.sort import keys as keymod
from cl_ops_tpu_torch.utils import intmath
from cl_ops_tpu_torch.utils.bits import cdiv, nlpo2
from cl_ops_tpu_torch.utils.profiling import named, spanned

_I32_MIN = -0x80000000
_I32_MAX = 0x7FFFFFFF
# Packed `position * 2 + eq` restore keys (and the merge path's `flag * p2
# + position` compaction keys) stay exact while 2 * rows < _PACK_MAX;
# beyond it the restores sort an extra column. Module-level so tests can
# shrink it.
_PACK_MAX = 2 ** 31
_IMPLS = ("auto", "direct", "banded", "merge")
_JOIN_TYPES = ("inner", "semi", "anti")


def _limbs(keys: torch.Tensor) -> tuple:
    return tuple(keymod.to_limbs(keys))


def _val_cols(vals: torch.Tensor) -> tuple:
    """Value column(s) as int32: 4-byte values one column, 8-byte values
    two word columns, 1- and 2-byte values zero-extended (bool as uint8)."""
    v = vals.view(torch.uint8) if vals.dtype == torch.bool else vals
    return psort.cols_to_i32((v,))[0]


def _val_from_cols(cols, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of _val_cols for gathered value columns."""
    if dtype == torch.bool:
        return psort.cols_from_i32(tuple(cols), (torch.uint8,))[0].view(
            torch.bool)
    return psort.cols_from_i32(tuple(cols), (dtype,))[0]


def _arange(n: int, dev) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=dev)


# --- the merge probe ---------------------------------------------------------------

def _merge_rank(build_limbs, build_vcols, probe_limbs,
                sorted_output: bool = False):
    """Counts and gathers of the merge-structured probe (nb, m > 0).

    Sorts the probes (with their merged ids m + row), bitonic-merges the
    ascending build with the descending probes and global-minimum pads
    (one bitonic sequence; build rows tie-break before equal probes), and
    reads each probe's count of build keys <= it as its merged position
    minus its rank among the probes.

    Returns, in ORIGINAL probe order (or SORTED probe order when
    sorted_output, skipping the restore sort): counts_leq, eq (build row
    counts_leq-1 equals the probe), val_prev and val_next (tuples of value
    columns at counts_leq-1 and counts_leq), and spos (sorted_output only:
    the original probe row of each output row; None otherwise).
    """
    nl = len(build_limbs)
    nb = build_limbs[0].numel()
    m = probe_limbs[0].numel()
    dev = probe_limbs[0].device
    p2 = nlpo2(nb + m)
    pad = p2 - nb - m
    packed = 2 * p2 < _PACK_MAX
    sp = psort.sort_i32_cols((*probe_limbs, m + _arange(m, dev)))
    cols = [torch.cat([b, s.flip(0), torch.full((pad,), _I32_MIN,
                                                 dtype=torch.int32,
                                                 device=dev)])
            for b, s in zip(build_limbs, sp[:nl])]
    # merged ids: build rows 0, probes m + row, pads -1 (before any real
    # row at the limb minimum, so every pad lands at the front)
    cols.append(torch.cat([torch.zeros(nb, dtype=torch.int32, device=dev),
                           sp[nl].flip(0),
                           torch.full((pad,), -1, dtype=torch.int32,
                                      device=dev)]))
    _, merge = _bt.resolve_geometry(p2, nl + 1)
    bk.bitonic_merge_2d(cols, merge_elems=merge)
    s_limbs, smerged = cols[:nl], cols[nl]
    flag = (smerged >= m).to(torch.int32)
    rank_excl = torch.cumsum(flag, 0) - flag
    pos = _arange(p2, dev)
    counts_all = (pos - rank_excl - pad).to(torch.int32)
    # compact the probe slots to the front, in merged order: one sort
    if packed:
        probe_pos = psort.sort_i32_cols(
            (psort.flag_pos_key(1 - flag, p2),))[0][:m]
    else:
        probe_pos = psort.sort_i32_cols((1 - flag, pos))[1][:m]
    probe_pos = probe_pos.to(torch.int64)
    counts = counts_all[probe_pos]
    probe_src = smerged[probe_pos] - m
    idx = (counts - 1).clamp(0, nb - 1).to(torch.int64)
    nxt = counts.clamp(0, nb - 1).to(torch.int64)
    val_prev = tuple(v[idx] for v in build_vcols)
    val_next = tuple(v[nxt] for v in build_vcols)
    eq = counts > 0
    for bl, sl in zip(build_limbs, s_limbs):
        eq = eq & (bl[idx] == sl[probe_pos])
    if sorted_output:
        return counts, eq, val_prev, val_next, probe_src
    nv = len(val_prev)
    if packed:  # back to original probe order; eq rides the key's low bit
        out = psort.sort_i32_cols(
            (probe_src * 2 + eq.to(torch.int32), counts, *val_prev,
             *val_next), num_keys=1, pad_safe=True)
        return (out[1], (out[0] & 1) > 0, tuple(out[2:2 + nv]),
                tuple(out[2 + nv:]), None)
    # two-column restore past the packed-key limit: probe_src is unique,
    # so eq rides as an inert column
    out = psort.sort_i32_cols(
        (probe_src, eq.to(torch.int32), counts, *val_prev, *val_next),
        num_keys=1, pad_safe=True)
    return (out[2], out[1] > 0, tuple(out[3:3 + nv]), tuple(out[3 + nv:]),
            None)


def _limbs_minus_one(limbs):
    """key - 1 in normalized limb space, and the is-minimum mask (the
    minimum maps to itself). No limb is decremented past i32 min."""
    if len(limbs) == 1:
        lo = limbs[0]
        is_min = lo == _I32_MIN
        return (lo - (~is_min).to(torch.int32),), is_min
    hi, lo = limbs
    lo_min = lo == _I32_MIN
    is_min = lo_min & (hi == _I32_MIN)
    borrow = lo_min & ~is_min  # lo wraps to i32 max, hi takes the borrow
    new_lo = torch.where(borrow, _I32_MAX, lo - (~lo_min).to(torch.int32))
    return (hi - borrow.to(torch.int32), new_lo), is_min


# --- strategy and band passes --------------------------------------------------------

def _probe_strategy(nb: int, probe_impl: str,
                    sorted_output: bool = False) -> str:
    """Resolve "auto" to the concrete probe strategy for this build size."""
    if probe_impl not in _IMPLS:
        raise BadArgsError(f"unknown probe_impl {probe_impl!r}; known: "
                           f"{_IMPLS}")
    if probe_impl == "direct" and sorted_output:
        raise BadArgsError("probe_impl='direct' keeps original probe order "
                           "and cannot honor sorted_output=True; use "
                           "'banded', 'merge', or auto")
    if probe_impl == "direct" and nb > bandprobe.DIRECT_MAX:
        raise BadArgsError("build side too large for probe_impl='direct'")
    if probe_impl != "auto":
        return probe_impl
    if sorted_output:
        return "banded"
    return "direct" if nb <= bandprobe.DIRECT_MAX else "banded"


def _band_probe_rows(m: int, nb: int) -> int:
    """Probe-block rows for a band pass: keep the expected build span of
    one probe block within half the window (uniform probes span about
    probe_rows * ROW * nb / m build rows)."""
    pr = bandprobe.PROBE_ROWS
    while pr > 128 and pr * bandprobe.ROW * nb > 8192 * m:
        pr //= 2
    return pr


def _banded_passes(bl, vals_i32, plimbs, passes, extra_cols=(),
                   defer_overflow: bool = False):
    """Sort the probes once (position and any `extra_cols` riding as
    payload), run one band pass per entry of `passes` (each maps sorted
    limbs to query limbs), and return (spos, sorted limbs, results per
    pass, sorted extra cols, ovf) with results per SORTED probe.

    Overflow makes the results unusable. Default: one host read per pass,
    and on overflow everything comes back None (the caller falls back to
    the merge probe). defer_overflow: no host read; ovf is the OR of the
    passes' flags as a 0-d bool tensor.
    """
    m = plimbs[0].numel()
    nl = len(plimbs)
    sp = psort.sort_i32_cols((*plimbs, _arange(m, plimbs[0].device),
                              *extra_cols), num_keys=nl + 1, pad_safe=True)
    sp_limbs, spos, scols = tuple(sp[:nl]), sp[nl], tuple(sp[nl + 1:])
    pr = _band_probe_rows(m, bl[0].numel())
    results = []
    ovf_any = torch.zeros((), dtype=torch.bool, device=plimbs[0].device)
    for fn in passes:
        count, eq, vp, vn, ovf = bandprobe.probe_banded_sorted(
            tuple(bl), tuple(vals_i32), tuple(fn(sp_limbs)), probe_rows=pr)
        if defer_overflow:
            ovf_any = ovf_any | ovf
        else:
            with named("clo.sync:band_overflow"):
                over = bool(ovf)
            if over:  # extreme skew: window exceeded -> merge fallback
                return None, None, None, None, None
        results.append((count, eq, vp, vn))
    return spos, sp_limbs, results, scols, ovf_any


def _minus_one(limbs):
    return _limbs_minus_one(tuple(limbs))[0]


def _merge_span(strat: str):
    """The merge probe's span: `clo.join:fallback` where it runs after a
    band overflow, none where it is the chosen strategy."""
    if strat == "merge":
        return contextlib.nullcontext()
    return named("clo.join:fallback")


def _probe_sorted(build_keys, build_vals, probe_keys, probe_impl: str,
                  sorted_output: bool, probe_cols_enc,
                  defer_overflow: bool):
    """Unique-build-key probe: (found, vals, spos|None, pcols|None, ovf).

    ovf is a 0-d bool tensor when defer_overflow (constant False off the
    banded strategy), else None. On the banded strategy the encoded probe
    payload columns ride the probe sort (returned as the 4th element);
    None means the caller reorders them through spos.
    """
    bl = _limbs(build_keys)
    plimbs = _limbs(probe_keys)
    vcols = _val_cols(build_vals)
    vdt = build_vals.dtype
    strat = _probe_strategy(build_keys.numel(), probe_impl, sorted_output)
    dev = probe_keys.device
    no_ovf = torch.zeros((), dtype=torch.bool, device=dev) \
        if defer_overflow else None
    if strat == "direct":
        _, eq, vps, _ = bandprobe.probe_direct(bl, vcols, plimbs)
        return eq, _val_from_cols(vps, vdt), None, None, no_ovf
    if strat == "banded":
        spos, _, res, scols, ovf = _banded_passes(
            bl, vcols, plimbs, [lambda s: s],
            extra_cols=probe_cols_enc if sorted_output else (),
            defer_overflow=defer_overflow)
        if res is not None:
            _, eq, vp, _ = res[0]
            if sorted_output:  # skip the restore sort entirely
                return eq, _val_from_cols(vp, vdt), spos, scols, ovf
            if 2 * spos.numel() < _PACK_MAX:
                # restore: the position rides the key with eq in its low bit
                out = psort.sort_i32_cols(
                    (spos * 2 + eq.to(torch.int32), *vp), num_keys=1,
                    pad_safe=True)
                return ((out[0] & 1) > 0, _val_from_cols(out[1:], vdt),
                        None, None, ovf)
            out = psort.sort_i32_cols((spos, eq.to(torch.int32), *vp),
                                      num_keys=1, pad_safe=True)
            return (out[1] > 0, _val_from_cols(out[2:], vdt), None, None,
                    ovf)
    with _merge_span(strat):
        _, eq, val_prev, _, spos = _merge_rank(bl, vcols, plimbs,
                                               sorted_output=sorted_output)
    return eq, _val_from_cols(val_prev, vdt), spos, None, no_ovf


def _probe_sorted_multi(build_keys, build_vals, probe_keys, probe_impl: str,
                        sorted_output: bool, probe_cols_enc,
                        defer_overflow: bool):
    """Non-unique probe: (match_count, first_vals, spos|None, pcols|None,
    ovf), as _probe_sorted.

    The upper bound (#build <= key) comes from one pass and the lower
    bound (#build < key) from a second pass on key-1 in limb space (a key
    at the limb minimum has lower bound 0). The first match value is the
    second pass's val_next. Both band passes share one probe sort, since
    key-1 keeps the sorted order.
    """
    bl = _limbs(build_keys)
    plimbs = _limbs(probe_keys)
    vcols = _val_cols(build_vals)
    vdt = build_vals.dtype
    strat = _probe_strategy(build_keys.numel(), probe_impl, sorted_output)
    dev = probe_keys.device
    no_ovf = torch.zeros((), dtype=torch.bool, device=dev) \
        if defer_overflow else None

    def first_match_fix(is_min, vn_cols):
        # minimum-key probes: the lower-bound pass's val_next points past
        # the match run; the first match is slot 0 of each value column
        return tuple(torch.where(is_min, v[0], c)
                     for v, c in zip(vcols, vn_cols))

    if strat == "direct":
        ub, _, _, _ = bandprobe.probe_direct(bl, vcols, plimbs)
        pm1, is_min = _limbs_minus_one(plimbs)
        lb, _, _, vns = bandprobe.probe_direct(bl, vcols, pm1)
        count = ub - torch.where(is_min, 0, lb)
        return (count, _val_from_cols(first_match_fix(is_min, vns), vdt),
                None, None, no_ovf)
    if strat == "banded":
        spos, sp_limbs, res, scols, ovf = _banded_passes(
            bl, vcols, plimbs, [lambda s: s, _minus_one],
            extra_cols=probe_cols_enc if sorted_output else (),
            defer_overflow=defer_overflow)
        if res is not None:
            ub = res[0][0]
            lb, vns = res[1][0], res[1][3]
            _, is_min = _limbs_minus_one(sp_limbs)
            count = ub - torch.where(is_min, 0, lb)
            val_cols = first_match_fix(is_min, vns)
            if sorted_output:  # skip the restore sort entirely
                return count, _val_from_cols(val_cols, vdt), spos, scols, \
                    ovf
            out = psort.sort_i32_cols((spos, count, *val_cols), num_keys=1,
                                      pad_safe=True)
            return out[1], _val_from_cols(out[2:], vdt), None, None, ovf
    # merge: its two passes sort the probes independently (by key and by
    # key-1, which may order min and min+1 keys differently), so compute in
    # original order and sort once for sorted_output
    with _merge_span(strat):
        ub = _merge_rank(bl, vcols, plimbs)[0]
        pm1, is_min = _limbs_minus_one(plimbs)
        lb, _, _, vns, _ = _merge_rank(bl, vcols, pm1)
        count = ub - torch.where(is_min, 0, lb)
        val_cols = first_match_fix(is_min, vns)
        if sorted_output:  # (limbs, position) is a total order
            m = plimbs[0].numel()
            nl = len(plimbs)
            out = psort.sort_i32_cols((*plimbs, _arange(m, dev), count,
                                       *val_cols), num_keys=nl + 1,
                                      pad_safe=True)
            return (out[nl + 1], _val_from_cols(out[nl + 2:], vdt), out[nl],
                    None, no_ovf)
    return count, _val_from_cols(val_cols, vdt), None, None, no_ovf


def _empty_probe(probe_keys, vdt, unique_build: bool, sorted_output: bool,
                 probe_cols_enc, defer_overflow: bool):
    """The probe of an empty side: nothing matches."""
    m = probe_keys.numel()
    dev = probe_keys.device
    hit = torch.zeros(m, dtype=torch.bool if unique_build else torch.int32,
                      device=dev)
    vals = intmath.full(m, 0, vdt, dev) if vdt != torch.bool else \
        torch.zeros(m, dtype=torch.bool, device=dev)
    spos = scols = None
    if sorted_output:
        plimbs = _limbs(probe_keys)
        nl = len(plimbs)
        sp = psort.sort_i32_cols((*plimbs, _arange(m, dev), *probe_cols_enc),
                                 num_keys=nl + 1, pad_safe=True) \
            if m else (*plimbs, _arange(0, dev), *probe_cols_enc)
        spos, scols = sp[nl], tuple(sp[nl + 1:])
    ovf = torch.zeros((), dtype=torch.bool, device=dev) \
        if defer_overflow else None
    return hit, vals, spos, scols, ovf


@functools.lru_cache(maxsize=None)
def _default_build_sorter(dtype: torch.dtype):
    """The JAX package's default build sort: abitonic for 4-byte keys, else
    the stable vendor sorter "xla"."""
    from cl_ops_tpu_torch.ops.sort import sort_new
    return sort_new("abitonic" if dtype.itemsize == 4 else "xla",
                    elem_dtype=dtype)


@spanned("clo.op:join")
def hash_join(build_keys, build_vals, probe_keys, *, build_sorted=False,
              sorter=None, unique_build: bool = True,
              join_type: str = "inner", probe_impl: str = "auto",
              sorted_output: bool = False, probe_cols=(),
              defer_overflow: bool = False):
    """Equi-join probe of the fact side against the build side.

    Args:
      build_keys: keys of the build (dimension) side, any integer or float
        dtype the key limbs take.
      build_vals: values carried per build key (any dtype up to 8 bytes).
      probe_keys: fact-side keys to look up (the build keys' dtype).
      build_sorted: set True when build_keys are already ascending.
      sorter: a Sorter for the build side (default: abitonic for 4-byte
        keys, else the stable vendor sorter "xla", as in the JAX package).
      unique_build: build keys are unique (dimension-table case).
      join_type: "inner" | "semi" | "anti".
      probe_impl: "auto" | "direct" | "banded" | "merge" (module docstring).
      sorted_output: return a trailing `probe_rows` tensor and skip the
        restore sorts: output rows come back grouped in ascending probe-key
        order, probe_rows[i] the original probe row of output row i
        ("direct", which keeps the original order, is rejected).
      probe_cols: probe-side payload columns, returned reordered to match
        the output rows (requires sorted_output). On the banded strategy
        they ride the probe sort; elsewhere they are gathered by probe_rows.
      defer_overflow: the serving form. Skips the host read of the band
        overflow flag per band pass and appends the flag as a trailing 0-d
        bool tensor: False means the outputs are exact; True means a band
        window overflowed under extreme skew and the results are garbage —
        re-run with probe_impl="merge". Non-banded strategies return a
        constant False.

    Returns:
      inner + unique_build: (found, vals), vals undefined where not found.
      inner + not unique_build: (match_count, first_vals): the value of the
        first match in build-key-sorted order.
      semi: bool mask of probes with >= 1 match; anti: of probes with none.
      With sorted_output every form gains a trailing probe_rows, and with
      probe_cols the reordered payload columns follow as one tuple. With
      defer_overflow the overflow flag is appended last.
    """
    if join_type not in _JOIN_TYPES:
        raise BadArgsError(f"unknown join_type {join_type!r}")
    if probe_cols and not sorted_output:
        raise BadArgsError("probe_cols requires sorted_output=True (in "
                           "original order the inputs are already aligned)")
    _probe_strategy(build_keys.numel(), probe_impl, sorted_output)
    if not build_sorted:
        if sorter is None:
            sorter = _default_build_sorter(build_keys.dtype)
        build_keys, build_vals = sorter.sort_with_device_data(build_keys,
                                                              build_vals)
    pc_enc, pc_spec = (psort.cols_to_i32(tuple(probe_cols))
                       if probe_cols else ((), ()))
    args = (probe_impl, sorted_output, pc_enc, defer_overflow)
    if build_keys.numel() == 0 or probe_keys.numel() == 0:
        hit, vals, spos, scols, ovf = _empty_probe(
            probe_keys, build_vals.dtype, unique_build, sorted_output,
            pc_enc, defer_overflow)
    elif unique_build:
        hit, vals, spos, scols, ovf = _probe_sorted(
            build_keys, build_vals, probe_keys, *args)
    else:
        hit, vals, spos, scols, ovf = _probe_sorted_multi(
            build_keys, build_vals, probe_keys, *args)
    found = hit if unique_build else hit > 0
    out_cols = ()
    if probe_cols:
        if scols is None:  # the strategy did not carry them: one gather each
            scols = tuple(c[spos.to(torch.int64)] for c in pc_enc)
        out_cols = (psort.cols_from_i32(scols, pc_spec),)
    tail = (ovf,) if defer_overflow else ()
    if join_type == "semi":
        out = (found, spos, *out_cols) if sorted_output else (found,)
    elif join_type == "anti":
        na = ~found
        out = (na, spos, *out_cols) if sorted_output else (na,)
    else:
        out = ((hit, vals, spos, *out_cols) if sorted_output
               else (hit, vals))
    out = out + tail
    return out[0] if len(out) == 1 else out


# --- the full expansion ------------------------------------------------------------

def _ranges_sorted(bl, vals_i32, plimbs, probe_impl: str):
    """Per-SORTED-probe match ranges (spos, ub, lb): rows lb..ub-1 of the
    sorted build side match the probe. The band strategies come out in
    sorted order; the merge fallback computes in original order and sorts
    (limbs, position, ub, lb) once to align."""
    nl = len(plimbs)
    strat = _probe_strategy(bl[0].numel(), probe_impl)
    if strat in ("direct", "banded"):
        spos, sp_limbs, res, _, _ = _banded_passes(
            bl, vals_i32, plimbs, [lambda s: s, _minus_one])
        if res is not None:
            _, is_min = _limbs_minus_one(sp_limbs)
            return spos, res[0][0], torch.where(is_min, 0, res[1][0])
    with _merge_span(strat):
        ub = _merge_rank(bl, vals_i32, plimbs)[0]
        pm1, is_min = _limbs_minus_one(plimbs)
        lb = torch.where(is_min, 0, _merge_rank(bl, vals_i32, pm1)[0])
        out = psort.sort_i32_cols(
            (*plimbs, _arange(plimbs[0].numel(), ub.device), ub, lb),
            num_keys=nl + 1, pad_safe=True)
    return out[nl], out[nl + 1], out[nl + 2]


def _expand_glue(sposj, valsr, prefix_inc, capacity: int):
    """(total, probe_idx, vals): rows at or past min(total, capacity) get
    probe_idx -1."""
    total = prefix_inc[-1]
    r = _arange(capacity, prefix_inc.device)
    valid = r < torch.clamp(total, max=capacity)
    return total, torch.where(valid, sposj, -1), valsr


def _expand_pass2_inputs(lbj, rq, j, pex_raw, nb: int, block: int):
    """Pass-2 queries and their exact per-output-block min and max."""
    # rows with j == 0 sit before the first prefix entry: exclusive prefix 0
    pex = torch.where(j == 0, 0, pex_raw)
    bpos = (lbj + (rq - pex)).clamp(0, nb - 1).to(torch.int32)
    capacity = rq.numel()
    grid = cdiv(capacity, block)
    bp = bpos
    if grid * block != capacity:  # pad with the last query: bounds unchanged
        bp = torch.cat([bpos, bpos[-1:].expand(grid * block - capacity)])
    b2 = bp.view(grid, block)
    return bpos, b2.min(1).values, b2.max(1).values


def _expand_from_ranges_banded(spos, ub, lb, svcols, capacity: int):
    """The expansion as two probe_band passes.

    Pass 1 searches the inclusive match-count prefix with the output rows
    r = 0..capacity-1 as (sorted) queries, with (prefix, lb, spos) as three
    value columns in one launch: the count is the segment j of row r,
    val_prev[0] its exclusive prefix, val_next[1..2] are lb[j] and spos[j].
    Queries clamp at total-1, so rows past the total replicate the last
    valid one. Pass 2 gathers the build values as a band search over iota
    keys; its queries dip back at each duplicate probe key, so it passes
    exact per-block bounds. Probe blocks of 128 rows (16K outputs, within
    the 16K-row window) keep expansions with >= 1 match per spanned probe
    from overflowing. A pass-2 overflow (sparse ranges) gathers the values
    directly; a pass-1 overflow returns None (the caller falls back).
    """
    nb = svcols[0].numel()
    pr = 128
    prefix_inc = torch.cumsum(ub - lb, 0, dtype=torch.int32)
    total = prefix_inc[-1]
    rq = torch.minimum(_arange(capacity, ub.device),
                       torch.clamp(total - 1, min=0))
    j, _, vps, vns, ovf1 = bandprobe.probe_banded_sorted(
        (prefix_inc,), (prefix_inc, lb, spos), (rq,), probe_rows=pr)
    with named("clo.sync:expand_overflow"):
        over = bool(ovf1)
    if over:
        return None
    bpos, blo, bhi = _expand_pass2_inputs(vns[1], rq, j, vps[0], nb,
                                          pr * bandprobe.ROW)
    _, _, valsr, _, ovf2 = bandprobe.probe_banded_sorted(
        (_arange(nb, ub.device),), tuple(svcols), (bpos,), probe_rows=pr,
        block_bounds=((blo,), (bhi,)))
    with named("clo.sync:expand_overflow"):
        over = bool(ovf2)
    if over:  # sparse: a direct gather instead of the band windows
        valsr = tuple(v[bpos.to(torch.int64)] for v in svcols)
    return _expand_glue(vns[2], valsr, prefix_inc, capacity)


def _expand_from_ranges(spos, ub, lb, svcols, capacity: int):
    """The expansion without band passes (the pass-1 overflow fallback, and
    the distributed expansion's).

    Output row r belongs to the sorted probe j whose range holds it: the
    last j whose range starts at or before r (the starts never decrease,
    and empty ranges share the start of the next non-empty one, so the
    last such j is the non-empty one); its build row is lb[j] + (r -
    start[j]).
    """
    counts = ub - lb
    prefix_inc = torch.cumsum(counts, 0, dtype=torch.int32)
    start = (prefix_inc - counts).to(torch.int64)
    m, nb = counts.numel(), svcols[0].numel()
    dev = ub.device
    r = torch.arange(capacity, dtype=torch.int64, device=dev)
    jc = (torch.searchsorted(start, r, right=True) - 1).clamp(0, m - 1)
    bpos = (lb[jc] + (r - start[jc])).clamp(0, nb - 1)
    vals = tuple(v[bpos] for v in svcols)
    return _expand_glue(spos[jc], vals, prefix_inc, capacity)


@spanned("clo.op:join")
def hash_join_expand(build_keys, build_vals, probe_keys, *, capacity: int,
                     build_sorted=False, sorter=None,
                     probe_impl: str = "auto"):
    """Emit ALL matching (probe row, build value) pairs, capacity-bounded.

    Every probe row appears once per matching build row. Output rows are
    ordered by (probe key, original probe position), the matches of one
    probe contiguous in sorted-build order.

    Args:
      capacity: output length. When the true match total exceeds it the
        output is TRUNCATED: check `total` and re-run with a larger one.
      (other args as hash_join; like it, the banded path reads the band
      overflow flags on the host.)

    Returns:
      (total, probe_idx, vals): total a 0-d int32 tensor counting all
      matches; probe_idx/vals of length capacity, row r < min(total,
      capacity) one match pair (original probe row, build value), later
      rows probe_idx -1.
    """
    if capacity <= 0:
        raise BadArgsError("capacity must be positive")
    dev = probe_keys.device
    if probe_keys.numel() == 0 or build_keys.numel() == 0:
        vals = torch.zeros(capacity, dtype=torch.bool, device=dev) \
            if build_vals.dtype == torch.bool else \
            intmath.full(capacity, 0, build_vals.dtype, dev)
        return (torch.zeros((), dtype=torch.int32, device=dev),
                torch.full((capacity,), -1, dtype=torch.int32, device=dev),
                vals)
    if not build_sorted:
        if sorter is None:
            sorter = _default_build_sorter(build_keys.dtype)
        build_keys, build_vals = sorter.sort_with_device_data(build_keys,
                                                              build_vals)
    bl = _limbs(build_keys)
    vcols = _val_cols(build_vals)
    spos, ub, lb = _ranges_sorted(bl, vcols, _limbs(probe_keys), probe_impl)
    out = _expand_from_ranges_banded(spos, ub, lb, vcols, capacity)
    if out is None:  # pass-1 band overflow
        with named("clo.join:fallback"):
            out = _expand_from_ranges(spos, ub, lb, vcols, capacity)
    total, pidx, vals = out
    return total, pidx, _val_from_cols(vals, build_vals.dtype)


def hash_u32(keys: torch.Tensor, table_bits: int) -> torch.Tensor:
    """Multiplicative (Fibonacci) hash of 32-bit keys into
    [0, 2^table_bits), as int32: (k * 2654435769 mod 2^32) >> (32 -
    table_bits), with keys converted to u32 as numpy's astype does. The
    product is taken in 16-bit halves so no int64 overflows."""
    k = interop.widen_u32(intmath.astype(keys, torch.uint32))
    c = 2654435769
    prod = ((k & 0xFFFF) * c + ((((k >> 16) * c) & 0xFFFF) << 16)) \
        & 0xFFFFFFFF
    return (prod >> (32 - table_bits)).to(torch.int32)
