"""Distributed hash join: exchange both sides by key, join each partition.

Counterpart of `cl_ops_tpu/parallel/join.py` (BASELINE.json's
"Distributed hash join: 1B-row fact x 100M-row dim"). Both relations
partition on the join key in one keyed exchange (the probe side carries
its global row ids), every position joins only its partition, and the
probe results go back to their origin rows: deterministic, and every
movement between positions is a collective of the mesh.

The local join runs the port's single-card machinery: the received build
rows sort once into the local table by (inverted validity, key limbs,
value) with the fused bitonic sort, and the probes search it with the
band probe (`bandprobe.probe_direct` while the table fits DIRECT_MAX,
else `join._banded_passes`) or, where that cannot be exact, the merge
probe. The table's slots past its `nv` valid rows hold the limb maximum
and every count clips at nv: a real key equal to the dtype's maximum
still joins, and no probe counts a fill slot. nv stays on the device.

Skew: the exchange's overflow counters are checked, never discarded
(check="replan": hash -> range splitters -> doubled capacities, then a
RuntimeError), or returned unread (check="defer"). A band-window
overflow under "replan" falls back to the merge probe after the host
read of its flag, as the single-card operator does; under "defer" no
host read is allowed, so a table past DIRECT_MAX takes the merge probe,
which is exact for any skew.
"""

from __future__ import annotations

import torch

from cl_ops_tpu_torch.ops.exec import bandprobe, psort
from cl_ops_tpu_torch.ops.exec.join import (_I32_MAX, _band_probe_rows,
                                            _banded_passes,
                                            _expand_from_ranges,
                                            _limbs_minus_one, _merge_rank,
                                            _minus_one, _val_cols,
                                            _val_from_cols)
from cl_ops_tpu_torch.ops.sort import keys as keymod
from cl_ops_tpu_torch.parallel.mesh import (DATA_AXIS, Mesh, Sharded,
                                            iota_sharded)
from cl_ops_tpu_torch.parallel.shuffle import valid_slots
from cl_ops_tpu_torch.parallel.splitters import (CHECKS, keyed_exchange_once,
                                                 keyed_exchange_replan)
from cl_ops_tpu_torch.utils.bits import is_po2

_JOIN_TYPES = ("inner", "semi", "anti")


def _exchange_sides(build_keys, build_vals, probe_keys, mesh: Mesh, *,
                    capacity_build: int, capacity_probe: int, axis: str,
                    partition: str, max_replan: int, samples_per_chip: int,
                    check: str, op_name: str):
    """Validate, then exchange the build rows (with their values) and the
    probe rows (with their global row ids) by the same key plan, the
    splitters sampled from the probe side. Returns (build result, probe
    result, build capacity, probe capacity, dropped or None)."""
    if check not in CHECKS:
        raise ValueError(f"unknown check {check!r}")
    n_chips = mesh.shape[axis]
    if not is_po2(n_chips):
        raise ValueError("mesh axis size must be a power of 2")
    sides = [(build_keys, (build_vals,)),
             (probe_keys, (iota_sharded(probe_keys.shape[0], mesh, axis),))]
    kw = dict(axis=axis, partition=partition,
              samples_per_chip=samples_per_chip, splitter_side=1)
    if check == "defer":
        (bres, pres), dropped = keyed_exchange_once(
            sides, mesh, capacities=(capacity_build, capacity_probe), **kw)
        return bres, pres, capacity_build, capacity_probe, dropped
    (bres, pres), (cb, cp) = keyed_exchange_replan(
        sides, mesh, capacities=(capacity_build, capacity_probe),
        max_replan=max_replan, op_name=op_name, **kw)
    return bres, pres, cb, cp, None


def _local_table(counts, keys, vals, cap: int):
    """A position's received build rows as its sorted local table: (key
    limbs with the slots past nv at the limb maximum, value columns, nv).
    Validity leads the sort (inverted), so the nv valid rows form the
    prefix in (key, value) order: among equal keys, the least value by its
    int32 columns comes first."""
    inv = (~valid_slots(counts, cap)).to(torch.int32)
    limbs = keymod.to_limbs(keys)
    out = psort.sort_i32_cols((inv, *limbs, *_val_cols(vals)))
    nv = counts.sum(dtype=torch.int32)
    live = torch.arange(inv.numel(), dtype=torch.int32,
                        device=inv.device) < nv
    s_limbs = tuple(torch.where(live, c, _I32_MAX)
                    for c in out[1:1 + len(limbs)])
    return s_limbs, tuple(out[1 + len(limbs):]), nv


def _scatter(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[idx[i]] = values[i] for a permutation idx."""
    return torch.empty_like(values).index_copy_(0, idx.to(torch.int64),
                                                values)


def _bounds(s_limbs, svals, plimbs, lower: bool, check: str,
            presorted: bool = False):
    """Per probe, in the probes' own order: ub, the table rows <= the key,
    and with `lower` lb, the rows < the key (from key - 1; 0 at the limb
    minimum), else None; neither clipped at nv. `presorted`: the probe
    limbs are already ascending, so the band passes skip their probe
    sort."""
    nb = s_limbs[0].numel()
    pm1, is_min = _limbs_minus_one(plimbs)
    queries = (plimbs, pm1) if lower else (plimbs,)
    counts = None
    if nb <= bandprobe.DIRECT_MAX:
        counts = [bandprobe.probe_direct(s_limbs, svals, q)[0]
                  for q in queries]
    elif check == "replan" and presorted:
        pr = _band_probe_rows(plimbs[0].numel(), nb)
        res = [bandprobe.probe_banded_sorted(s_limbs, svals, q,
                                             probe_rows=pr)
               for q in queries]
        # one host read of the overflow flags, as in the single-card join
        if not bool(torch.stack([r[4] for r in res]).any()):
            counts = [r[0] for r in res]
    elif check == "replan":
        spos, _, res, _, _ = _banded_passes(
            s_limbs, svals, plimbs, [lambda s: s, _minus_one][:len(queries)])
        if res is not None:
            counts = [_scatter(r[0], spos) for r in res]
    if counts is None:  # the merge probe: exact for any skew
        counts = [_merge_rank(s_limbs, svals, q)[0] for q in queries]
    return counts[0], torch.where(is_min, 0, counts[1]) if lower else None


def _gather(cols, idx: torch.Tensor):
    idx = idx.to(torch.int64)
    return tuple(c[idx] for c in cols)


def dist_hash_join(build_keys, build_vals, probe_keys, mesh: Mesh, *,
                   capacity_build: int, capacity_probe: int,
                   axis: str = DATA_AXIS, unique_build: bool = True,
                   join_type: str = "inner", partition: str = "hash",
                   max_replan: int = 3, samples_per_chip: int = 256,
                   check: str = "replan"):
    """Equi-join of row-sharded relations.

    capacity_* bound the rows of one (source -> partition) bucket of the
    two sides' exchange. partition: "hash", or "range" (start from
    splitters sampled from the probe side, the opener for known-skewed
    fact keys). check: "replan" (default) checks the exchange on the host
    and re-plans, never losing rows; "defer" runs one exchange under the
    given plan with no host read and appends the per-side per-position
    dropped counters, which the caller must find zero for the result to
    be exact.

    Outputs are row-sharded Shardeds aligned with probe_keys' rows:
      inner + unique_build:     (found, vals), vals undefined where not found
      inner + not unique_build: (match_count, first_vals): the value of the
        first match in the local table's (key, value) order, i.e. the least
        value by its int32 columns
      semi / anti:              the match / no-match mask alone
    With check="defer" the tuple gains (dropped_build, dropped_probe).

    Only the non-unique inner join needs the lower bound: every other form
    reads its answer from the upper bound (the last table row <= the key
    is a match, or none is), one band pass instead of two.
    """
    if join_type not in _JOIN_TYPES:
        raise ValueError(f"unknown join_type {join_type!r}")
    n_chips = mesh.shape[axis]
    n_probe = probe_keys.shape[0]
    bres, pres, cb, cp, dropped = _exchange_sides(
        build_keys, build_vals, probe_keys, mesh,
        capacity_build=capacity_build, capacity_probe=capacity_probe,
        axis=axis, partition=partition, max_replan=max_replan,
        samples_per_chip=samples_per_chip, check=check,
        op_name="dist_hash_join")
    shard_len = n_probe // n_chips
    lower = join_type == "inner" and not unique_build
    with_vals = join_type == "inner"
    vdt = bres[2].dtype

    def local(me, bc, bk, bv, pc, pk, pg):
        s_limbs, svals, nv = _local_table(bc, bk, bv, cb)
        plimbs = tuple(keymod.to_limbs(pk))
        ub, lb = _bounds(s_limbs, svals, plimbs, lower, check)
        ubc = torch.minimum(ub, nv)
        if lower:
            lbc = torch.minimum(lb, nv)
            cnt = ubc - lbc
            at = lbc
        else:
            at = (ubc - 1).clamp(min=0)
            hit = ubc > 0
            for s, p in zip(_gather(s_limbs, at), plimbs):
                hit &= s == p
            cnt = hit.to(torch.int32)
        valid = valid_slots(pc, cp)
        # back to the origin: slot s * cp + i came from position s, so the
        # buffer's buckets are already the return buckets, and rows
        # received from s number <= cp: no return bucket can overflow
        back = [torch.where(valid, pg, -1), torch.where(valid, cnt, 0)]
        if with_vals:
            back += _gather(svals, at.clamp(max=svals[0].numel() - 1))
        return [c.view(n_chips, cp) for c in back]

    per = mesh.map(local, *bres, *pres)
    routed = [mesh.all_to_all([p[i] for p in per])
              for i in range(len(per[0]))]

    def place(me, rg, *cols):
        # into this position's original row order; empty slots (row id -1)
        # land in a spare slot that is cut off
        idx = torch.where(rg >= 0, rg - me * shard_len, shard_len)
        out = []
        for c in cols:
            buf = torch.zeros(shard_len + 1, dtype=c.dtype, device=c.device)
            out.append(buf.index_copy_(0, idx.to(torch.int64), c)[:shard_len])
        return out

    placed = mesh.map(place, *routed)
    cnt = Sharded(mesh, [p[0] for p in placed])
    if join_type == "semi":
        out = (Sharded(mesh, [c > 0 for c in cnt.shards]),)
    elif join_type == "anti":
        out = (Sharded(mesh, [c == 0 for c in cnt.shards]),)
    else:
        vals = Sharded(mesh, [_val_from_cols(p[1:], vdt) for p in placed])
        found = cnt if lower else Sharded(mesh, [c > 0 for c in cnt.shards])
        out = (found, vals)
    if dropped is not None:
        out = out + (dropped,)
    return out[0] if len(out) == 1 else out


def dist_hash_join_expand(build_keys, build_vals, probe_keys, mesh: Mesh, *,
                          capacity_build: int, capacity_probe: int,
                          capacity_out: int, axis: str = DATA_AXIS,
                          partition: str = "hash", max_replan: int = 3,
                          samples_per_chip: int = 256,
                          check: str = "replan"):
    """Distributed inner-join expansion: every matching pair.

    Both relations co-partition by key as in dist_hash_join, every position
    expands its partition, and the outputs STAY partition-sharded: a pair
    belongs to its key's partition, with no probe row to align to.

    capacity_out bounds the pairs of one position. Returns (totals,
    probe_rows, vals), row-sharded Shardeds: position c's totals[c] counts
    its partition's matches; its first min(totals[c], capacity_out) rows
    each hold (global probe row, build value), ordered by (key, probe row)
    and, within one probe, by the local table's (key, value) order; later
    rows hold probe_rows == -1. totals[c] > capacity_out means position
    c's output was cut short: run again with a larger capacity_out.
    check: as dist_hash_join; "defer" appends (dropped_build,
    dropped_probe).
    """
    bres, pres, cb, cp, dropped = _exchange_sides(
        build_keys, build_vals, probe_keys, mesh,
        capacity_build=capacity_build, capacity_probe=capacity_probe,
        axis=axis, partition=partition, max_replan=max_replan,
        samples_per_chip=samples_per_chip, check=check,
        op_name="dist_hash_join_expand")
    vdt = bres[2].dtype

    def local(me, bc, bk, bv, pc, pk, pg):
        s_limbs, svals, nv = _local_table(bc, bk, bv, cb)
        # the probes sorted by (validity, key, global row id): the row id
        # is a key, so the pairs of one key come in probe-row order
        inv = (~valid_slots(pc, cp)).to(torch.int32)
        limbs = keymod.to_limbs(pk)
        out = psort.sort_i32_cols((inv, *limbs, pg))
        live = out[0] == 0
        # invalid probes trail; repeating the last valid key keeps the
        # queries ascending and their band windows narrow (at the limb
        # maximum they would reach past the window and flag an overflow)
        last = (live.sum() - 1).clamp(min=0)
        q = tuple(torch.where(live, c, c[last]) for c in out[1:-1])
        ub, lb = _bounds(s_limbs, svals, q, True, check, presorted=True)
        ub = torch.where(live, torch.minimum(ub, nv), 0)
        lb = torch.where(live, torch.minimum(lb, nv), 0)
        total, pidx, vals = _expand_from_ranges(out[-1], ub, lb, svals,
                                                capacity_out)
        return total.reshape(1), pidx, _val_from_cols(vals, vdt)

    per = mesh.map(local, *bres, *pres)
    out = tuple(Sharded(mesh, [p[i] for p in per]) for i in range(3))
    return out + (dropped,) if dropped is not None else out
