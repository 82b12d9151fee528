"""Skew-aware repartitioning: sampled splitters + range exchange.

Counterpart of `cl_ops_tpu/parallel/splitters.py`. Hash partitioning
balances only uniform keys; under skew one position drowns. Every position
contributes a strided sample of its keys, `mesh.all_gather` gives each the
whole sample, and each computes the same equal-frequency splitters from it;
rows then route by `searchsorted(splitters, key)` (side left), so each
position owns an equal fraction of rows, not of key space.

Keys of every dtype that `ops/sort/keys.py` takes are compared through
their order-preserving limbs (one int32, or two folded into one int64), so
unsigned and float keys order as the JAX package orders them.
"""

from __future__ import annotations

import torch

from cl_ops_tpu_torch import interop
from cl_ops_tpu_torch.ops.exec.join import hash_u32
from cl_ops_tpu_torch.ops.sort import keys as keymod
from cl_ops_tpu_torch.parallel.mesh import (DATA_AXIS, Mesh, Sharded,
                                            put_sharded, replicate,
                                            replicated, replicated_sum_int)
from cl_ops_tpu_torch.parallel.shuffle import (partition_exchange,
                                               valid_slots)
from cl_ops_tpu_torch.utils.bits import log2_floor


def _order_key(k: torch.Tensor) -> torch.Tensor:
    """An int32 or int64 tensor ordered as the keys k, one-to-one."""
    limbs = keymod.to_limbs(k)
    if len(limbs) == 1:
        return limbs[0]
    # high limb * 2^32 + low limb as unsigned: no int64 overflows
    return limbs[0].to(torch.int64) * (1 << 32) \
        + (limbs[1].to(torch.int64) + (1 << 31))


def _sorted(k: torch.Tensor) -> torch.Tensor:
    """The keys k in ascending order."""
    return interop.take(k, torch.sort(_order_key(k)).indices)


def hash_partition_ids(keys: torch.Tensor, n_chips: int) -> torch.Tensor:
    """Hash partition id in [0, n_chips) (Fibonacci hash high bits), int32."""
    bits = log2_floor(n_chips)
    if bits == 0:
        return torch.zeros(keys.shape, dtype=torch.int32, device=keys.device)
    return hash_u32(keys, bits)


def _range_ids(splitters: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """searchsorted(splitters, keys), side left, as int32."""
    return torch.searchsorted(_order_key(splitters),
                              _order_key(keys)).to(torch.int32)


def _replicate(splitters, mesh: Mesh) -> Sharded:
    """Splitters at every position: plan_splitters' output as it is, or a
    host array or tensor copied to each position's device."""
    if isinstance(splitters, Sharded):
        return splitters
    if not isinstance(splitters, torch.Tensor):
        splitters = interop.to_torch(splitters, device="cpu")
    return replicate(splitters, mesh)


def _pids(mode: str, keys, mesh: Mesh, splitter_side: int,
          samples_per_chip: int, axis: str) -> list[Sharded]:
    """Every side's partition ids under a hash or range plan."""
    n_chips = mesh.shape[axis]
    if mode == "hash":
        return [Sharded(mesh, mesh.map(
            lambda me, k: hash_partition_ids(k, n_chips), k)) for k in keys]
    spl = plan_splitters(keys[splitter_side], mesh,
                         samples_per_chip=samples_per_chip, axis=axis)
    return [Sharded(mesh, mesh.map(lambda me, s, k: _range_ids(s, k), spl, k))
            for k in keys]


# the overflow contracts of the keyed operators: re-plan on the host, or
# one exchange whose dropped counters go back to the caller unread
CHECKS = ("replan", "defer")


def _check_partition(partition: str) -> None:
    if partition not in ("hash", "range"):
        raise ValueError(f"unknown partition {partition!r}")


def keyed_exchange_replan(sides, mesh: Mesh, *, capacities,
                          axis: str = DATA_AXIS, partition: str = "hash",
                          max_replan: int = 3, samples_per_chip: int = 256,
                          splitter_side: int | None = None,
                          op_name: str = "keyed_exchange"):
    """Partition-exchange keyed relations together, re-planning on overflow.

    Every side routes by the same function of its key column, so equal keys
    from all sides land on the same position.

    Args:
      sides: sequence of (keys, extra_cols) pairs (Shardeds, or anything
        put_sharded takes).
      capacities: per-side starting (source -> partition) bucket bounds.
      partition: "hash" (Fibonacci-hash high bits) or "range"
        (equal-frequency splitters from a strided key sample).
      splitter_side: which side's keys feed plan_splitters (default: the
        longest side).

    Each attempt reads every side's dropped count on the host. On any
    overflow the plan escalates: hash switches to range splitters; next
    the splitter sample quadruples; after that every overflowing side's
    capacity doubles per attempt, with the plan fixed, so sides that did
    not overflow keep their previous exchange instead of running it again.
    After `max_replan` escalations with rows still dropping it raises
    RuntimeError: rows are never silently lost.

    Returns (results, final_capacities): results[i] = (counts, out_keys,
    *out_cols) for side i in partition_exchange's bucket layout.
    """
    _check_partition(partition)
    sides = [(put_sharded(k, mesh, axis),
              tuple(put_sharded(c, mesh, axis) for c in cols))
             for k, cols in sides]
    keys = [k for k, _ in sides]
    caps = list(capacities)
    if splitter_side is None:
        splitter_side = max(range(len(sides)), key=lambda i: keys[i].shape[0])
    mode = partition
    attempt = 0
    resampled = False
    plan_v = 0
    pids = None
    cache: dict = {}  # side -> (plan_v, cap, result, drop)
    while True:
        if pids is None:
            pids = _pids(mode, keys, mesh, splitter_side, samples_per_chip,
                         axis)
        results, drops = [], []
        for i, ((k, cols), pid) in enumerate(zip(sides, pids)):
            hit = cache.get(i)
            if hit is not None and hit[0] == plan_v and hit[1] == caps[i]:
                res, drop = hit[2], hit[3]
            else:
                counts, dropped, *outs = partition_exchange(
                    k, pid, mesh, capacity=caps[i], axis=axis,
                    extra_cols=cols)
                res = (counts, *outs)
                drop = replicated_sum_int(dropped, mesh)
                cache[i] = (plan_v, caps[i], res, drop)
            results.append(res)
            drops.append(drop)
        if not any(drops):
            return results, tuple(caps)
        if attempt >= max_replan:
            raise RuntimeError(
                f"{op_name}: shuffle overflow persists after {attempt} "
                f"re-plans (dropped rows per side: {drops}, capacities "
                f"{caps}); raise the capacity bounds")
        attempt += 1
        if mode == "hash":
            mode = "range"  # skew-aware: balance row counts, not key space
            plan_v += 1
            pids = None
        elif not resampled:
            samples_per_chip *= 4
            resampled = True
            plan_v += 1
            pids = None
        else:  # plan fixed: only the overflowing sides re-shuffle
            caps = [c * 2 if d else c for c, d in zip(caps, drops)]


def keyed_exchange_once(sides, mesh: Mesh, *, capacities,
                        axis: str = DATA_AXIS, partition: str = "hash",
                        samples_per_chip: int = 256,
                        splitter_side: int | None = None):
    """One keyed partition exchange under a fixed plan, with no host read.

    The steady-state sibling of keyed_exchange_replan: the dropped counters
    stay on the devices for the caller to check when it chooses.

    Returns (results, dropped): results[i] = (counts, out_keys, *out_cols)
    in partition_exchange's bucket layout; dropped[i] is side i's Sharded
    per-position drop count (all zeros: the exchange was exact).
    """
    _check_partition(partition)
    sides = [(put_sharded(k, mesh, axis), cols) for k, cols in sides]
    keys = [k for k, _ in sides]
    if splitter_side is None:
        splitter_side = max(range(len(sides)), key=lambda i: keys[i].shape[0])
    pids = _pids(partition, keys, mesh, splitter_side, samples_per_chip, axis)
    results, drops = [], []
    for (k, cols), pid, cap in zip(sides, pids, capacities):
        counts, dropped, *outs = partition_exchange(
            k, pid, mesh, capacity=cap, axis=axis, extra_cols=cols)
        results.append((counts, *outs))
        drops.append(dropped)
    return results, tuple(drops)


def plan_splitters(keys, mesh: Mesh, *, samples_per_chip: int = 256,
                   axis: str = DATA_AXIS) -> Sharded:
    """positions - 1 equal-frequency splitters from a strided sample.

    Returns a replicated Sharded of (positions - 1,) keys: partition p
    takes the keys in (splitter[p-1], splitter[p]].
    """
    n_chips = mesh.shape[axis]
    ks = put_sharded(keys, mesh, axis)

    def sample(me, k):
        m = k.numel()
        stride = max(m // samples_per_chip, 1)
        idx = (torch.arange(samples_per_chip, device=k.device) * stride) % m
        return _sorted(interop.take(k, idx))

    def pick(me, allsamp):
        allsamp = _sorted(allsamp)
        total = allsamp.numel()
        at = torch.arange(1, n_chips, device=allsamp.device) * total \
            // n_chips
        return interop.take(allsamp, at)

    gathered = mesh.all_gather(mesh.map(sample, ks))
    return Sharded(mesh, mesh.map(pick, gathered), replicated(mesh))


def range_partition_exchange(data, splitters, mesh: Mesh, *, capacity: int,
                             axis: str = DATA_AXIS, extra_cols=()):
    """Route rows by range: part_id = searchsorted(splitters, key).

    `splitters` is plan_splitters' output, or the same keys as a host
    array or tensor. Same return convention as partition_exchange.
    """
    ds = put_sharded(data, mesh, axis)
    pid = Sharded(mesh, mesh.map(lambda me, s, k: _range_ids(s, k),
                                 _replicate(splitters, mesh), ds))
    return partition_exchange(ds, pid, mesh, capacity=capacity, axis=axis,
                              extra_cols=extra_cols)


def dist_sort_sample(x, mesh: Mesh, *, capacity_factor: float = 2.0,
                     samples_per_chip: int = 256, axis: str = DATA_AXIS,
                     max_resample: int = 2):
    """Sample sort across the mesh: splitters -> range exchange -> local sort.

    The alternative to the hypercube dist_sort: one all_to_all instead of
    log^2(P) ppermute rounds.

    Returns (totals, sorted_buf, dropped), each a Sharded: position c holds
    totals[c] valid rows sorted ascending at the front of its
    (positions * capacity) slots of sorted_buf (entries past totals[c] are
    unspecified), and all of position c's keys precede position c+1's.
    capacity_factor sizes the per-bucket headroom over the uniform share.
    When rows drop, the splitters are planned again from 4x the samples,
    up to `max_resample` times, before rows are let drop: check `dropped`.
    (A single key heavier than a bucket cannot be split by sampling; raise
    capacity_factor for those.)
    """
    n_chips = mesh.shape[axis]
    xs = put_sharded(x, mesh, axis)
    shard_len = xs.shape[0] // n_chips
    capacity = int(capacity_factor * shard_len / n_chips) + 1
    attempt = 0
    while True:
        splitters = plan_splitters(xs, mesh,
                                   samples_per_chip=samples_per_chip,
                                   axis=axis)
        counts, dropped, buf = range_partition_exchange(
            xs, splitters, mesh, capacity=capacity, axis=axis)
        if attempt >= max_resample:
            break
        if replicated_sum_int(dropped, mesh) == 0:
            break
        samples_per_chip *= 4  # adaptive re-sample on overflow
        attempt += 1

    def local(me, c, b):
        valid = valid_slots(c, capacity)
        bits = interop.signed_view(b)
        # the valid rows sorted, then the empty slots: validity is the
        # primary key (no key-space sentinel), for any key dtype
        rows = _sorted(bits[valid].view(b.dtype))
        out = torch.cat([interop.signed_view(rows), bits[~valid]])
        return out.view(b.dtype), c.sum(dtype=torch.int32).reshape(1)

    per = mesh.map(local, counts, buf)
    return (Sharded(mesh, [p[1] for p in per]),
            Sharded(mesh, [p[0] for p in per]), dropped)
