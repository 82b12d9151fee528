"""Distributed partition exchange: the all_to_all radix shuffle.

Counterpart of `cl_ops_tpu/parallel/shuffle.py`. Each position:
  1. stable-sorts its rows by target partition id;
  2. ranks every row within its partition;
  3. places rows into fixed-capacity per-partition buckets (rows past
     `capacity` go to one spare slot that is cut off, and are counted);
  4. `mesh.all_to_all` hands bucket d of every position to position d.

Deterministic: bucket order is fixed by mesh position and the stable sort
keeps source order within a bucket, so every output buffer, empty slots
(zeros) included, equals the JAX package's bit for bit.
"""

from __future__ import annotations

import torch

from cl_ops_tpu_torch.interop import signed_view
from cl_ops_tpu_torch.parallel.mesh import (DATA_AXIS, Mesh, Sharded,
                                            put_sharded)


def partition_exchange(data, part_id, mesh: Mesh, *, capacity: int,
                       axis: str = DATA_AXIS, extra_cols=()):
    """Route rows to the position owning their partition.

    Args:
      data: 1-D rows (a Sharded, or anything put_sharded takes; the length
        divides evenly over the mesh).
      part_id: each row's target partition, an integer in [0, positions).
      capacity: the most rows any (source -> destination) bucket carries;
        rows beyond it are dropped and counted.
      extra_cols: more columns of the same rows, routed along.

    Returns (counts, dropped, out_data, *out_cols), each a Sharded: a
    position's `counts` (int32, one per source) are the valid rows it
    received from each source, `dropped` (int32, one) the rows it could
    not send; its `out_*` hold (positions * capacity) slots, the rows from
    source s at [s*capacity, s*capacity + counts[s]) and zeros after them.
    """
    n_chips = mesh.shape[axis]
    n = data.shape[0]
    if n % n_chips:
        raise ValueError(f"length {n} not divisible by {n_chips} chips")
    pids = put_sharded(part_id, mesh, axis)
    cols = [put_sharded(c, mesh, axis) for c in (data, *extra_cols)]
    slots = n_chips * capacity

    def local(me, pid, *cs):
        pid = pid.to(torch.int32)
        order = torch.sort(pid, stable=True).indices
        spid = pid[order].to(torch.int64)
        counts_all = torch.bincount(pid, minlength=n_chips)[:n_chips]
        part_start = torch.cumsum(counts_all, 0) - counts_all
        rank = torch.arange(pid.numel(), device=pid.device) \
            - part_start[spid]
        # rows past capacity land in the spare last slot, cut off below
        dest = torch.where(rank < capacity, spid * capacity + rank, slots)
        sent = counts_all.clamp(max=capacity)
        dropped = (counts_all - sent).sum().to(torch.int32).reshape(1)
        bufs = []
        for c in cs:
            sc = signed_view(c)[order]
            buf = torch.zeros(slots + 1, dtype=sc.dtype, device=sc.device)
            buf.index_copy_(0, dest, sc)
            bufs.append(buf[:slots].view(n_chips, capacity))
        return sent.to(torch.int32).view(n_chips, 1), dropped, bufs

    per = mesh.map(local, pids, *cols)
    counts = mesh.all_to_all([p[0] for p in per])
    outs = [Sharded(mesh, [t.view(c.dtype) for t in mesh.all_to_all(
                [p[2][i] for p in per])])
            for i, c in enumerate(cols)]
    return (Sharded(mesh, counts), Sharded(mesh, [p[1] for p in per]), *outs)


def valid_slots(counts: torch.Tensor, capacity: int) -> torch.Tensor:
    """The filled slots of a position's exchange buffer, as a bool mask:
    source s's rows fill [s * capacity, s * capacity + counts[s])."""
    slot = torch.arange(capacity, device=counts.device)
    return (slot[None, :] < counts.view(-1, 1)).reshape(-1)
