"""Multi-process execution: one mesh over several processes.

Counterpart of `cl_ops_tpu/parallel/multiproc.py`. The JAX package wires
its processes together with `jax.distributed` and lets XLA's collectives
cross the process boundary. Here `init_process` joins a
`torch.distributed` group over gloo, and `global_mesh` returns a
`ProcessMesh`: a `Mesh` whose positions are every process's devices, in
rank order, of which this process holds its own. Only the mesh's four
collective methods change; every `parallel/` operator runs on it
unchanged, each process driving its own positions (SPMD: every process
calls the same operators in the same order).

Transport: gloo moves host tensors only (it takes no CUDA tensor for an
all-to-all), and NCCL refuses two ranks on one card. So a shard on the
card that crosses to another process is staged through host memory for
the collective and copied back to its position's device before any
computation; pairs of positions within one process copy directly.

Simulation recipe (tests/test_torch_multiproc.py): start N python
processes, call `init_process(rank, N, coordinator)` in each, build the
mesh with `global_mesh(devices=[...])` and the inputs with
`from_process_local`, and read results with `local_rows`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from cl_ops_tpu_torch import interop
from cl_ops_tpu_torch.core.errors import BadArgsError, CloOpsError, ErrorCode
from cl_ops_tpu_torch.parallel.mesh import (DATA_AXIS, Mesh, Sharded, _cat,
                                            row_sharding)
from cl_ops_tpu_torch.utils import intmath


def init_process(process_id: int, num_processes: int,
                 coordinator: str = "localhost:12655") -> None:
    """Join this process into the group of `num_processes` processes whose
    rendezvous is `coordinator` ("host:port"). Call it before global_mesh.
    """
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def _host_bytes(t: torch.Tensor) -> torch.Tensor:
    """t's bytes as a 1-D uint8 host tensor."""
    return t.detach().contiguous().cpu().reshape(-1).view(torch.uint8)


class ProcessMesh(Mesh):
    """A mesh whose positions span the processes of the default
    torch.distributed group: process r holds positions [r * L, (r + 1) * L)
    on its L devices, every process the same number."""

    def __init__(self, devices, axis: str = DATA_AXIS):
        super().__init__(devices, axis)
        if not dist.is_initialized():
            raise CloOpsError("global_mesh: call init_process first",
                              ErrorCode.SHARDING)
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        per = len(self.devices)
        counts = [torch.zeros(1, dtype=torch.int64)
                  for _ in range(self.world)]
        dist.all_gather(counts, torch.tensor([per], dtype=torch.int64))
        if any(int(c) != per for c in counts):
            raise BadArgsError(f"processes hold {[int(c) for c in counts]} "
                               "positions; every process must hold the "
                               "same number")
        self.per = per
        self.positions = tuple(range(self.rank * per, (self.rank + 1) * per))
        self._size = per * self.world

    def _key(self):
        return super()._key() + (self.rank, self.world)

    def _rank_of(self, position: int) -> int:
        return position // self.per

    def _exchange(self, parcels, like: torch.Tensor):
        """parcels[r]: tensors for process r (empty for this process), each
        with `like`'s dtype and trailing shape. Returns recv[r]: the host
        tensors process r sent to this one, in the order it listed them.

        Two gloo all-to-alls: the row counts (a fixed header of per * per
        entries a pair, -1 where unused), then the bytes."""
        width = self.per * self.per
        head = torch.full((self.world, width), -1, dtype=torch.int64)
        for r, ts in enumerate(parcels):
            for j, t in enumerate(ts):
                head[r, j] = t.shape[0]
        got = torch.empty_like(head)
        dist.all_to_all_single(got.view(-1), head.view(-1))
        trail = tuple(like.shape[1:])
        row_bytes = like.element_size() * int(np.prod(trail, dtype=np.int64))
        send = [_host_bytes(t) for ts in parcels for t in ts]
        send = torch.cat(send) if send else torch.empty(0, dtype=torch.uint8)
        in_split = [int(sum(t.shape[0] for t in ts)) * row_bytes
                    for ts in parcels]
        rows = got.clamp(min=0)
        out_split = [int(r.sum()) * row_bytes for r in rows]
        buf = torch.empty(sum(out_split), dtype=torch.uint8)
        dist.all_to_all_single(buf, send, output_split_sizes=out_split,
                               input_split_sizes=in_split)
        recv, off = [], 0
        for r in range(self.world):
            ts = []
            for n_rows in got[r].tolist():
                if n_rows < 0:
                    continue
                nb = n_rows * row_bytes
                ts.append(buf[off:off + nb].clone().view(like.dtype)
                          .reshape((n_rows,) + trail))
                off += nb
            recv.append(ts)
        return recv

    def all_gather(self, per_shard) -> list[torch.Tensor]:
        """Every position receives the concatenation, in mesh order, of
        every position's tensor."""
        recv = self._exchange([[] if r == self.rank else list(per_shard)
                               for r in range(self.world)], per_shard[0])
        recv[self.rank] = list(per_shard)
        parts = [t for ts in recv for t in ts]
        return [_cat([t.to(dev) for t in parts]) for dev in self.devices]

    def all_to_all(self, per_shard) -> list[torch.Tensor]:
        """per_shard[i] holds one bucket per global position (a tensor with
        a leading dim of mesh.size, or a list); position d receives bucket
        d of every source, concatenated in source order."""
        per = self.per
        parcels = [[] if r == self.rank else
                   [b[d] for b in per_shard
                    for d in range(r * per, (r + 1) * per)]
                   for r in range(self.world)]
        recv = self._exchange(parcels, per_shard[0][0])
        out = []
        for i, (d, dev) in enumerate(zip(self.positions, self.devices)):
            parts = []
            for s in range(self.size):
                r, sl = self._rank_of(s), s % per
                parts.append(per_shard[sl][d] if r == self.rank
                             else recv[r][sl * per + i])
            out.append(_cat([t.to(dev) for t in parts]))
        return out

    def ppermute(self, per_shard, perm) -> list[torch.Tensor]:
        """For each (src, dst) pair of `perm` (global positions, the same
        list on every process), position dst receives a copy of position
        src's tensor; a position that receives nothing gets zeros shaped
        like its own tensor."""
        perm = list(perm)
        mine = set(self.positions)
        parcels = [[] for _ in range(self.world)]
        for src, dst in perm:
            r = self._rank_of(dst)
            if src in mine and r != self.rank:
                parcels[r].append(per_shard[src - self.positions[0]])
        recv = self._exchange(parcels, per_shard[0])
        taken = [0] * self.world
        out = [None] * self.per
        for src, dst in perm:
            r = self._rank_of(src)
            if dst not in mine:
                continue
            i = dst - self.positions[0]
            if r == self.rank:
                t = per_shard[src - self.positions[0]]
            else:
                t = recv[r][taken[r]]
                taken[r] += 1
            out[i] = t.to(self.devices[i], copy=True)
        return [torch.zeros_like(per_shard[i]) if t is None else t
                for i, t in enumerate(out)]

    def sum_to_host(self, per_shard) -> int:
        """The host int of the sum of every position's integer tensor: the
        local sums, all-reduced."""
        total = torch.tensor([sum(int(intmath.to_i64(t).sum())
                                  for t in per_shard)], dtype=torch.int64)
        dist.all_reduce(total)
        return int(total)


def global_mesh(axis: str = DATA_AXIS, *, devices=None) -> ProcessMesh:
    """The mesh over every process's positions, this process holding one
    position per entry of `devices` (default: each of its CUDA cards; a
    device may repeat). Raises without CUDA when `devices` is not given."""
    if devices is None:
        if not torch.cuda.is_available():
            raise CloOpsError("global_mesh: torch.cuda is not available; "
                              "pass devices= for positions on the CPU",
                              ErrorCode.DEVICE_NOT_FOUND)
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return ProcessMesh(devices, axis)


def from_process_local(local_rows, mesh: Mesh, *,
                       axis: str = DATA_AXIS) -> Sharded:
    """A row-sharded Sharded from this process's block of rows: process p
    contributes rows [p * L, (p + 1) * L) of the global value (L =
    len(local_rows), equal on every process), split evenly over its
    positions."""
    if not isinstance(local_rows, torch.Tensor):
        local_rows = interop.to_torch(np.asarray(local_rows), device="cpu")
    n = local_rows.shape[0]
    per = len(mesh.devices)
    if n % per:
        raise ValueError(f"{n} rows do not split evenly over {per} "
                         "positions")
    m = n // per
    return Sharded(mesh, [local_rows[i * m:(i + 1) * m].to(dev, copy=True)
                          for i, dev in enumerate(mesh.devices)],
                   row_sharding(mesh, axis))


def local_rows(x: Sharded) -> np.ndarray:
    """This process's rows of a row-sharded Sharded, in position order (a
    replicated one's whole value)."""
    if x.layout.axis is None:
        return interop.to_numpy(x.shards[0])
    return np.concatenate([interop.to_numpy(s) for s in x.shards])
