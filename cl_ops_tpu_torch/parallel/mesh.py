"""The mesh of the distributed layer: shards, layouts and collectives.

Counterpart of `cl_ops_tpu/parallel/mesh.py`. The JAX package drives a 1-D
mesh of devices from one process and moves data between them with XLA
collectives inside `shard_map`. Here a `Mesh` is a tuple of torch devices,
one per position of its single axis, and a `Sharded` holds one tensor per
position: the counterpart of a row-sharded (or replicated) `jax.Array`.

Every movement of data between positions goes through the mesh's four
collective methods (`all_gather`, `all_to_all`, `ppermute`, `sum_to_host`),
so a mesh across processes (`multiproc.ProcessMesh`) changes only those
methods. Each of them COPIES into the receiving position's memory, also
when sender and receiver share a device: the bitonic kernels sort in place,
and a received shard that shared storage with its sender would be
overwritten by the sender's next merge.

A process holds some of the mesh's positions (`Mesh.positions`; all of
them on the in-process mesh): `Mesh.devices`, `Sharded.shards`, `Mesh.map`
and the collectives' lists have one entry per position of this process, in
position order, while `Mesh.map` passes each entry's global position `me`.

A device may repeat. `make_mesh(devices=["cpu"] * 8)` gives eight shards on
the CPU (the tests' mesh), `make_mesh(devices=["cuda:0"] * 4)` four shards
of one card, whose exchanges are then copies within the card's memory.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from cl_ops_tpu_torch import interop
from cl_ops_tpu_torch.core.dtypes import canonicalize
from cl_ops_tpu_torch.core.errors import BadArgsError, CloOpsError, ErrorCode
from cl_ops_tpu_torch.utils import intmath
from cl_ops_tpu_torch.utils.platform import default_device

DATA_AXIS = "data"


def _device_scope(device: torch.device):
    """Make `device` current for the kernels' launches (a CUDA device), or
    do nothing (the CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class Mesh:
    """A 1-D mesh: one torch device per position of the axis `axis`, every
    position held by this process."""

    def __init__(self, devices, axis: str = DATA_AXIS):
        self.devices = tuple(_indexed(default_device(d)) for d in devices)
        if not self.devices:
            raise BadArgsError("a mesh needs at least one device")
        self.axis = axis
        # the global positions this process holds, one per device
        self.positions = tuple(range(len(self.devices)))
        self._size = len(self.devices)

    @property
    def size(self) -> int:
        """Positions of the whole mesh, over every process."""
        return self._size

    @property
    def whole(self) -> bool:
        """True when this process holds every position."""
        return len(self.positions) == self._size

    @property
    def shape(self) -> dict[str, int]:
        """{axis: positions}, as `jax.sharding.Mesh.shape`."""
        return {self.axis: self.size}

    def _key(self):
        return (type(self), self.devices, self.axis, self.positions,
                self._size)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, axis={self.axis!r})"

    def map(self, fn, *args) -> list:
        """[fn(me, *(a[i] for a in args)) for each position me of this
        process, i its index among them], each with its position's device
        current: `shard_map`'s local function. Each of `args` is a Sharded
        or a list with one entry per position of this process."""
        per = [a.shards if isinstance(a, Sharded) else a for a in args]
        out = []
        for i, (me, dev) in enumerate(zip(self.positions, self.devices)):
            with _device_scope(dev):
                out.append(fn(me, *(p[i] for p in per)))
        return out

    # --- collectives: each copies into the receiver's memory ----------------

    def all_gather(self, per_shard) -> list[torch.Tensor]:
        """Every position receives the concatenation (along dim 0, in mesh
        order) of every position's tensor."""
        return [_cat([t.to(dev) for t in per_shard]) for dev in self.devices]

    def all_to_all(self, per_shard) -> list[torch.Tensor]:
        """`jax.lax.all_to_all(..., tiled=False)`: per_shard[s] holds one
        bucket per position (a tensor with a leading dim of mesh.size, or a
        list; list buckets may differ in length); position d receives
        bucket d of every source, concatenated along dim 0 in source
        order."""
        return [_cat([buckets[d].to(dev) for buckets in per_shard])
                for d, dev in enumerate(self.devices)]

    def ppermute(self, per_shard, perm) -> list[torch.Tensor]:
        """`jax.lax.ppermute`: for each (src, dst) pair of `perm`, position
        dst receives a copy of position src's tensor; a position that
        receives nothing gets zeros shaped like its own tensor."""
        out = [None] * self.size
        for src, dst in perm:
            out[dst] = per_shard[src].to(self.devices[dst], copy=True)
        return [torch.zeros_like(per_shard[i]) if t is None else t
                for i, t in enumerate(out)]

    def sum_to_host(self, per_shard) -> int:
        """The host int of the sum of every position's integer tensor (a
        host read of each)."""
        return sum(int(intmath.to_i64(t).sum()) for t in per_shard)


def _indexed(device: torch.device) -> torch.device:
    """"cuda" as the card it means ("cuda:<current>"), as tensors report it."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _cat(parts) -> torch.Tensor:
    """torch.cat into new memory (also of one part), for any dtype (this
    CPU build concatenates unsigned tensors through their signed views)."""
    dt = parts[0].dtype
    return torch.cat([interop.signed_view(p) for p in parts]).view(dt)


@dataclass(frozen=True)
class Layout:
    """How a Sharded lies on its mesh: rows split over `axis`, or every
    position holding the whole value (axis None). The counterpart of a
    `NamedSharding` with `P(axis)` or `P()`."""
    mesh: Mesh
    axis: str | None


def row_sharding(mesh: Mesh, axis: str = DATA_AXIS) -> Layout:
    """Rows partitioned over the mesh axis."""
    return Layout(mesh, axis)


def replicated(mesh: Mesh) -> Layout:
    """The same value at every position."""
    return Layout(mesh, None)


class Sharded:
    """One tensor per mesh position, what every `dist_*` function takes and
    returns. Row-sharded by default: the global tensor is the shards'
    concatenation in mesh order. Replicated (`layout=replicated(mesh)`):
    every shard holds the whole value."""

    def __init__(self, mesh: Mesh, shards, layout: Layout | None = None):
        shards = tuple(shards)
        if len(shards) != len(mesh.devices):
            raise BadArgsError(f"{len(shards)} shards for the "
                               f"{len(mesh.devices)} positions of this "
                               "process")
        for s, dev in zip(shards, mesh.devices):
            if s.device != dev:
                raise BadArgsError(f"shard on {s.device}, its position on "
                                   f"{dev}")
        self.mesh = mesh
        self.shards = shards
        self.layout = layout or row_sharding(mesh, mesh.axis)

    @property
    def devices(self) -> tuple[torch.device, ...]:
        return tuple(s.device for s in self.shards)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def shape(self) -> tuple[int, ...]:
        """The global shape. On a mesh across processes the rows split
        evenly, as every operator of the layer splits them."""
        first = tuple(self.shards[0].shape)
        if self.layout.axis is None:
            return first
        if not self.mesh.whole:
            return (first[0] * self.mesh.size,) + first[1:]
        return (sum(s.shape[0] for s in self.shards),) + first[1:]

    def _check_whole(self) -> None:
        if self.layout.axis is not None and not self.mesh.whole:
            raise BadArgsError("this process holds only some rows of a "
                               "mesh across processes; read them with "
                               "multiproc.local_rows")

    def cat(self) -> torch.Tensor:
        """The global tensor (in mesh order), on the first shard's device."""
        self._check_whole()
        if self.layout.axis is None:
            return self.shards[0]
        dev = self.shards[0].device
        return _cat([s.to(dev) for s in self.shards])

    def numpy(self) -> np.ndarray:
        """The global value as a host numpy array, bit for bit."""
        self._check_whole()
        if self.layout.axis is None:
            return interop.to_numpy(self.shards[0])
        return np.concatenate([interop.to_numpy(s) for s in self.shards])

    def __repr__(self) -> str:
        return (f"Sharded({self.dtype}, shape={self.shape}, "
                f"mesh={self.mesh!r})")


def make_mesh(n_devices: int | None = None, axis: str = DATA_AXIS, *,
              devices=None) -> Mesh:
    """A 1-D mesh over the first `n_devices` CUDA cards (default: all).

    Raises CloOpsError when CUDA is absent or has fewer cards than asked
    for: it never falls back to the CPU or repeats a card by itself. An
    explicit `devices=` list (its first `n_devices` when given) may name
    the CPU and may repeat a device, giving several shards on one device.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise CloOpsError("make_mesh: torch.cuda is not available; pass "
                              "devices= for a mesh on the CPU",
                              ErrorCode.DEVICE_NOT_FOUND)
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if not 1 <= n <= count:
            raise CloOpsError(f"make_mesh: {n} cards asked for, {count} "
                              "present", ErrorCode.DEVICE_NOT_FOUND)
        devices = [f"cuda:{i}" for i in range(n)]
    elif n_devices is not None:
        devices = list(devices)[:n_devices]
    return Mesh(devices, axis)


def put_sharded(a, mesh: Mesh, axis: str = DATA_AXIS) -> Sharded:
    """Split rows evenly over the mesh, copying each of this process's
    shards onto its position's device. A Sharded already laid out that way
    passes through untouched; a numpy array, a tensor, or a Sharded of
    another layout is split from its global value. Raises ValueError when
    the rows do not split evenly."""
    layout = row_sharding(mesh, axis)
    if isinstance(a, Sharded):
        if a.layout == layout:
            return a
        a = a.cat()
    if not isinstance(a, torch.Tensor):
        a = interop.to_torch(np.asarray(a), device="cpu")
    n = a.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split evenly over {mesh.size} "
                         f"positions of axis {axis!r}")
    m = n // mesh.size
    return Sharded(mesh, [a[i * m:(i + 1) * m].to(dev, copy=True)
                          for i, dev in zip(mesh.positions, mesh.devices)],
                   layout)


def iota_sharded(n: int, mesh: Mesh, axis: str = DATA_AXIS,
                 dtype=torch.int32) -> Sharded:
    """arange(n), made directly on each position's device."""
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split evenly over {mesh.size} "
                         "positions")
    m = n // mesh.size
    dt = canonicalize(dtype)
    return Sharded(mesh, [torch.arange(i * m, (i + 1) * m, dtype=dt,
                                       device=dev)
                          for i, dev in zip(mesh.positions, mesh.devices)],
                   row_sharding(mesh, axis))


def replicate(value: torch.Tensor, mesh: Mesh) -> Sharded:
    """The same value at every position: a copy on each position's device."""
    return Sharded(mesh, [value.to(dev, copy=True) for dev in mesh.devices],
                   replicated(mesh))


def replicated_sum_int(x, mesh: Mesh) -> int:
    """Host int of the sum of the integer array x (a Sharded of either
    layout, or anything put_sharded takes)."""
    return mesh.sum_to_host(put_sharded(x, mesh, mesh.axis).shards)
