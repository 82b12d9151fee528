"""Sort abstraction: named impls, key specialization, host/device entry.

Counterpart of `cl_ops_tpu/ops/sort/abstract.py` (the reference's
`clo_sort_abstract.c:91-418`). Keys are normalized to order-preserving int32
limbs (keys.py); an impl sorts limb columns plus an optional int32 payload.
4-byte values ride as that payload; otherwise (a key_fn, or 8/2/1-byte
values) the payload is the row index and the elements and values are
gathered by it. Descending order sorts complemented limbs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from cl_ops_tpu_torch import interop
from cl_ops_tpu_torch.core.dtypes import canonicalize, type_info
from cl_ops_tpu_torch.core.errors import BadArgsError
from cl_ops_tpu_torch.core.registry import Registry, parse_options
from cl_ops_tpu_torch.ops.sort import keys as keymod


@dataclasses.dataclass(frozen=True)
class SortSpec:
    """Static specialization of one sorter object."""

    elem_dtype: torch.dtype
    key_dtype: torch.dtype
    ascending: bool
    has_key_fn: bool  # True when a custom key extractor is used


@dataclasses.dataclass(frozen=True)
class SortImplDef:
    """Vtable analog of CloSortImplDef (clo_sort_abstract.in.h:43-110).

    make_limb_sorter(spec, options) returns
      fn(limbs: tuple[int32 tensor, ...], payload: int32 tensor | None)
        -> (sorted_limbs, sorted_payload)
    smem_usage(kernel_name, numel, options, n_arrays) -> bytes of dynamic
    shared memory per block.
    """

    name: str
    in_place: bool
    make_limb_sorter: Callable[..., Callable]
    kernel_names: tuple[str, ...]
    smem_usage: Callable[[str, int, dict, int], int]


sort_impls: Registry[SortImplDef] = Registry("sort")


class Sorter:
    """A specialized sorter (analog of `struct clo_sort`)."""

    def __init__(self, impl: SortImplDef, spec: SortSpec,
                 key_fn: Optional[Callable], options: dict[str, str]):
        self._impl = impl
        self.spec = spec
        self._key_fn = key_fn
        self._options = options
        self._limb_sorter = impl.make_limb_sorter(spec, options)

    # -- introspection (parity: clo_sort_abstract.in.h:147-170) --------------
    @property
    def name(self) -> str:
        return self._impl.name

    @property
    def in_place(self) -> bool:
        return self._impl.in_place

    @property
    def elem_dtype(self) -> torch.dtype:
        return self.spec.elem_dtype

    @property
    def key_dtype(self) -> torch.dtype:
        return self.spec.key_dtype

    @property
    def num_kernels(self) -> int:
        return len(self._impl.kernel_names)

    def kernel_name(self, i: int) -> str:
        return self._impl.kernel_names[i]

    def smem_usage(self, kernel_name: str, numel: int) -> int:
        return self._impl.smem_usage(kernel_name, numel, self._options,
                                     keymod.num_limbs(self.spec.key_dtype))

    # -- entry points --------------------------------------------------------
    def sort_with_device_data(self, data: torch.Tensor, values=None):
        """Sort a tensor where it lies, optionally carrying a values tensor.

        Returns sorted data, or (sorted data, reordered values).
        """
        if data.dim() != 1:
            raise BadArgsError(f"sort expects 1-D input, got {tuple(data.shape)}")
        if data.dtype != self.spec.elem_dtype:
            raise BadArgsError(
                f"input dtype {data.dtype} != specialized elem dtype "
                f"{self.spec.elem_dtype}")
        if values is not None and (values.dim() != 1
                                   or values.shape[0] != data.shape[0]
                                   or values.device != data.device):
            raise BadArgsError("values must be 1-D, of the data's length, "
                               "on the data's device")
        raw_keys = self._key_fn(data) if self._key_fn is not None else data
        if raw_keys.dtype != self.spec.key_dtype:
            raise BadArgsError(f"key_fn produced dtype {raw_keys.dtype}, "
                               f"expected {self.spec.key_dtype}")
        limbs = keymod.to_limbs(raw_keys)
        if not self.spec.ascending:
            limbs = [~l for l in limbs]  # complement reverses the order

        def restore_keys(sorted_limbs):
            if not self.spec.ascending:
                sorted_limbs = [~l for l in sorted_limbs]
            return keymod.from_limbs(list(sorted_limbs),
                                     self.spec.elem_dtype)

        if values is None and self._key_fn is None and len(limbs) == 1:
            sorted_limbs, _ = self._limb_sorter(tuple(limbs), None)
            return restore_keys(sorted_limbs)

        # 4-byte values with the identity key ride the sort as the payload.
        if (values is not None and self._key_fn is None
                and values.dtype.itemsize == 4):
            sorted_limbs, spay = self._limb_sorter(
                tuple(limbs), values.view(torch.int32))
            return restore_keys(sorted_limbs), spay.view(values.dtype)

        n = data.shape[0]
        payload = torch.arange(n, dtype=torch.int32, device=data.device)
        _, perm = self._limb_sorter(tuple(limbs), payload)
        perm = perm.to(torch.int64)
        out = interop.take(data, perm)
        if values is None:
            return out
        return out, interop.take(values, perm)

    def sort_with_host_data(self, data, values=None, device=None):
        """Host round trip: numpy in, sort on `device` (None = "cuda"),
        numpy out (parity: clo_sort_with_host_data)."""
        np_dt = type_info(self.spec.elem_dtype).np_dtype or np.uint16
        dev = interop.to_torch(np.asarray(data, np_dt), device,
                               self.spec.elem_dtype)
        if values is None:
            return interop.to_numpy(self.sort_with_device_data(dev))
        out, vout = self.sort_with_device_data(
            dev, interop.to_torch(np.asarray(values), device))
        return interop.to_numpy(out), interop.to_numpy(vout)

    __call__ = sort_with_device_data


def sort_new(name: str = "satradix",
             options: str | dict[str, Any] | None = None,
             elem_dtype="uint", key_dtype=None,
             key_fn: Optional[Callable] = None,
             ascending: bool = True) -> Sorter:
    """Create a sorter by name (parity: clo_sort_new, clo_sort_abstract.c:91).

    Args:
      name: an impl of sort_names(): "sbitonic" | "abitonic" | "gselect" |
        "satradix" (the default, as in the JAX package) | "xla".
      options: reference-style option string/dict (e.g. "radix=16" for
        satradix, "block_elems=1024,single_launch=1" for abitonic).
      elem_dtype: element type of the array being sorted.
      key_dtype: ordering key type; defaults to elem_dtype.
      key_fn: tensor function elem -> key (CLO_SORT_KEY_GET analog).
      ascending: sort direction.
    """
    impl = sort_impls.get(name)()
    ed = canonicalize(elem_dtype)
    kd = canonicalize(key_dtype) if key_dtype is not None else ed
    if key_fn is None and kd != ed:
        raise BadArgsError("key_dtype differs from elem_dtype but no key_fn")
    spec = SortSpec(elem_dtype=ed, key_dtype=kd, ascending=ascending,
                    has_key_fn=key_fn is not None)
    return Sorter(impl, spec, key_fn, parse_options(options))


def sort_names() -> list[str]:
    return sort_impls.names()
