"""Named-implementation registries.

Python re-expression of the reference's vtable plugin registries:
sort impls selected by string name (`src/cl_ops/sort/clo_sort_abstract.c:110-121`),
scan impls (`src/cl_ops/scan/clo_scan_abstract.c:85-89`), RNG generators
(`src/cl_ops/rng/clo_rng.c:60-68`).

Instead of C structs of function pointers, a registry maps a name to a factory
callable; factories receive parsed option dicts (the analog of the reference's
"opt1=val1,opt2=val2" option strings, e.g. `clo_sort_abitonic.c:486-543`).
"""

from __future__ import annotations

from typing import Any, Callable, Generic, TypeVar

from cl_ops_tpu_torch.core.errors import CloOpsError, ErrorCode

T = TypeVar("T")


class Registry(Generic[T]):
    """A name -> factory registry with decorator-based registration."""

    def __init__(self, kind: str):
        self._kind = kind
        self._impls: dict[str, Callable[..., T]] = {}

    def register(self, name: str) -> Callable[[Callable[..., T]], Callable[..., T]]:
        def deco(factory: Callable[..., T]) -> Callable[..., T]:
            if name in self._impls:
                raise CloOpsError(
                    f"{self._kind} implementation {name!r} already registered",
                    ErrorCode.IMPL_DUPLICATE)
            self._impls[name] = factory
            return factory
        return deco

    def get(self, name: str) -> Callable[..., T]:
        try:
            return self._impls[name]
        except KeyError:
            raise CloOpsError(
                f"unknown {self._kind} implementation {name!r}; "
                f"known: {sorted(self._impls)}",
                ErrorCode.IMPL_NOT_FOUND) from None

    def names(self) -> list[str]:
        return sorted(self._impls)

    def __contains__(self, name: str) -> bool:
        return name in self._impls


def parse_options(options: str | dict[str, Any] | None) -> dict[str, str]:
    """Parse a reference-style option string "k1=v1,k2=v2" into a dict.

    Mirrors the per-impl option parsing of e.g. satradix
    (`clo_sort_satradix.c:353-421`: "radix=16,scan=blelloch,scanopt=...").
    Bare flags (no '=') map to "1". A dict passes through (values stringified).
    """
    if options is None:
        return {}
    if isinstance(options, dict):
        return {str(k): str(v) for k, v in options.items()}
    out: dict[str, str] = {}
    for item in options.split(","):
        item = item.strip()
        if not item:
            continue
        if "=" in item:
            k, v = item.split("=", 1)
            out[k.strip()] = v.strip()
        else:
            out[item] = "1"
    return out
