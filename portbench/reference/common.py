"""Plain PyTorch building blocks of the references. They use neither the
port nor anything it made: only the generated tables.

`exact=False` is the control: every decimal column is carried, summed and
ordered in float32, the nearest precision below the int64 cents that the
configurations state.
"""

import torch


def dec(exact: bool) -> torch.dtype:
    return torch.int64 if exact else torch.float32


def as_int(x: torch.Tensor) -> torch.Tensor:
    """A decimal result in the configurations' int64 units."""
    return x if x.dtype == torch.int64 else torch.round(x.double()).long()


def lookup(keys: torch.Tensor, probes: torch.Tensor):
    """(found, row) of each probe among unique `keys`: row indexes `keys`."""
    if keys.numel() == 0:
        return (torch.zeros_like(probes, dtype=torch.bool),
                torch.zeros_like(probes, dtype=torch.int64))
    skeys, order = torch.sort(keys)
    pos = torch.searchsorted(skeys, probes).clamp(max=skeys.numel() - 1)
    return skeys[pos] == probes, order[pos]


def group_sum(keys: torch.Tensor, values, dtype):
    """(distinct keys ascending, [sum of each value column], row counts)."""
    uniq, inv = torch.unique(keys, return_inverse=True)
    sums = [torch.zeros(uniq.numel(), dtype=dtype, device=keys.device)
            .index_add_(0, inv, v.to(dtype)) for v in values]
    return uniq, sums, torch.bincount(inv, minlength=uniq.numel())
