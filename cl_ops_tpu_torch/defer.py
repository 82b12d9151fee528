"""Exactness witnesses for the deferred (serving-form) operators.

Counterpart of `cl_ops_tpu/defer.py`. The serving forms —
`hash_join(defer_overflow=True)` and `rollup_query(defer=True)` — skip the
per-call host read of the band-overflow flag and return it as a trailing
witness on the device instead: the result is exact iff every witness is
zero or False. `verify_deferred` checks them in one call. It reads the
witnesses on the host, so keep it out of the steady-state serving loop:
verify once per plan, after a shift in the data's distribution, or on a
sampled cadence.
"""

from __future__ import annotations

import numpy as np
import torch

from cl_ops_tpu_torch import interop
from cl_ops_tpu_torch.core.errors import CloOpsError, ErrorCode


class DeferredOverflowError(CloOpsError):
    """A deferred serving-form result is NOT exact (witnesses fired)."""

    def __init__(self, message: str):
        super().__init__(message, ErrorCode.OUT_OF_RESOURCES)


def _host(w) -> np.ndarray:
    if isinstance(w, torch.Tensor):
        return interop.to_numpy(w)
    return np.asarray(w)


def verify_deferred(*witnesses, op_name: str = "deferred op") -> None:
    """Raise unless a serving-form result is exact (all witnesses clear).

    Args:
      *witnesses: any mix of the trailing outputs the deferred forms
        return — dropped-row counters (integers, zero means no loss),
        overflow flags (bools, False means no overflow), tensors or numpy
        arrays or scalars of those, or tuples/lists of them (pass `out[-1]`
        directly).
      op_name: label for the error message.

    Raises:
      DeferredOverflowError naming the first witness that fired, with the
      dropped-row total or the count of set flags; the caller should re-run
      on the exact path (for the join, probe_impl="merge").
      ValueError when no witness is given.
    """
    flat: list = []

    def _flatten(w):
        if isinstance(w, (tuple, list)):
            for x in w:
                _flatten(x)
        else:
            flat.append(w)

    _flatten(witnesses)
    if not flat:
        raise ValueError("verify_deferred needs at least one witness")
    for i, w in enumerate(flat):
        a = _host(w)
        if a.dtype == np.bool_:
            fired = int(a.sum())
            if fired:
                raise DeferredOverflowError(
                    f"{op_name}: overflow flag witness #{i} fired on "
                    f"{fired} entr{'y' if fired == 1 else 'ies'} — the "
                    "deferred result is not exact; re-run on the exact "
                    "path")
        else:
            dropped = int(a.sum())
            if dropped:
                raise DeferredOverflowError(
                    f"{op_name}: dropped-row witness #{i} reports "
                    f"{dropped} dropped rows — the deferred result is not "
                    "exact; re-run on the exact path")
