"""ORDER BY ... LIMIT k (top-k) and SELECT DISTINCT.

Counterpart of `cl_ops_tpu/ops/exec/topk.py`. No kernel of its own: both
compose the bitonic sort (ops/exec/psort.py) and the GROUP BY boundary
reduce, whose kernels are ported.

top_k: a full sort moves every row through O(log^2 n) passes, but LIMIT k
with k << n needs only the k extreme rows. So:

  1. estimate a threshold t from a strided sample (its (oversample*k/n)-th
     quantile): one small torch.sort, as JAX sorts it with lax.sort;
  2. cut the rows into W-wide blocks and pull up to KB survivors (rows
     <= t) per block by argmax-and-clear sweeps over the mask, with no
     n-row sort;
  3. sort only the B*KB candidates by (value, position) and gather the k
     winners' payloads.

The sampled threshold can miss (fewer than k survivors), a block can hold
more than KB survivors (clustered or duplicated values), or k can be too
large for the extraction; then the exact full sort runs instead. JAX picks
the branch with lax.cond; here the one `ok` flag is read on the host, as
the join reads its band flag. Both branches are exact, so the result is
the same either way. The JAX options use_pallas and cap (unused since its
block-extraction rewrite) have no counterpart.
"""

from __future__ import annotations

import torch

from cl_ops_tpu_torch.core.errors import BadArgsError
from cl_ops_tpu_torch.ops.exec import psort
from cl_ops_tpu_torch.ops.exec.aggregate import _boundary_reduce_cols
from cl_ops_tpu_torch.ops.sort import keys as keymod
from cl_ops_tpu_torch.utils.profiling import named, spanned

W, KB = 1024, 4        # extraction block width and survivors per block
_I32_MAX = 0x7FFFFFFF

# The branch the last top_k call took: "small" (the exact sort, chosen
# from the shapes alone), "fast" (threshold extraction) or "exact" (the
# extraction's check failed). Read by chip_smoke.py.
last_branch = None


@spanned("clo.op:topk")
def top_k(values, k: int, *payload_cols, largest: bool = False,
          oversample: int = 4, sample_size: int = 16384):
    """The k extreme rows of `values`, sorted, with payload columns.

    values: 1-D column (any normalizable dtype). k: the LIMIT.
    payload_cols: same-length columns returned alongside. largest: False
    returns the k smallest ascending, True the k largest descending.
    oversample: the threshold quantile's safety factor. sample_size: the
    strided threshold sample's length.

    Returns (top_values, *top_payloads), each of length k. Exact for every
    input; ties break by input position (stable).
    """
    global last_branch
    n = values.shape[0]
    if k <= 0:
        raise BadArgsError(f"k must be positive, got {k}")
    dev = values.device
    kl = keymod.to_limbs(values)
    if largest:
        kl = [~c for c in kl]  # bitwise NOT reverses the order
    enc, spec = psort.cols_to_i32(tuple(payload_cols))

    def from_limb_cols(limb_cols):
        if largest:
            limb_cols = [~c for c in limb_cols]
        return keymod.from_limbs(list(limb_cols), values.dtype)

    def exact(limbs):
        # (key, pos) is a unique prefix, so payloads skip the comparator
        pos = torch.arange(n, dtype=torch.int32, device=dev)
        out = psort.sort_i32_cols((*limbs, pos, *enc),
                                  num_keys=len(limbs) + 1, pad_safe=True)
        top = from_limb_cols([c[:k] for c in out[:len(limbs)]])
        rest = out[len(limbs) + 1:]
        return (top, *psort.cols_from_i32([c[:k] for c in rest], spec))

    # Small n, k near n, or multi-limb keys (a one-limb threshold cannot
    # cut multi-limb order exactly), or more expected survivors per block
    # than the extraction holds: the exact full sort.
    if k >= n or len(kl) > 1 or n <= max(4 * k, sample_size) \
            or 2 * oversample * k * W >= KB * n:
        last_branch = "small"
        return exact(kl)

    limb = kl[0]
    # --- threshold from a strided sample quantile ---------------------------
    m = min(sample_size, n)
    sample = limb[::n // m][:m]
    j = min(m - 1, (m * k * oversample) // n + 1)
    t = torch.sort(sample).values[j]

    # --- block-local survivor extraction ------------------------------------
    n2 = -(-n // W) * W
    limb2 = limb
    if n2 != n:
        limb2 = torch.cat([limb, torch.full((n2 - n,), _I32_MAX,
                                            dtype=torch.int32, device=dev)])
    x2 = limb2.view(-1, W)
    nb = x2.shape[0]
    mm = (x2 <= t).to(torch.int32)
    # pad rows survive only when t is i32 max, which fails `ok` anyway
    cnt_b = mm.sum(1)
    blk_base = torch.arange(nb, dtype=torch.int32, device=dev)[:, None] * W
    cvals, cposs = [], []
    for _ in range(KB):
        # argmax of an int mask is its first 1 (torch returns the first
        # maximal index)
        first = torch.argmax(mm, 1, keepdim=True)
        has = torch.gather(mm, 1, first) > 0
        gpos = blk_base + first.to(torch.int32)
        cvals.append(torch.where(has, torch.gather(x2, 1, first),
                                 _I32_MAX)[:, 0])
        cposs.append(torch.where(has & (gpos < n), gpos, n)[:, 0])
        mm.scatter_(1, first, 0)
    ok = (cnt_b.sum() >= k) & ~(cnt_b > KB).any() & (t < _I32_MAX)
    with named("clo.sync:topk_check"):
        ok = bool(ok)
    if not ok:
        last_branch = "exact"
        return exact([limb])

    # candidates sorted by (value, pos): ties break by input position, as
    # in the full sort; empties (i32 max, pos n) sort last and cannot
    # reach slot k while there are at least k survivors
    last_branch = "fast"
    sv, sp = psort.sort_i32_cols((torch.cat(cvals), torch.cat(cposs)))
    top_pos = sp[:k].clamp(max=n - 1).to(torch.int64)
    pays = psort.cols_from_i32([c[top_pos] for c in enc], spec)
    return (from_limb_cols([sv[:k]]), *pays)


def distinct(keys_col, *, capacity: int):
    """SELECT DISTINCT: the unique values of a column, ascending.

    Sorts the key column alone on normalized limbs, then gathers each
    group's boundary value through the GROUP BY boundary reduce (a "max"
    over the key itself with key_ordered=True is a gather at the group
    ends). Returns (unique_values, count): the first `count` slots hold
    the distinct values ascending, later slots are padding. `capacity` is
    the result buffer's size (the distinct count must not exceed it).
    """
    kl = keymod.to_limbs(keys_col)
    out = psort.sort_i32_cols(tuple(kl))
    skeys = keymod.from_limbs(list(out), keys_col.dtype)
    gk, _, cnt = _boundary_reduce_cols(
        skeys, (skeys,), num_groups=capacity, aggs=("max",),
        key_ordered=(True,))
    return gk, cnt
