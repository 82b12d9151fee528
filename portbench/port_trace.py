"""The port's own spans in a traced window, for the per-layer metrics that
read them.

While a profiler records, the port (cl_ops_tpu_torch, through
`utils/profiling.named`) opens these host ranges:

    clo.op:<layer>        each operator call (groupby, filter, join, topk)
    clo.sort n=<rows> padded=<rows> cols=<columns>
                          a bitonic sort's padding copy, passes and cut-back
    clo.sync:<flag>       a host read of a device flag (band_overflow,
                          expand_overflow, topk_check)
    clo.join:fallback     the merge probe that runs after a band overflow

They are plain host ops to the profiler, not user annotations, so they
have no projection on the device's timeline and `trace.aggregate` reads
the same with or without them. They nest on the one client thread, so the
span that encloses another is its parent. A kernel belongs to the
innermost span that holds the host time of its launch, found by the rule
of `trace.aggregate` (the runtime call, else the linked op), and counts
only when that time lies in a `pb.q:` query span. A span counts when it
starts in a query span.

A reader is handed `trace.aggregate`'s result, in which `run._per_layer`
keeps the `summarize` of the same events under "port"; `of` returns it.
"""

from __future__ import annotations

import bisect

from portbench import trace as tr

PREFIX = "clo."


def kind(name: str) -> str:
    """A port span's kind: its name without the prefix and attributes
    ("clo.sort n=5 padded=8 cols=2" -> "sort")."""
    return name[len(PREFIX):].split(" ", 1)[0]


def attrs(name: str) -> dict:
    """A port span's attributes as ints ("n=5 padded=8" -> {"n": 5, ...})."""
    return {k: int(v) for k, v in
            (kv.split("=", 1) for kv in name.split()[1:])}


def nest(events):
    """The port's host spans sorted by start, an enclosing span before the
    spans it holds, and the index of each one's parent (-1: none)."""
    spans = sorted((e for e in events
                    if e.kind == "cpu" and e.name.startswith(PREFIX)),
                   key=lambda e: (e.start, -e.end))
    parent, open_ = [], []
    for i, s in enumerate(spans):
        while open_ and spans[open_[-1]].end < s.end:
            open_.pop()
        parent.append(open_[-1] if open_ else -1)
        open_.append(i)
    return spans, parent


def innermost(spans, parent, starts, t) -> int:
    """Index of the innermost span that holds host time t (-1: none)."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0 and spans[i].end < t:
        i = parent[i]
    return i


def overlap(a, b) -> int:
    """Total length of the intersection of two sorted lists of disjoint
    (start, end) intervals."""
    total = i = j = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(hi - lo, 0)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def of(t: dict) -> dict | None:
    """The `summarize` of the events that `t`, the result of
    `trace.aggregate`, was made from, kept in `t` under "port" (None: none
    kept)."""
    return t.get("port")


def summarize(events, cards: int = 1) -> dict:
    """The port's spans in the traced window of `events` on `cards` cards,
    which runs from the first query span's start to the last's end, as in
    `trace.aggregate`.

    Returns {"ops": {layer: outermost clo.op spans}, "kind_s": {span kind:
    device s of the kernels whose innermost port span it is}, "sorts",
    "sort_rows", "sort_padded" (clo.sort spans and the sums of their n and
    padded), "syncs" (clo.sync spans), "fallbacks" (clo.join:fallback
    spans), "host_s" (host s in the outermost clo.op spans less their
    clo.sync spans), "idle_s" (device idle s while the host is in an
    outermost clo.op span: on each card, then the mean over the cards)}.
    """
    queries = sorted((e.start, e.end) for e in events if e.kind == "query")
    if not queries:
        raise ValueError("the trace holds no query span")
    qstarts = [q[0] for q in queries]
    w0, w1 = queries[0][0], max(q[1] for q in queries)
    launch_at = {e.corr: e.start for e in events if e.kind == "launch"}
    op_at = {e.corr: e.start for e in events
             if e.kind in ("cpu", "op", "query")}
    busy = tr.busy(events, w0, w1, cards)

    def in_query(t):
        i = bisect.bisect_right(qstarts, t) - 1
        return i >= 0 and t <= queries[i][1]

    spans, parent = nest(events)
    starts = [s.start for s in spans]
    kinds = [kind(s.name) for s in spans]
    out = {"ops": {}, "kind_s": {}, "sorts": 0, "sort_rows": 0,
           "sort_padded": 0, "syncs": 0, "fallbacks": 0, "host_s": 0.0,
           "idle_s": 0.0}
    outer_ops, sync_ns = [], {}
    for i, s in enumerate(spans):
        if not in_query(s.start):
            continue
        k = kinds[i]
        # the outermost op span that holds this one, itself included
        top, j = -1, i
        while j >= 0:
            if kinds[j].startswith("op:"):
                top = j
            j = parent[j]
        if k == "sort":
            a = attrs(s.name)
            out["sorts"] += 1
            out["sort_rows"] += a["n"]
            out["sort_padded"] += a["padded"]
        elif k.startswith("sync:"):
            out["syncs"] += 1
            if top >= 0:
                sync_ns[top] = sync_ns.get(top, 0) + s.end - s.start
        elif k == "join:fallback":
            out["fallbacks"] += 1
        elif top == i:
            layer = k[len("op:"):]
            out["ops"][layer] = out["ops"].get(layer, 0) + 1
            outer_ops.append(i)
    for i in outer_ops:
        s = spans[i]
        out["host_s"] += (s.end - s.start - sync_ns.get(i, 0)) * 1e-9

    for e in events:
        if e.kind != "kernel":
            continue
        t = launch_at.get(e.corr, op_at.get(e.linked))
        if t is None or not in_query(t):
            continue
        i = innermost(spans, parent, starts, t)
        if i >= 0:
            out["kind_s"][kinds[i]] = (out["kind_s"].get(kinds[i], 0.0)
                                       + (e.end - e.start) * 1e-9)

    held = [(max(spans[i].start, w0), min(spans[i].end, w1))
            for i in outer_ops]
    out["idle_s"] = sum(overlap(tr.idle(card, w0, w1), held) * 1e-9
                        for card in busy) / cards
    return out
