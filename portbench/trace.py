"""From a profiler trace to the per-layer numbers, in memory.

The plans wrap each operator call in a `record_function` range named
`pb.op:<layer>`, and the harness wraps each query in `pb.q:<query>`. A
device kernel belongs to the span in which the host launched it: the
kernel's correlation id leads to the runtime call that launched it (or, if
the trace lacks that call, to the torch op it was linked to), and that
call's host time decides the span. A kernel's own start time never does.
Kernels launched in a query span but in no operator span are the plan's
glue. A card's busy time is the union of its kernel, copy and set
intervals over the traced window, so overlapping work is not counted
twice. On a cell of several cards the union is taken on each card, a card
that ran nothing counts as idle throughout, and the busy time is the mean
over the cards; device seconds of a layer or kernel are summed over them.
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass

QUERY, OP = "pb.q:", "pb.op:"
GLUE = "glue"
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")
_RUNTIME = re.compile(r"cuda[A-Z]|cu[A-Z]")   # runtime and driver calls


@dataclass(frozen=True)
class Event:
    """One trace event. kind: "query" and "op" (the benchmark's spans),
    "launch" (a runtime or driver call), "cpu" (any other host op),
    "kernel", or "device" (a copy or set on the device)."""
    kind: str
    name: str
    start: int              # ns
    end: int                # ns
    corr: int = 0           # correlation id
    linked: int = 0         # the torch op a launch or kernel is linked to
    device: int = 0         # the card of a kernel or device event


def _kind(e) -> str | None:
    """The Event kind of a profiler event (None: not used). Older torch
    builds lack `activity_type`; their events are told apart by device and
    name."""
    name = e.name()
    act = e.activity_type() if hasattr(e, "activity_type") else None
    if str(e.device_type()) != "DeviceType.CPU":
        if act is not None:
            return {"kernel": "kernel", "gpu_memcpy": "device",
                    "gpu_memset": "device"}.get(act)
        if name.startswith(("pb.", "ProfilerStep")):
            return None     # a host range's projection on the device
        return "device" if name.startswith(("Memcpy", "Memset")) \
            else "kernel"
    if name.startswith(QUERY):
        return "query"
    if name.startswith(OP):
        return "op"
    if act in LAUNCH_KINDS or (act is None and _RUNTIME.match(name)):
        return "launch"
    return "cpu"


def from_profiler(prof) -> list[Event]:
    """The events of a finished torch.profiler.profile, unparsed."""
    out = []
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e)
        if kind is not None:
            on_card = kind in ("kernel", "device")
            out.append(Event(kind, e.name(), e.start_ns(), e.end_ns(),
                             e.correlation_id(), e.linked_correlation_id(),
                             e.device_index() if on_card else 0))
    return out


class _Intervals:
    """Sorted, non-overlapping labelled host intervals."""

    def __init__(self, spans):
        spans = sorted(spans)
        self.starts = [s[0] for s in spans]
        self.spans = spans

    def at(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t <= self.spans[i][1]:
            return self.spans[i][2]
        return None


def union(intervals):
    """Merge (start, end) intervals into sorted disjoint ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle(busy_intervals, w0: int, w1: int) -> list:
    """The non-empty gaps of [w0, w1] between sorted disjoint busy
    intervals that lie inside it."""
    edges = [w0] + [x for iv in busy_intervals for x in iv] + [w1]
    return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]


def busy(events: list[Event], w0: int, w1: int, cards: int = 1) -> list:
    """Each card's busy intervals in the window [w0, w1]: the union of its
    kernel, copy and set intervals. With one card every device event is
    its; with several, an event's `device` names its card (0 .. cards - 1).
    """
    per_card = [[] for _ in range(cards)]
    for e in events:
        if e.kind in ("kernel", "device") and e.end > w0 and e.start < w1:
            card = e.device if cards > 1 else 0
            if not 0 <= card < cards:
                raise ValueError(f"a device event on card {card} of a "
                                 f"cell of {cards}")
            per_card[card].append((max(e.start, w0), min(e.end, w1)))
    return [union(iv) for iv in per_card]


def aggregate(events: list[Event], cards: int = 1) -> dict:
    """Per-layer device seconds, launches, busy and idle time of a traced
    window of whole queries on `cards` cards (the cell's, not the trace's:
    a card that ran nothing is idle throughout).

    Returns {"queries", "window_s", "busy_s", "busy_s_per_card",
    "kernels", "unattributed", "layer_s": {layer: s}, "kernel_s": {kernel:
    s}, "gaps": {host span: s}}. The window runs from the first query
    span's start to the last's end. "busy_s" is the mean of
    "busy_s_per_card"; "layer_s", "kernel_s" and "gaps" are sums over the
    cards.
    """
    queries = [e for e in events if e.kind == "query"]
    if not queries:
        raise ValueError("the trace holds no query span")
    qspans = _Intervals((e.start, e.end, e.name[len(QUERY):])
                        for e in queries)
    ospans = _Intervals((e.start, e.end, e.name[len(OP):])
                        for e in events if e.kind == "op")
    w0, w1 = min(e.start for e in queries), max(e.end for e in queries)
    launch_at = {e.corr: e.start for e in events if e.kind == "launch"}
    op_at = {e.corr: e.start for e in events
             if e.kind in ("cpu", "op", "query")}

    layer_s, kernel_s = {}, {}
    kernels = unattributed = 0
    for k in events:
        if k.kind != "kernel":
            continue
        t = launch_at.get(k.corr, op_at.get(k.linked))
        if t is None or qspans.at(t) is None:
            unattributed += t is None
            continue
        layer = ospans.at(t) or GLUE
        dur = (k.end - k.start) * 1e-9
        layer_s[layer] = layer_s.get(layer, 0.0) + dur
        name = short(k.name)
        kernel_s[name] = kernel_s.get(name, 0.0) + dur
        kernels += 1

    per_card = busy(events, w0, w1, cards)
    gaps = {}
    for card in per_card:
        for g0, g1 in idle(card, w0, w1):
            q = qspans.at(g0)
            label = f"{q}/{ospans.at(g0) or GLUE}" if q else "between_queries"
            gaps[label] = gaps.get(label, 0.0) + (g1 - g0) * 1e-9
    busy_s = [sum(e - s for s, e in card) * 1e-9 for card in per_card]
    return {"queries": len(queries), "window_s": (w1 - w0) * 1e-9,
            "busy_s": sum(busy_s) / cards, "busy_s_per_card": busy_s,
            "kernels": kernels, "unattributed": unattributed,
            "layer_s": layer_s, "kernel_s": kernel_s, "gaps": gaps}


def short(kernel: str, width: int = 80) -> str:
    """A kernel's name without `void ` and torch's namespace, cut to
    `width` characters."""
    return kernel.removeprefix("void ").replace("at::native::", "")[:width]


def top(d: dict, n: int = 10) -> list:
    """The n largest entries of {name: seconds}, largest first."""
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
