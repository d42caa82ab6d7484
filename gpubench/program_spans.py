"""The program's own spans laid over the traced window.

While a profiler records, the port keeps the spans it closes in a ring
(``invesalius3_tpu_torch.utils.logging.perf_report``), timed by
``time.time_ns()``.  The profiler's Chrome trace counts from a base: the
epoch floored to Kineto's 7889238-s periods.  Less that base, a ring span
lies on the trace's clock, where the device's idle gaps can be put down to
the stage the host was in.  Where the program keeps no such ring, or its
spans do not fall inside the harness's action spans, nothing is read.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

KINETO_PERIOD_NS = 7889238 * 10**9
ACTION = "gpubench.action"
KEYS = {"name", "start_ns", "end_ns", "id", "parent", "root"}


def ring() -> list:
    """The program's ring of closed spans, or an empty list where the
    program keeps none."""
    try:
        from invesalius3_tpu_torch.utils import logging as ilog
    except ImportError:
        return []
    report = getattr(ilog, "perf_report", None)
    return [e for e in (report() if report else []) if isinstance(e, dict) and KEYS <= set(e)]


def traced(ctx, root_name: str) -> Optional[List[dict]]:
    """The ring's spans of every root ``root_name`` in the traced window,
    moved onto the trace's clock (``start``, ``end`` in its ns), roots
    first; None where the ring holds no such root or one lies outside every
    ``gpubench.action`` span of the trace."""
    tr = ctx["trace"]
    entries = ring()
    if tr is None or not entries:
        return None
    base = entries[-1]["start_ns"] // KINETO_PERIOD_NS * KINETO_PERIOD_NS
    moved = [dict(e, start=e["start_ns"] - base, end=e["end_ns"] - base) for e in entries]
    roots = [e for e in moved if e["parent"] is None and e["name"] == root_name
             and tr.start <= e["start"] and e["end"] <= tr.end]
    actions = [(a, b) for name, a, b in tr.spans if name == ACTION]
    if not roots or not all(any(a <= r["start"] and r["end"] <= b for a, b in actions)
                            for r in roots):
        return None
    ids = {r["id"] for r in roots}
    return roots + [e for e in moved if e["root"] in ids and e["parent"] is not None]


def idle_gaps(tr) -> List[Tuple[int, int]]:
    """The window's spans of time with no device work (ns), as
    ``Trace.idle_gaps`` finds them."""
    edges = [tr.start] + [x for iv in tr.busy_intervals() for x in iv] + [tr.end]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]


def idle_share_in(ctx, root_name: str, names) -> Optional[float]:
    """The share (%) of the traced window in which the card was idle, in
    gaps that began while the host was inside a span named in ``names`` of
    a root ``root_name``."""
    spans = traced(ctx, root_name)
    if spans is None:
        return None
    tr = ctx["trace"]
    inside: List[List[int]] = []  # the union of those spans, in order
    for a, b in sorted((s["start"], s["end"]) for s in spans if s["name"] in names):
        if inside and a <= inside[-1][1]:
            inside[-1][1] = max(inside[-1][1], b)
        else:
            inside.append([a, b])
    starts = [a for a, _ in inside]

    def in_span(t: int) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t < inside[i][1]

    idle = sum(b - a for a, b in idle_gaps(tr) if in_span(a))
    return 100.0 * idle / (tr.end - tr.start)
