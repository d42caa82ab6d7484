"""Readings of one traced root of the program's spans, averaged over the
traced actions: a child span's host time, a root's count.  Each returns
None where the program keeps no such root in the traced window, or none
of its roots holds the child or the count."""

from __future__ import annotations

from typing import Optional

from gpubench import program_spans


def child_ms(ctx, root_name: str, name: str) -> Optional[float]:
    """The host time (ms) of the spans ``name`` of each root ``root_name``."""
    spans = program_spans.traced(ctx, root_name)
    if spans is None:
        return None
    times = [s["end"] - s["start"] for s in spans if s["name"] == name]
    if not times:
        return None
    return sum(times) / 1e6 / sum(s["parent"] is None for s in spans)


def root_count(ctx, root_name: str, name: str) -> Optional[float]:
    """The count ``name`` of each root ``root_name``."""
    spans = program_spans.traced(ctx, root_name)
    if spans is None:
        return None
    counts = [s.get("counts", {}).get(name) for s in spans if s["parent"] is None]
    if None in counts:
        return None
    return sum(counts) / len(counts)
