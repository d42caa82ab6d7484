"""The traced window: ``torch.profiler`` over a run of actions, reduced to
the device's busy time, its kernels by name and its idle gaps, each gap
named by the harness span the host was in when the device fell idle."""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "gpubench.window"
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


def span(name: str):
    """A host span in the trace (``record_function``) under the harness's
    prefix."""
    return torch.profiler.record_function(f"gpubench.{name}")


class Trace:
    """Device intervals and host spans of one profiled window, in ns, read
    from the profiler's Chrome trace (its event categories name device work
    alike in every torch release)."""

    def __init__(self, prof):
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        work: List[Tuple[str, int, int]] = []
        spans: List[Tuple[str, int, int]] = []
        ops: List[Tuple[str, int, int]] = []
        window = None
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat, name = e.get("cat", ""), e.get("name", "")
            a = int(float(e["ts"]) * 1000)
            ev = (name, a, a + int(float(e["dur"]) * 1000))
            if cat in DEVICE_WORK:
                work.append(ev)
            elif cat == "cpu_op":
                ops.append(ev)
            elif cat == "user_annotation" and name.startswith("gpubench."):
                if name == WINDOW:
                    window = ev
                else:
                    spans.append(ev)
        if window is None:
            raise RuntimeError(f"the trace holds no {WINDOW} span")
        self.start, self.end = window[1], window[2]
        self.work = sorted((w for w in work if w[2] > self.start and w[1] < self.end),
                           key=lambda w: w[1])
        self.spans, self.ops = spans, ops

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device's work, clipped to the window."""
        out: List[Tuple[int, int]] = []
        for _, a, b in self.work:
            a, b = max(a, self.start), min(b, self.end)
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def kernel_seconds(self, pattern: str) -> Tuple[float, int]:
        """(summed seconds, launches) of the device work whose name matches
        ``pattern``."""
        rx = re.compile(pattern)
        hits = [b - a for name, a, b in self.work if rx.search(name)]
        return sum(hits) / 1e9, len(hits)

    def top_ops(self, k: int = 10) -> List[List]:
        by: Dict[str, int] = {}
        for name, a, b in self.work:
            by[name] = by.get(name, 0) + (b - a)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[name, ns / 1e9] for name, ns in top]

    @staticmethod
    def _innermost(events, t: int) -> Optional[str]:
        best: Optional[Tuple[str, int, int]] = None
        for e in events:
            if e[1] <= t < e[2] and (best is None or e[1] >= best[1]):
                best = e
        return best[0] if best else None

    def _host_at(self, t: int) -> str:
        """What the host was in at ``t``: the innermost harness span (the
        window if none) and the innermost torch operation, if one was open."""
        span = self._innermost(self.spans, t) or WINDOW
        op = self._innermost(self.ops, t)
        return f"{span} > {op}" if op else span

    def idle_gaps(self, k: int = 10) -> List[List]:
        edges = [self.start] + [x for iv in self.busy_intervals() for x in iv] + [self.end]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self._host_at(a), (b - a) / 1e9] for a, b in gaps[:k]]


@contextlib.contextmanager
def profiled(device: torch.device):
    """Profile the block; yields a list that receives the ``Trace``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out: List[Trace] = []
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            yield out
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    out.append(Trace(prof))
