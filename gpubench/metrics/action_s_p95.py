"""The 95th percentile of every action's wall time in the window (host
clock, numpy's interpolation between order statistics)."""

import math


def read(ctx):
    s = sorted(ctx["action_times"])
    if len(s) < 20:
        return None
    pos = 0.95 * (len(s) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)
