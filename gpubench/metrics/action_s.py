"""The window's wall time over the actions it completed (host clock)."""


def read(ctx):
    return ctx["window_s"] / len(ctx["action_times"])
