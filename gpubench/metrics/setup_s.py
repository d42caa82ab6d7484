"""Process start to the first timed action (host clock)."""


def read(ctx):
    return ctx["setup_s"]
