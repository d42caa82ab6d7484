"""The share of the traced window in which the card was idle, in gaps that
began while the host was inside one of the refine loop's flag reads (the
program's spans ``watershed.flag_read``, on the trace's clock)."""

from gpubench import program_spans


def read(ctx):
    return program_spans.idle_share_in(ctx, "watershed", {"watershed.flag_read"})
