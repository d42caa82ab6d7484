"""The share of the traced window in which the card was idle, in gaps that
began while the host was inside the segmenter's patch loop: a batch's span
``segment.batch`` (its gather, model and scatter spans lie within it), on
the trace's clock."""

from gpubench import program_spans


def read(ctx):
    return program_spans.idle_share_in(ctx, "segment", {"segment.batch"})
