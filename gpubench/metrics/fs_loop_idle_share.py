"""The share of the traced window in which the card was idle, in gaps that
began while the host was inside a batch of the parcellation's view loop
(the program's span ``parcellate.batch``, its ``parcellate.model`` and
``parcellate.add`` within it), on the trace's clock."""

from gpubench import program_spans


def read(ctx):
    return program_spans.idle_share_in(ctx, "parcellate", {"parcellate.batch"})
