"""The sweep kernels' share of their byte roofline: the bytes the traced
actions' sweeps need (``counts.refine_sweep_bytes``: three sweeps a round
at each level's shape, int16 labels) over the summed time of the
``ws_*kernel`` launches in the trace, against the card's HBM rate.  Where
the trace's launches are not the rounds' three a round, the bytes cannot
be laid on them, and nothing is read."""

from gpubench import counts

LABEL_BYTES = 2  # int16 markers keep int16 labels through the refine


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    levels = [lv for r in ctx["traced_records"] for lv in r.get("rounds", [])]
    seconds, launches = tr.kernel_seconds(r"ws_\w*kernel")
    if not levels or not launches or launches != sum(3 * n for _, n in levels):
        return None
    need = counts.refine_sweep_bytes(levels, LABEL_BYTES)
    return 100.0 * need / counts.PEAK_HBM_BYTES_S / seconds
