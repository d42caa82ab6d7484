"""The refine loop's host reads of a batch's "changed" flag in one
watershed action (the program's ``watershed.flag_reads`` count, kept with
each traced root span ``watershed``), averaged over the traced actions."""

from gpubench import program_spans


def read(ctx):
    spans = program_spans.traced(ctx, "watershed")
    if spans is None:
        return None
    roots = [s for s in spans if s["parent"] is None]
    return sum(r.get("counts", {}).get("watershed.flag_reads", 0) for r in roots) / len(roots)
