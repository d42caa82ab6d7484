"""The host's time in the segmenter's copy of the probability and mask to
the host (the program's span ``segment.host_result``), per traced
segmentation, in ms."""

from gpubench import program_spans


def read(ctx):
    spans = program_spans.traced(ctx, "segment")
    if spans is None:
        return None
    hosts = [s["end"] - s["start"] for s in spans if s["name"] == "segment.host_result"]
    if not hosts:
        return None
    return sum(hosts) / 1e6 / sum(s["parent"] is None for s in spans)
