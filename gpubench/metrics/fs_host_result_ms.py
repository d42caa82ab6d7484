"""The host's time in the parcellation's mask and its copy of the labels
and mask to the host (the program's span ``parcellate.host_result``), per
traced parcellation, in ms."""

from gpubench import span_reads


def read(ctx):
    return span_reads.child_ms(ctx, "parcellate", "parcellate.host_result")
