"""The weight bytes the parcellation sends to the card in one action (the
program's count ``parcellate.weight_bytes``, kept with each traced root
``parcellate``), in MB (10^6 bytes), averaged over the traced actions."""

from gpubench import span_reads


def read(ctx):
    n = span_reads.root_count(ctx, "parcellate", "parcellate.weight_bytes")
    return None if n is None else n / 1e6
