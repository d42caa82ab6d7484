"""The host's time in building the parcellation's pipeline, the three
networks made and their weights loaded onto the card (the program's span
``parcellate.build``), per traced parcellation, in ms."""

from gpubench import span_reads


def read(ctx):
    return span_reads.child_ms(ctx, "parcellate", "parcellate.build")
