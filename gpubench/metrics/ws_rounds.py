"""The refine rounds of one watershed action, summed over its multigrid
levels (the ``rounds=`` list the program fills), averaged over the run's
actions."""


def read(ctx):
    sums = [sum(n for _, n in r["rounds"]) for r in ctx["records"] if "rounds" in r]
    return sum(sums) / len(sums) if sums else None
