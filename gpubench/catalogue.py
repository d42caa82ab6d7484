"""The refine rounds that the program's watershed takes on CTs of one
configuration, one CT a noise stream: the readings a watershed traffic
file's ``catalogue`` of streams is chosen from.

    python -m gpubench.catalogue --config head_ct512 --streams 0:512

The rounds a watershed takes follow its CT's noise, and an action's time
follows its rounds; so that every seed does the same work, a mix draws
its CTs only from streams whose levels take the same rounds.  Prints one
JSON line a stream, then one line that groups the streams by their
rounds, the largest group first.  The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time

from gpubench import gen, run


def readings(cfg: dict, streams, algorithm: str = "Watershed", device: str = "cuda:0"):
    import torch

    from invesalius3_tpu_torch.ops import watershed

    dev = torch.device(device)
    markers = gen.markers(cfg, dev)
    for s in streams:
        ct = gen.head_ct(cfg, s, dev)
        rounds: list = []
        run.sync(dev)
        t = time.perf_counter()
        watershed.watershed(ct, markers, algorithm, multigrid_levels=cfg["multigrid_levels"],
                            rounds=rounds)
        run.sync(dev)
        yield {"stream": s, "rounds": [n for _, n in rounds], "s": time.perf_counter() - t}
        del ct


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m gpubench.catalogue")
    p.add_argument("--config", required=True)
    p.add_argument("--streams", required=True, help="first:last, last excluded")
    args = p.parse_args(argv)
    run.set_cache_env()
    cfg = run.load_json(run.HERE / "configs" / f"{args.config}.json")
    lo, hi = (int(x) for x in args.streams.split(":"))
    groups = collections.defaultdict(list)
    for line in readings(cfg, range(lo, hi)):
        groups[tuple(line["rounds"])].append(line["stream"])
        print(json.dumps(line), flush=True)
    print(json.dumps(sorted(([list(k), v] for k, v in groups.items()),
                            key=lambda kv: -len(kv[1]))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
