"""The readings that the check's limits are set from, in one process.

    python -m gpubench.control --workload unet3d_f8.train96 --seeds 11,12,13 --side control
    python -m gpubench.control --workload unet3d_f8.train96 --seeds 11,12,13 --side program
    python -m gpubench.control --workload unet3d_f8.train96 --seeds 11 --side program \
        --fault half_batch

For each seed the cell's inputs are made at its own size and the plain
reference is run; ``--side program`` then runs the program once (set-up,
which for training drives the checked steps, and one action) and
``--side control`` the control (the reference in the step of precision
below the configuration's, or with a guarantee broken).  Each seed prints
one JSON line of the numbers the check compares.  The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

from gpubench import run


def readings(workload: str, seeds, side: str, fault=None, device: str = "cuda:0",
             config=None, traffic=None):
    import torch

    from gpubench import faults

    spec = run.cell_spec(run.manifest(), workload)
    cfg = config if config is not None else spec["config"]
    mix = traffic if traffic is not None else spec["traffic"]
    cls = run.action_class(mix["action"])
    dev = torch.device(device)
    for seed in seeds:
        act = cls(cfg, mix, seed, dev)
        if side == "program":
            with faults.planted(fault) if fault else contextlib.nullcontext():
                answer = act.first_answer()
            act.release()
        else:
            act.make_inputs()
            answer = act.control()
        checks = act.judge([answer], act.reference())
        yield {"workload": workload, "seed": seed, "side": side, "fault": fault,
               "checks": {c["name"]: c["value"] for c in checks}}
        del act, answer
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m gpubench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--side", choices=("program", "control"), required=True)
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    run.set_cache_env()
    for line in readings(args.workload, [int(s) for s in args.seeds.split(",")],
                         args.side, args.fault):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
