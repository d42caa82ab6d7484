"""The cells added beside ``tiny.py``'s at sizes a CPU test holds: the
parcellation at conform 32 (the published 64 filters kept), the mandible
segmentation on planes of a 40^3 CT in 16^3 patches."""

import time

from gpubench import run
from gpubench.tests.tiny import CPU, small_volumes

PARCELLATE = "fastsurfer_f64.parcellate"
MANDIBLE = "unet3d_f8.mandible_segment"


def tiny(workload: str):
    """(config, traffic) of ``workload`` at a size a CPU test holds."""
    spec = run.cell_spec(run.manifest(), workload)
    cfg, mix = dict(spec["config"]), dict(spec["traffic"], trace_actions=1)
    if workload == PARCELLATE:
        cfg["conform"] = 32
        mix["volume"] = dict(mix["volume"], n=32)
    else:
        mix.update(planes=20, patch=16)
    return cfg, mix


def action(workload: str, seed: int):
    cfg, mix = tiny(workload)
    return run.action_class(mix["action"])(cfg, mix, seed, CPU)


def run_tiny(workload: str, seed: int, trace: bool = False) -> dict:
    cfg, mix = tiny(workload)
    with small_volumes():
        return run.run_cell(workload, seed, 0.2, trace, time.perf_counter(), device="cpu",
                            config=cfg, traffic=mix)


def control_checks(workload: str, seed: int) -> dict:
    """The check's numbers, each with its limit, of the control's answer."""
    with small_volumes():
        a = action(workload, seed)
        a.make_inputs()
        return {c["name"]: (c["value"], c["limit"]) for c in a.judge([a.control()], a.reference())}
