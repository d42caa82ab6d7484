"""The cells at sizes a CPU test holds: the same configurations, traffic
and actions, with the volumes and patches cut."""

import contextlib

import torch

from gpubench import run

CPU = torch.device("cpu")


def tiny(workload: str, conv_dtype: str = None):
    """(config, traffic) of ``workload`` at a size a CPU test holds."""
    spec = run.cell_spec(run.manifest(), workload)
    cfg, mix = dict(spec["config"]), dict(spec["traffic"])
    mix["trace_actions"] = 1
    if "n" in cfg:
        cfg["n"] = 72 if mix["action"] == "watershed" else 48
    if conv_dtype:
        cfg["conv_dtype"] = conv_dtype
    if mix["action"] == "segment":
        mix["volume"] = dict(mix["volume"], n=40)
        mix["patch"] = 16
    if mix["action"] == "train":
        mix.update(patch=16, batch=2, keep_horizon=1)  # a tiny run's window holds one step
    return cfg, mix


@contextlib.contextmanager
def small_volumes(n: int = 40):
    """Configurations read by name (the training cell's CT) at side ``n``."""
    orig = run.load_json

    def load(path):
        d = orig(path)
        return dict(d, n=n) if "n" in d and "configs" in str(path) else d
    run.load_json = load
    try:
        yield
    finally:
        run.load_json = orig


def action(workload: str, seed: int, conv_dtype: str = None):
    cfg, mix = tiny(workload, conv_dtype)
    return run.action_class(mix["action"])(cfg, mix, seed, CPU)


def run_tiny(workload: str, seed: int, trace: bool = False, conv_dtype: str = None) -> dict:
    import time

    cfg, mix = tiny(workload, conv_dtype)
    with small_volumes():
        return run.run_cell(workload, seed, 0.2, trace, time.perf_counter(), device="cpu",
                            config=cfg, traffic=mix)
