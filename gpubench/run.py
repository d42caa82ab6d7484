"""One run of one cell: set-up, a closed-loop window of user actions, the
check of what the window produced against the plain reference, and the
result as one JSON line.

    python -m gpubench --workload head_ct512.watershed --seed 7 --seconds 30 --trace 0

Every piece of a cell is found by name: the cell in ``BENCHMARK.json``
names its configuration (``configs/<config>.json``) and traffic mix
(``traffic/<traffic>.json``); the traffic file names the action
(``actions/<action>.py``); each per-layer metric is read by
``metrics/<metric>.py``.  Adding a cell, a mix or a metric adds files and
entries and edits none.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "invesalius3_tpu")
CACHE = ROOT / ".gpubench_cache"


def set_cache_env() -> None:
    """Every compile cache in fixed directories inside the checkout, and no
    library that could load JAX by itself."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def cell_spec(bench: dict, workload: str) -> dict:
    """The cell, its configuration and its traffic, read by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return {"cell": cell, "config": load_json(ROOT / cfg_entry["file"]),
            "traffic": load_json(HERE / "traffic" / f"{cell['traffic']}.json")}


def metrics_of(bench: dict, workload: str, kind: str) -> List[dict]:
    """The ``kind`` ("end_to_end" or "per_layer") metrics this cell reports."""
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])]


def action_class(name: str):
    return importlib.import_module(f"gpubench.actions.{name}").Action


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``, loaded by its file name: it takes
    the run's context and returns the number, or None where the run has
    nothing to read."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"gpubench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()[0]
    except Exception as e:  # the number stands without it; say why
        return f"unread ({type(e).__name__})"


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, t0: float,
             device: Optional[str] = None, config: Optional[dict] = None,
             traffic: Optional[dict] = None) -> dict:
    """One run of ``workload``; returns the result object.  ``device``,
    ``config`` and ``traffic`` replace the card and what the manifest names
    (the harness's tests run a cell at a tiny size on the CPU)."""
    import torch

    from gpubench import trace as tr

    bench = manifest()
    spec = cell_spec(bench, workload)
    cell = spec["cell"]
    cfg = config if config is not None else spec["config"]
    mix = traffic if traffic is not None else spec["traffic"]
    dev = torch.device(device or "cuda:0")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    act = action_class(mix["action"])(cfg, mix, seed, dev, trace)
    t_ready = time.perf_counter()
    act.setup()
    sync(dev)
    print(f"gpubench: set-up {t_ready - t0:.3f} s to the card, {time.perf_counter() - t_ready:.3f}"
          f" s inputs, program and warm-up (the warm-up {act.warm_s:.3f} s)", file=sys.stderr)

    times: List[float] = []
    records: List[dict] = []
    t_start = time.perf_counter()
    setup_s = t_start - t0

    def one(i: int) -> None:
        a = time.perf_counter()
        with tr.span("action"):
            records.append(act(i))
        times.append(time.perf_counter() - a)

    while time.perf_counter() - t_start < seconds or not times:
        one(len(times))
    window_s = time.perf_counter() - t_start
    untraced = len(times)
    # the traced run profiles a few more actions once the window has closed
    trace_obj = None
    if trace:
        with tr.profiled(dev) as got:
            for _ in range(int(mix["trace_actions"])):
                one(len(times))
        trace_obj = got[0]

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    act.release()
    t_check = time.perf_counter()
    checks = act.check()
    q = statistics.quantiles(times[:untraced], n=4) if untraced > 1 else [times[0]] * 3
    print(f"gpubench: {untraced} actions in {window_s:.3f} s (each {min(times):.4f} / "
          f"{q[0]:.4f} / {q[1]:.4f} / {q[2]:.4f} / {max(times):.4f} s); set-up {setup_s:.3f} s;"
          f" the check took {time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    correct = all(c["value"] <= c["limit"] for c in checks)

    ctx = {"action_times": times[:untraced], "window_s": window_s, "setup_s": setup_s,
           "records": records[:untraced], "traced_records": records[untraced:],
           "trace": trace_obj, "config": cfg, "traffic": mix, "action": act}
    metrics: Dict[str, dict] = {}
    kind = "per_layer" if trace else "end_to_end"
    for m in metrics_of(bench, workload, kind):
        value = metric_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    kind_name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind_name,
                   "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": untraced,
              "failed": act.failed,
              "metrics": metrics, "device": device_info}
    if trace_obj is not None:
        device_info["busy_s"] = trace_obj.busy_s
        device_info["window_s"] = trace_obj.window_s
        result["breakdown"] = {"device_ops": trace_obj.top_ops(),
                               "idle_gaps": trace_obj.idle_gaps()}
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return result


def main(argv: List[str], t0: float) -> int:
    p = argparse.ArgumentParser(prog="python -m gpubench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_cache_env()

    import torch

    t_torch = time.perf_counter()
    bench = manifest()
    chips = int(cell_spec(bench, args.workload)["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"gpubench: {args.workload} needs {chips} CUDA device(s), found {n}",
              file=sys.stderr)
        return 2
    print(f"gpubench: set-up {t_torch - t0:.3f} s to import torch, "
          f"{time.perf_counter() - t_torch:.3f} s to find the card", file=sys.stderr)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t0)
    found = forbidden_modules()
    if found:
        print(f"gpubench: the run loaded {found}: no JAX, Flax or JAX package may load",
              file=sys.stderr)
        return 3
    if args.trace:
        print(f"gpubench: card {power_limit()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0

