"""A configuration, a traffic mix and a per-layer metric added as files,
with their entries in BENCHMARK.json, are found by name: no file that is
already there is edited."""

import json
import shutil
import subprocess
import sys

from gpubench import run


def test_new_files_are_found(tmp_path):
    shutil.copytree(run.HERE, tmp_path / "gpubench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = run.manifest()
    cfg = run.load_json(run.HERE / "configs" / "head_ct512.json")
    (tmp_path / "gpubench" / "configs" / "head_ct64.json").write_text(json.dumps(dict(cfg, n=64)))
    mix = dict(run.load_json(run.HERE / "traffic" / "watershed.json"), trace_actions=1)
    (tmp_path / "gpubench" / "traffic" / "watershed_again.json").write_text(json.dumps(mix))
    (tmp_path / "gpubench" / "metrics" / "labels_seen.py").write_text(
        "def read(ctx):\n    return float(len(ctx['records']))\n")
    bench["configs"].append({"name": "head_ct64", "source": "https://example.org/ct64",
                             "file": "gpubench/configs/head_ct64.json", "reduced": ["n"],
                             "why": "a small CT"})
    bench["workloads"].append({"name": "head_ct64.watershed_again", "config": "head_ct64",
                               "traffic": "watershed_again", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "labels_seen", "unit": "count", "better": "higher",
                               "source": "program_counter", "layer": "watershed refine loop",
                               "moves": "action_s", "workloads": ["head_ct64.watershed_again"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, time; from gpubench import run; "
            "r = run.run_cell('head_ct64.watershed_again', 4, 0.1, True, time.perf_counter(), "
            "device='cpu'); print(json.dumps(r))")
    env_path = f"{tmp_path}:{run.ROOT}"
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600, env={"PYTHONPATH": env_path, "PATH": "/usr/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True
    assert r["metrics"]["labels_seen"]["value"] >= 1
    # the cell is listed by the new metric alone
    assert set(r["metrics"]) == {"labels_seen"}
