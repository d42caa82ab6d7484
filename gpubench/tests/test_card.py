"""On the card: a short run of each cell prints a correct result line
(``python -m pytest gpubench/tests -m cuda`` on a machine with an H100).
The window is long enough to reach the training step that a seed keeps."""

import json
import subprocess
import sys

import pytest

from gpubench import run


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in run.manifest()["workloads"]])
def test_short_run(card, workload):
    out = subprocess.run([sys.executable, "-m", "gpubench", "--workload", workload, "--seed",
                          str(2**31 + 99), "--seconds", "20", "--trace", "0"], cwd=run.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"
