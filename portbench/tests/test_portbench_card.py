"""On the card: one short run of the command end to end, its last line in
the result's format.  Skips where there is no card."""

import json
import subprocess
import sys

import pytest

from portbench import manifest


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["headline_restarts16"])
def test_command_prints_a_correct_result(cuda, workload):
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", workload,
                          "--seed", str(2**31 + 7), "--seconds", "1", "--trace", "0"],
                         cwd=str(manifest.ROOT), capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert set(result["metrics"]) == {"setup_s", "gentry_sweeps_per_s", "peak_device_mb"}
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
