"""On the card: one short run of a cell through the benchmark's command
gives a correct result line (skips without an NVIDIA GPU)."""

import json
import subprocess
import sys

import pytest

from benchmark.tests.tiny import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(card, trace):
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "drnmf-k5-r1000.offline-wsj0", "--seed", str(2 ** 31 + 77),
         "--seconds", "3", "--trace", str(trace)],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
    if trace:
        assert result["device"]["busy_s"] > 0
        assert "b1_roofline.enhance" in result["metrics"]
    else:
        assert set(result["metrics"]) == {"enhance_audio_s_per_s", "setup_s"}
