"""The benchmark loads neither JAX nor the JAX package; its command refuses
to run without a card, and in a directory without the program."""

import shutil
import subprocess
import sys

from benchmark.tests.tiny import ROOT

_PROBE = """
import sys
sys.path.insert(0, {root!r})
from benchmark.tests.tiny import make_root
from benchmark.harness import run_workload
import benchmark.control, benchmark.faults, benchmark.run
root = make_root({tmp!r})
for cell in ("tiny-drnmf.tiny-offline", "tiny-snmf.tiny-offline",
             "tiny-drnmf.tiny-train"):
    run_workload(cell, 1, 0.05, 1, device="cpu", root=root)
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "flax", "drnmf_tpu", "chip_smoke", "bench"))
print("BAD", bad)
"""


def test_no_jax_is_loaded(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE.format(root=str(ROOT),
                                             tmp=str(tmp_path))],
        capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BAD []" in proc.stdout


def test_run_refuses_without_a_card_and_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "snmf-r1000.offline-wsj0", "--seed", str(2 ** 31 + 9), "--seconds",
         "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(ROOT / "build")})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_run_fails_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "snmf-r1000.offline-wsj0", "--seed", "1", "--seconds", "1",
         "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
