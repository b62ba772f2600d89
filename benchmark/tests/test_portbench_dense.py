"""The dense-U cell (``drivers/offline_drnmf_dense.py``) on the CPU: a
tiny checkout from ``tiny.py`` with a ``drnmf_dense`` configuration and its
cell added beside the tiny cells runs correct, untraced and traced, with
the new readers callable; ``yardstick/dense_bounds.py`` on hand-counted
shapes and against chip_smoke.py's B3 figures."""

import json

import pytest

from benchmark.harness import Bench, run_workload
from benchmark.tests.tiny import LIMITS, TINY_DRNMF, make_root
from benchmark.yardstick import dense_bounds
from benchmark.yardstick.peaks import PEAK_BYTES_PER_S, PEAK_TF32_FLOPS

DENSE_CELL = "drnmf-k5-r1000-trainU.offline-wsj0"
CELL = "tiny-drnmf-dense.tiny-offline"
# the flagship's draw at 2r = 16: uniform(0, 0.05 / 2r) added, as
# 2.5e-5 is at 2r = 2000
TINY_DENSE = dict(TINY_DRNMF, family="drnmf_dense",
                  params_trainable=["log_D", "log_alph", "log_U1", "log_Uk"],
                  u_draw={"log_U1_shift": 0.2, "log_Uk_shift": 0.5,
                          "added": 0.05 / 16})
NEW_READERS = ("b3_roofline.enhance", "dense_prep_pct.enhance")


@pytest.fixture(scope="module")
def dense_root(tmp_path_factory):
    """``tiny.make_root``'s checkout with the tiny dense configuration, its
    cell and its limits, the cell listed where the real dense cell is."""
    root = make_root(tmp_path_factory.mktemp("dense"))
    bench = root / "benchmark"
    (bench / "configs" / "tiny-drnmf-dense.json").write_text(
        json.dumps(TINY_DENSE))
    (bench / "limits" / f"{CELL}.json").write_text(json.dumps(
        {"numbers": {k: {"limit": v}
                     for k, v in LIMITS["offline"].items()}}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-drnmf-dense", "source": "toy",
                            "file": "benchmark/configs/tiny-drnmf-dense.json",
                            "reduced": [], "why": "toy"})
    spec["workloads"].append({"name": CELL, "config": "tiny-drnmf-dense",
                              "traffic": "tiny-offline", "chips": 1,
                              "why": "toy"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if DENSE_CELL in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_dense_cell_runs_and_is_correct(dense_root, trace):
    result = run_workload(CELL, 2 ** 41 + 29, 0.2, trace, device="cpu",
                          root=dense_root)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    listed = {m["name"] for m in Bench(dense_root).per_layer(CELL)}
    assert set(NEW_READERS) <= listed
    if not trace:
        assert set(result["metrics"]) == {"enhance_audio_s_per_s",
                                          "setup_s"}
        return
    for name in NEW_READERS:
        assert callable(Bench(dense_root).reader(name).read)
    # the CPU runs no B3 kernel; the dense route's weights span records
    assert "b3_roofline.enhance" not in result["metrics"]
    prep = result["metrics"]["dense_prep_pct.enhance"]
    assert 0.0 < prep["value"] <= 100.0 and prep["unit"] == "%"


def test_dense_bounds_count_the_frames_given():
    # K = 2, F = 3, 2r = 4: 2 rows over 6 steps, 10 of their row-steps
    assert dense_bounds.dense_step_flops(3, 4, 2) == 2 * 16 * 3 + 2 * 3 * 4 * 2
    weights = (3 * 16 + 2 * 3 * 4 + 2 * 4) * 4
    assert dense_bounds.dense_weight_bytes(3, 4, 2) == weights
    b = dense_bounds.dense_bounds(2, 6, 10, 3, 4, 2)
    assert b["flops"] == (2 * 16 * 3 + 2 * 3 * 4 * 2) * 10
    # tiny weights fit the L2: read once
    assert b["bytes"] == 10 * (3 * 4 + 1 + 4 * 4) + 2 * 4 * 4 + weights
    # K == 1 reads u1 alone
    assert dense_bounds.dense_weight_bytes(3, 4, 1) == (16 + 12 + 4) * 4
    assert dense_bounds.dense_model_flops(7, 3, 4, 2) == (
        dense_bounds.dense_step_flops(3, 4, 2) + 2 * 3 * 4) * 7


def test_dense_bounds_at_the_flagship():
    # chip_smoke.py's B3 at 256 x 1,021, K = 5, 2r = 2000, every step
    # valid: 20.2 TFLOP, 40.73 ms, bound by the operations
    b = dense_bounds.dense_bounds(256, 1021, 256 * 1021, 257, 2000, 5)
    assert b["flops"] == pytest.approx(20.2e12, rel=3e-3)
    assert b["bound_s"] == pytest.approx(40.73e-3, rel=1e-3)
    assert b["bound_by"] == "operations"
    # the weights: 106 MB, 56 MB of it past the L2 at every later step
    weights = dense_bounds.dense_weight_bytes(257, 2000, 5)
    assert weights == pytest.approx(106.3e6, rel=1e-3)
    # the cell's launch (128 rows, ~2,050 steps, 54% padding) is bound by
    # the weights' re-reads, ~34 ms
    cell = dense_bounds.dense_bounds(128, 2050, int(128 * 2050 * 0.46), 257,
                                     2000, 5)
    assert cell["bound_by"] == "bytes"
    assert cell["bound_s"] == pytest.approx(
        2049 * (weights - dense_bounds.L2_BYTES) / PEAK_BYTES_PER_S, rel=0.1)
    assert cell["flops"] / PEAK_TF32_FLOPS == pytest.approx(19e-3, rel=0.1)
