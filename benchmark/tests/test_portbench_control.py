"""The control (the reference with every product in TF32, in the program's
place) and every fault a cell can have come out as not correct, at a tiny
size on the CPU; the program itself comes out correct."""

import pytest

from benchmark.control import readings
from benchmark.faults import FAULTS
from benchmark.harness import Bench, run_workload
from benchmark.tests.tiny import CELLS


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("seed", [17, 2 ** 35 + 1])
def test_control_fails_and_program_passes(tiny_root, cell, seed):
    limits = Bench(tiny_root).limits(cell)
    got = readings(cell, seed, 0.05, "cpu", tiny_root)
    assert all(v <= limits[k] for k, v in got["program"].items())
    assert any(v > limits[k] for k, v in got["control"].items())


def _faults():
    out = []
    for cell, (config, traffic) in sorted(CELLS.items()):
        kind = ("train" if "train" in traffic else "offline",
                config.split("-")[1])
        out += [(cell, fault) for fault in FAULTS[kind]]
    return out


@pytest.mark.parametrize("cell,fault", _faults())
def test_each_fault_makes_the_run_incorrect(tiny_root, cell, fault):
    bench = Bench(tiny_root)
    workload = bench.workload(cell)
    kind = (bench.traffic(workload["traffic"])["kind"],
            bench.config(workload["config"])["family"])
    with FAULTS[kind][fault]():
        result = run_workload(cell, 99, 0.05, 0, device="cpu",
                              root=tiny_root)
    assert result["correct"] is False
    assert result["failed"] >= 1
