"""The harness finds a configuration, a traffic mix, a cell, its limits and
a per-layer metric added as new files in a checkout, with no edit to a file
it already has; every cell of the repository's BENCHMARK.json has its
files."""

import json

import pytest

from benchmark.harness import Bench, run_workload
from benchmark.tests.tiny import ROOT


def test_every_entry_of_the_benchmark_has_its_files():
    bench = Bench(ROOT)
    spec = bench.spec
    for w in spec["workloads"]:
        config = bench.config(w["config"])
        traffic = bench.traffic(w["traffic"])
        assert bench.driver(traffic["kind"], config["family"]).RATE in {
            m["name"] for m in bench.end_to_end(w["name"])}
        assert bench.limits(w["name"])
        for m in bench.per_layer(w["name"]):
            assert callable(bench.reader(m["name"]).read)
            assert m["moves"] in {e["name"] for e in bench.end_to_end(
                w["name"])}
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names))


def test_new_files_are_found_by_name(tiny_root):
    reader = tiny_root / "benchmark" / "metrics" / "calls_seen.enhance.py"
    reader.write_text("def read(ctx):\n"
                      "    return float(ctx['counters']['calls'])\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({
        "name": "calls_seen.enhance", "unit": "calls", "better": "higher",
        "source": "program_counter", "layer": "offline entry",
        "moves": "enhance_audio_s_per_s",
        "workloads": ["tiny-snmf.tiny-offline"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    try:
        result = run_workload("tiny-snmf.tiny-offline", 2 ** 33 + 5, 0.2, 1,
                              device="cpu", root=tiny_root)
    finally:
        spec["per_layer"].pop()
        (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
        reader.unlink()
    assert result["correct"]
    assert result["metrics"]["calls_seen.enhance"]["value"] == \
        result["attempted"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell", ["tiny-drnmf.tiny-offline",
                                  "tiny-snmf.tiny-offline",
                                  "tiny-drnmf.tiny-train"])
def test_tiny_cells_run_and_are_correct(tiny_root, cell):
    result = run_workload(cell, 2 ** 40 + 3, 0.2, 0, device="cpu",
                          root=tiny_root)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) >= {"setup_s"}
    assert len(result["metrics"]) == 2
    assert result["failed"] == 0 and result["attempted"] >= 1
