"""One run of one cell: set-up, the measured window, the reading of the
trace, the comparison with the reference, and the result's line.

Everything is found by name from ``BENCHMARK.json``: the cell's
configuration file (its ``file``), ``traffic/<traffic>.json``, the driver
``drivers/<kind>_<family>.py`` (the traffic's ``kind``, the
configuration's ``family``), ``limits/<cell>.json`` and, with a trace,
the reader ``metrics/<metric>.py`` of every per-layer metric the cell
reports.  A later cell, mix, configuration or metric is a new file and a
new entry, and no edit here."""

import contextlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from .yardstick import trace as trace_mod
from .yardstick.compare import judge, load_limits

HERE = Path(__file__).resolve().parent


class Bench:
    """The benchmark's files under ``root`` (the checkout): its
    ``BENCHMARK.json`` and the folder ``benchmark/`` beside it."""

    def __init__(self, root=None):
        self.root = Path(root) if root is not None else HERE.parent
        self.dir = self.root / "benchmark"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name):
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload '{name}' in BENCHMARK.json")

    def config(self, name):
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration '{name}' in BENCHMARK.json")

    def traffic(self, name):
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def limits(self, workload):
        return load_limits(self.dir / "limits" / f"{workload}.json")

    def driver(self, kind, family):
        return _load(self.dir / "drivers" / f"{kind}_{family}.py",
                     f"benchmark.drivers.{kind}_{family}")

    def end_to_end(self, workload):
        return [m for m in self.spec["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload):
        return [m for m in self.spec["per_layer"]
                if workload in m.get("workloads", [workload])]

    def reader(self, metric):
        return _load(self.dir / "metrics" / f"{metric}.py",
                     "benchmark.metrics." + metric.replace(".", "_"))


def _load(path, module_name):
    """The module in the file ``path``, imported under ``module_name``
    (a name inside the package ``benchmark``, so its relative imports
    resolve there)."""
    if not path.exists():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = module
    spec.loader.exec_module(module)
    return module


def _device_info(device):
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run_workload(name, seed, seconds, trace, device="cuda", root=None,
                 t_start=None):
    """Run cell ``name`` once; returns the result's dict (the keys of the
    result's line, ``checks`` last)."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    bench = Bench(root)
    workload = bench.workload(name)
    config = bench.config(workload["config"])
    traffic = bench.traffic(workload["traffic"])
    limits = bench.limits(name)
    driver_mod = bench.driver(traffic["kind"], config["family"])
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    drv = driver_mod.Driver(config, traffic, seed, device, bool(trace))
    drv.sync()
    setup_s = time.perf_counter() - t_start

    profiler = contextlib.nullcontext()
    if trace:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
    work, calls = 0.0, 0
    with profiler as prof:
        with torch.profiler.record_function(trace_mod.WINDOW):
            t0 = time.perf_counter()
            while True:
                work += drv.call(calls)
                calls += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            drv.sync()
            window_s = time.perf_counter() - t0
    dev = _device_info(device)

    metrics = {}
    breakdown = None
    if trace:
        summary = trace_mod.summarize(prof.events())
        ctx = {"trace": summary, "counters": drv.counters, "config": config,
               "traffic": traffic, "window_s": summary["window_s"]}
        for m in bench.per_layer(name):
            value = bench.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = summary["busy_s"] or 0.0
        dev["window_s"] = summary["window_s"]
        breakdown = {"device_ops": summary["device_ops"],
                     "idle_gaps": summary["idle_gaps"]}
        del prof, summary, ctx
    else:
        rates = {"setup_s": setup_s, driver_mod.RATE: work / window_s}
        for m in bench.end_to_end(name):
            metrics[m["name"]] = {"value": rates[m["name"]],
                                  "unit": m["unit"]}

    numbers = drv.check()
    correct, checks = judge(numbers, limits)
    result = {"correct": correct, "attempted": calls,
              "failed": sum(c["value"] > c["limit"] or c["value"] != c["value"]
                            for c in checks.values()),
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result
