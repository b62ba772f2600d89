"""The comparison that decides ``correct``: each number the cell's driver
compares with the plain reference against the limit of its own in
``limits/<cell>.json``.  A number that is not finite fails."""

import json
import math


def load_limits(path):
    with open(path) as f:
        return {name: float(entry["limit"])
                for name, entry in json.load(f)["numbers"].items()}


def judge(numbers, limits):
    """(correct, checks): ``checks`` maps each compared number to its value
    and limit.  Every limit must have its number and every number its
    limit."""
    if set(numbers) != set(limits):
        raise ValueError(f"numbers {sorted(numbers)} and limits "
                         f"{sorted(limits)} differ")
    checks = {name: {"value": float(numbers[name]), "limit": limits[name]}
              for name in sorted(numbers)}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    return correct, checks


def rel_gap(got, want, floor):
    """|got - want| / max(|want|, floor): the gap between two readings of
    one quantity, against the reference's reading or a floor."""
    return abs(got - want) / max(abs(want), floor)


def waveform_gap(got, want):
    """max over signals of ||got - want|| / ||want||; inf where a signal is
    missing or its length differs."""
    worst = 0.0
    for g, w in zip(got, want):
        if g is None or len(g) != len(w):
            return math.inf
        diff = float(((g - w) ** 2).sum())
        worst = max(worst, math.sqrt(diff / max(float((w ** 2).sum()),
                                                1e-30)))
    return worst
