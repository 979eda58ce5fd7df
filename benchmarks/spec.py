"""The cells of ``BENCHMARK.json`` and the files their names resolve to.

A cell names a configuration (its ``file`` in ``BENCHMARK.json``) and a
traffic mix (``benchmarks/traffic/<traffic>.json``); its correctness
limits are ``benchmarks/limits/<cell>.json``; each per-layer metric is
read by ``read(trace)`` in ``benchmarks/metrics/<metric>.py``.  A cell, a
configuration, a mix or a metric is added as new files and a new entry in
``BENCHMARK.json``: no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    root: Path

    @property
    def flow(self) -> dict:
        """The flow settings as run: the configuration's, then the mix's."""
        return {**self.config["flow"], **self.traffic["flow"]}

    @property
    def shape(self) -> tuple:
        return tuple(self.config["volume"]["shape"])


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def load(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` with its configuration, mix, limits and the
    metrics it reports."""
    bench = benchmark(root)
    cell = _named(bench["workloads"], workload, "workload")
    config = _named(bench["configs"], cell["config"], "configuration")
    here = root / "benchmarks"

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    return Cell(
        name=workload, chips=int(cell["chips"]),
        config=json.loads((root / config["file"]).read_text()),
        traffic=json.loads((here / "traffic" / f"{cell['traffic']}.json")
                           .read_text()),
        limits=json.loads((here / "limits" / f"{workload}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)],
        root=root)


def reader(metric: str, root: Path = ROOT):
    """``read`` of ``benchmarks/metrics/<metric>.py``: trace -> value, or
    None where the trace holds nothing to read."""
    path = root / "benchmarks" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmarks.metrics." + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
