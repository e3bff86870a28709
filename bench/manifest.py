"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration under ``configs/`` and its generator under ``generators/``,
its traffic mix under ``traffic/``, the mix's algorithm under
``algorithms/`` and its per-job draws under ``draws/``, and each metric's
reader under ``metrics/``."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def config(name: str) -> dict:
    return _json(BENCH / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return _json(BENCH / "traffic" / f"{name}.json")


def _module(kind: str, name: str):
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def algorithm(name: str):
    return _module("algorithms", name)


def generator(name: str):
    return _module("generators", name)


def draw(name: str):
    return _module("draws", name)


def metric_reader(name: str):
    return _module("metrics", name)


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def metrics_of(manifest: dict, workload: str, trace: bool) -> list:
    """The metrics a run of ``workload`` reports: its end-to-end metrics,
    or with ``trace`` its per-layer ones."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in manifest[kind] if applies(m, workload)]
