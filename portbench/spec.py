"""Finds what a cell is made of by name, so that a configuration, a
traffic mix, a loop kind or a metric is added as a new file alone:

- ``BENCHMARK.json`` at the checkout's root: the cells and the metrics;
- ``portbench/configs/<config>.json``: model file, numerics, max_batch;
- ``portbench/traffic/<traffic>.json``: the loop kind and its parameters;
- ``portbench/loops/<kind>.py``: a loop kind, with ``run(...)``;
- ``portbench/metrics/<metric>.py``, else ``<metric before its first
  dot>.py``: a metric's reader, with ``read(run)``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from types import ModuleType
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))


def root_of(here: str = HERE) -> str:
    """The checkout's root: the directory that holds ``portbench``."""
    return os.path.dirname(here)


def bench_dir(root: str) -> str:
    return os.path.join(root, "portbench")


def benchmark(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _names(root: str, sub: str, ext: str) -> List[str]:
    d = os.path.join(bench_dir(root), sub)
    return sorted(n[: -len(ext)] for n in os.listdir(d)
                  if n.endswith(ext) and not n.startswith("_"))


def list_configs(root: str) -> List[str]:
    return _names(root, "configs", ".json")


def list_traffic(root: str) -> List[str]:
    return _names(root, "traffic", ".json")


def list_loops(root: str) -> List[str]:
    return _names(root, "loops", ".py")


def list_metrics(root: str) -> List[str]:
    return _names(root, "metrics", ".py")


def _json(root: str, sub: str, name: str) -> dict:
    path = os.path.join(bench_dir(root), sub, f"{name}.json")
    if not os.path.isfile(path):
        raise KeyError(f"no {sub[:-1] if sub.endswith('s') else sub} "
                       f"named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def config(root: str, name: str) -> dict:
    return _json(root, "configs", name)


def traffic(root: str, name: str) -> dict:
    return _json(root, "traffic", name)


def cell(root: str, workload: str) -> Dict[str, object]:
    """The workload entry of ``BENCHMARK.json`` with its configuration
    and traffic files read, and the metrics it reports."""
    bench = benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload named {workload!r} in BENCHMARK.json")
    w = entries[workload]

    def reported(m: dict, e2e: List[str]) -> bool:
        # a metric without a workloads list is every cell's, a per-layer
        # one every cell's that reports the end-to-end metric it moves
        if "workloads" in m:
            return workload in m["workloads"]
        return "moves" not in m or m["moves"] in e2e

    e2e = [m for m in bench["end_to_end"] if reported(m, [])]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if reported(m, e2e_names)]
    return dict(workload=w, config=config(root, w["config"]),
                traffic=traffic(root, w["traffic"]), end_to_end=e2e,
                per_layer=per_layer)


def _module(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def loop(root: str, kind: str) -> ModuleType:
    path = os.path.join(bench_dir(root), "loops", f"{kind}.py")
    if not os.path.isfile(path):
        raise KeyError(f"no loop kind {kind!r} ({path})")
    return _module(path, f"portbench_loop_{kind}")


def reader(root: str, metric: str) -> Callable:
    """The ``read(run)`` of ``metric``: its own file, else the file of its
    name before the first dot (``nonconv_ms.py`` reads ``nonconv_ms.video``)."""
    d = os.path.join(bench_dir(root), "metrics")
    for name in (metric, metric.split(".", 1)[0]):
        path = os.path.join(d, f"{name}.py")
        if os.path.isfile(path):
            mod = _module(path, "portbench_metric_" + name.replace(".", "_"))
            return mod.read
    raise KeyError(f"no reader for metric {metric!r} under {d}")
