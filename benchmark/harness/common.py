"""What every cell shares: the benchmark's files found by name, the device
and its description, the result line, the import guard."""

from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys
from typing import Callable, Dict, List

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "unit_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A module from a file under ``benchmark/`` (names may hold '-' and '.')."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of BENCHMARK.json with everything it names: its
    configuration file, its traffic file, its reference module and the
    readers of its per-layer metrics."""

    def __init__(self, spec: dict, workload: str, bench_dir: str = BENCH):
        cells = {w["name"]: w for w in spec["workloads"]}
        if workload not in cells:
            raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                             f"(have {sorted(cells)})")
        self.spec = spec
        self.workload = cells[workload]
        self.name = workload
        configs = {c["name"]: c for c in spec["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = load_json(os.path.dirname(bench_dir), self.config_entry["file"])
        self.mix = load_json(bench_dir, "traffic", self.workload["traffic"] + ".json")
        self.limits = load_json(bench_dir, "limits", workload + ".json")["limits"]
        self.reference = load_module(
            os.path.join(bench_dir, "reference", self.workload["config"] + ".py"),
            "reference_" + self.workload["config"].replace("-", "_"))
        self.end_to_end = [m for m in spec["end_to_end"] if self._has(m)]
        self.per_layer = [m for m in spec["per_layer"] if self._has(m)]
        self.readers = {m["name"]: load_module(
            os.path.join(bench_dir, "metrics", m["name"] + ".py"),
            "metric_" + m["name"].replace(".", "_")).read for m in self.per_layer}

    def _has(self, metric: dict) -> bool:
        if "workloads" in metric:
            return self.name in metric["workloads"]
        if metric.get("moves"):  # a per-layer metric without the key: every cell of its metric
            moved = next(m for m in self.spec["end_to_end"] if m["name"] == metric["moves"])
            return self._has(moved)
        return True


def device_info(count: int, dev=None) -> dict:
    import torch

    if dev is not None and dev.type != "cuda":  # a rehearsal: no device numbers
        return {"platform": dev.type, "kind": dev.type, "count": count, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(count)))}


def synchronizer(dev) -> Callable[[], None]:
    import torch

    return torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)


def empty_cache(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.empty_cache()


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def metric(value: float, unit: str) -> dict:
    return {"value": float(value), "unit": unit}


def read_layers(cell: Cell, run: dict) -> Dict[str, dict]:
    """Each per-layer metric of the cell that its reader finds."""
    out = {}
    for m in cell.per_layer:
        value = cell.readers[m["name"]](run)
        if value is not None and math.isfinite(value):
            out[m["name"]] = metric(value, m["unit"])
    return out


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def judge(checks: Dict[str, dict]) -> bool:
    return all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in checks.values())
