"""The benchmark's data, found by name.

A cell is one entry of ``workloads`` in ``BENCHMARK.json``.  Everything that
belongs to one configuration, one traffic mix, one cell's limits or one
per-layer metric sits in a file of its own, which is looked up here by the
name the cell gives:

    bench/configs/<config>.json    sizes, source, cuts, the port config, the reference
    bench/traffic/<mix>.json       the job: batch, lengths, token law, optimizer
    bench/limits/<cell>.json       what the check compares and each number's limit
    bench/metrics/<metric>.py      a reader: ``read(ctx) -> float | None``
    bench/roofline/<op>.py         operations and bytes of one op for its shapes

Adding a cell, a configuration, a mix or a metric is adding files and
entries; nothing here names any of them.
"""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    bench: Path

    def metrics(self, trace: bool) -> list:
        return self.per_layer if trace else self.end_to_end


def _read_json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def _data(bench: Path, kind: str, name: str, suffix: str) -> Path:
    if not _NAME.match(name):
        raise ValueError(f"{kind} name {name!r} is not a benchmark name")
    return bench / kind / f"{name}{suffix}"


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, *, root: Path = ROOT, bench: Path = BENCH) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files from
    ``bench``, and the metrics that it reports."""
    spec = _read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = dict(_read_json(root / configs[w["config"]]["file"]))
    config.setdefault("name", w["config"])
    traffic = dict(_read_json(_data(bench, "traffic", w["traffic"], ".json")))
    traffic.setdefault("name", w["traffic"])
    limits = _read_json(_data(bench, "limits", name, ".json"))
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic, limits=limits,
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)],
        bench=bench)


def load_module(path: Path, prefix: str) -> ModuleType:
    """A Python file of the benchmark's data (a metric reader, a roofline
    formula, a reference) loaded by path: its name may hold dots."""
    mod_name = f"_bench_{prefix}_" + re.sub(r"\W", "_", path.stem)
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench: Path = BENCH) -> ModuleType:
    return load_module(_data(bench, "metrics", name, ".py"), "metric")


def roofline(op: str, bench: Path = BENCH) -> ModuleType:
    return load_module(_data(bench, "roofline", op, ".py"), "roofline")


def reference(config: dict, bench: Path = BENCH) -> ModuleType:
    """The plain reference that the configuration names (``reference``)."""
    return load_module(_data(bench, "reference", config["reference"], ".py"), "reference")


def peaks(kind: str, bench: Path = BENCH) -> dict | None:
    """The published peaks of the device ``kind`` (``torch.cuda.get_device_name``),
    or None for a device the table does not hold."""
    table = _read_json(bench / "peaks.json")
    for entry in table["devices"]:
        if entry["match"] in kind:
            return entry
    return None
