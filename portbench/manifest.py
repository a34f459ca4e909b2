"""The benchmark's manifest and the files it names.

``BENCHMARK.json`` at the root of the checkout names the cells; each cell
names a configuration and a traffic mix, and each metric its reader.  The
harness finds every one of them by name:

- a configuration ``<name>``: ``portbench/configs/<name>.json``;
- a traffic mix ``<name>``: ``portbench/traffic/<name>.json``;
- a per-layer metric ``<name>``: ``portbench/metrics/<name>.py``, a module
  with ``read(ctx)`` that returns the value or None;
- a cell's limits for ``correct``: ``portbench/limits/<workload>.json``.

A later change adds a configuration, a mix, a metric or a cell by adding
files and entries, never by editing one that is here.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def check_names(manifest: dict) -> list[str]:
    """Every name, unit and traffic key against the manifest's rules;
    the list of faults found (empty when sound)."""
    faults = []
    names = []
    for c in manifest.get("configs", []):
        names.append(c["name"])
        names.extend(c.get("reduced", []))
    for w in manifest.get("workloads", []):
        names += [w["name"], w["config"], w["traffic"]]
    for kind in ("end_to_end", "per_layer"):
        for m in manifest.get(kind, []):
            names.append(m["name"])
            if not UNIT_RE.match(m["unit"]):
                faults.append(f"unit {m['unit']!r} of {m['name']}")
    for n in names:
        if not NAME_RE.match(n):
            faults.append(f"name {n!r}")
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [e["name"] for e in manifest.get(kind, [])]
        if len(seen) != len(set(seen)):
            faults.append(f"duplicate names in {kind}")
    return faults


def workload(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _json_by_name(kind: str, name: str, root: Path) -> dict:
    if not NAME_RE.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    with open(root / "portbench" / kind / f"{name}.json") as f:
        return json.load(f)


def config(name: str, root: Path = ROOT) -> dict:
    return _json_by_name("configs", name, root)


def traffic(name: str, root: Path = ROOT) -> dict:
    return _json_by_name("traffic", name, root)


def limits(workload_name: str, root: Path = ROOT) -> dict:
    return _json_by_name("limits", workload_name, root)


def cell_metrics(manifest: dict, workload_name: str, kind: str) -> list:
    """The metrics of ``kind`` ("end_to_end" or "per_layer") that the
    cell reports: those that list it, and those without a ``workloads``
    key that move an end-to-end metric the cell reports."""
    e2e = [m for m in manifest["end_to_end"]
           if workload_name in m.get("workloads", [workload_name])]
    if kind == "end_to_end":
        return e2e
    e2e_names = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if (workload_name in m["workloads"] if "workloads" in m
                else m["moves"] in e2e_names)]


def metric_reader(name: str, root: Path = ROOT):
    """The ``read(ctx)`` of ``portbench/metrics/<name>.py``."""
    if not NAME_RE.match(name):
        raise ValueError(f"bad metric name {name!r}")
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
