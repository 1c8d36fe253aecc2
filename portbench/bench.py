"""What the benchmark is, read from data: ``BENCHMARK.json`` at the root
and, under this package, one file for each configuration (``configs/``,
named in ``BENCHMARK.json``), traffic mix (``mixes/<mix>.json``), cell
(``cells/<cell>.json``: how many served requests or steps the check
judges, and the limit of each number compared) and metric
(``metrics/<metric>.py``, a reader ``read(rec) -> number or None``), and
one driver for each kind of mix (``drivers/<kind>.py``). A new
configuration, mix, cell or metric is a new file; nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def reader(name: str, pkg: Path = PKG):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = pkg / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reports(metric: dict, cell: str, bench: dict) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    lists; without the key, every cell that reports the end-to-end metric
    it moves (an end-to-end metric without the key: every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        e2e = next(m for m in bench["end_to_end"] if m["name"] == metric["moves"])
        return reports(e2e, cell, bench)
    return True


def metrics_of(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` prints: its end-to-end metrics, or
    with ``trace`` its per-layer ones."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if reports(m, cell, bench)]


def validate(bench: dict, root: Path = ROOT, pkg: Path = PKG) -> list[str]:
    """Every fault of ``bench`` against the files it names: names and units,
    sources, each cell's configuration, mix and cell file, each metric's
    reader, ``moves`` naming an end-to-end metric that each cell reporting
    the per-layer metric reports, and every cell reporting ``setup_s``,
    another end-to-end metric and a per-layer one."""
    errs = []
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = {w["name"]: w for w in bench["workloads"]}
    configs = {c["name"]: c for c in bench["configs"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if not NAME.match(m["name"]):
            errs.append(f"metric name {m['name']!r}")
        if not UNIT.match(m["unit"]):
            errs.append(f"{m['name']}: unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            errs.append(f"{m['name']}: better {m['better']!r}")
        if m["source"] not in SOURCES:
            errs.append(f"{m['name']}: source {m['source']!r}")
        if not (pkg / "metrics" / f"{m['name']}.py").is_file():
            errs.append(f"{m['name']}: no reader metrics/{m['name']}.py")
        for w in m.get("workloads", []):
            if w not in cells:
                errs.append(f"{m['name']}: unknown workload {w!r}")
    for m in bench["end_to_end"]:
        if m["source"] not in ("host_clock", "device_trace"):
            errs.append(f"{m['name']}: an end-to-end metric's source")
    if "setup_s" not in e2e:
        errs.append("no setup_s")
    for m in bench["per_layer"]:
        if m["moves"] not in e2e:
            errs.append(f"{m['name']}: moves {m['moves']!r}, not an end-to-end metric")
            continue
        for w in cells:
            if reports(m, w, bench) and not reports(e2e[m["moves"]], w, bench):
                errs.append(f"{m['name']} in {w}, which does not report {m['moves']}")
    for c in bench["configs"]:
        if not NAME.match(c["name"]):
            errs.append(f"config name {c['name']!r}")
        if not (root / c["file"]).is_file():
            errs.append(f"{c['name']}: no file {c['file']}")
    for w, cell in cells.items():
        if not NAME.match(w) or not NAME.match(cell["traffic"]):
            errs.append(f"cell {w!r} or its traffic {cell['traffic']!r}")
        if cell["config"] not in configs:
            errs.append(f"{w}: unknown config {cell['config']!r}")
        mix = pkg / "mixes" / f"{cell['traffic']}.json"
        if not mix.is_file():
            errs.append(f"{w}: no mix file {mix.name}")
        elif not (pkg / "drivers" / f"{load_json(mix)['kind']}.py").is_file():
            errs.append(f"{w}: no driver for kind {load_json(mix)['kind']!r}")
        if not (pkg / "cells" / f"{w}.json").is_file():
            errs.append(f"{w}: no cell file cells/{w}.json")
        mine = [m["name"] for m in metrics_of(bench, w, False)]
        if "setup_s" not in mine or len(mine) < 2:
            errs.append(f"{w}: reports {mine}: setup_s and another end-to-end metric")
        if not metrics_of(bench, w, True):
            errs.append(f"{w}: no per-layer metric")
    return errs
