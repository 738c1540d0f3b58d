"""Finding a cell's pieces by name: ``BENCHMARK.json`` at the checkout's
root names the cell, its configuration file and its traffic mix; the mix
is ``symbench/traffic/<traffic>.json``, the loop it names
``symbench/loops/<loop>.py``, a configuration's model family
``symbench/families/<family>.py`` (its reference side
``symbench/refs/<family>.py``), a metric's reader
``symbench/metrics/<name>.py`` and a cell's limits
``symbench/limits/<cell>.json``."""
from __future__ import annotations

import importlib.util
import json
import os
import re
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(man: dict, name: str, root: str = ROOT) -> dict:
    for c in man["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    with open(os.path.join(BENCH, "traffic", f"{name}.json")) as f:
        return json.load(f)


def metrics_of(man: dict, cell: str, trace: bool):
    """The cell's metrics: its end-to-end ones, or with ``trace`` its
    per-layer ones (a metric without ``workloads`` is every cell's)."""
    group = man["per_layer"] if trace else man["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def module(kind: str, name: str):
    """``symbench/<kind>/<name>.py``, loaded once."""
    key = f"symbench_{kind}_" + re.sub(r"\W", "_", name)
    if key not in sys.modules:
        path = os.path.join(BENCH, kind, f"{name}.py")
        if not os.path.exists(path):
            raise KeyError(f"no {kind} {name!r}: {path} is missing")
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


def loop(mix: dict):
    """The loop module a traffic mix names: ``run`` and ``readings``."""
    return module("loops", mix["loop"])


def family(arch: dict):
    """The model family module of a configuration file."""
    return module("families", arch["family"])


def reader(name: str):
    """The ``read(run)`` function of ``metrics/<name>.py``; a name with a
    ``.suffix`` that has no file of its own (``device_idle_pct.moe``) reads
    with the file of the name before its last dot."""
    base = name
    while not os.path.exists(os.path.join(BENCH, "metrics", f"{base}.py")) \
            and "." in base:
        base = base.rsplit(".", 1)[0]
    return module("metrics", base).read
