"""BENCHMARK.json against the benchmark's contract, and every piece of a
cell found from its files by name."""
import os
import re

import pytest

from bench import manifest

MAN = manifest.load()
NAME = manifest.NAME
UNIT = manifest.UNIT
BENCH = manifest.BENCH


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "symbench/run.py"]
    assert MAN["paths"] == ["symbench"]
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MAN[group]:
            yield e["name"]
    for w in MAN["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in MAN["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_names_use_the_allowed_characters(name):
    assert NAME.match(name), name


def test_units_text_and_uniqueness():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in MAN[group]]
        assert len(names) == len(set(names)), group
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in MAN["workloads"]]
                 + [c["why"] for c in MAN["configs"]]
                 + [c["source"] for c in MAN["configs"]]
                 + [m["layer"] for m in MAN["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_end_to_end_metrics_and_bounds():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in MAN["workloads"]}
    for cell in cells:
        own = [m for m in MAN["end_to_end"]
               if cell in m.get("workloads", [cell])]
        assert len(own) >= 2 and any(m["name"] == "setup_s" for m in own)
        assert manifest.metrics_of(MAN, cell, True), cell


def test_each_per_layer_metric_moves_a_metric_its_cells_report():
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        moved = next(e for e in MAN["end_to_end"] if e["name"] == m["moves"])
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell]), (m["name"], cell)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_finds_its_files_by_name():
    configs = {c["name"]: c for c in MAN["configs"]}
    for w in MAN["workloads"]:
        c = configs[w["config"]]
        assert c["file"].startswith("symbench/configs/")
        arch = manifest.config(MAN, w["config"])
        assert arch["name"] == w["config"] and arch["source"] == c["source"]
        mix = manifest.traffic(w["traffic"])
        assert callable(manifest.loop(mix).run)
        assert callable(manifest.loop(mix).readings)
        assert callable(manifest.family(arch).ffn_weights)
        assert os.path.exists(os.path.join(BENCH, "limits",
                                           f"{w['name']}.json"))
        assert w["chips"] == 1
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        if m["name"] != "setup_s":
            assert callable(manifest.reader(m["name"])), m["name"]


def test_reduced_names_no_width_and_lists_each_change():
    width = re.compile(r"(hidden|intermediate|latent|state|_dim$|_rank$|"
                       r"head|expan|per_tok)")
    for c in MAN["configs"]:
        arch = manifest.config(MAN, c["name"])
        for key in c["reduced"]:
            assert not width.search(key), key
            assert key in arch.get("published", {}), key
        assert set(arch.get("published", {})) == set(c["reduced"])


def test_paths_hold_only_the_benchmark():
    root = os.path.dirname(BENCH)
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), root)
            assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", rel), rel
