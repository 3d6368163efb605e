"""The manifest keeps the contract's form, and every name in it finds its
file."""

import json
import re

import pytest

from conftest import ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def _all_metrics():
    return MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "lapbench/run.py"]
    assert MANIFEST["paths"] == ["lapbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units_use_allowed_characters():
    names = [c["name"] for c in MANIFEST["configs"]] + [w["name"] for w in MANIFEST["workloads"]]
    names += [m["name"] for m in _all_metrics()]
    names += [w["config"] for w in MANIFEST["workloads"]] + [w["traffic"] for w in MANIFEST["workloads"]]
    names += [k for c in MANIFEST["configs"] for k in c["reduced"]]
    for name in names:
        assert NAME.match(name), name
    for m in _all_metrics():
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in MANIFEST["workloads"]] + [c["why"] for c in MANIFEST["configs"]]
                 + [c["source"] for c in MANIFEST["configs"]] + [m["layer"] for m in MANIFEST["per_layer"]]):
        assert TEXT.match(text), text


def test_names_are_unique():
    for group in (MANIFEST["configs"], MANIFEST["workloads"], _all_metrics()):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_entries_have_just_the_contract_keys():
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("workload", [w["name"] for w in MANIFEST["workloads"]])
def test_every_cell_finds_its_files(workload):
    from lapbench import manifest

    cell = manifest.Cell(ROOT, workload)
    assert (ROOT / cell.config_entry["file"]).is_file()
    assert str(cell.config_entry["file"]).startswith("lapbench/")
    for metric, reader in cell.readers(False) + cell.readers(True):
        assert callable(reader.read), metric["name"]
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in MANIFEST["per_layer"]])
def test_per_layer_cells_report_what_it_moves(metric):
    m = next(x for x in MANIFEST["per_layer"] if x["name"] == metric)
    moved = next(x for x in MANIFEST["end_to_end"] if x["name"] == m["moves"])
    cells = m.get("workloads", [w["name"] for w in MANIFEST["workloads"]])
    for cell in cells:
        assert "workloads" not in moved or cell in moved["workloads"], (metric, cell)


def test_layers_have_one_spelling_per_metric_family():
    layers = {m["layer"] for m in MANIFEST["per_layer"]}
    assert all(TEXT.match(layer) for layer in layers)


def test_every_config_has_a_cell_and_no_cell_takes_four_chips():
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
    assert all(w["chips"] == 1 for w in MANIFEST["workloads"])


def test_files_of_configs_are_distinct_and_hold_no_widths_in_reduced():
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    for c in MANIFEST["configs"]:
        for key in c["reduced"]:
            assert not re.search(r"(hidden|_dim|_rank|head|intermediate)", key), key


def test_run_seconds_fit_the_check_with_24_cells():
    s = MANIFEST["run_seconds"]
    cells = 24
    total = (2 + 14 * cells) * (s + 60) + cells * 2 * 90 + 1200
    assert total <= 43200
