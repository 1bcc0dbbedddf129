"""BENCHMARK.json against the contract's shape, and every name in it
resolving to its file; a new cell is found from its files alone."""
import json
import re
import shutil

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in SPEC["command"])


@pytest.mark.parametrize("kind,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entries_have_the_contract_keys(kind, keys):
    names = [e["name"] for e in SPEC[kind]]
    assert len(names) == len(set(names))
    for e in SPEC[kind]:
        assert set(e) - {"workloads"} == keys, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for text in ("why", "layer", "source"):
            if text in e:
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] and "\t" not in e[text]


def test_every_name_resolves_to_its_file():
    cells = {w["name"]: w for w in SPEC["workloads"]}
    configs = {c["name"] for c in SPEC["configs"]}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for c in SPEC["configs"]:
        assert (harness.ROOT / c["file"]).is_file()
        assert c["file"].startswith("benchmark/")
    for name, w in cells.items():
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (harness.BENCH / "workloads" / f"{name}.json").is_file()
        assert (harness.BENCH / "traffic" / f"{w['traffic']}.py").is_file()
        cell = harness.load_cell(name)
        assert cell.params["limits"]
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert callable(harness.metric_reader(m["name"]))
        assert set(m.get("workloads", [])) <= set(cells)


def test_a_new_cell_is_found_from_its_files_alone(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    first = spec["workloads"][0]
    spec["workloads"].append(dict(first, name="extra.cell", why="a cell added as data"))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    params = json.loads((harness.BENCH / "workloads" / f"{first['name']}.json").read_text())
    params["steps"] = 7
    (root / "benchmark" / "workloads" / "extra.cell.json").write_text(json.dumps(params))
    cell = harness.load_cell("extra.cell", root=root)
    assert cell.params["steps"] == 7 and cell.entry["config"] == first["config"]
    assert [m["name"] for m in cell.end_to_end] == [
        m["name"] for m in SPEC["end_to_end"] if "workloads" not in m]
