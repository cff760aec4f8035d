"""BENCHMARK.json against the contract's shape, and the harness finding
each cell's files by name, also a cell added with new files only."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_and_units(section):
    names = [e["name"] for e in SPEC[section]]
    assert len(names) == len(set(names))
    for e in SPEC[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]


def test_bounds_and_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_found_by_name(cell):
    from portbench import run

    c = run.load_cell(cell)
    assert c["cell"]["chips"] == 1
    assert (ROOT / "portbench" / "entries"
            / f"{c['traffic']['entry']}.py").is_file()
    for m in c["per_layer"]:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
    assert set(c["limits"]) == {"chi2_gap", "sigma_rel"}
    names = {m["name"] for m in c["end_to_end"]}
    assert {"fit_ms", "setup_s"} <= names


def test_config_files_state_their_cut():
    """Each configuration's file lists the keys it changes from its
    source as BENCHMARK.json does, each a key of the file, and says what
    it assumes."""
    for conf in SPEC["configs"]:
        data = json.loads((ROOT / conf["file"]).read_text())
        assert data["reduced"] == conf["reduced"]
        assert data["source"] == conf["source"]
        assert all(k in data for k in data["reduced"])
        assert data["assumed"]


def test_new_files_only_make_a_new_cell(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files and new BENCHMARK.json entries are found, no file edited."""
    copy = tmp_path / "repo"
    copy.mkdir()
    shutil.copytree(ROOT / "portbench", copy / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (copy / "portbench").rglob("*")
              if p.is_file()}
    spec = json.loads(json.dumps(SPEC))
    (copy / "portbench" / "configs" / "tiny.json").write_text(
        (ROOT / "portbench" / "configs" / "gls100k.json").read_text())
    (copy / "portbench" / "traffic" / "refit.json").write_text(json.dumps(
        {"entry": "hybrid", "loop": "closed", "clients": 1, "maxiter": 5,
         "warm_fits": 1, "traced_fits": 1, "judged_answers": 1}))
    (copy / "portbench" / "metrics" / "fits_in_window.py").write_text(
        "def read(ctx):\n    return ctx['window']['fits']\n")
    (copy / "portbench" / "checks" / "tiny.refit.json").write_text(
        '{"chi2_gap": 1e-5, "sigma_rel": 1e-2}')
    spec["configs"].append({"name": "tiny", "source": "https://example.org",
                            "file": "portbench/configs/tiny.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "tiny.refit", "config": "tiny",
                              "traffic": "refit", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "fits_in_window", "unit": "fits",
                              "better": "higher", "source": "host_clock",
                              "layer": "Fit driver and fused loop",
                              "moves": "fit_ms"})
    (copy / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import sys, json; sys.path.insert(0, '.');"
            "from portbench import run; c = run.load_cell('tiny.refit');"
            "import importlib;"
            "m = [importlib.import_module('portbench.metrics.' + x['name'])"
            " for x in c['per_layer']];"
            "print(json.dumps([c['traffic']['entry'], c['config']['toas_per_pulsar'],"
            " [x['name'] for x in c['per_layer']],"
            " m[-1].read({'window': {'fits': 7}})]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=copy, check=True,
                         capture_output=True, text=True).stdout
    entry, n, metrics, fits = json.loads(out.strip().splitlines()[-1])
    assert entry == "hybrid" and n == 100_000 and fits == 7
    assert metrics[-1] == "fits_in_window" and "idle_share" in metrics
    after = {p: p.read_bytes() for p in before}
    assert after == before
