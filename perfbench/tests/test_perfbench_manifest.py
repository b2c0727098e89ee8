"""BENCHMARK.json against the benchmark's contract, and that a new cell,
traffic mix, configuration and metric are found as files alone."""

import json
import os
import re
import shutil
import subprocess
import sys


from perfbench.harness import HERE, ROOT, load_cell, load_json

MANIFEST = load_json(os.path.join(ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(MANIFEST["command"]) <= 32
    assert all(LINE.match(w) for w in MANIFEST["command"])
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    rs = MANIFEST["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


def test_names_units_and_lines():
    names = []
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"])
        assert LINE.match(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("perfbench/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        names.append(c["name"])
    cells = []
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] == 1
        assert LINE.match(w["why"])
        cells.append(w["name"])
    assert len(set(cells)) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in MANIFEST["workloads"]}) \
        == len(cells)
    assert {w["config"] for w in MANIFEST["workloads"]} == set(names)
    e2e = {}
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                           "source"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= set(cells)
        e2e[m["name"]] = m
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    layers = set()
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                           "layer", "moves"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert LINE.match(m["layer"]) and m["moves"] in e2e
        for c in m["workloads"]:
            assert c in e2e[m["moves"]].get("workloads", cells)
        layers.add(m["layer"])
    all_names = [m["name"] for m in MANIFEST["end_to_end"]
                 + MANIFEST["per_layer"]]
    assert len(set(all_names)) == len(all_names)
    for cell in cells:      # setup_s, another end-to-end, a per-layer one
        got = [n for n, m in e2e.items() if cell in m.get("workloads", cells)]
        assert "setup_s" in got and len(got) >= 2
        assert any(cell in m["workloads"] for m in MANIFEST["per_layer"])


def test_every_name_has_its_files():
    for w in MANIFEST["workloads"]:
        cell = load_cell(w["name"], MANIFEST)
        assert cell.model and cell.mix and cell.work["check"]["limits"]
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert os.path.exists(os.path.join(HERE, "metrics", m["name"] + ".py"))
    for w in MANIFEST["workloads"]:
        limits = load_cell(w["name"], MANIFEST).work["check"]["limits"]
        assert all(isinstance(v, (int, float)) for v in limits.values())


NEW_FILES = {
    "perfbench/traffic/sat128.json": None,           # copied from sat512
    "perfbench/configs/vi-ctc-copy.json": None,      # copied from vi config
    "perfbench/workloads/vi-ctc-copy.sat128.json": {
        "config": "vi-ctc-copy", "traffic": "sat128", "serving": {},
        "trace": {"offset_s": 1.0, "seconds": 1.0},
        "check": {"sample_streams": 2, "limits": {"route_mismatches": 0}}},
    "perfbench/metrics/chunks_per_s.py":
        "def read(run):\n    return run.chunks / run.window_s\n",
}

PROBE = """
import json
from perfbench import harness
from perfbench.run import cell_metrics, load_reader
man = json.load(open("BENCHMARK.json"))
cell = harness.load_cell("vi-ctc-copy.sat128", man)
run = harness.RunRecord(cell.name, cell.mix["loop"], cell.model, 64, 0.64,
                        window_s=2.0, chunks=10)
names = [m["name"] for m in cell_metrics(man, cell.name, True)]
print(json.dumps({"streams": cell.mix["streams"], "metrics": names,
                  "value": load_reader("chunks_per_s").read(run)}))
"""


def test_new_cell_mix_config_and_metric_are_files_alone(tmp_path):
    shutil.copytree(HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads(json.dumps(MANIFEST))
    for rel, body in NEW_FILES.items():
        path = tmp_path / rel
        if rel.endswith("sat128.json") and "traffic" in rel:
            mix = load_json(os.path.join(HERE, "traffic", "sat512.json"))
            body = dict(mix, streams=128)
        elif "configs" in rel:
            body = load_json(os.path.join(HERE, "configs",
                                          "vi-ctc-emformer20.json"))
        path.write_text(body if isinstance(body, str) else json.dumps(body))
    man["configs"].append({"name": "vi-ctc-copy", "source": "x",
                           "file": "perfbench/configs/vi-ctc-copy.json",
                           "reduced": [], "why": "a copy"})
    man["workloads"].append({"name": "vi-ctc-copy.sat128",
                             "config": "vi-ctc-copy", "traffic": "sat128",
                             "chips": 1, "why": "a smaller closed loop"})
    man["end_to_end"][0]["workloads"].append("vi-ctc-copy.sat128")
    man["per_layer"].append({"name": "chunks_per_s", "unit": "chunks/s",
                             "better": "higher", "source": "host_clock",
                             "layer": "scheduler", "moves": "rt_streams",
                             "workloads": ["vi-ctc-copy.sat128"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"streams": 128, "metrics": ["chunks_per_s"], "value": 5.0}
