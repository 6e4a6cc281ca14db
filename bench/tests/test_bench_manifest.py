"""BENCHMARK.json against the limits the benchmark keeps to, and every file it names
found by name."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = ("hidden", "intermediate", "latent", "state", "proj", "head", "expand",
          "experts_per_tok", "top_k")
CELLS = [w["name"] for w in MAN["workloads"]]


def test_keys_and_limits():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert 1 <= len(MAN["paths"]) <= 16 and all(
        re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and (ROOT / p).is_dir() for p in MAN["paths"])
    assert len(MAN["command"]) <= 32
    for word in MAN["command"][1:]:
        assert not word.startswith("/") and ".." not in word
        if (ROOT / word).exists():
            assert any(Path(word).parts[0] == Path(p).parts[0] for p in MAN["paths"])
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    n = len(MAN["workloads"])
    assert (2 + 14 * 24) * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert 1 <= n <= 24 and 1 <= len(MAN["configs"]) <= 24
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_keys(section):
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                             "workloads"}}[section]
    names = [e["name"] for e in MAN[section]]
    assert len(names) == len(set(names))
    for e in MAN[section]:
        assert set(e) <= allowed and set(e) >= allowed - {"workloads"}, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    if section in ("end_to_end", "per_layer"):
        srcs = {"end_to_end": {"host_clock", "device_trace"},
                "per_layer": {"host_clock", "device_trace", "program_span",
                              "program_counter"}}[section]
        assert all(e["source"] in srcs for e in MAN[section])


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert 1 <= len(e2e) <= 16
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    from bench import harness

    c = harness.load_cell(cell, ROOT)
    w = [w for w in MAN["workloads"] if w["name"] == cell][0]
    assert c.chips == 1 and NAME.match(w["traffic"]) and NAME.match(w["config"])
    assert len(w["why"]) <= 200
    assert c.config["name"] == w["config"]
    assert set(harness.NUMBERS) <= set(c.limits)
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in reported, m["name"]
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    for m in c.end_to_end:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


def test_every_metric_entry_lists_existing_cells():
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert set(m.get("workloads", CELLS)) <= set(CELLS), m["name"]
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("conf", [c["name"] for c in MAN["configs"]])
def test_config_files(conf):
    c = [c for c in MAN["configs"] if c["name"] == conf][0]
    assert c["file"].startswith("bench/") and (ROOT / c["file"]).is_file()
    assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for k in c["reduced"]:
        assert not k.endswith(("_dim", "_rank")) and not any(w in k for w in WIDTHS), k
    body = json.loads((ROOT / c["file"]).read_text())
    assert body["name"] == conf and set(c["reduced"]) <= set(body)
    assert sum(1 for x in MAN["workloads"] if x["config"] == conf) >= 1
