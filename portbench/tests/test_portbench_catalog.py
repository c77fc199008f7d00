"""BENCHMARK.json against the benchmark's contract, and the harness finding
a configuration, a traffic mix, a metric and a cell added as new files."""

from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from portbench.harness.catalog import Catalog
from portbench.harness import runner
from portbench.tests import tiny

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        return json.load(fh)


def line_ok(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"][:2] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024


def test_configs(bench):
    used = {c["config"] for c in bench["workloads"]}
    for entry in bench["configs"]:
        assert set(entry) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(entry["name"]) and entry["name"] in used
        assert entry["file"].startswith("portbench/") and line_ok(entry["why"])
        with open(os.path.join(REPO, entry["file"])) as fh:
            config = json.load(fh)
        assert config["reduced"] == entry["reduced"] == []
        assert config["source"] == entry["source"]


def test_cells(bench):
    names = [c["name"] for c in bench["workloads"]]
    assert len(names) == len(set(names))
    pairs = {(c["config"], c["traffic"]) for c in bench["workloads"]}
    assert len(pairs) == len(names)
    four = sum(c["chips"] == 4 for c in bench["workloads"])
    assert four <= max(1, len(names) // 4)
    catalog = Catalog()
    for cell in bench["workloads"]:
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and line_ok(cell["why"])
        assert cell["chips"] in (1, 4)
        traffic = catalog.traffic(cell["traffic"])
        catalog.driver(traffic["driver"])
        assert catalog.limits(cell["name"])


def test_metrics(bench):
    catalog = Catalog()
    seen = set()
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in seen and UNIT.match(m["unit"])
        seen.add(m["name"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        catalog.reader(m["name"])
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {c["name"] for c in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and line_ok(m["layer"])
        for cell in m["workloads"]:
            # the cell reports the end-to-end metric this one moves
            assert cell in cells and cell in e2e[m["moves"]].get("workloads", [cell])
    for cell in bench["workloads"]:
        names = {m["name"] for m in catalog.metrics(cell["name"], trace=False)}
        assert "setup_s" in names and len(names) >= 2
        assert catalog.metrics(cell["name"], trace=True)


def test_rooflines_named_for_kernels(bench):
    for m in bench["per_layer"]:
        if "roofline" in m["name"]:
            assert m["unit"] == "%" and m["name"].split(".")[0].endswith("_roofline")


@pytest.fixture
def copy(tmp_path):
    """A copy of the benchmark (BENCHMARK.json and portbench/) to add files to."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    shutil.copytree(os.path.join(REPO, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def test_new_cell_config_mix_and_metric_are_files_only(copy):
    bench_dir = copy / "portbench"
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    config = json.loads((bench_dir / "configs" / "tbn_bninception_mha.json").read_text())
    config["name"] = "tbn_bninception_mha_fp32"
    config["overrides"] = config["overrides"] + ["tpu.compute_dtype=float32"]
    config["model"]["compute_dtype"] = "float32"
    (bench_dir / "configs" / "tbn_bninception_mha_fp32.json").write_text(json.dumps(config))
    mix = json.loads((bench_dir / "traffic" / "serve_b10_closed2.json").read_text())
    mix["clients"] = 1
    (bench_dir / "traffic" / "serve_b10_closed1.json").write_text(json.dumps(mix))
    (bench_dir / "metrics" / "requests_done.serve.py").write_text(
        "def read(record):\n    return float(len(record['latencies_s']))\n")
    (bench_dir / "limits" / "fp32.serve_b10_closed1.json").write_text(json.dumps(
        {"logits_rel_rmse": {"limit": 1e-4}}))
    spec = json.loads((copy / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tbn_bninception_mha_fp32", "source": config["source"],
                            "file": "portbench/configs/tbn_bninception_mha_fp32.json",
                            "reduced": [], "why": "float32"})
    spec["workloads"].append({"name": "fp32.serve_b10_closed1", "config": "tbn_bninception_mha_fp32",
                              "traffic": "serve_b10_closed1", "chips": 1, "why": "one client"})
    for m in spec["end_to_end"]:
        if m["name"].startswith("serve_"):
            m["workloads"].append("fp32.serve_b10_closed1")
    spec["per_layer"].append({"name": "requests_done.serve", "unit": "requests",
                              "better": "higher", "source": "host_clock", "layer": "serve front",
                              "moves": "serve_clips_per_s",
                              "workloads": ["fp32.serve_b10_closed1"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(spec))
    after = {p: p.read_bytes() for p in before}
    assert after == before  # nothing that was there changed

    catalog = Catalog(repo=str(copy), bench=str(bench_dir))
    assert [m["name"] for m in catalog.metrics("fp32.serve_b10_closed1", trace=True)] == [
        "requests_done.serve"]
    run = tiny.small_run("fp32.serve_b10_closed1", catalog=catalog)
    assert run.traffic["clients"] == 2  # the small size's; the mix itself says 1
    run.traffic["clients"] = 1
    record = catalog.driver(run.traffic["driver"]).run(run)
    record["power_limit_w"] = None
    run.trace = True
    line = runner.result_line(run, record, catalog)
    assert line["correct"]
    assert line["metrics"]["requests_done.serve"]["value"] == len(record["latencies_s"]) > 0
    assert list(line)[-1] == "checks"
