"""The harness's last line has exactly the contract's keys, a run
without a card exits non-zero with no result, and the registry finds a
configuration, a mix and a per-layer metric added as new files."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

import run as bench
from benchlib import registry
from tiny import Opts, job_cell

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _outcome(trace):
    out = registry.driver("similar_job").run(job_cell(), Opts(trace=False))
    if trace:
        out["obs"]["device"] = {"busy_s": 0.5, "window_s": 1.0,
                                "kernels": {"topk_kernel": 0.01},
                                "device_ops": [["topk_kernel", 0.01]],
                                "idle_gaps": [["job", 0.2]]}
    return out


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_keys(monkeypatch, trace):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    cell = registry.load_cell(ROOT, "bert-similar-job")
    line = bench.result_line(cell, _outcome(trace), trace)
    want = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == want
    assert set(line["device"]) == (
        {"platform", "kind", "count", "memory_peak_bytes"}
        | ({"busy_s", "window_s"} if trace else set()))
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    names = ({m["name"] for m in cell.per_layer} if trace
             else {m["name"] for m in cell.end_to_end})
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
    assert line["correct"] is True
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


def test_forbidden_module_loaded_by_a_reader_withholds_the_result(
        monkeypatch, capsys):
    """A per-layer reader that loads a forbidden module, after the
    window, leaves the run with no result and a non-zero exit."""
    import types
    monkeypatch.setattr(bench, "_environment", lambda: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    outcome = _outcome(True)
    monkeypatch.setattr(registry, "driver", lambda name, *a: types.
                        SimpleNamespace(run=lambda cell, opts: outcome))

    def reader(cell, obs, *a):
        monkeypatch.setitem(sys.modules, "flax",
                            types.ModuleType("flax"))
        return {}

    monkeypatch.setattr(registry, "read_metrics", reader)
    rc = bench.main(["--workload", "bert-similar-job", "--seed", "3",
                     "--seconds", "1", "--trace", "1"])
    out = capsys.readouterr()
    assert rc != 0
    assert out.out.strip() == ""
    assert "flax" in out.err


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "bert-similar-job", "--seed", "3", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_files_are_found_and_run(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files (and entries) to a copy of the benchmark are found and run;
    no file that was there changes."""
    bench_dir = tmp_path / "bench_port"
    shutil.copytree(BENCH, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(bench_dir)
    cfg = job_cell().config
    cfg["name"] = "bert-tiny-test"
    (bench_dir / "configs" / "bert-tiny-test.json").write_text(
        json.dumps(cfg))
    mix = dict(job_cell().traffic, why="a tiny catalog")
    (bench_dir / "traffic" / "tiny-catalog.json").write_text(json.dumps(mix))
    (bench_dir / "metrics" / "jobs_seen.job.py").write_text(
        'def read(obs):\n    return float(obs["jobs"])\n')
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "bert-tiny-test", "source": "test",
                            "file": "bench_port/configs/bert-tiny-test.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "bert-tiny.tiny", "config":
                              "bert-tiny-test", "traffic": "tiny-catalog",
                              "chips": 1, "why": "test"})
    spec["end_to_end"][0]["workloads"].append("bert-tiny.tiny")
    spec["per_layer"].append({"name": "jobs_seen.job", "unit": "jobs",
                              "better": "higher", "source":
                              "program_counter", "layer": "jobs",
                              "moves": "job_rows_per_s",
                              "workloads": ["bert-tiny.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = registry.load_cell(str(tmp_path), "bert-tiny.tiny",
                              str(bench_dir))
    assert cell.config["name"] == "bert-tiny-test"
    assert [m["name"] for m in cell.per_layer] == ["jobs_seen.job"]
    out = registry.driver(cell.driver, str(bench_dir)).run(cell, Opts())
    metrics = registry.read_metrics(cell, out["obs"], str(bench_dir))
    assert metrics == {"jobs_seen.job": {"value": 1.0, "unit": "jobs"}}
    after = _digests(bench_dir)
    assert {k: v for k, v in after.items() if k in before} == before
