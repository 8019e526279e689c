"""The comparison fails what it should, driven on the CPU at a size a
test run holds, the harness's look for a card skipped: the control (the
reference with fp8 products in the program's place) and each fault the
cells can have (a step that leaves the state unchanged, half the batch
left out with the mean over the rest, an answer altered where it is
written). One card has no exchange between chips to leave out."""

import pytest

import run as bench
from benchlib import registry
from tiny import Opts, job_cell, train_cell


def _correct(cell, **kw):
    out = registry.driver(cell.driver).run(cell, Opts(seconds=0.3, **kw))
    return bench.verdict(out["checks"]), {c["name"]: c["value"]
                                          for c in out["checks"]}


@pytest.mark.parametrize("cell", [job_cell, train_cell])
def test_sound_run_is_correct(cell):
    ok, got = _correct(cell())
    assert ok, got


@pytest.mark.parametrize("cell, kw", [
    (job_cell, {"control": "fp8"}),
    (job_cell, {"control": "tf32_search"}),
    (job_cell, {"fault": "answer"}),
    (train_cell, {"control": "fp8"}),
    (train_cell, {"fault": "unchanged"}),
    (train_cell, {"fault": "half_batch"}),
])
def test_control_and_faults_fail(cell, kw):
    ok, got = _correct(cell(), **kw)
    assert not ok, got


@pytest.mark.cuda
@pytest.mark.parametrize("workload, group", [
    ("bert-similar-job", "control=fp8"),
    ("bert-similar-job", "control=tf32_search"),
    ("b4-train-arcface", "control=fp8"),
    ("b4-train-arcface", "fault=half_batch"),
])
def test_control_fails_at_the_cells_size_on_the_card(workload, group):
    """At the cell's own size, on three seeds (``calibrate.py``)."""
    import json
    import os
    import subprocess
    import sys
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, os.path.join(here, "calibrate.py"), "--workload",
         workload, "--seconds", "1", "--group",
         f"{group}:3300000001,3300000002,3300000003"],
        capture_output=True, text=True, timeout=1800)
    assert proc.returncode == 0, proc.stderr[-3000:]
    cell = registry.load_cell(os.path.dirname(here), workload)
    limits = cell.config["limits"]
    for line in proc.stdout.strip().splitlines():
        checks = json.loads(line)["checks"]
        assert any(v > limits.get(k, 0.0) for k, v in checks.items())
