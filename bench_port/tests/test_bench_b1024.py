"""The ``bert-train-b1024`` cell on the CPU at a tiny size: the driver's
window and judge, its faults and control."""

import pytest

from benchlib import registry
from tiny import Opts
from tiny2 import b1024_train_cell

DRIVER = registry.driver("train_nlp")


@pytest.fixture(autouse=True)
def tiny_tower(monkeypatch):
    """The program's tower at the cell's cut shape (its ``tiny`` preset
    holds a 128-row vocabulary, the cell's titles need 3,072)."""
    from multimodalsimilar_tpu_torch.cli import train
    from multimodalsimilar_tpu_torch.models.bert import BertConfig
    cfg = b1024_train_cell().config
    monkeypatch.setattr(train, "_text_config", lambda args: BertConfig.tiny(
        vocab_size=cfg["vocab_size"]))


def _checks(out):
    return {c["name"]: c["value"] for c in out["checks"]}


def test_run_is_correct_and_reports_its_metrics():
    cell = b1024_train_cell()
    out = DRIVER.run(cell, Opts(seed=7))
    checks = _checks(out)
    assert checks["label_rows_differing"] == 0
    assert checks["token_ids_rows_differing"] == 0
    for name, limit in cell.traffic["limits"].items():
        assert checks[name] <= limit, (name, checks[name])
    assert set(out["e2e"]) == {"train_examples_per_s", "setup_s"}
    obs = out["obs"]
    assert obs["model_flops"] > 0 and obs["steps"] >= 1
    assert obs["arcface_launches"] == 0     # the CPU runs the plain head


@pytest.mark.parametrize("kind,name", [("fault", "unchanged"),
                                       ("fault", "half_batch"),
                                       ("control", "fp8")])
def test_faults_and_control_fail_a_check(kind, name):
    cell = b1024_train_cell()
    out = DRIVER.run(cell, Opts(seed=7, **{kind: name}))
    checks = _checks(out)
    assert any(checks[n] > lim for n, lim in cell.traffic["limits"].items())
