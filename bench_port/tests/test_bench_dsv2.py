"""The ``dsv2-lite-similar-job`` cell on the CPU at a tiny size: the
driver's run and judge, its faults and control, the reference's expert
loop against the port's grouped plain path, the counts and the readers
of its two metrics."""

import pytest
import torch

from benchlib import moe_flops, registry
from reference import deepseek_v2 as ref
from tiny import Opts
from tiny2 import dsv2_job_cell

DRIVER = registry.driver("similar_job_dsv2")


def _checks(out):
    return {c["name"]: c["value"] for c in out["checks"]}


@pytest.fixture(scope="module")
def sound():
    return DRIVER.run(dsv2_job_cell(), Opts(seed=11))


def test_run_is_correct_and_reports_its_metrics(sound):
    checks = _checks(sound)
    limits = dsv2_job_cell().config["limits"]
    assert checks["token_ids_rows_differing"] == 0
    for name, limit in limits.items():
        assert checks[name] <= limit, (name, checks[name])
    assert set(sound["e2e"]) == {"job_rows_per_s", "setup_s"}
    assert sound["obs"]["model_flops"] > 0 and sound["attempted"] >= 96


@pytest.mark.parametrize("fault", ["topk_renormalised", "no_yarn_mscale",
                                   "shared_expert_dropped", "answer"])
def test_each_fault_fails_a_check(fault):
    cell = dsv2_job_cell()
    out = DRIVER.run(cell, Opts(seed=11, fault=fault))
    checks = _checks(out)
    assert any(checks[n] > lim for n, lim in cell.config["limits"].items())


def test_reference_expert_loop_matches_the_grouped_plain_path():
    """``reference/deepseek_v2.py:moe`` (boolean masks over the experts)
    against ``ops/moe.py``'s plain grouped path on the same weights."""
    from multimodalsimilar_tpu_torch.models import hf_import
    from multimodalsimilar_tpu_torch.models.deepseek_v2 import (
        DeepseekV2Config, MoE)
    cfg = dict(dsv2_job_cell().config, bos_token_id=3060)
    w = {k: v.float() for k, v in ref.draw(cfg, 5, 1, "cpu").items()}
    config = DeepseekV2Config.from_hf(cfg)
    layer = MoE(config, torch.float32)
    state = hf_import.deepseek_v2_state_from_hf(
        {"model." + k: v for k, v in w.items()}, config)
    layer.load_state_dict({k[len("layers.1.mlp."):]: v
                           for k, v in state.items()
                           if k.startswith("layers.1.mlp.")})
    x = torch.randn(4, 7, 64, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = ref.moe(w, "layers.1.", cfg, x.reshape(-1, 64)).view(x.shape)
        got = layer(x)
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)


def _reader(name):
    return registry._module(f"{registry.HERE}/metrics/{name}.py",
                            "t_" + name.replace(".", "_")).read


def test_expert_bound_and_readers():
    lite = registry.load_cell(registry.HERE + "/..", "dsv2-lite-similar-job")
    assert moe_flops.expert_flops(1, lite.config) == 2 * 3 * 2048 * 1408
    # an expert's bfloat16 weights are 17.3 MB; a launch pair reads 64
    assert moe_flops.expert_bytes(1, 0, lite.config) == \
        pytest.approx(64 * 17.3e6, rel=2e-3)
    # 4.48 GFLOP a token, as the published shapes give
    assert moe_flops.seq_flops(1, lite.config) == pytest.approx(4.48e9,
                                                                rel=0.01)
    roof = _reader("expert_roofline.dsjob")
    obs = {"expert_bound_s": 0.5, "device": {"kernels": {
        "void cutlass::device_kernel<GroupProblemShape<x>>": 0.8,
        "at::cuda::detail::prepare_grouped_gemm_data<y>": 0.2,
        "ampere_bf16_s16816gemm": 9.0}}}
    assert roof(obs) == pytest.approx(50.0)
    assert roof({"device": obs["device"]}) is None


def test_moe_enqueue_share_reads_the_program_spans(monkeypatch):
    import threading
    import types
    from benchlib import program
    main = threading.main_thread().ident
    spans = [("embed.launch", None, main, 0, 10_000),
             ("moe.route", None, main, 0, 1_000),
             ("moe.experts", None, main, 1_000, 3_000),
             ("moe.combine", None, main, 3_000, 4_000)]
    rec = types.SimpleNamespace(spans=spans, counters={})
    monkeypatch.setattr(program, "record", lambda: rec)
    read = _reader("moe_enqueue_share.dsjob")
    assert read({}) == pytest.approx(40.0)
    rec.spans = spans[:1]                # a program with no MoE spans
    assert read({}) is None
