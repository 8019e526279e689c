"""The two cells this file's tests add, at a size a CPU test run holds:
``dsv2-lite-similar-job`` with the tower's widths, depth and expert
count cut, and ``bert-train-b1024`` with a tiny BERT at batch 8."""

from __future__ import annotations

import copy

from benchlib.registry import Cell, load_traffic
from tiny import _config


def dsv2_job_cell() -> Cell:
    cfg = _config("deepseek-v2-lite")
    cfg.update(vocab_size=3072, hidden_size=64, intermediate_size=128,
               moe_intermediate_size=32, num_hidden_layers=3,
               num_attention_heads=4, n_routed_experts=8,
               num_experts_per_tok=2, n_shared_experts=2, kv_lora_rank=32,
               qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)
    cfg["rope_scaling"] = dict(cfg["rope_scaling"],
                               original_max_position_embeddings=16)
    cfg["assumed"] = dict(cfg["assumed"], bos_token_id=3060)
    cfg["recipe"].update(max_length=24, batch_size=16)
    # float32 on the CPU on both sides would meet at 1e-6; the program
    # runs bfloat16 weights and products: limits for this size
    cfg["limits"] = {"embedding_gap": 0.05, "neighbour_list_gap": 1e-5,
                     "reference_list_gap": 0.01}
    traffic = copy.deepcopy(load_traffic("catalog-20k-dsv2"))
    traffic.update(rows=96, catalogs_ahead=2, warmup_rows=48)
    traffic["judge"].update(rows_per_job=12, longest_per_job=2,
                            reference_batch=32)
    return Cell("dsv2-lite-similar-job", 1, "deepseek-v2-lite", cfg,
                "catalog-20k-dsv2", traffic, [], [])


def b1024_train_cell() -> Cell:
    """``bert-train-b1024`` with the encoder cut to the port's ``tiny``
    preset's shape over the cell's char vocabulary, 40 classes, batch 8,
    seq buckets 16/24 at max_length 24."""
    cfg = _config("roberta-wwm-ext-base")
    cfg.update(vocab_size=3072, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=4, intermediate_size=128,
               max_position_embeddings=64)
    traffic = copy.deepcopy(load_traffic("titles-zipf-10205-b1024"))
    traffic.update(rows=400, title_len=[4, 20], warmup_steps=4)
    traffic["recipe"]["num_classes"] = 40
    traffic["recipe"]["flags"].update(bert_preset="tiny", batch_size=8,
                                      max_length=24, seq_buckets="16,24")
    # limits for this size, from CPU readings over seeds 5-8: sound
    # 0.00026-0.0033 (gradient) and 0.00012-0.00075 (change), fp8
    # products 0.0017-0.034 and 0.0032-0.0062
    traffic["limits"] = {"first_gradient_gap": 0.008, "change_gap": 0.002}
    return Cell("bert-train-b1024", 1, "roberta-wwm-ext-base", cfg,
                "titles-zipf-10205-b1024", traffic, [], [])
