"""Cells at a size a CPU test run holds: the benchmark's configurations
and mixes with their depths, widths and counts cut, run on the CPU."""

from __future__ import annotations

import copy
import json
import os
import time

import torch

from benchlib.registry import Cell, load_traffic

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(name: str) -> dict:
    with open(os.path.join(BENCH, "configs", f"{name}.json"),
              encoding="utf-8") as f:
        return json.load(f)


def job_cell() -> Cell:
    cfg = _config("roberta-wwm-ext-base")
    cfg.update(vocab_size=3072, hidden_size=32, num_hidden_layers=2,
               num_attention_heads=4, intermediate_size=64,
               max_position_embeddings=64)
    cfg["recipe"].update(max_length=24, batch_size=16)
    # limits for this size, from CPU readings over seeds 1-6: embedding
    # gap 0.0063-0.0117 sound, 0.029-0.048 with fp8 products; list gap
    # 0 sound, 1.7e-5-5.9e-5 with TF32 products; the whole job's list gap
    # against the reference's embeddings 5e-6-1.7e-5 sound, infinite with
    # an altered answer
    cfg["limits"] = {"embedding_gap": 0.02, "neighbour_list_gap": 1e-5,
                     "reference_list_gap": 1e-4}
    traffic = copy.deepcopy(load_traffic("catalog-50k"))
    traffic.update(rows=96, catalogs_ahead=2, warmup_rows=48)
    traffic["judge"].update(rows_per_job=12, longest_per_job=2)
    return Cell("bert-similar-job", 1, "roberta-wwm-ext-base", cfg,
                "catalog-50k", traffic, [], [])


class Opts:
    """``run.py``'s options, on the CPU."""

    def __init__(self, seed=7, seconds=0.01, trace=False, control=None,
                 fault=None, full_precision=False):
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.control, self.fault = control, fault
        self.full_precision = full_precision
        self.device = torch.device("cpu")
        self.t_start = time.perf_counter()

    def log(self, what: str) -> None:
        pass


def train_cell() -> Cell:
    """The program's ``tiny`` EfficientNet (two trimmed stages) at 64 px,
    50 classes, batch 4."""
    cfg = _config("efficientnet_b4")
    cfg.update(width_mult=1.0, depth_mult=1.0, stem_channels=8,
               head_channels=32, num_features=32, drop_path_rate=0.1,
               stages=[[1, 8, 1, 1, 3], [6, 16, 2, 2, 3]], fc_dim=16)
    cfg["recipe"]["num_classes"] = 50
    # limits for this size and the tests' seed 7, from CPU readings:
    # sound 0.0013 (gradient) and 0.0016 (change), fp8 products 0.0159 and
    # 0.0167 (seeds 1-6: sound 0.0017-0.0161 and 0.0011-0.0152, fp8
    # 0.0197-0.364 and 0.0150-0.0707); the median channel's statistics
    # at the last stage's end over seeds 1-7: sound 0.0009-0.0014, fp8
    # products 0.012-0.024
    cfg["statistics_stage"] = 1
    cfg["limits"] = {"stem_statistics_gap": 0.01,
                     "blocks_statistics_gap": 0.004,
                     "first_gradient_gap": 0.008, "change_gap": 0.008}
    cfg["recipe"]["flags"].update(backbone="tiny", image_size=64, fc_dim=16,
                                  batch_size=4)
    traffic = copy.deepcopy(load_traffic("daodian-images-zipf-4181"))
    traffic.update(rows=400, images=24, image_px=[64, 100],
                   writer_threads=2, warmup_steps=4)
    return Cell("b4-train-arcface", 1, "efficientnet_b4", cfg,
                "daodian-images-zipf-4181", traffic, [], [])
