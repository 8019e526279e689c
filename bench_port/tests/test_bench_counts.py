"""The operation and byte counts agree with hand counts at stated
shapes."""

import json
import os

import pytest

from benchlib import flops, peaks
from reference import efficientnet as ref

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bert_sequence():
    # one layer, L = 10 tokens, H = 4, I = 8: q, k, v and output
    # projections 4 x 2 x 10 x 4 x 4 = 1,280; the MLP 2 x 2 x 10 x 4 x 8
    # = 1,280; q k^T and p v 2 x 2 x 10 x 10 x 4 = 1,600; the pooler
    # 2 x 4 x 4 = 32
    assert flops.bert_seq_flops(10, 4, 1, 8) == 1280 + 1280 + 1600 + 32


def test_title_tokens():
    assert flops.title_tokens("ab c", 128) == 5
    assert flops.title_tokens("x" * 200, 128) == 128


def test_topk_and_arcface():
    assert flops.topk_flops(3, 5, 7) == 2 * 3 * 5 * 7
    assert flops.topk_bytes(3, 5, 7, 2) == 4 * (3 + 5) * 7 + 8 * 3 * 2
    assert flops.arcface_flops(24, 4181, 512) == 2 * 24 * 4181 * 512
    assert flops.arcface_bytes(2, 3, 4) == 4 * (8 + 12 + 6) + 16


def test_roofline_takes_the_larger_bound():
    assert peaks.roofline_s(989e12, 0) == pytest.approx(1.0)
    assert peaks.roofline_s(0, 3.35e12) == pytest.approx(1.0)


def test_efficientnet_one_block():
    # image 8, stem 3x3 stride 2 to 4 channels at 4 x 4: 2 x 9 x 3 x 4 x 16
    # = 3,456; one block expand 6 from 4 to 8 channels, 3x3 stride 1:
    # the 1x1 expansion 2 x 4 x 24 x 16 = 3,072, the depthwise 2 x 9 x 24 x
    # 16 = 6,912, squeeze-excite 2 x 2 x 24 x 1 = 96, the projection
    # 2 x 24 x 8 x 16 = 6,144; the head 1x1 from 8 to 16: 2 x 8 x 16 x 16
    # = 4,096
    got = flops.efficientnet_forward_flops([(6, 4, 8, 1, 3)], 4, 16, 8)
    assert got == 3456 + 3072 + 6912 + 96 + 6144 + 4096


def test_b4_table():
    with open(os.path.join(BENCH, "configs", "efficientnet_b4.json")) as f:
        cfg = json.load(f)
    table = ref.block_table(cfg)
    # B4: 32 blocks; stem 48 channels; the last block 448 channels
    assert len(table) == 32
    assert ref.make_divisible(32 * 1.4) == 48
    assert table[-1][2] == 448
    assert ref.make_divisible(1280 * 1.4) == cfg["num_features"] == 1792
