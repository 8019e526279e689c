"""Operations and bytes that the inputs need, from the published shapes.

Only products are counted (two operations a multiply-add); element-wise
work, normalisation and softmax are not. Padding is never counted: a
title of L tokens costs what L tokens cost, whatever batch shape the
program runs it in."""

from __future__ import annotations

from typing import Iterable, List, Tuple


def bert_seq_flops(tokens: int, hidden: int, layers: int,
                   intermediate: int) -> float:
    """Forward operations of one sequence of ``tokens`` real tokens
    through a post-LN BERT encoder and its tanh pooler: per layer the
    q, k, v and output projections (8 L H^2), the two MLP products
    (4 L H I) and the attention products q k^T and p v (4 L^2 H); the
    pooler's product on the first token (2 H^2)."""
    L, H = tokens, hidden
    per_layer = 8 * L * H * H + 4 * L * H * intermediate + 4 * L * L * H
    return float(layers * per_layer + 2 * H * H)


def bert_job_flops(token_counts: Iterable[int], hidden: int, layers: int,
                   intermediate: int) -> float:
    return sum(bert_seq_flops(t, hidden, layers, intermediate)
               for t in token_counts)


def title_tokens(title: str, max_length: int) -> int:
    """Tokens of a title under a character tokenizer: [CLS], one token
    per non-space character, [SEP], cut to ``max_length``."""
    return min(sum(1 for c in title if not c.isspace()) + 2, max_length)


def topk_flops(n_query: int, n_corpus: int, dim: int) -> float:
    """The inner products of an exact search: 2 Q N D."""
    return 2.0 * n_query * n_corpus * dim


def topk_bytes(n_query: int, n_corpus: int, dim: int, k: int) -> float:
    """f32 queries and corpus read once; k (f32 score, int32 index) pairs
    written a query."""
    return 4.0 * (n_query + n_corpus) * dim + 8.0 * n_query * k


def arcface_flops(batch: int, classes: int, dim: int) -> float:
    """The cosine product of an ArcFace head: 2 B C D."""
    return 2.0 * batch * classes * dim


def arcface_bytes(batch: int, classes: int, dim: int) -> float:
    """f32 x and W read once, int64 labels read once, f32 logits written
    once."""
    return 4.0 * (batch * dim + classes * dim + batch * classes) \
        + 8.0 * batch


# -- EfficientNet ------------------------------------------------------------

def _conv_out(size: int, kernel: int, stride: int) -> int:
    """Output side of a conv with symmetric padding kernel // 2."""
    pad = kernel // 2
    return (size + 2 * pad - kernel) // stride + 1


def efficientnet_forward_flops(blocks: List[Tuple[int, int, int, int, int]],
                               stem: int, head: int, image: int,
                               se_ratio: float = 0.25) -> float:
    """Forward operations of one image through an EfficientNet: the stem
    (3x3, stride 2), each block of ``blocks`` = (expand, in, out, stride,
    kernel) as a 1x1 expansion (when expand > 1), a depthwise conv, the
    squeeze-excite pair of 1x1 convs on the pooled vector (reduced width
    from the block's input channels) and the 1x1 projection, then the
    1x1 head conv."""
    s = _conv_out(image, 3, 2)
    flops = 2.0 * 9 * 3 * stem * s * s
    for expand, cin, cout, stride, k in blocks:
        mid = cin * expand
        if expand != 1:
            flops += 2.0 * cin * mid * s * s
        so = _conv_out(s, k, stride)
        flops += 2.0 * k * k * mid * so * so
        reduced = max(1, int(cin * se_ratio))
        flops += 2.0 * 2 * mid * reduced
        flops += 2.0 * mid * cout * so * so
        s = so
    flops += 2.0 * blocks[-1][2] * head * s * s
    return flops
