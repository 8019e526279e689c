"""Tests that need an NVIDIA GPU: the CUDA kernels against their plain
versions, and the port's entry points on the card.

They skip without a card. This file imports neither JAX nor the JAX
package, so it also runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from multimodalsimilar_tpu_torch.ops import topk as T
from multimodalsimilar_tpu_torch.retrieval.engine import SimilarityEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: csrc/topk.cu has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _ints(rng, shape, dev):
    return torch.from_numpy(rng.integers(-3, 4, size=shape)
                            .astype(np.float32)).to(dev)


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("q", [1, 300, 20_000], ids=["q1", "q300", "q20k"])
def test_kernel_equals_plain_on_exact_data(dev, metric, q):
    """Small-integer rows make every score exact, so results must be
    identical, ties (duplicate rows) included; q picks the split and the
    unsplit launch."""
    rng = np.random.default_rng(0)
    corpus = _ints(rng, (5000, 96), dev)
    corpus[100:200] = corpus[:100]
    queries = _ints(rng, (q, 96), dev)
    queries[:1] = corpus[:1]
    for k in (1, 13, 101, 128):
        got = T.topk_cuda(corpus, queries, k, metric, true_n=4900)
        want = T.topk_plain(corpus, queries, k, metric, true_n=4900)
        torch.cuda.synchronize()
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
        assert int(got[1].max()) < 4900


def test_kernel_counts_launches_and_validates(dev):
    x = torch.randn(300, 40, device=dev)
    before = T.LAUNCHES["topk"]
    T.streaming_topk(x, x, 5)
    assert T.LAUNCHES["topk"] == before + 1
    with pytest.raises(ValueError, match="k <= 128"):
        T.topk_cuda(x, x, 129)
    with pytest.raises(ValueError, match="float32"):
        T.topk_cuda(x.half(), x.half(), 5)
    with pytest.raises(ValueError, match="contiguous"):
        T.topk_cuda(x, x.t().contiguous().t(), 5)
    with pytest.raises(ValueError, match="not a CUDA device"):
        T.topk_cuda(x.cpu(), x, 5)


def test_engine_on_card_matches_engine_on_cpu(dev):
    rng = np.random.default_rng(1)
    emb = rng.normal(size=(3000, 64)).astype(np.float32)
    keys = [f"k{i}" for i in range(3000)]
    gpu = SimilarityEngine(emb, keys, device=dev)
    cpu = SimilarityEngine(emb, keys, device="cpu")
    gs, gi = gpu.search(13)
    cs, ci = cpu.search(13)
    np.testing.assert_allclose(gs, cs, atol=1e-5)
    assert (gi[:, 0] == np.arange(3000)).all()
    app = rng.normal(size=(600, 64)).astype(np.float32)
    for eng in (gpu, cpu):
        eng.update(app, [f"n{i}" for i in range(600)])
    gs, gi = gpu.search(7, queries=app[:50])
    cs, ci = cpu.search(7, queries=app[:50])
    np.testing.assert_allclose(gs, cs, atol=1e-5)
    v, i = gpu.search_device(7, app[:50])
    assert v.device.type == "cuda"
    np.testing.assert_array_equal(i.cpu().numpy(), gi)
