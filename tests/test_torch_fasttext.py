"""fastText: the port's ``models/fasttext.py`` against the JAX package's.

The same titles (ASCII, Chinese — every UTF-8 byte of which is
sign-extended by the hash — and full-width spaces) must give identical
vocab ids, native packer and Python path alike; on weights carried over
with ``fasttext_from_jax`` the supervised and unsupervised sentence
vectors agree within 1e-6 and predictions are equal; and training from the
same initial weights (JAX's ``init_params`` patched to return the port's)
follows the same trajectory: per-step losses within 1e-5, final tables
within rtol 1e-4 / atol 1e-6 (duplicate-id scatter-adds sum in another
order), equal predictions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodalsimilar_tpu.models import fasttext as J
from multimodalsimilar_tpu_torch.models import fasttext as P
from multimodalsimilar_tpu_torch.models.convert import fasttext_from_jax

torch.set_num_threads(1)

WORDS = ["苹果", "香蕉", "牛奶", "酸奶", "可乐", "汽水", "apple", "milk",
         "水果", "乳品", "饮料", "新鲜", "500g", "盒装"]


def _corpus(n=240, seed=0):
    rng = np.random.default_rng(seed)
    texts, labels = [], []
    for i in range(n):
        words = list(rng.choice(WORDS, rng.integers(1, 6)))
        sep = "　" if i % 17 == 0 else " "        # full-width space
        texts.append(sep.join(words))
        labels.append(f"lv{WORDS.index(words[0]) % 3}")   # learnable
    return texts, labels


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_vocab_ids_match_jax(native, monkeypatch):
    texts, _ = _corpus()
    texts += ["apple milk", "苹果 牛奶 盒装", "未知 词", ""]
    jv = J.FastTextVocab.build(texts, bucket=997)
    pv = P.FastTextVocab.build(texts, bucket=997)
    assert pv.words == jv.words and pv.size == jv.size
    if not native:
        pv.__dict__["_native"] = None                 # the Python path
    for line in texts[:20]:
        assert pv.line_ids(line) == jv.line_ids(line)
        assert pv.line_ids(line, 1) == jv.line_ids(line, 1)
    for t in ("苹果", "apple", "500g", "　"):
        assert P._fnv1a(t) == J._fnv1a(t)
    want = jv.encode_batch(texts, max_tokens=12)
    got = pv.encode_batch(texts, max_tokens=12)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.fixture(scope="module")
def jax_model():
    texts, labels = _corpus()
    return J.train_supervised(texts, labels, dim=8, epochs=3, bucket=500,
                              batch_size=32, max_tokens=16)


def test_sentence_vectors_and_predict_on_carried_weights(jax_model):
    texts, labels = _corpus(seed=1)
    m = fasttext_from_jax(
        {k: np.asarray(v) for k, v in jax_model.params.items()},
        jax_model.vocab.words, jax_model.vocab.bucket, jax_model.labels,
        jax_model.dim, jax_model.word_ngrams, jax_model.max_tokens,
        device="cpu")
    np.testing.assert_allclose(m.get_sentence_vector(texts),
                               jax_model.get_sentence_vector(texts),
                               rtol=0, atol=1e-6)
    ids, mask = jax_model.vocab.encode_batch(texts, 16)
    want = np.asarray(J.sentence_vector(jax_model.params, jnp.asarray(ids),
                                        jnp.asarray(mask)))
    got = P.sentence_vector(m.params, torch.from_numpy(ids).long(),
                            torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(m.predict(texts), jax_model.predict(texts))
    assert m.test(texts, labels) == jax_model.test(texts, labels)
    assert m.get_sentence_vector([]).shape == (0, 8)
    with pytest.raises(ValueError, match="do not fit"):
        fasttext_from_jax({"input": np.zeros((3, 8)),
                           "output": np.zeros((3, 8))},
                          jax_model.vocab.words, 500, jax_model.labels, 8,
                          device="cpu")


def test_training_matches_jax_from_the_same_init(monkeypatch):
    """Both packages run the same batches in the same order from the
    port's initial weights; JAX's per-step losses are read through a
    debug callback on its cross-entropy."""
    texts, labels = _corpus(n=300, seed=2)
    vocab = P.FastTextVocab.build(texts, bucket=500)
    init = P.init_params(torch.Generator().manual_seed(0), vocab.size, 8,
                         len(set(labels)))
    monkeypatch.setattr(J, "init_params", lambda rng, v, d, l: {
        k: jnp.asarray(t.numpy()) for k, t in init.items()})
    jax_losses = []

    def ce(logits, y):
        loss = optax.softmax_cross_entropy_with_integer_labels(logits, y)
        jax.debug.callback(lambda v: jax_losses.append(float(v)),
                           loss.mean())
        return loss

    class _Optax:
        linear_schedule = staticmethod(optax.linear_schedule)
        softmax_cross_entropy_with_integer_labels = staticmethod(ce)

    monkeypatch.setattr(J, "optax", _Optax)
    kw = dict(dim=8, epochs=3, bucket=500, batch_size=32, max_tokens=16,
              lr=0.5)
    jm = J.train_supervised(texts, labels, **kw)
    pm = P.train_supervised(texts, labels, device="cpu", **kw)
    steps = 3 * (300 // 32)
    assert len(jax_losses) == len(pm.train_losses) == steps
    np.testing.assert_allclose(pm.train_losses, jax_losses, rtol=1e-5)
    assert pm.train_losses[-1] < pm.train_losses[0]
    for name in ("input", "output"):
        np.testing.assert_allclose(pm.params[name].numpy(),
                                   np.asarray(jm.params[name]), rtol=1e-4,
                                   atol=1e-6)
    np.testing.assert_array_equal(pm.predict(texts), jm.predict(texts))
    assert pm.labels == jm.labels


def test_save_load_roundtrip_and_refusals(tmp_path, monkeypatch):
    texts, _ = _corpus(seed=3)
    m = P.train_supervised(*_corpus(n=64), dim=4, epochs=1, bucket=50,
                           batch_size=16, device="cpu")
    path = str(tmp_path / "ft.pt")
    m.save(path)
    back = P.FastTextClassifier.load(path, device="cpu")
    np.testing.assert_array_equal(back.get_sentence_vector(texts),
                                  m.get_sentence_vector(texts))
    assert back.labels == m.labels and back.vocab.words == m.vocab.words
    torch.save({"input": torch.zeros(2)}, str(tmp_path / "other.pt"))
    with pytest.raises(ValueError, match="not a fastText model"):
        P.FastTextClassifier.load(str(tmp_path / "other.pt"), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.FastTextClassifier.load(path)          # the card by default
