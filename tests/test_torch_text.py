"""Text input: the port's tokenizer and text helpers against the JAX
package's, on the cases of tests/test_data.py and tests/test_native.py.

Ids, masks and token types must be identical, through the native C++
packer and through the pure-Python encoder.
"""

import numpy as np
import pytest

from multimodalsimilar_tpu.data import text as jtext
from multimodalsimilar_tpu.data.tokenizer import TextTokenizer as JTokenizer
from multimodalsimilar_tpu.data.tokenizer import (
    build_char_vocab as jbuild_char_vocab)
from multimodalsimilar_tpu_torch import native
from multimodalsimilar_tpu_torch.data import text
from multimodalsimilar_tpu_torch.data.tokenizer import (TextTokenizer,
                                                        build_char_vocab)
from multimodalsimilar_tpu_torch.utils.buckets import bucket_ladder

NATIVE_LINES = ["红 苹果 新鲜 多汁", "青 苹果", "可乐 冰镇 最好喝的", "单词"] * 8
DATA_LINES = ["红富士苹果", "青苹果", "牛奶", "酸奶 原味", "可乐"]
EXTRA = ["未知字符χψω", "x y  z", "全角　空格", "", "   "]


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "python"])
@pytest.mark.parametrize("corpus", [NATIVE_LINES, DATA_LINES],
                         ids=["native_cases", "data_cases"])
def test_tokenizer_matches_jax(corpus, use_native):
    vocab = build_char_vocab(corpus)
    assert vocab == jbuild_char_vocab(corpus)
    tok = TextTokenizer.from_vocab(vocab, use_native=use_native)
    jtok = JTokenizer.from_vocab(vocab, use_native=False)
    if use_native and not native.available():
        pytest.skip("no C++ toolchain for native/fastpack.cpp")
    assert tok.backend == ("native" if use_native else "python")
    texts = list(corpus) + EXTRA
    for ml in (3, 4, 8, 32):
        got, want = tok(texts, max_length=ml), jtok(texts, max_length=ml)
        for key in ("input_ids", "attention_mask", "token_type_ids"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
            assert got[key].dtype == np.int32
    with pytest.raises(ValueError, match="max_length"):
        tok(texts, max_length=2)


def test_vocab_file_round_trip(tmp_path):
    path = str(tmp_path / "vocab.txt")
    tok = TextTokenizer.from_corpus(DATA_LINES, save_vocab_path=path)
    back = TextTokenizer.from_vocab_file(path)
    jback = JTokenizer.from_vocab_file(path)
    assert back.vocab_size == tok.vocab_size == jback.vocab_size
    out = back(["青苹果"], max_length=8)
    np.testing.assert_array_equal(out["input_ids"],
                                  jback(["青苹果"], max_length=8)["input_ids"])


def test_native_library_builds_into_the_port():
    """The port's native build never writes the JAX package's file."""
    if not native.available():
        pytest.skip("no C++ toolchain for native/fastpack.cpp")
    assert native._LIB.endswith("multimodalsimilar_tpu_torch/build/"
                                "libfastpack.so")


def test_text_helpers_match_jax():
    names = ["【福利秒杀】苹果[新品]", "源本牛奶【每日福利】", "plain"]
    assert text.preprocess_for_infer(names) == \
        jtext.preprocess_for_infer(names)
    item = {"product_name": "苹果1", "first_level_category_name": "水果12",
            "second_level_category_name": "苹果3", "product_title": "红 富士 5"}
    assert text.gen_title(item) == jtext.gen_title(item)


def test_bucket_ladder_copy():
    assert bucket_ladder("24,48,128", 128) == [24, 48, 128]
    assert bucket_ladder(None, 128) is None
