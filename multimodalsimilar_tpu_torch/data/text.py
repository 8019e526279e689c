"""Text cleaning — behavioral parity with the reference's (duplicated) helpers.

The reference copies these into ~8 scripts; here they live once:

* ``preprocess_for_infer`` (nlp_classifier_train.py:40-50): strip a fixed list
  of marketing boilerplate tokens, then remove ``[...]`` bracket groups.
* ``gen_title`` (daodian_infer.py:136-146): "<lv1> <lv2> <product_name>
  <product_title>" with digits stripped from the category names and title,
  whitespace collapsed.
* ``load_stopwords`` (nlp_classifier_train.py:35-36): the reference loads
  stopwords.txt everywhere but never applies it (SURVEY.md §2.7) — provided
  for completeness, and ``preprocess_for_infer`` can optionally apply them.

Copied from ``multimodalsimilar_tpu/data/text.py``: the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import re
from string import digits
from typing import Iterable, List, Optional, Sequence

REMOVE_WORDS: Sequence[str] = (
    "【福利秒杀】", "【每日福利】", "【福利爆款】", "【专柜品质】",
    "【1元秒杀】", "【直播专用1元秒杀】", "【", "】", "源本",
)

_BRACKET_RE = re.compile(r"\[[^()]*\]")
_DIGIT_TABLE = str.maketrans("", "", digits)


def preprocess_for_infer(
    spu_names: Iterable[str],
    remove_words: Sequence[str] = REMOVE_WORDS,
    stopwords: Optional[Sequence[str]] = None,
) -> List[str]:
    """Strip marketing tokens and [bracket] groups from product titles."""
    result = []
    for spu_name in spu_names:
        line = spu_name
        for r in remove_words:
            line = line.replace(r, "")
        for c in _BRACKET_RE.findall(line):
            line = line.replace(c, "")
        if stopwords:
            for s in stopwords:
                line = line.replace(s, "")
        result.append(line)
    return result


def gen_title(item) -> str:
    """Compose the retrieval title from category names + product name/title.

    ``item`` is any mapping with keys product_name,
    first/second_level_category_name, product_title (daodian_infer.py:138-146).
    Digits are stripped from categories and title, not from the product name.
    """
    sku_sn_name = item["product_name"]
    lv1 = item["first_level_category_name"].translate(_DIGIT_TABLE)
    lv2 = item["second_level_category_name"].translate(_DIGIT_TABLE)
    raw_title = item.get("product_title")
    goods_title = raw_title.translate(_DIGIT_TABLE) if isinstance(
        raw_title, str) else ""
    title = f"{lv1} {lv2} {sku_sn_name} {goods_title}"
    return " ".join(title.split()).strip()


def load_stopwords(path: str) -> List[str]:
    with open(path, encoding="utf-8") as f:
        return [line.rstrip("\n") for line in f if line.rstrip("\n")]
