"""The traffic generators repeat exactly from a seed, and differ between
seeds and jobs."""

import os

import numpy as np

from benchlib import gen
from benchlib.registry import load_traffic
from benchlib.registry import driver


def test_titles_repeat_from_a_seed():
    a = gen.make_titles(2000, gen.rng_for(2**31 + 17, 1, 0))
    b = gen.make_titles(2000, gen.rng_for(2**31 + 17, 1, 0))
    c = gen.make_titles(2000, gen.rng_for(2**31 + 17, 1, 1))
    assert a == b
    assert a != c


def test_titles_have_the_mix_shape():
    titles = gen.make_titles(5000, gen.rng_for(3))
    lens = np.array([len(t) for t in titles])
    assert lens.min() >= 8 and lens.max() <= 40
    assert set("".join(titles)) <= set(gen.TITLE_POOL)
    # every tenth title from row n // 10 on is an earlier one with its
    # last character replaced by a digit
    for i in range(500, 5000, 10):
        assert titles[i][-1].isdigit()
        assert any(t[:-1] == titles[i][:-1] for t in titles[:i])


def test_labels_and_images_repeat_from_a_seed():
    a = gen.zipf_with_last(1000, 4181, gen.rng_for(5))
    b = gen.zipf_with_last(1000, 4181, gen.rng_for(5))
    assert (a == b).all() and a[-1] == 4180 and a.max() == 4180
    x = gen.make_images(gen.rng_for(6), 2, 40)
    y = gen.make_images(gen.rng_for(6), 2, 40)
    assert x.shape == (2, 40, 40, 3) and x.dtype == np.uint8
    assert (x == y).all()


def test_jpegs_repeat_whatever_the_thread_order(tmp_path):
    keys = [f"k{i}" for i in range(6)]
    sizes = [64, 80, 72, 64, 96, 100]
    for root, workers in ((tmp_path / "a", 1), (tmp_path / "b", 4)):
        gen.write_jpegs(str(root), keys, sizes, (9, 12), workers=workers)
    for k in keys:
        assert (tmp_path / "a" / f"{k}.jpg").read_bytes() == \
            (tmp_path / "b" / f"{k}.jpg").read_bytes()


def test_catalogs_and_tables_repeat_from_a_seed(tmp_path):
    traffic = load_traffic("catalog-50k")
    job = driver("similar_job")
    assert job.catalog(traffic, 11, 1, 0, rows=300) == \
        job.catalog(traffic, 11, 1, 0, rows=300)
    assert job.catalog(traffic, 11, 1, 0, rows=300) != \
        job.catalog(traffic, 11, 1, 1, rows=300)
    train = driver("train_cv")
    mix = dict(load_traffic("daodian-images-zipf-4181"), rows=200,
               images=5, image_px=[64, 80])
    recipe = {"num_classes": 50, "flags": {"key_col": "goods_sku",
                                           "label_col": "tag_new_id"}}
    a = train.write_inputs(mix, recipe, 13, str(tmp_path / "a"))
    b = train.write_inputs(mix, recipe, 13, str(tmp_path / "b"))
    assert a == b
    assert sorted(os.listdir(tmp_path / "a")) == \
        sorted(os.listdir(tmp_path / "b"))
