"""The image utilities in the port against the JAX package's, on the CPU.

``data/images.py``, ``pipelines/embcache.py`` and ``_bounded_map`` are
copies; these tests hold them to the originals on images written with
``cv2.imwrite`` under ``tmp_path``: the same header dims, decoded pixels,
resizes, normalization, augmentations from the same seeds, decode-cache
and packed-embedding-cache records (each package reads what the other
writes), and ``device_normalize`` against the JAX one (f32, within 1e-6).
"""

import os
from concurrent.futures import ThreadPoolExecutor

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalsimilar_tpu.data import datasets as jdatasets
from multimodalsimilar_tpu.data import images as JI
from multimodalsimilar_tpu.models.vision import (
    device_normalize as jdevice_normalize)
from multimodalsimilar_tpu.pipelines.embcache import (
    EmbeddingCache as JEmbeddingCache)
from multimodalsimilar_tpu_torch.data import datasets
from multimodalsimilar_tpu_torch.data import images as I
from multimodalsimilar_tpu_torch.models.vision import device_normalize, to_nchw
from multimodalsimilar_tpu_torch.pipelines.embcache import EmbeddingCache

torch.set_num_threads(1)


def _photo(rng, h, w):
    """A blocky colour image with some noise, so resizes and JPEG
    quantization have something to do."""
    g = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, 3), dtype=np.uint8)
    img = np.repeat(np.repeat(g, 8, 0), 8, 1)[:h, :w]
    noise = rng.integers(-10, 11, img.shape)
    return np.clip(img.astype(int) + noise, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    out = {}
    for name, (h, w) in {"big.jpg": (300, 420), "small.jpg": (40, 50),
                         "wide.png": (64, 96)}.items():
        path = str(d / name)
        cv2.imwrite(path, _photo(rng, h, w))
        out[name] = path
    bad = d / "broken.jpg"
    bad.write_bytes(b"\xff\xd8not a jpeg")
    out["broken.jpg"] = str(bad)
    out["missing.jpg"] = str(d / "missing.jpg")
    return out


@pytest.mark.parametrize("name", ["big.jpg", "small.jpg", "wide.png",
                                  "broken.jpg", "missing.jpg"])
def test_decode_and_dims_match_jax(files, name):
    path = files[name]
    assert I.image_dims(path) == JI.image_dims(path)
    assert I.image_dims(path, jpeg_only=True) == \
        JI.image_dims(path, jpeg_only=True)
    for min_size in (None, 64, 128):
        got = I.decode_image(path, min_size=min_size)
        want = JI.decode_image(path, min_size=min_size)
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)
    if os.path.exists(path):
        raw = open(path, "rb").read()
        got, want = I.decode_image_bytes(raw), JI.decode_image_bytes(raw)
        assert (got is None) == (want is None)
        if want is not None:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [32, 64, 100])
@pytest.mark.parametrize("normalize_host", [True, False])
def test_load_eval_resize_normalize_match_jax(files, size, normalize_host):
    for name in ("big.jpg", "small.jpg", "wide.png"):
        got = I.load_eval(files[name], size, normalize_host=normalize_host)
        want = JI.load_eval(files[name], size, normalize_host=normalize_host)
        assert got.shape == want.shape == (size, size, 3)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert I.load_eval(files["broken.jpg"], size) is None
    img = JI.decode_image(files["big.jpg"])
    np.testing.assert_array_equal(I.resize(img, size), JI.resize(img, size))
    np.testing.assert_array_equal(I.normalize(img), JI.normalize(img))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augmentations_match_jax_from_the_same_seed(files, seed):
    img = JI.decode_image(files["big.jpg"])
    got = I.augment_train(img, np.random.default_rng(seed), 64)
    want = JI.augment_train(img, np.random.default_rng(seed), 64)
    np.testing.assert_array_equal(got, want)
    got = I.load_train(files["wide.png"], 48, np.random.default_rng(seed),
                       normalize_host=False)
    want = JI.load_train(files["wide.png"], 48, np.random.default_rng(seed),
                         normalize_host=False)
    np.testing.assert_array_equal(got, want)


def test_decoded_cache_reads_what_the_other_package_wrote(files, tmp_path):
    port = I.DecodedCache.open(str(tmp_path / "port"), 32)
    jax_side = JI.DecodedCache.open(str(tmp_path / "jax"), 32)
    try:
        for name in ("big.jpg", "small.jpg"):
            a = I.load_eval(files[name], 32, cache=port, normalize_host=False)
            b = JI.load_eval(files[name], 32, cache=jax_side,
                             normalize_host=False)
            np.testing.assert_array_equal(a, b)
        assert len(port) == len(jax_side) == 2
    finally:
        port.close()
        jax_side.close()
    # each package opens the other's directory and finds the records
    for mod, other in ((I, "jax"), (JI, "port")):
        c = mod.DecodedCache.open(str(tmp_path / other), 32)
        try:
            np.testing.assert_array_equal(
                c.get(files["big.jpg"]),
                JI.load_eval(files["big.jpg"], 32, normalize_host=False))
        finally:
            c.close()
    with pytest.raises(ValueError, match="32px"):
        I.DecodedCache(str(tmp_path / "jax"), 64)


def test_embedding_cache_is_interchangeable_with_jax(tmp_path):
    rng = np.random.default_rng(0)
    vecs = {f"k{i}": rng.standard_normal(8).astype(np.float32)
            for i in range(20)}
    port = EmbeddingCache.open(str(tmp_path / "c"), 8)
    port.put_many(dict(list(vecs.items())[:12]))
    port.put("k12", vecs["k12"])
    jcache = JEmbeddingCache(str(tmp_path / "c"), 8)
    try:
        # the JAX package reads the port's records and appends its own
        for k in list(vecs)[:13]:
            np.testing.assert_array_equal(jcache.get(k), vecs[k])
        jcache.put_many(dict(list(vecs.items())[13:]))
        # ... which the port picks up through its index refresh
        assert sorted(port.keys()) == sorted(vecs) == sorted(jcache.keys())
        for k, v in vecs.items():
            np.testing.assert_array_equal(port.get(k), v)
        assert port.get_many(["k1", "nope"]).keys() == {"k1"}
        assert "k3" in port and "nope" not in port
        with pytest.raises(ValueError, match="8"):
            port.put("x", np.zeros(9, np.float32))
        with pytest.raises(ValueError, match="8-d"):
            EmbeddingCache(str(tmp_path / "c"), 16)
    finally:
        port.close()
        jcache.close()


def test_embedding_cache_emb_txt_round_trip_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    keys = [f"sku{i}" for i in range(6)]
    for i, k in enumerate(keys[:5]):
        os.makedirs(tmp_path / "tree" / k)
        np.savetxt(tmp_path / "tree" / k / "emb.txt",
                   rng.standard_normal(4 if i != 3 else 5))  # one wrong dim

    def path(k):
        return str(tmp_path / "tree" / k / "emb.txt")

    port = EmbeddingCache(str(tmp_path / "p"), 4)
    jcache = JEmbeddingCache(str(tmp_path / "j"), 4)
    try:
        assert port.import_emb_txt(path, keys) == \
            jcache.import_emb_txt(path, keys) == 4
        for k in keys:
            a, b = port.get(k), jcache.get(k)
            assert (a is None) == (b is None)
            if b is not None:
                np.testing.assert_array_equal(a, b)

        def out(k):
            return str(tmp_path / "out" / k / "emb.txt")

        assert port.export_emb_txt(out) == 4
        for k in jcache.keys():
            np.testing.assert_allclose(np.loadtxt(out(k)), jcache.get(k),
                                       rtol=1e-6)
    finally:
        port.close()
        jcache.close()


@pytest.mark.parametrize("window", [1, 3, 32])
def test_bounded_map_matches_jax(window):
    items = list(range(25))
    with ThreadPoolExecutor(4) as pool:
        got = list(datasets._bounded_map(pool, lambda x: x * x, items,
                                         window))
        want = list(jdatasets._bounded_map(pool, lambda x: x * x, items,
                                           window))
    assert got == want == [x * x for x in items]


def test_bounded_map_caps_work_in_flight():
    started = []

    def work(x):
        started.append(x)
        return x

    with ThreadPoolExecutor(2) as pool:
        gen = datasets._bounded_map(pool, work, range(1000), window=4)
        assert [next(gen) for _ in range(3)] == [0, 1, 2]
        gen.close()                 # abandoned early: the rest cancelled
    assert len(started) < 50


def test_device_normalize_matches_jax_and_host_normalize():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (2, 5, 7, 3), dtype=np.uint8)
    got = device_normalize(torch.from_numpy(img))
    want = np.asarray(jdevice_normalize(jnp.asarray(img)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.numpy(), I.normalize(img), atol=1e-6,
                               rtol=0)
    x = torch.from_numpy(want.copy())
    assert device_normalize(x) is x          # float input passes through
    nchw = to_nchw(got)
    assert nchw.shape == (2, 3, 5, 7)
    assert nchw.is_contiguous(memory_format=torch.channels_last)
