"""Traffic generators: product titles, synthetic photos, Zipf labels and
the JPEG writer. Every draw comes from a ``numpy`` generator seeded by
the caller, so a seed gives the same inputs.

The title and photo shapes follow the repository's single-pass drivers
(``make_titles``, ``make_images``, ``zipf_labels``, ``zipf_with_last``,
``write_jpegs``); the titles are drawn in one vectorised pass, since a
catalog of 50,000 titles drawn row by row takes over a second of set-up.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence

import numpy as np

# the title alphabet: 3,000 CJK ideographs and the ten digits
TITLE_POOL = [chr(0x4E00 + i) for i in range(3000)] + list("0123456789")


def rng_for(*parts: int) -> np.random.Generator:
    """A generator keyed by a seed and any further indices (a job, a
    purpose), each part a non-negative integer of any size."""
    return np.random.default_rng([int(p) for p in parts])


def make_titles(n: int, rng: np.random.Generator, min_len: int = 8,
                max_len: int = 40, dup_every: int = 10) -> List[str]:
    """``n`` synthetic product titles of ``min_len``-``max_len`` characters
    drawn uniformly from ``TITLE_POOL``; every ``dup_every``-th title from
    row ``n // dup_every`` on is a near-duplicate of an earlier title (its
    last character replaced by a digit)."""
    lens = rng.integers(min_len, max_len + 1, size=n)
    flat = rng.integers(0, len(TITLE_POOL), size=int(lens.sum()))
    points = np.fromiter(map(ord, TITLE_POOL), np.uint32, len(TITLE_POOL))
    text = points[flat].astype("<u4").tobytes().decode("utf-32-le")
    ends = np.cumsum(lens)
    starts = ends - lens
    titles = [text[a:b] for a, b in zip(starts.tolist(), ends.tolist())]
    for i in range(n // dup_every, n, dup_every):
        src = titles[int(rng.integers(0, i))]
        titles[i] = src[:-1] + str(int(rng.integers(0, 10)))
    return titles


def make_images(rng: np.random.Generator, n: int, size: int) -> np.ndarray:
    """``n`` synthetic uint8 [size, size, 3] photos: a random 16 x 16 grid
    of colours, each cell a flat block, so pooled features differ between
    images as they do between products."""
    grid = rng.integers(0, 256, (n, 16, 16, 3), dtype=np.uint8)
    cell = -(-size // 16)
    x = np.repeat(np.repeat(grid, cell, axis=1), cell, axis=2)
    return np.ascontiguousarray(x[:, :size, :size])


def zipf_labels(n: int, n_cls: int, rng: np.random.Generator,
                exponent: float = 1.1) -> np.ndarray:
    """Class ids with P(k) proportional to 1 / (k + 1)^exponent."""
    p = 1.0 / np.arange(1, n_cls + 1) ** exponent
    return rng.choice(n_cls, size=n, p=p / p.sum()).astype(np.int64)


def zipf_with_last(n: int, n_cls: int, rng: np.random.Generator,
                   exponent: float = 1.1) -> np.ndarray:
    """Zipf labels with class ``n_cls - 1`` present, so a head sized from
    the labels has exactly ``n_cls`` rows."""
    labels = zipf_labels(n, n_cls, rng, exponent)
    labels[-1] = n_cls - 1
    return labels


def write_jpegs(root: str, keys: Sequence[str], sizes: Sequence[int],
                seed_parts: Sequence[int], workers: int = 8,
                quality: int = 90) -> int:
    """Write ``{root}/{key}.jpg`` for each key, a ``make_images`` photo of
    its size, drawn from ``rng_for(*seed_parts, i)`` so the files do not
    depend on the order the threads run in. Returns the bytes written."""
    import cv2
    os.makedirs(root, exist_ok=True)

    def one(i: int) -> int:
        img = make_images(rng_for(*seed_parts, i), 1, int(sizes[i]))[0]
        ok, buf = cv2.imencode(".jpg", img,
                               [cv2.IMWRITE_JPEG_QUALITY, quality])
        if not ok:
            raise RuntimeError(f"cv2 could not encode {keys[i]}.jpg")
        with open(os.path.join(root, f"{keys[i]}.jpg"), "wb") as f:
            f.write(buf.tobytes())
        return len(buf)

    with ThreadPoolExecutor(max_workers=workers) as pool:
        return sum(pool.map(one, range(len(keys))))
