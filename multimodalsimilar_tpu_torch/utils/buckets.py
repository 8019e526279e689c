"""Sequence-bucket parsing shared by serving and training paths.

One place for the "24,32,48" / [24, 32, 48] / 48 -> bucket ladder logic so
CLI flags, YAML configs, and library callers behave identically.

Copied from ``multimodalsimilar_tpu/utils/buckets.py``: the port imports
nothing of the JAX package.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

BucketsLike = Union[None, int, str, Sequence[int]]


def parse_buckets(value: BucketsLike) -> Optional[List[int]]:
    """Normalize a user-supplied bucket spec to a list of ints (or None).

    Accepts a comma string ("24,32,48"), a single int (a YAML
    ``seq_buckets: 48``), or any iterable of ints.
    """
    if value is None:
        return None
    if isinstance(value, int):
        value = [value]
    elif isinstance(value, str):
        value = [b for b in value.split(",") if b.strip()]
    try:
        out = [int(b) for b in value]
    except (TypeError, ValueError):
        raise ValueError(f"bad bucket spec {value!r}: expected ints like "
                         f"24,32,48")
    return out or None


def bucket_ladder(buckets: BucketsLike, max_length: int
                  ) -> Optional[List[int]]:
    """Sorted unique buckets below max_length, with max_length as the final
    rung — every batch fits some rung."""
    parsed = parse_buckets(buckets)
    if not parsed:
        return None
    # b == max_length is the natural full-ladder spec ("48,64,128" with
    # max_length 128) — exactly equivalent to the appended final rung, so
    # it drops silently; only b > max_length smells like a typo
    dropped = sorted({b for b in parsed if b > max_length})
    if dropped:
        # a typo ("480" for "48") must not silently degrade to no
        # bucketing — the 2.3x training win would quietly disappear
        import warnings
        warnings.warn(
            f"seq bucket(s) {dropped} > max_length {max_length} are "
            f"unreachable (every batch is truncated to max_length) and "
            f"were dropped; buckets must be < max_length to have any "
            f"effect",
            stacklevel=2)
    inner = sorted({b for b in parsed if 0 < b < max_length})
    return inner + [max_length]
