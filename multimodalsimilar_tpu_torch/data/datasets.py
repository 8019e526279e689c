"""Job input tables (counterpart of multimodalsimilar_tpu/data/datasets.py).

Only ``read_table`` is ported so far, for CSV and parquet files. pandas is
imported inside it: the port's device path does not need pandas.
"""

from __future__ import annotations

import os
from typing import Sequence


class InputError(ValueError):
    """Bad job input (missing table / missing columns)."""


def read_table(path: str, require: Sequence[str] = ()):
    """CSV or parquet by extension (the reference's two input formats).
    Other URL-style paths (s3://, https://) pass straight to pandas.
    ``require`` lists columns the caller needs; missing ones produce one
    clear error naming the file and its actual columns."""
    import pandas as pd
    if path.startswith(("hive://", "hivesql://")):
        raise InputError(f"{path}: warehouse pulls are not ported yet; "
                         f"extract the table to CSV or parquet")
    if "://" not in path and not os.path.exists(path):
        raise InputError(f"input table not found: {path}")
    df = (pd.read_parquet(path) if path.endswith(".parquet")
          else pd.read_csv(path))
    missing = [c for c in require if c not in df.columns]
    if missing:
        raise InputError(
            f"{path}: missing column(s) {missing}; found "
            f"{list(df.columns)} — point the matching --*_col flags at "
            f"your table's column names")
    return df
