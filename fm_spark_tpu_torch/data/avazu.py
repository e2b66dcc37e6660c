"""Avazu CTR CSV → hashed packed binary (the port's copy of
``fm_spark_tpu/data/avazu.py``, the same ids and packed bytes; config 4).

Kaggle Avazu format: a header, then ``id,click,hour,C1,banner_pos,
site_id,site_domain,site_category,app_id,app_domain,app_category,
device_id,device_ip,device_model,device_type,device_conn_type,C14..C21``:
24 columns. ``id`` is dropped, ``click`` is the label, and the other 22
columns are categorical fields, ``hour`` (YYMMDDHH) split into day of
week and hour of day: 23 fields, all hashed per field
(``data/hashing.py``), vals 1.0.
"""

from __future__ import annotations

import datetime

import numpy as np

from fm_spark_tpu_torch.data import hashing
from fm_spark_tpu_torch.data.packed import PackedWriter

RAW_COLUMNS = 24          # incl. id + click
NUM_FIELDS = 23           # 21 raw categorical + day-of-week + hour-of-day


def parse_lines(lines: list[bytes], bucket: int, per_field: bool = True,
                on_error=None, path: str = "<avazu>",
                start_lineno: int = 1, use_native: bool = True):
    """Parse body lines (no header) → (ids[N,23] int32, labels[N] int8).

    Tokenizes in Python, then hashes all rows' tokens, the header-derived
    day-of-week and hour tokens among them, in one
    ``native.hash_tokens_batch`` call (``use_native=False``: the numpy
    ``hashing.hash_tokens_batch``, the same ids).

    A malformed row (wrong column count, unparseable ``hour`` field)
    raises ``ValueError`` by default; with ``on_error(path, lineno, line,
    reason)`` it is reported with its ``path`` and line number and
    dropped, so N shrinks to the good-row count.
    """
    labels_list: list[int] = []
    tokens: list[bytes] = []
    dow_cache: dict[bytes, bytes] = {}
    for k, line in enumerate(lines):
        cols = line.rstrip(b"\r\n").split(b",")
        reason = None
        if len(cols) != RAW_COLUMNS:
            reason = (
                f"avazu line has {len(cols)} columns, want {RAW_COLUMNS}"
            )
        else:
            hour = cols[2]  # YYMMDDHH
            date = hour[:6]
            dow = dow_cache.get(date)
            if dow is None:
                try:
                    d = datetime.date(2000 + int(date[0:2]),
                                      int(date[2:4]), int(date[4:6]))
                except ValueError:
                    reason = f"bad hour field {date[:12]!r} (want YYMMDDHH)"
                else:
                    dow = str(d.weekday()).encode()
                    dow_cache[date] = dow
        if reason is not None:
            if on_error is None:
                raise ValueError(reason)
            on_error(path, start_lineno + k, line.rstrip(b"\r\n"), reason)
            continue
        labels_list.append(1 if cols[1] == b"1" else 0)
        tokens.append(dow)
        tokens.append(hour[6:8])
        tokens.extend(cols[3:])
    n = len(labels_list)
    labels = np.asarray(labels_list, np.int8)
    fields = np.tile(np.arange(NUM_FIELDS, dtype=np.int64), n)
    if use_native:
        from fm_spark_tpu_torch import native

        out_ids = native.hash_tokens_batch(tokens, fields, bucket, per_field)
    else:
        out_ids = hashing.hash_tokens_batch(tokens, fields, bucket, per_field)
    return out_ids.reshape(n, NUM_FIELDS).astype(np.int32), labels


def preprocess(src_paths, out_dir: str, bucket: int, per_field: bool = True,
               chunk_lines: int = 200_000, use_native: bool = True) -> int:
    """Stream Avazu CSV file(s) → packed dataset. Returns the example
    count."""
    if isinstance(src_paths, str):
        src_paths = [src_paths]
    with PackedWriter(out_dir, NUM_FIELDS, store_vals=False) as w:
        for path in src_paths:
            with open(path, "rb") as f:
                header = f.readline()
                if not header.startswith(b"id,click"):
                    raise ValueError(f"{path}: not an Avazu CSV (header "
                                     f"{header[:30]!r})")
                while True:
                    lines = f.readlines(chunk_lines * 100)
                    if not lines:
                        break
                    ids, labels = parse_lines(lines, bucket, per_field,
                                              use_native=use_native)
                    w.append(ids, labels)
        count = w.num_examples
    return count


def synthesize_csv(path: str, num_examples: int, seed: int = 0,
                   vocab: int = 500):
    """Write an Avazu-shaped synthetic CSV (the same bytes as the
    reference's for a seed)."""
    rng = np.random.default_rng(seed)
    header = (
        "id,click,hour,C1,banner_pos,site_id,site_domain,site_category,"
        "app_id,app_domain,app_category,device_id,device_ip,device_model,"
        "device_type,device_conn_type,C14,C15,C16,C17,C18,C19,C20,C21"
    )
    with open(path, "w") as f:
        f.write(header + "\n")
        for i in range(num_examples):
            click = 1 if rng.random() < 0.17 else 0
            day = rng.integers(21, 31)
            hh = rng.integers(0, 24)
            cols = [str(10000000 + i), str(click), f"1410{day:02d}{hh:02d}"]
            cols += [
                f"{int(rng.zipf(1.4)) % vocab:06x}" for _ in range(21)
            ]
            f.write(",".join(cols) + "\n")
