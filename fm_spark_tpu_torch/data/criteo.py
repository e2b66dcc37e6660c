"""Criteo click logs: TSV → hashed packed binary (the port's copy of
``fm_spark_tpu/data/criteo.py``, the same ids and packed bytes).

Format: ``label \\t i1..i13 \\t c1..c26``: 13 integer count features
and 26 categorical hex tokens, an empty field missing (39 ids per
sample). Preprocessing is a one-time job: stream the text, hash every
field (``data/hashing.py``), write the packed format
(``data/packed.py``); training never sees text. The native parser
(``native/fasthash.cpp``) does it; :func:`parse_lines` is the plain
version it is held to (``use_native=False``).

The vals are all 1.0 (one-hot), so the packed dataset has no vals file.
"""

from __future__ import annotations

import numpy as np

from fm_spark_tpu_torch.data import hashing
from fm_spark_tpu_torch.data.packed import PackedWriter

NUM_INT = 13
NUM_CAT = 26
NUM_FIELDS = NUM_INT + NUM_CAT


def parse_line(line: bytes, bucket: int, per_field: bool = True):
    """Parse ONE Criteo TSV line → ``(label, ids_row list[int])``.

    Raises ``ValueError`` on a wrong column count or a non-integer label
    or count, without source context (callers add ``path:lineno``).
    """
    cols = line.rstrip(b"\r\n").split(b"\t")
    if len(cols) != NUM_FIELDS + 1:
        raise ValueError(
            f"criteo line has {len(cols)} columns, want {NUM_FIELDS + 1}"
        )
    try:
        label = 1 if int(cols[0]) > 0 else 0
        row = [0] * NUM_FIELDS
        for f in range(NUM_INT):
            tok = cols[1 + f]
            if tok == b"":
                key = (1 << 40) + 1  # MISS_KEY (hashing.py)
            elif tok.startswith(b"-"):
                key = 1 << 40  # NEG_KEY
            else:
                key = int(np.floor(np.log1p(float(int(tok))) ** 2))
            row[f] = hashing.hash_int_u64_spec(f, key, bucket, per_field)
        for f in range(NUM_INT, NUM_FIELDS):
            row[f] = hashing.hash_token(f, cols[1 + f], bucket, per_field)
    except (ValueError, OverflowError) as e:
        raise ValueError(f"bad criteo field ({e})") from None
    return label, row


def parse_lines(lines: list[bytes], bucket: int, per_field: bool = True,
                on_error=None, path: str = "<criteo>",
                start_lineno: int = 1):
    """The plain Criteo parser, the spec of ``fm_parse_criteo``.

    Returns (ids[N,39] int32, labels[N] int8). A malformed line (wrong
    column count, non-integer label or count) raises ``ValueError`` by
    default; with ``on_error(path, lineno, line, reason)`` it is reported
    with its ``path`` and line number (``start_lineno`` for the first
    line) and dropped, so N shrinks to the good-row count
    (:func:`~fm_spark_tpu_torch.data.records.strict` raises instead).
    """
    n = len(lines)
    ids = np.empty((n, NUM_FIELDS), np.int32)
    labels = np.empty(n, np.int8)
    r = 0
    for k, line in enumerate(lines):
        try:
            label, row = parse_line(line, bucket, per_field)
        except ValueError as e:
            if on_error is None:
                raise
            on_error(path, start_lineno + k, line.rstrip(b"\r\n"), str(e))
            continue
        labels[r] = label
        ids[r] = row
        r += 1
    return ids[:r], labels[:r]


def preprocess(src_paths, out_dir: str, bucket: int, per_field: bool = True,
               chunk_bytes: int = 1 << 24, use_native: bool = True) -> int:
    """Stream Criteo TSV file(s) → packed dataset. Returns the example
    count.

    Chunked reads never split a line across a parse call: the native
    parser reports the bytes it consumed, and the tail goes in front of
    the next chunk. ``use_native=False`` parses with :func:`parse_lines`,
    which gives the same ids; a native library that does not build
    raises.
    """
    from fm_spark_tpu_torch import native

    if isinstance(src_paths, str):
        src_paths = [src_paths]
    with PackedWriter(out_dir, NUM_FIELDS, store_vals=False) as w:
        for path in src_paths:
            with open(path, "rb") as f:
                tail = b""
                while True:
                    chunk = f.read(chunk_bytes)
                    if not chunk and not tail:
                        break
                    buf = tail + chunk
                    if not chunk:
                        # Flush a final unterminated line, if any.
                        if not buf.endswith(b"\n"):
                            buf += b"\n"
                        tail = b""
                    if use_native:
                        ids, labels, consumed = native.parse_criteo_chunk(
                            buf, bucket, per_field)
                        tail = buf[consumed:] if chunk else b""
                    else:
                        nl = buf.rfind(b"\n")
                        complete, tail = buf[: nl + 1], buf[nl + 1:]
                        if not chunk:
                            tail = b""
                        lines = complete.splitlines()
                        ids, labels = parse_lines(lines, bucket, per_field)
                    if ids.shape[0]:
                        w.append(ids, labels)
                    if not chunk:
                        break
        count = w.num_examples
    return count


def synthesize_tsv(path: str, num_examples: int, seed: int = 0,
                   vocab_per_field: int = 1000, missing_rate: float = 0.05):
    """Write a Criteo-shaped synthetic TSV, one line at a time (the same
    bytes as the reference's for a seed). Token and count distributions
    are Zipf-skewed like the real logs."""
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        for _ in range(num_examples):
            cols = [b"1" if rng.random() < 0.25 else b"0"]
            for _f in range(NUM_INT):
                if rng.random() < missing_rate:
                    cols.append(b"")
                else:
                    cols.append(str(int(rng.zipf(1.5)) - 1).encode())
            for _f in range(NUM_CAT):
                if rng.random() < missing_rate:
                    cols.append(b"")
                else:
                    tok = int(rng.zipf(1.3)) % vocab_per_field
                    cols.append(f"{tok:08x}".encode())
            f.write(b"\t".join(cols) + b"\n")
