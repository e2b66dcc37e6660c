"""libSVM text format ↔ fixed-nnz arrays (a copy of
``fm_spark_tpu/data/libsvm.py``: the same file gives the same arrays in
both packages).

The reference ingests ``MLUtils.loadLibSVMFile`` → RDD[LabeledPoint] with
sparse vectors (SURVEY.md §3.3). The TPU-native representation is fixed-nnz
``(ids[N,S], vals[N,S], labels[N])``: rows with fewer than S non-zeros are
padded with ``val=0`` entries (a zero value contributes nothing to any FM
term — ops/fm.py), rows with more raise by default (truncation is opt-in,
silent data loss is not).

Error path (ISSUE 5): :func:`parse_libsvm_line` raises a DISTINCT
``ValueError`` per failure mode (missing label vs malformed ``idx:val``
pair vs unparseable label) with the offending token repr-escaped, and
:func:`load_libsvm` either raises with ``path:lineno`` context and the
truncated offending line, or — given ``on_error`` — reports and DROPS
the bad line (the hook of the quarantine policy, ROADMAP Queue 1
item 4).
"""

from __future__ import annotations

import numpy as np

from fm_spark_tpu_torch.data.records import preview_line


def parse_libsvm_line(line: bytes, zero_based: bool = False):
    """Parse ONE libSVM line (comments/terminator already stripped) →
    ``(label, idx, val)``.

    Raises ``ValueError`` with a failure-mode-specific message: a line
    whose first token is an ``idx:val`` pair is a MISSING LABEL (a
    common truncation artifact), distinct from an unparseable label and
    from a malformed ``idx:val`` pair — the pre-hardening parser
    collapsed all three into one opaque error. No source context here;
    callers (load_libsvm) add ``path:lineno``.
    """
    if isinstance(line, str):
        line = line.encode()
    parts = line.split(b"#")[0].split()
    if not parts:
        raise ValueError("blank line")
    head = parts[0]
    if b":" in head:
        raise ValueError(
            f"missing label (line starts with feature pair "
            f"{preview_line(head, 40)})"
        )
    try:
        label = float(head)
    except ValueError:
        raise ValueError(
            f"unparseable label {preview_line(head, 40)}"
        ) from None
    idx, val = [], []
    for p in parts[1:]:
        i, sep, v = p.partition(b":")
        if not sep or not i or not v:
            raise ValueError(
                f"malformed idx:val pair {preview_line(p, 40)}"
            )
        try:
            idx.append(int(i) - (0 if zero_based else 1))
            val.append(float(v))
        except ValueError:
            raise ValueError(
                f"malformed idx:val pair {preview_line(p, 40)}"
            ) from None
    if idx and min(idx) < 0:
        raise ValueError(
            "negative feature index — file is probably zero-based; "
            "pass zero_based=True"
        )
    return label, idx, val


def load_libsvm(path: str, max_nnz: int | None = None,
                truncate: bool = False, zero_based: bool = False,
                on_error=None):
    """Parse a libSVM file → ``(ids[N,S] int32, vals[N,S] f32, labels[N] f32)``.

    ``max_nnz`` fixes S (default: the file's max row nnz). One-based
    indices (the libSVM convention) are shifted to zero-based unless
    ``zero_based``. A malformed line raises with ``path:lineno`` context
    and the truncated, repr-escaped offending line; with
    ``on_error(path, lineno, line, reason)`` it is reported and DROPPED
    instead (the quarantine path).
    """
    rows: list[tuple[float, list[int], list[float]]] = []
    widest = 0
    with open(path, "rb") as f:
        for lineno, raw in enumerate(f, 1):
            stripped = raw.rstrip(b"\r\n")
            line = raw.split(b"#")[0].strip()
            if not line:
                continue
            try:
                label, idx, val = parse_libsvm_line(line,
                                                    zero_based=zero_based)
            except ValueError as e:
                if on_error is not None:
                    on_error(path, lineno, stripped, str(e))
                    continue
                raise ValueError(
                    f"{path}:{lineno}: bad libsvm line ({e}) — "
                    f"{preview_line(stripped)}"
                ) from e
            widest = max(widest, len(idx))
            rows.append((label, idx, val))
    S = max_nnz if max_nnz is not None else max(widest, 1)
    if widest > S and not truncate:
        raise ValueError(
            f"row with {widest} non-zeros exceeds max_nnz={S}; pass "
            "truncate=True to drop overflow features"
        )
    n = len(rows)
    ids = np.zeros((n, S), np.int32)
    vals = np.zeros((n, S), np.float32)
    labels = np.empty(n, np.float32)
    for r, (label, idx, val) in enumerate(rows):
        labels[r] = label
        k = min(len(idx), S)
        ids[r, :k] = idx[:k]
        vals[r, :k] = val[:k]
    return ids, vals, labels


def save_libsvm(path: str, ids: np.ndarray, vals: np.ndarray,
                labels: np.ndarray, zero_based: bool = False) -> None:
    """Write fixed-nnz arrays as libSVM text (zero-val entries dropped)."""
    off = 0 if zero_based else 1
    with open(path, "w") as f:
        for r in range(ids.shape[0]):
            lab = labels[r]
            parts = [f"{lab:.9g}"]
            for s in range(ids.shape[1]):
                if vals[r, s] != 0.0:
                    parts.append(f"{int(ids[r, s]) + off}:{vals[r, s]:.9g}")
            f.write(" ".join(parts) + "\n")
