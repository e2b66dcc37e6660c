"""Deterministic feature hashing: raw field values → bucket ids (the
port's copy of ``fm_spark_tpu/data/hashing.py``: the same ids in both
packages).

MurmurHash3 x86_32, seeded per field so the same token in different
fields gets independent ids; Python's salted ``hash()`` would differ
across hosts and runs. Two layouts:

- **flat**: ``id = murmur3(token, seed=field) % num_buckets``;
- **per-field** (FieldFM and FieldFFM):
  ``id = field * bucket + murmur3(token, seed=field) % bucket``.

This numpy implementation is the plain version of the native hashing in
``native/fasthash.cpp`` (:mod:`fm_spark_tpu_torch.native`), which gives
the same ids bit for bit (tests hold them equal).

Integer features (Criteo's 13 count columns) are one-hot encoded by
log-squashed bin, ``bin = floor(log1p(x)²)``, hashed as a u64 key;
negatives and missing values get dedicated keys.
"""

from __future__ import annotations

import math

import numpy as np


_C1 = np.uint32(0xCC9E2D51)
_C2 = np.uint32(0x1B873593)


def _rotl32(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _fmix32(h: np.ndarray) -> np.ndarray:
    h ^= h >> np.uint32(16)
    h *= np.uint32(0x85EBCA6B)
    h ^= h >> np.uint32(13)
    h *= np.uint32(0xC2B2AE35)
    h ^= h >> np.uint32(16)
    return h


def murmur3_32(data: bytes, seed: int = 0) -> int:
    """MurmurHash3 x86_32 of ``data`` — scalar, canonical implementation."""
    h = np.uint32(seed)
    n = len(data)
    nblocks = n // 4
    with np.errstate(over="ignore"):
        if nblocks:
            blocks = np.frombuffer(data[: nblocks * 4], dtype="<u4")
            for k in blocks:
                k = np.uint32(k) * _C1
                k = _rotl32(k, 15) * _C2
                h ^= k
                h = _rotl32(h, 13) * np.uint32(5) + np.uint32(0xE6546B64)
        tail = data[nblocks * 4:]
        k = np.uint32(0)
        if len(tail) >= 3:
            k ^= np.uint32(tail[2]) << np.uint32(16)
        if len(tail) >= 2:
            k ^= np.uint32(tail[1]) << np.uint32(8)
        if len(tail) >= 1:
            k ^= np.uint32(tail[0])
            k *= _C1
            k = _rotl32(k, 15) * _C2
            h ^= k
        h ^= np.uint32(n)
        h = _fmix32(h)
    return int(h)


def murmur3_u64(keys: np.ndarray, seed: int | np.ndarray = 0) -> np.ndarray:
    """Vectorized MurmurHash3 x86_32 over uint64 keys (as 8 LE bytes).

    Bit-identical to ``murmur3_32(key.tobytes('<u8'), seed)``. ``seed`` may
    be a scalar or an array broadcastable against ``keys`` (per-field
    seeds).
    """
    keys = np.asarray(keys, np.uint64)
    seed = np.asarray(seed, np.uint32)
    with np.errstate(over="ignore"):
        h = np.broadcast_to(seed, keys.shape).copy()
        for block in (keys & np.uint64(0xFFFFFFFF), keys >> np.uint64(32)):
            k = block.astype(np.uint32) * _C1
            k = _rotl32(k, 15) * _C2
            h ^= k
            h = _rotl32(h, 13) * np.uint32(5) + np.uint32(0xE6546B64)
        h ^= np.uint32(8)
        h = _fmix32(h)
    return h


def hash_token(field: int, token: bytes | str, bucket: int,
               per_field: bool = True) -> int:
    """One token → bucket id (the scalar spec the batch paths must match)."""
    if isinstance(token, str):
        token = token.encode("utf-8")
    h = murmur3_32(token, seed=field) % bucket
    return field * bucket + h if per_field else h


def int_feature_token(x) -> bytes:
    """Criteo-style integer feature → one-hot token (log1p² binning)."""
    if x is None or x == "":
        return b"__missing__"
    x = int(x)
    if x < 0:
        return b"__neg__"
    return str(int(math.floor(math.log1p(x) ** 2))).encode()


def hash_int_features(values: np.ndarray, fields: np.ndarray, bucket: int,
                      per_field: bool = True,
                      missing: np.ndarray | None = None) -> np.ndarray:
    """Vectorized integer-feature hashing: [N, F] int64 values → bucket ids.

    Matches ``hash_token(field, int_feature_token(x), bucket)`` for every
    element (the token's decimal-string bytes are re-derived from the bin
    because murmur3_u64 hashes fixed 8-byte keys; instead we hash the BIN
    VALUE as a u64 key — a distinct keying from the string path, so this
    function pairs with :func:`hash_int_u64_spec` as its scalar oracle).
    ``missing`` marks elements that get the dedicated missing key.
    """
    values = np.asarray(values, np.int64)
    neg = values < 0
    safe = np.where(neg, 0, values)
    bins = np.floor(np.log1p(safe.astype(np.float64)) ** 2).astype(np.uint64)
    # Reserved keys far above any log1p² bin (< ~2000 for int64 range).
    NEG_KEY = np.uint64(1 << 40)
    MISS_KEY = np.uint64((1 << 40) + 1)
    keys = np.where(neg, NEG_KEY, bins)
    if missing is not None:
        keys = np.where(missing, MISS_KEY, keys)
    h = murmur3_u64(keys, seed=np.asarray(fields, np.uint32)) % np.uint32(bucket)
    ids = h.astype(np.int64)
    if per_field:
        ids = ids + np.asarray(fields, np.int64) * bucket
    return ids


def hash_int_u64_spec(field: int, key: int, bucket: int,
                      per_field: bool = True) -> int:
    """Scalar oracle for :func:`hash_int_features` (u64-keyed murmur)."""
    h = int(murmur3_u64(np.asarray([key], np.uint64), seed=field)[0]) % bucket
    return field * bucket + h if per_field else h


def hash_tokens_batch(tokens: list[bytes], fields: np.ndarray, bucket: int,
                      per_field: bool = True) -> np.ndarray:
    """Hash a flat list of byte tokens with per-element field seeds.

    Pure-Python loop — the portable fallback; the C++ extension provides
    the fast path with identical output (tests assert it).
    """
    fields = np.asarray(fields, np.int64)
    out = np.empty(len(tokens), np.int64)
    for i, tok in enumerate(tokens):
        out[i] = hash_token(int(fields[i]), tok, bucket, per_field)
    return out
