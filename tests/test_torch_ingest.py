"""The port's input slice against the JAX package: feature hashing, the
Criteo and Avazu parsers, preprocessing into packed dirs, the packed
reader and its cursor, the compact aux's ``'split'`` policy, and the
native preprocessing library against its numpy versions.

Every comparison is exact: hashing and parsing are integer work, and the
packed format is bytes. Inputs come from the JAX package's synthesizers
(the port's write the same bytes) and numpy seeds.
"""

import json
import os
import re
import sys

import numpy as np
import pytest

from fm_spark_tpu import cli as jcli
from fm_spark_tpu.data import DedupAuxBatches as JDedupAuxBatches
from fm_spark_tpu.data import avazu as javazu
from fm_spark_tpu.data import criteo as jcriteo
from fm_spark_tpu.data import hashing as jhashing
from fm_spark_tpu.data import packed as jpacked
from fm_spark_tpu.ops import scatter as jscatter
from fm_spark_tpu_torch import cli, native
from fm_spark_tpu_torch.data import (DedupAuxBatches, PackedBatches,
                                     PackedDataset, PackedWriter, avazu,
                                     criteo,
                                     hashing, iter_packed_once, records,
                                     shuffle_packed)
from fm_spark_tpu_torch.ops import scatter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = ("ids.bin", "labels.bin", "meta.json")


def _same_dirs(a, b):
    assert sorted(os.listdir(a)) == sorted(os.listdir(b)) == sorted(FILES)
    for name in FILES:
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name


@pytest.fixture(scope="module")
def tsv(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("criteo") / "day.tsv")
    jcriteo.synthesize_tsv(path, 3000, seed=3)
    return path


@pytest.fixture(scope="module")
def csv(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("avazu") / "train.csv")
    javazu.synthesize_csv(path, 2000, seed=1)
    return path


# ------------------------------------------------------------- hashing


@pytest.mark.parametrize("data, seed, want", [
    (b"", 0, 0), (b"", 1, 0x514E28B7), (b"", 0xFFFFFFFF, 0x81F16F39),
    (b"Hello, world!", 1234, 0xFAF6CDB3), (b"abc", 0, None),
    (b"abcd", 7, None), (b"abcde" * 7, 99, None), (bytes(range(256)), 3, None)])
def test_murmur3_equals_jax_and_the_native_hash(data, seed, want):
    got = hashing.murmur3_32(data, seed)
    assert got == jhashing.murmur3_32(data, seed)
    assert got == native.murmur3_32(data, seed)
    if want is not None:
        assert got == want


@pytest.mark.parametrize("per_field", [True, False])
@pytest.mark.parametrize("bucket", [1, 97, 1 << 18])
def test_token_and_u64_batches_equal_jax(per_field, bucket):
    rng = np.random.default_rng(bucket)
    tokens = [bytes(rng.integers(0, 256, rng.integers(0, 13)).astype(np.uint8))
              for _ in range(500)]
    fields = rng.integers(0, 39, 500)
    want = jhashing.hash_tokens_batch(tokens, fields, bucket, per_field)
    np.testing.assert_array_equal(
        hashing.hash_tokens_batch(tokens, fields, bucket, per_field), want)
    np.testing.assert_array_equal(
        native.hash_tokens_batch(tokens, fields, bucket, per_field), want)
    keys = rng.integers(0, 1 << 62, 500).astype(np.uint64)
    keys[:2] = [(1 << 40), (1 << 40) + 1]           # the NEG and MISS keys
    h = jhashing.murmur3_u64(keys, fields.astype(np.uint32)) % np.uint32(bucket)
    want = h.astype(np.int64) + (fields * bucket if per_field else 0)
    np.testing.assert_array_equal(
        native.hash_u64_batch(keys, fields, bucket, per_field), want)
    vals = rng.integers(-3, 10**6, (100, 13))
    miss = rng.random((100, 13)) < 0.1
    f13 = np.broadcast_to(np.arange(13), (100, 13))
    np.testing.assert_array_equal(
        hashing.hash_int_features(vals, f13, bucket, per_field, missing=miss),
        jhashing.hash_int_features(vals, f13, bucket, per_field, missing=miss))


# -------------------------------------------------------------- parsing


def test_criteo_parsers_equal_jax(tsv):
    with open(tsv, "rb") as f:
        chunk = f.read()
    lines = chunk.splitlines()
    want_ids, want_labels = jcriteo.parse_lines(lines, 1 << 18)
    ids, labels = criteo.parse_lines(lines, 1 << 18)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(labels, want_labels)
    # The native chunk parser consumes complete lines only.
    cut = len(chunk) - 10
    nids, nlabels, consumed = native.parse_criteo_chunk(chunk[:cut], 1 << 18)
    assert consumed == chunk[:cut].rfind(b"\n") + 1
    np.testing.assert_array_equal(nids, want_ids[:len(nids)])
    np.testing.assert_array_equal(nlabels, want_labels[:len(nids)])
    assert len(nids) == len(lines) - 1


@pytest.mark.parametrize("use_native", [True, False])
def test_avazu_parser_equals_jax(csv, use_native):
    with open(csv, "rb") as f:
        lines = f.read().splitlines()[1:]
    want = javazu.parse_lines(lines, 1 << 14)
    got = avazu.parse_lines(lines, 1 << 14, use_native=use_native)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dataset", ["criteo", "avazu"])
def test_a_malformed_line_raises_with_path_and_lineno(tmp_path, tsv, csv,
                                                      dataset):
    from fm_spark_tpu_torch import configs

    src = tsv if dataset == "criteo" else csv
    with open(src, "rb") as f:
        lines = f.read().splitlines()[:20]
    lines[6] = b"1\tnot\ta\trow"
    bad = tmp_path / f"bad.{dataset}"
    bad.write_bytes(b"\n".join(lines) + b"\n")
    name = "criteo1tb_fm_r64" if dataset == "criteo" else "avazu_ffm_r16"
    with pytest.raises(records.BadRecord,
                       match=re.escape(f"{bad}:7: ") + ".*columns"):
        cli.load_text(configs.get_config(name), str(bad))
    # The parsers' own default, as the reference's: no context, a raise.
    mod, jmod = (criteo, jcriteo) if dataset == "criteo" else (avazu, javazu)
    body = lines[1:] if dataset == "avazu" else lines
    seen = []
    got = mod.parse_lines(body, 64, on_error=lambda *a: seen.append(a[:2]),
                          path="p")
    want = jmod.parse_lines(body, 64, on_error=lambda *a: None, path="p")
    np.testing.assert_array_equal(got[0], want[0])
    assert seen == [("p", 6 if dataset == "avazu" else 7)]
    with pytest.raises(ValueError, match="columns"):
        mod.parse_lines(body, 64)


def test_chip_smoke_criteo_writer_gives_lines_both_parsers_take(tmp_path):
    sys.path.insert(0, REPO)
    import chip_smoke

    path = str(tmp_path / "day.tsv")
    size = chip_smoke._criteo_tsv(path, 2000, seed=1)
    assert os.path.getsize(path) == size
    with open(path, "rb") as f:
        chunk = f.read()
    lines = chunk.splitlines()
    assert len(lines) == 2000
    cols = [line.split(b"\t") for line in lines]
    assert {len(c) for c in cols} == {40}
    empty = np.array([[tok == b"" for tok in c[1:]] for c in cols])
    assert 0.03 < empty.mean() < 0.07
    ids, labels = criteo.parse_lines(lines, 1 << 18)
    nids, nlabels, consumed = native.parse_criteo_chunk(chunk, 1 << 18)
    assert consumed == len(chunk)
    np.testing.assert_array_equal(nids, ids)
    np.testing.assert_array_equal(nlabels, labels)
    np.testing.assert_array_equal(
        ids, jcriteo.parse_lines(lines, 1 << 18)[0])


# -------------------------------------------------------- preprocessing


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("dataset", ["criteo", "avazu"])
def test_preprocess_writes_the_jax_packed_bytes(tmp_path, tsv, csv, dataset,
                                                shuffle, use_native):
    if dataset == "criteo":
        size = os.path.getsize(tsv)
        # At least two chunks, split mid-line.
        jcriteo.preprocess(tsv, str(tmp_path / "j"), 64, chunk_bytes=size // 3)
        n = criteo.preprocess(tsv, str(tmp_path / "p"), 64,
                              chunk_bytes=size // 3 + 17,
                              use_native=use_native)
        assert n == 3000
    else:
        javazu.preprocess(csv, str(tmp_path / "j"), 64, chunk_lines=300)
        n = avazu.preprocess(csv, str(tmp_path / "p"), 64, chunk_lines=7,
                             use_native=use_native)
        assert n == 2000
    if shuffle:
        # Small enough a budget that the shuffle deals into groups.
        jpacked.shuffle_packed(str(tmp_path / "j"), str(tmp_path / "js"),
                               seed=5, mem_budget_bytes=40_000)
        shuffle_packed(str(tmp_path / "p"), str(tmp_path / "ps"), seed=5,
                       mem_budget_bytes=40_000)
        _same_dirs(tmp_path / "js", tmp_path / "ps")
    else:
        _same_dirs(tmp_path / "j", tmp_path / "p")


@pytest.mark.parametrize("dataset", ["criteo", "avazu"])
def test_both_clis_preprocess_to_the_same_bytes(tmp_path, capsys, tsv, csv,
                                                 dataset):
    name = "criteo1tb_fm_r64" if dataset == "criteo" else "avazu_ffm_r16"
    src = tsv if dataset == "criteo" else csv
    out = []
    for tag, main in (("j", jcli.main), ("p", cli.main)):
        d = str(tmp_path / tag)
        assert main(["preprocess", "--config", name, "--input", src,
                     "--out-dir", d]) == 0
        out.append(d)
        assert not os.path.exists(d + ".unshuffled.tmp")
    _same_dirs(*out)
    advice = []
    for main in (jcli.main, cli.main):
        assert main(["cap-advise", "--data", out[1], "--batch-size", "512",
                     "--batches", "3", "--seed", "2"]) == 0
        advice.append(json.loads(capsys.readouterr().out.splitlines()[-1]))
    keys = ("max_unique_per_field_overall", "per_batch_max", "per_field_max",
            "recommended_compact_cap", "batches_scanned")
    assert {k: advice[0][k] for k in keys} == {k: advice[1][k] for k in keys}


# --------------------------------------------------------- packed reader


@pytest.fixture(scope="module")
def packed(tmp_path_factory, tsv):
    base = tmp_path_factory.mktemp("packed")
    criteo.preprocess(tsv, str(base / "raw"), 64)
    shuffle_packed(str(base / "raw"), str(base / "dir"), seed=0)
    return str(base / "dir")


@pytest.mark.parametrize("bucket", [0, 64])
def test_packed_batches_and_cursor_equal_jax(packed, bucket):
    ds, jds = PackedDataset(packed), jpacked.PackedDataset(packed)
    kw = dict(seed=4, chunk_size=700, row_range=(0, 2400), bucket=bucket)
    pb, jb = PackedBatches(ds, 500, **kw), jpacked.PackedBatches(jds, 500,
                                                                 **kw)
    states = []
    for _ in range(11):                        # crosses two epochs
        for g, w in zip(pb.next_batch(), jb.next_batch()):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert pb.state() == jb.state()
        states.append(pb.state())
    assert states[-1]["epoch"] == 2
    # A restore mid-epoch, from each package's saved cursor into the other.
    pb2, jb2 = PackedBatches(ds, 500, **kw), jpacked.PackedBatches(jds, 500,
                                                                   **kw)
    pb2.restore(states[6])
    jb2.restore(dict(states[6]))
    for _ in range(4):
        want = jb2.next_batch()
        for g, w in zip(pb2.next_batch(), want):
            np.testing.assert_array_equal(g, w)
    assert pb2.state() == jb2.state()
    with pytest.raises(ValueError, match="different seed"):
        PackedBatches(ds, 500, seed=5, chunk_size=700, row_range=(0, 2400),
                      bucket=bucket).restore(states[0])
    for g, w in zip(iter_packed_once(ds, 700, bucket, (2400, 3000)),
                    jcli.iter_packed_once(jds, 700, bucket, (2400, 3000))):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_threads", [1, 4])
@pytest.mark.parametrize("store_vals", [False, True])
@pytest.mark.parametrize("bucket", [0, 64])
def test_assemble_native_equals_numpy_and_jax(tmp_path, packed, n_threads,
                                              store_vals, bucket):
    ds = PackedDataset(packed)
    if store_vals:
        with PackedWriter(str(tmp_path / "v"), ds.num_fields) as w:
            rng = np.random.default_rng(0)
            w.append(np.asarray(ds.ids[:]), np.asarray(ds.labels[:]),
                     rng.uniform(0.5, 2, ds.ids.shape).astype(np.float32))
        ds = PackedDataset(str(tmp_path / "v"))
    jds = jpacked.PackedDataset(ds.path)
    rng = np.random.default_rng(n_threads)
    for sel in (rng.integers(0, 3000, 777), np.s_[100:900], np.s_[5:6]):
        got = ds.assemble(sel, bucket=bucket, n_threads=n_threads)
        plain = ds.assemble(sel, bucket=bucket, use_native=False)
        want = jds.assemble(sel, bucket=bucket)
        for g, p, w in zip(got, plain, want):
            assert g.dtype == p.dtype == w.dtype
            np.testing.assert_array_equal(g, p)
            np.testing.assert_array_equal(g, w)
    if not store_vals:
        vals = ds.assemble(np.arange(4))[1]
        assert not vals.flags.writeable           # the shared all-ones
    with pytest.raises(ValueError, match="out of range"):
        ds.assemble(np.array([0, 3000]))


def test_a_failed_fasthash_build_raises(tmp_path, monkeypatch):
    fake = tmp_path / "g++"
    fake.write_text("#!/bin/sh\necho 'fasthash.cpp:1: error: bad'\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(native, "_gxx", lambda: str(fake))
    monkeypatch.setattr(native, "_fast", None)
    with pytest.raises(native.NativeBuildError, match="error: bad"):
        native.murmur3_32(b"x")
    # No fallback: the preprocessing that asks for the native path raises.
    with pytest.raises(native.NativeBuildError):
        avazu.parse_lines([b"1,0,14102100," + b"a," * 20 + b"a"], 64)


# -------------------------------------------------------- 'split' policy


def test_split_gives_the_jax_sub_batches_and_cursor(packed):
    ds, jds = PackedDataset(packed), jpacked.PackedDataset(packed)
    kw = dict(seed=2, chunk_size=900, bucket=64)
    cap = 40          # a batch of 512 holds more distinct ids in a field
    src = DedupAuxBatches(PackedBatches(ds, 512, **kw), cap=cap,
                          overflow="split")
    ref = JDedupAuxBatches(jpacked.PackedBatches(jds, 512, **kw), cap=cap,
                           overflow="split")
    outs, saved, splits = [], [], 0
    for _ in range(12):
        got, want = src.next_batch(), ref.next_batch()
        for g, w in zip(got[:4], want[:4]):
            assert g.shape[0] == 512                # the step's static B
            np.testing.assert_array_equal(g, w)
        for g, w in zip(got[4], want[4]):
            np.testing.assert_array_equal(g, w)
        assert src.state() == ref.state()
        splits += int(got[3].sum() < 512)
        outs.append(got)
        saved.append(src.state())
    assert splits >= 4
    # While halves are pending the state is the cursor before the split
    # batch (so two states in a row repeat): a resume from it replays the
    # whole batch, a part already trained first, as JAX's does.
    j = next(i for i in range(1, 12) if saved[i] == saved[i - 1])
    again = DedupAuxBatches(PackedBatches(ds, 512, **kw), cap=cap,
                            overflow="split")
    jagain = JDedupAuxBatches(jpacked.PackedBatches(jds, 512, **kw), cap=cap,
                              overflow="split")
    again.restore(saved[j])
    jagain.restore(dict(saved[j]))
    replay = [again.next_batch() for _ in range(4)]
    for got in replay:
        for g, w in zip(got[:4], jagain.next_batch()[:4]):
            np.testing.assert_array_equal(g, w)
        assert again.state() == jagain.state()
    assert any(np.array_equal(replay[0][0], o[0]) for o in outs[:j + 1])
    with pytest.raises(scatter.CompactCapOverflow):
        DedupAuxBatches(PackedBatches(ds, 512, **kw), cap=cap).next_batch()
    with pytest.raises(jscatter.CompactCapOverflow):
        JDedupAuxBatches(jpacked.PackedBatches(jds, 512, **kw),
                         cap=cap).next_batch()
