"""The port's native raw-text stream (``data/native_stream.py``) against
its Python stream and the JAX package's native stream: a differential
fuzz over dirty Criteo, Avazu and libSVM shards (batches, cursors and
dead-letter records equal at every step), cursors restored across the two
paths, the fault points taking the policy path, the producer-side
wrappers (``MappedBatches``, ``StackedBatches``) and ``fmtorch train``'s
stream levers and refusals.
"""

import argparse
from unittest import mock

import numpy as np
import pytest

from fm_spark_tpu.data import native_stream as jnative_stream
from fm_spark_tpu.data import stream as jstream
from fm_spark_tpu_torch import native
from fm_spark_tpu_torch.data import native_stream, stream
from fm_spark_tpu_torch.resilience import faults
from fm_spark_tpu_torch.utils.logging import read_events

NUM_INT, NUM_CAT = 13, 26


def _criteo_lines(rng, n):
    dirty = [
        b"\x00garbage \xff\xfe", b"1\tonly\tthree\tcols", b"", b"   \t  ",
        b"x" + b"\t1" * (NUM_INT + NUM_CAT),
        b"1\tfoo" + b"\t1" * (NUM_INT + NUM_CAT - 1),
        b"1" + b"\t2" * (NUM_INT + NUM_CAT) + b"\t",
        # Python-parseable, outside the strict native grammar: back
        # through the Python parser, bit for bit.
        b"+1" + b"\t3" * (NUM_INT + NUM_CAT),
        b"1\t+7" + b"\t4" * (NUM_INT + NUM_CAT - 1),
        b"1\t" + b"1" * 21 + b"\t5" * (NUM_INT + NUM_CAT - 1),
        b"1\t-abc" + b"\t6" * (NUM_INT + NUM_CAT - 1),
    ]
    out = []
    for i in range(n):
        if i % 10 == 3:
            out.append(dirty[(i // 10) % len(dirty)])
            continue
        cols = [b"1" if rng.random() < 0.3 else b"0"]
        cols += [b"" if rng.random() < 0.1
                 else str(int(rng.integers(0, 5000))).encode()
                 for _ in range(NUM_INT)]
        cols += [b"" if rng.random() < 0.1
                 else b"%06x" % int(rng.integers(0, 4000))
                 for _ in range(NUM_CAT)]
        out.append(b"\t".join(cols))
    return out


def _avazu_lines(rng, n):
    dirty = [b"\x00garbage", b"1,2,3", b"", b"id,click,hour" + b",h" * 21,
             b"1,1,14bad103" + b",t" * 21, b"1,0,14134108" + b",t" * 21,
             b"1,0,14103208" + b",t" * 21, b"1,0,1410" + b",t" * 21,
             b"1,0,+1102108" + b",t" * 21]
    out = []
    for i in range(n):
        if i % 10 == 4:
            out.append(dirty[(i // 10) % len(dirty)])
            continue
        cols = [str(10_000_000 + i).encode(),
                b"1" if rng.random() < 0.2 else b"0",
                f"1410{int(rng.integers(21, 29)):02d}"
                f"{int(rng.integers(0, 24)):02d}".encode()]
        cols += [b"%05x" % int(rng.integers(0, 3000)) for _ in range(21)]
        out.append(b",".join(cols))
    return out


def _libsvm_lines(rng, n, num_features=512, max_nnz=6):
    dirty = [b"# a full-line comment", b"", b"1:2.5 3:1", b"abc 1:2",
             b"1 2:3:4", b"1 :5", b"1 5:", b"1 -3:1", b"0 0:1", b"1 9999:1",
             b"1 " + b" ".join(b"%d:1" % (i + 1) for i in range(9)),
             b"1 2:inf", b"inf 2:1", b"1e999 2:1", b"+1.5 2:1.25",
             b"1 1_0:2.5", b"1 3:1_0.5", b"1", b"1 4:1e2  # trailing"]
    out = []
    for i in range(n):
        if i % 8 == 2:
            out.append(dirty[(i // 8) % len(dirty)])
            continue
        nnz = int(rng.integers(1, max_nnz + 1))
        idx = rng.choice(num_features, size=nnz, replace=False) + 1
        out.append(b"%d %s" % (i % 2, b" ".join(
            b"%d:%s" % (int(ix), f"{v:.6g}".encode())
            for ix, v in zip(idx, rng.normal(size=nnz)))))
    return out


def _write_shards(tmp_path, lines, name, header=None, crlf_every=0):
    paths = []
    per = (len(lines) + 2) // 3
    for s in range(3):
        p = str(tmp_path / name.format(s))
        with open(p, "wb") as f:
            if header is not None and s == 0:
                f.write(header + b"\n")
            for j, line in enumerate(lines[s * per:(s + 1) * per]):
                f.write(line + (b"\r\n" if crlf_every and j % crlf_every == 1
                                else b"\n"))
        paths.append(p)
    return paths


def _dead(path):
    return [(e["path"], e["lineno"], e["reason"], e["line"])
            for e in read_events(path) if e["event"] == "bad_record"]


CASES = {
    "criteo": (_criteo_lines, 39, 1 << 12, "s{}.tsv", None, 7),
    "avazu": (_avazu_lines, 23, 1 << 11, "s{}.csv", b"id,", 0),
    "libsvm": (_libsvm_lines, 6, 0, "s{}.svm", None, 5),
}


@pytest.mark.parametrize("dataset", list(CASES))
def test_differential_fuzz_against_python_and_jax(tmp_path, rng, dataset):
    """The port's native stream, its Python stream and JAX's native stream
    over the same dirty shards at different chunk sizes: every batch, every
    cursor, the guard's counters and the dead-letter records equal."""
    gen, nnz, bucket, name, hp, crlf = CASES[dataset]
    nf = nnz * bucket if bucket else 512
    lines = gen(rng, 1500 if dataset == "criteo" else 3000)
    paths = _write_shards(tmp_path, lines, name, header=(
        b"id,click,hour" + b",h" * 21 if hp else None), crlf_every=crlf)

    def guard(mod, tag):
        return mod.RecordGuard("quarantine", str(tmp_path / tag))

    srcs = [
        native_stream.NativeStreamBatches(
            stream.ShardReader(paths, chunk_bytes=311, header_prefix=hp),
            dataset, 128, nnz, guard=guard(stream, "n"), num_features=nf,
            bucket=bucket),
        stream.StreamBatches(
            stream.ShardReader(paths, chunk_bytes=97, header_prefix=hp),
            stream.line_parser(dataset, bucket), 128, nnz,
            guard=guard(stream, "p"), num_features=nf),
        jnative_stream.NativeStreamBatches(
            jstream.ShardReader(paths, chunk_bytes=1 << 12,
                                header_prefix=hp),
            dataset, 128, nnz, guard=guard(jstream, "j"), num_features=nf,
            bucket=bucket)]
    n = 16 if dataset == "criteo" else 30              # past one epoch
    for i in range(n):
        got = [s.next_batch() for s in srcs]
        for other in got[1:]:
            for x, y in zip(got[0], other):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y, err_msg=f"batch {i}")
        assert srcs[0].state() == srcs[1].state() == srcs[2].state(), i
    assert srcs[0].state()["epoch"] >= 1
    assert srcs[0].guard.n_bad > 50
    dead = [_dead(str(tmp_path / t / "deadletter.jsonl")) for t in "npj"]
    assert dead[0] == dead[1] == dead[2]


@pytest.mark.parametrize("chunk", [1, 3, 64, 1 << 16])
def test_unterminated_last_line_at_any_chunk(tmp_path, chunk):
    p = str(tmp_path / "u.svm")
    with open(p, "wb") as f:
        f.write(b"1 1:1.0\n0 2:1.0\r\n1 3:2.5")
    nat = native_stream.NativeStreamBatches(
        stream.ShardReader([p], chunk_bytes=chunk), "libsvm", 2, 2,
        num_features=16)
    py = stream.StreamBatches(stream.ShardReader([p], chunk_bytes=5),
                              stream.line_parser("libsvm"), 2, 2,
                              num_features=16)
    for _ in range(3):
        for x, y in zip(nat.next_batch(), py.next_batch()):
            np.testing.assert_array_equal(x, y)
        assert nat.state() == py.state()


def test_strict_policy_raises_the_same_bad_record(tmp_path):
    p = str(tmp_path / "s.svm")
    with open(p, "wb") as f:
        f.write(b"1 1:1.0\ngarbage line\n0 2:1.0\n")
    msgs = []
    for src in (native_stream.NativeStreamBatches(
            stream.ShardReader([p]), "libsvm", 4, 2, num_features=16),
            stream.StreamBatches(stream.ShardReader([p]),
                                 stream.line_parser("libsvm"), 4, 2,
                                 num_features=16)):
        with pytest.raises(stream.BadRecord) as e:
            src.next_batch()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "s.svm:2" in msgs[0]


@pytest.mark.parametrize("first,second", [("python", "native"),
                                          ("native", "python"),
                                          ("jax", "native"),
                                          ("native", "jax")])
def test_cursors_restore_across_the_paths(tmp_path, rng, first, second):
    """A cursor written by one path (or by the JAX package) resumes on the
    other with the same continuation."""
    paths = _write_shards(tmp_path, _libsvm_lines(rng, 600), "s{}.svm")

    def fresh(kind, tag):
        if kind == "jax":
            return jstream.StreamBatches(
                jstream.ShardReader(paths, chunk_bytes=71),
                jstream.line_parser("libsvm"), 32, 6,
                guard=jstream.RecordGuard("quarantine", str(tmp_path / tag)),
                num_features=512)
        guard = stream.RecordGuard("quarantine", str(tmp_path / tag))
        if kind == "python":
            return stream.StreamBatches(
                stream.ShardReader(paths, chunk_bytes=53),
                stream.line_parser("libsvm"), 32, 6, guard=guard,
                num_features=512)
        return native_stream.NativeStreamBatches(
            stream.ShardReader(paths, chunk_bytes=201), "libsvm", 32, 6,
            guard=guard, num_features=512)

    src = fresh(first, "a")
    for _ in range(5):
        src.next_batch()
    state = src.state()
    want = [src.next_batch() for _ in range(8)]
    dst = fresh(second, "b")
    dst.restore(dict(state))
    for w in want:
        for x, y in zip(dst.next_batch(), w):
            np.testing.assert_array_equal(x, y)
    assert dst.state() == src.state()
    assert dst.guard.counters() == src.guard.counters()


# ------------------------------------------------------------ fault points


def _raising(point, exc):
    """An ``inject`` that raises ``exc`` at the first call of ``point``."""
    fired = []

    def inject(p):
        if p == point and not fired:
            fired.append(p)
            raise exc
    return inject


@pytest.mark.parametrize("path", ["native", "python"])
def test_ingest_corrupt_takes_the_policy_path(tmp_path, path):
    p = str(tmp_path / "s.svm")
    with open(p, "wb") as f:
        f.write(b"\n   \n" + b"1 1:1.0\n" * 10)

    def make(guard):
        if path == "native":
            return native_stream.NativeStreamBatches(
                stream.ShardReader([p]), "libsvm", 4, 2, guard=guard,
                num_features=16)
        return stream.StreamBatches(stream.ShardReader([p]),
                                    stream.line_parser("libsvm"), 4, 2,
                                    guard=guard, num_features=16)

    guard = stream.RecordGuard("quarantine", str(tmp_path / "q"))
    with mock.patch.object(faults, "inject", _raising(
            "ingest_corrupt", faults.FaultInjected("injected failure at "
                                                   "ingest_corrupt#1"))):
        make(guard).next_batch()
    # The first REAL record (line 3: blanks are skipped before the fault
    # point) took the injected reason through quarantine.
    events = read_events(guard.dead_letter_path)
    assert guard.n_bad == 1 and len(events) == 1
    assert events[0]["lineno"] == 3 and "ingest_corrupt" in events[0]["reason"]
    with mock.patch.object(faults, "inject", _raising(
            "ingest_corrupt", faults.FaultInjected("boom"))):
        with pytest.raises(stream.BadRecord, match="boom"):
            make(stream.RecordGuard()).next_batch()
    with mock.patch.object(faults, "inject", _raising(
            "ingest_corrupt", faults.InjectedDeviceLoss("ingest_corrupt",
                                                        1))):
        with pytest.raises(faults.InjectedDeviceLoss):
            make(stream.RecordGuard()).next_batch()
    with mock.patch.object(faults, "inject", _raising(
            "ingest_truncate", faults.FaultInjected("cut"))):
        with pytest.raises(faults.FaultInjected, match="cut"):
            make(stream.RecordGuard()).next_batch()
    assert "ingest_corrupt" in faults.KNOWN_POINTS
    faults.inject("ingest_truncate")               # a no-op without a plan


# ----------------------------------------------------- factory / fallback


def test_factory_picks_native_and_falls_back_outside_the_contract(tmp_path):
    p = str(tmp_path / "s.svm")
    with open(p, "wb") as f:
        f.write(b"1 1:1.0\n0 2:1.0\n")
    got = native_stream.make_stream_batches(stream.ShardReader([p]),
                                            "libsvm", 2, 2, num_features=16)
    assert isinstance(got, native_stream.NativeStreamBatches)
    assert native.stream_parse_available("criteo")
    assert not native_stream.native_stream_supported("criteo", 10, 1 << 10)
    assert native_stream.native_stream_supported("criteo", 39, 1 << 10)
    reason = native_stream.native_stream_unsupported_reason(
        "criteo", 39, 1 << 26)
    assert reason == jnative_stream.native_stream_unsupported_reason(
        "criteo", 39, 1 << 26)
    got = native_stream.make_stream_batches(
        stream.ShardReader([p]), "criteo", 2, 10, bucket=1 << 10)
    assert type(got) is stream.StreamBatches
    with pytest.raises(RuntimeError, match="native ingest requested"):
        native_stream.make_stream_batches(
            stream.ShardReader([p]), "criteo", 2, 10, bucket=1 << 10,
            native_ingest=True)
    # A library that does not build raises; nothing falls back.
    with mock.patch.object(native, "load_fast",
                           side_effect=native.NativeBuildError("no g++")):
        with pytest.raises(native.NativeBuildError):
            native_stream.make_stream_batches(stream.ShardReader([p]),
                                              "libsvm", 2, 2)


# ------------------------------------------------------ the wrappers


def test_mapped_and_stacked_batches_pass_state_and_guard_through(tmp_path,
                                                                 rng):
    from fm_spark_tpu_torch.data import (MappedBatches, Prefetcher,
                                         StackedBatches)

    paths = _write_shards(tmp_path, _libsvm_lines(rng, 300), "s{}.svm")
    guard = stream.RecordGuard("quarantine", str(tmp_path / "q"))
    src = native_stream.NativeStreamBatches(
        stream.ShardReader(paths), "libsvm", 16, 6, guard=guard,
        num_features=512)
    mapped = MappedBatches(src, lambda b: (b[0] + 1, *b[1:]))
    stacked = StackedBatches(mapped, 3, total=7)
    assert stacked.guard is guard and mapped.guard is guard
    shapes = []
    for _ in range(3):
        b = stacked.next_batch()
        shapes.append(b[0].shape)
        assert stacked.state() == src.state()
    assert shapes == [(3, 16, 6)] * 3
    with pytest.raises(StopIteration):
        stacked.next_batch()                        # 7 source batches read
    assert src.state()["records"] >= 7 * 16
    # The tail stack pads with copies of its last real batch.
    np.testing.assert_array_equal(b[0][1], b[0][2])
    state = src.state()
    with Prefetcher(StackedBatches(MappedBatches(src, lambda b: b), 2),
                    depth=2) as pf:
        pf.next_batch()
        assert pf.guard is guard
    fresh = native_stream.NativeStreamBatches(
        stream.ShardReader(paths), "libsvm", 16, 6, num_features=512)
    StackedBatches(MappedBatches(fresh, lambda b: b), 2).restore(state)
    assert fresh.state() == state


@pytest.mark.parametrize("lever", [
    dict(sparse_update="scatter_add"),
    dict(sparse_update="dedup", host_dedup=True, compact_cap=256)])
def test_two_steps_per_call_over_a_stream_equal_one(tmp_path, lever):
    """``fit_field_sparse`` over a raw-text stream: a roll of 2 (stacked on
    the producer thread) gives the params, losses and cursor of single
    steps bit for bit, over an odd step count (the tail stack)."""
    import torch

    from fm_spark_tpu_torch import models
    from fm_spark_tpu_torch.cli import _field_local_rows
    from fm_spark_tpu_torch.data import MappedBatches, criteo
    from fm_spark_tpu_torch.train import TrainConfig, fit_field_sparse

    criteo.synthesize_tsv(str(tmp_path / "d.tsv"), 700, seed=2)
    with open(tmp_path / "d.tsv", "rb") as f:
        lines = f.read().splitlines()
    lines[10] = b"garbage"
    paths = _write_shards(tmp_path, lines, "s{}.tsv")
    spec = models.FieldFMSpec(num_features=39 * 64, rank=4, num_fields=39,
                              bucket=64, init_std=0.1)
    cfg = TrainConfig(num_steps=5, batch_size=256, learning_rate=0.05,
                      reg_factors=1e-4, log_every=1, **lever)
    runs = []
    for spc in (1, 2):
        src = MappedBatches(native_stream.NativeStreamBatches(
            stream.ShardReader(paths), "criteo", 256, 39,
            guard=stream.RecordGuard("quarantine", str(tmp_path / f"q{spc}")),
            num_features=39 * 64, bucket=64),
            lambda b: _field_local_rows(b, 64))
        stats = {}
        params = fit_field_sparse(spec, cfg, src, device="cpu",
                                  steps_per_call=spc, stats=stats)
        runs.append((params, stats))
    (p1, s1), (p2, s2) = runs
    assert torch.equal(p1["w0"], p2["w0"])
    assert all(torch.equal(a, b) for a, b in zip(p1["vw"], p2["vw"]))
    assert s1["ingest"]["bad_records"] == s2["ingest"]["bad_records"] == 2
    assert s1["loss"][-1] == s2["loss"][-1]


# ----------------------------------------------------- fmtorch's levers


def _args(**kw):
    base = dict(data=None, test_fraction=0.0, native_ingest=False,
                data_policy="strict", quarantine_dir=None, max_bad_frac=1.0)
    base.update(kw)
    return argparse.Namespace(**base)


def test_stream_levers_and_refusals(tmp_path, monkeypatch, capsys):
    from fm_spark_tpu_torch import cli, configs
    from fm_spark_tpu_torch.data import criteo

    cfg = configs.get_config("criteo1tb_fm_r64", bucket=64)
    tcfg = cfg.train_config(batch_size=32)
    paths = []
    for i in range(2):
        p = str(tmp_path / f"s{i}.tsv")
        criteo.synthesize_tsv(p, 50, seed=i)
        paths.append(p)
    data = ",".join(paths)
    with pytest.raises(SystemExit, match="missing shard"):
        cli._stream_source(_args(data=data + ",nope.tsv"), cfg, tcfg)
    with pytest.raises(SystemExit, match="--test-fraction 0"):
        cli._stream_source(_args(data=data, test_fraction=0.2), cfg, tcfg)
    # Quarantine without --quarantine-dir: refused with the plane off,
    # the dead letters under the run dir with it on.
    with pytest.raises(SystemExit, match="needs --quarantine-dir or an obs"):
        cli._stream_source(_args(data=data, data_policy="quarantine"), cfg,
                           tcfg)
    from fm_spark_tpu_torch import obs

    obs.configure(str(tmp_path / "run"))
    try:
        _, q = cli._stream_source(_args(data=data, data_policy="quarantine"),
                                  cfg, tcfg)
        assert q.guard.dead_letter_path == str(tmp_path / "run" /
                                               stream.DEAD_LETTER_FILE)
        q.close()
        q.guard.close()
    finally:
        obs.shutdown()
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="single-process"):
        cli._stream_source(_args(data=data), cfg, tcfg)
    monkeypatch.delenv("WORLD_SIZE")
    src, s = cli._stream_source(_args(data=data, native_ingest=True), cfg,
                                tcfg)
    assert isinstance(s, native_stream.NativeStreamBatches)
    ids = src.next_batch()[0]
    assert ids.min() >= 0 and ids.max() < 64          # field-local
    # Outside the native contract (an id space past int32): the Python
    # parser, with the reason on stderr.
    wide = configs.get_config("criteo1tb_fm_r64", bucket=1 << 26)
    _, s = cli._stream_source(_args(data=data, native_ingest=True), wide,
                              wide.train_config(batch_size=32))
    assert type(s) is stream.StreamBatches
    assert "fell back to the pure-Python" in capsys.readouterr().err
    parser = cli.build_parser()
    args = parser.parse_args(["train", "--config", "criteo1tb_fm_r64",
                              "--steps", "1", "--data", data, "--lr", "0.3",
                              "--loss", "hinge", "--seed", "7",
                              "--prefetch", "0", "--table-layout", "col",
                              "--max-bad-frac", "0.1"])
    assert (args.lr, args.loss, args.seed, args.prefetch, args.table_layout,
            args.max_bad_frac) == (0.3, "hinge", 7, 0, "col", 0.1)


def test_in_memory_text_goes_through_the_guard(tmp_path):
    """``load_text``: quarantine drops a bad line into the dead-letter
    journal, strict raises with path:lineno, and the whole-load breaker
    aborts past --max-bad-frac."""
    from fm_spark_tpu_torch import cli, configs
    from fm_spark_tpu_torch.data import criteo

    cfg = configs.get_config("criteo1tb_fm_r64", bucket=64)
    p = str(tmp_path / "d.tsv")
    criteo.synthesize_tsv(p, 100, seed=1)
    with open(p, "rb") as f:
        lines = f.read().splitlines()
    lines[4] = b"garbage"
    with open(p, "wb") as f:
        f.write(b"\n".join(lines) + b"\n")
    q = str(tmp_path / "q")
    ids, _, _, _ = cli.load_text(cfg, p, _args(data_policy="quarantine",
                                               quarantine_dir=q))
    assert ids.shape == (99, 39)
    assert [e["lineno"] for e in read_events(q + "/deadletter.jsonl")] == [5]
    with pytest.raises(stream.BadRecord, match=r"d\.tsv:5"):
        cli.load_text(cfg, p, _args())
    with pytest.raises(stream.IngestAborted):
        cli.load_text(cfg, p, _args(data_policy="quarantine",
                                    quarantine_dir=q, max_bad_frac=0.001))
