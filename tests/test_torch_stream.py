"""The port's raw-text stream (``data/stream.py``) against the JAX
package's: the shard reader's lines and cursors, the record guard's
verdicts, reasons and dead-letter records, the batch stream batch for
batch and cursor for cursor over dirty Criteo, Avazu and libSVM shards,
the SIGKILL drills (``fmtorch train --data a,b,c`` and ``FMTrainer`` on
libSVM) and a few streamed field-sparse steps against the JAX CLI's loop.

Records are compared whole except the journal's ``ts``. The step parity
uses ``tests/test_torch_train.py``'s tolerance (loss within 1e-6,
parameters within ``atol=1e-5`` in float32).
"""

import json
import os
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from fm_spark_tpu.data import stream as jstream
from fm_spark_tpu.utils.logging import read_events as jread_events
from fm_spark_tpu_torch.data import records, stream
from fm_spark_tpu_torch.utils.logging import read_events

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_INT, NUM_CAT = 13, 26


# ---------------------------------------------------------- dirty lines


def _criteo_lines(rng, n):
    """Clean Criteo rows and every class the guard rejects, 1 in 10."""
    dirty = [
        b"\x00garbage \xff\xfe",
        b"1\tonly\tthree\tcols",
        b"",
        b"x" + b"\t1" * (NUM_INT + NUM_CAT),
        b"1\tfoo" + b"\t1" * (NUM_INT + NUM_CAT - 1),
        b"1" + b"\t2" * (NUM_INT + NUM_CAT) + b"\t",
        b"+1" + b"\t3" * (NUM_INT + NUM_CAT),
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
    dirty = [b"\x00garbage", b"1,2,3", b"",
             b"id,click,hour" + b",h" * 21,
             b"1,1,14bad103" + b",t" * 21,
             b"1,0,14134108" + b",t" * 21,
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
    dirty = [b"# a comment", b"", b"1:2.5 3:1", b"abc 1:2", b"1 2:3:4",
             b"1 -3:1", b"0 0:1", b"1 9999:1",
             b"1 " + b" ".join(b"%d:1" % (i + 1) for i in range(9)),
             b"1 2:inf", b"inf 2:1", b"+1.5 2:1.25", b"1",
             b"1 4:1e2  # trailing comment"]
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


def _write_shards(tmp_path, lines, name, header=None, n_shards=3,
                  unterminated=False):
    paths = []
    per = (len(lines) + n_shards - 1) // n_shards
    for s in range(n_shards):
        part = lines[s * per:(s + 1) * per]
        p = str(tmp_path / name.format(s))
        with open(p, "wb") as f:
            if header is not None and s == 0:
                f.write(header + b"\n")
            body = b"\n".join(part) + b"\n"
            if unterminated and s == n_shards - 1:
                body = body[:-1]
            f.write(body)
        paths.append(p)
    return paths


def _no_ts(events):
    return [{k: v for k, v in e.items() if k != "ts"} for e in events]


# ----------------------------------------------------------- ShardReader


@pytest.mark.parametrize("chunk", [1, 7, 64, 1 << 16])
def test_shard_reader_lines_and_cursors_equal_jax(tmp_path, rng, chunk):
    lines = _avazu_lines(rng, 60)
    paths = _write_shards(tmp_path, lines, "s{}.csv",
                          header=b"id,click,hour", unterminated=True)
    # A headerless shard whose first line starts like the header: skipped
    # by match, as the reference's; one whose first line does not: kept.
    with open(paths[1], "rb") as f:
        body = f.read()
    with open(paths[1], "wb") as f:
        f.write(b"id,not,a,header\n" + body)
    kw = dict(chunk_bytes=chunk, header_prefix=b"id,")
    got, want = stream.ShardReader(paths, **kw), jstream.ShardReader(paths,
                                                                    **kw)
    for epoch in range(2):
        while True:
            try:
                w = want.next_line()
            except StopIteration:
                with pytest.raises(StopIteration):
                    got.next_line()
                break
            assert got.next_line() == w
            assert got.state() == want.state()
        got.rewind()
        want.rewind()
        assert got.state() == want.state()
    # A cursor from either package restores into the other.
    for _ in range(25):
        want.next_line()
    back = stream.ShardReader(paths, chunk_bytes=5, header_prefix=b"id,")
    back.restore(want.state())
    assert [back.next_line() for _ in range(20)] == [
        want.next_line() for _ in range(20)]
    with pytest.raises(ValueError, match="shard list changed"):
        stream.ShardReader(paths[:2]).restore(want.state())


# ----------------------------------------------------------- RecordGuard


ROWS = [
    (1.0, [1, 2], [0.5, 0.5]), (float("nan"), [1], [1.0]),
    (1.0, [1], [float("inf")]), (1.0, [64], [1.0]), (1.0, [-1], [1.0]),
    (1.0, [1, 2, 3], [1.0] * 3), (float("-inf"), [], []),
]


@pytest.mark.parametrize("kw", [dict(num_features=64, max_nnz=2),
                                dict(num_features=0, max_nnz=0)])
def test_record_guard_verdicts_and_dead_letters_equal_jax(tmp_path, kw):
    guards = []
    for tag, mod in (("p", stream), ("j", jstream)):
        g = mod.RecordGuard("quarantine", quarantine_dir=str(tmp_path / tag))
        verdicts = [g.admit("f.svm", i + 1, b"line %d" % i, *row, **kw)
                    for i, row in enumerate(ROWS)]
        guards.append((g, verdicts))
    (pg, pv), (jg, jv) = guards
    assert pv == jv and pg.counters() == jg.counters()
    for row in ROWS:
        assert stream.RecordGuard.violation(*row, **kw) == \
            jstream.RecordGuard.violation(*row, **kw)
    assert _no_ts(read_events(pg.dead_letter_path)) == _no_ts(
        jread_events(jg.dead_letter_path))


def test_bad_record_text_equals_jax():
    for line in (b"the line", b"\x00\xff" * 200, "unicode é", b""):
        got = stream.BadRecord("day0.tsv", 7, "boom", line)
        want = jstream.BadRecord("day0.tsv", 7, "boom", line)
        assert str(got) == str(want)
        assert (got.path, got.lineno, got.reason) == (
            want.path, want.lineno, want.reason)
        assert stream.preview_line(line) == jstream.preview_line(line)
    # records.py re-exports the names it gave before.
    assert records.BadRecord is stream.BadRecord
    assert records.preview_line is stream.preview_line
    with pytest.raises(stream.BadRecord, match=r"day0\.tsv:7: boom"):
        stream.RecordGuard("strict").bad("day0.tsv", 7, b"x", "boom")


@pytest.mark.parametrize("windowed", [True, False])
def test_breaker_abort_record_equals_jax(tmp_path, windowed):
    outs = []
    for tag, mod in (("p", stream), ("j", jstream)):
        g = mod.RecordGuard("quarantine", quarantine_dir=str(tmp_path / tag),
                            max_bad_frac=0.2, window=32, min_records=16,
                            windowed=windowed)
        err = None
        try:
            for i in range(200):
                if i % 3:
                    g.ok()
                else:
                    g.bad("f", i + 1, b"x", "bad")
            g.check_overall()
        except mod.IngestAborted as e:
            err = str(e)
        err = err and err.replace(str(tmp_path / tag), "<q>")
        outs.append((err, g.counters(), _no_ts(
            (read_events if tag == "p" else jread_events)(
                g.dead_letter_path))))
    assert outs[0][0] is not None and outs[0] == outs[1]
    assert outs[0][2][-1]["event"] == "ingest_aborted"


# --------------------------------------------------------- StreamBatches


def _sources(tmp_path, dataset, policy, paths, b, max_nnz, nf, bucket,
             header_prefix=None):
    out = []
    for tag, mod in (("p", stream), ("j", jstream)):
        qdir = str(tmp_path / f"q{tag}") if policy == "quarantine" else None
        guard = mod.RecordGuard(policy, quarantine_dir=qdir)
        out.append(mod.StreamBatches(
            mod.ShardReader(paths, chunk_bytes=97,
                            header_prefix=header_prefix),
            mod.line_parser(dataset, bucket), b, max_nnz, guard=guard,
            num_features=nf))
    return out


@pytest.mark.parametrize("policy", ["quarantine", "strict"])
@pytest.mark.parametrize("dataset", ["criteo", "avazu", "libsvm"])
def test_stream_batches_equal_jax(tmp_path, rng, dataset, policy):
    if dataset == "criteo":
        lines, nnz, bucket, hp = _criteo_lines(rng, 600), 39, 1 << 10, None
    elif dataset == "avazu":
        lines, nnz, bucket, hp = _avazu_lines(rng, 600), 23, 1 << 10, b"id,"
    else:
        lines, nnz, bucket, hp = _libsvm_lines(rng, 600), 6, 0, None
    nf = nnz * bucket if bucket else 512
    paths = _write_shards(tmp_path, lines, "s{}.txt",
                          header=b"id,click,hour" if hp else None)
    got, want = _sources(tmp_path, dataset, policy, paths, 64, nnz, nf,
                         bucket, hp)
    for i in range(14):                       # past the epoch's tail
        try:
            w = want.next_batch()
        except jstream.BadRecord as e:
            with pytest.raises(stream.BadRecord) as g:
                got.next_batch()
            assert str(g.value) == str(e)
            assert policy == "strict"
            return
        for x, y in zip(got.next_batch(), w):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        assert got.state() == want.state(), i
    assert policy == "quarantine" and got.state()["epoch"] >= 1
    assert got.guard.n_bad > 20
    assert _no_ts(read_events(got.guard.dead_letter_path)) == _no_ts(
        jread_events(want.guard.dead_letter_path))
    # Each package's cursor resumes the other's stream.
    state = want.state()
    ahead = [want.next_batch() for _ in range(3)]
    back = _sources(tmp_path / "r", dataset, policy, paths, 64, nnz, nf,
                    bucket, hp)[0]
    back.restore(state)
    for w in ahead:
        for x, y in zip(back.next_batch(), w):
            np.testing.assert_array_equal(x, y)


def test_ingest_counters_land_in_the_registry(tmp_path, rng):
    from fm_spark_tpu_torch import obs

    paths = _write_shards(tmp_path, _libsvm_lines(rng, 120), "s{}.svm")
    ok0 = obs.counter("ingest.rows_ok_total").value
    bad0 = obs.counter("ingest.rows_quarantined_total").value
    src = stream.StreamBatches(
        stream.ShardReader(paths), stream.line_parser("libsvm"), 32, 6,
        guard=stream.RecordGuard("quarantine", str(tmp_path / "q")),
        num_features=512)
    src.next_batch()
    src.next_batch()
    assert obs.counter("ingest.rows_ok_total").value - ok0 == src.guard.n_ok
    assert (obs.counter("ingest.rows_quarantined_total").value - bad0
            == src.guard.n_bad > 0)
    assert obs.gauge("ingest.rows_per_sec").value > 0
    assert src.rows_per_sec > 0


# ------------------------------------------------------- SIGKILL drills


def _kill_after(cmd, step, ckdir, env, cwd=REPO):
    """Run ``cmd``, SIGKILL it once it logged ``step`` and its chain has a
    verified step; returns the JSON lines it printed."""
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, cwd=cwd,
                            env=env, stderr=subprocess.DEVNULL)
    seen = []
    try:
        deadline = time.time() + 240
        for line in proc.stdout:
            if line.startswith("{"):
                seen.append(json.loads(line))
            if any(x.get("step", 0) >= step and "loss" in x for x in seen):
                break
            assert time.time() < deadline
        good = os.path.join(ckdir, "last_good.json")
        while not os.path.exists(good) and time.time() < deadline:
            time.sleep(0.05)
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        proc.stdout.close()
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == -signal.SIGKILL
    return seen


def _criteo_shards(tmp_path, rows=900):
    from fm_spark_tpu_torch.data import criteo

    criteo.synthesize_tsv(str(tmp_path / "day.tsv"), rows, seed=5)
    with open(tmp_path / "day.tsv", "rb") as f:
        lines = f.read().splitlines()
    for i in (4, 300, 301, 650):
        lines[i] = b"x" + lines[i][1:]
    return _write_shards(tmp_path, lines, "s{}.tsv")


def test_sigkill_of_fmtorch_train_on_shards_resumes_exactly_once(tmp_path,
                                                                  capsys):
    """``fmtorch train --data s0,s1,s2`` (config 3 at bucket 64, the
    native parser, quarantine) killed after step 5 and resumed by the same
    command: the losses, the last step's cursor and the params equal the
    uninterrupted run's, and so do the bad/good counts and the distinct
    dead-letter records."""
    from fm_spark_tpu_torch import cli

    paths = _criteo_shards(tmp_path)

    def cmd(tag):
        return ["train", "--config", "criteo1tb_fm_r64", "--bucket", "64",
                "--data", ",".join(paths), "--native-ingest",
                "--data-policy", "quarantine", "--quarantine-dir",
                str(tmp_path / f"q{tag}"), "--max-bad-frac", "0.05",
                "--test-fraction", "0", "--batch-size", "256", "--steps", "8",
                "--sparse-update", "dedup", "--host-dedup", "--compact-cap",
                "256", "--checkpoint-dir", str(tmp_path / f"ck{tag}"),
                "--checkpoint-every", "2", "--model-out",
                str(tmp_path / f"m{tag}"), "--device", "cpu"]

    def run(tag):
        assert cli.main(cmd(tag)) == 0
        return [json.loads(x) for x in capsys.readouterr().out.splitlines()
                if x.startswith("{")]

    full = run("1")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    killed = _kill_after([sys.executable, "-m", "fm_spark_tpu_torch",
                          *cmd("2")], 5, str(tmp_path / "ck2"), env)
    rest = run("2")
    losses = {x["step"]: x["loss"] for x in full if "loss" in x}
    resumed = [x["resumed"] for x in rest if "resumed" in x][0]
    assert 0 < resumed["step"] < 8
    assert {x["step"]: x["loss"] for x in rest if "loss" in x} == {
        k: v for k, v in losses.items() if k > resumed["step"]}
    assert all(losses[x["step"]] == x["loss"] for x in killed if "loss" in x)
    counts = [[x for x in out if "dead_letter" in x][0] for out in (full,
                                                                    rest)]
    assert counts[0]["bad_records"] == counts[1]["bad_records"] > 0
    assert counts[0]["good_records"] == counts[1]["good_records"]
    with np.load(tmp_path / "m1" / "params.npz") as a, \
            np.load(tmp_path / "m2" / "params.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    states = [json.load(open(tmp_path / f"ck{t}" / "8" / "state.json"))
              for t in "12"]
    assert states[0]["pipeline"] == states[1]["pipeline"]

    def dead(tag):
        return {(e["path"], e["lineno"], e["reason"]) for e in read_events(
            str(tmp_path / f"q{tag}" / "deadletter.jsonl"))
            if e["event"] == "bad_record"}

    assert dead("1") == dead("2") and len(dead("1")) == 4


_FM_CHILD = """
import json, os, sys

sys.path.insert(0, {repo!r})
from fm_spark_tpu_torch import models
from fm_spark_tpu_torch.checkpoint import Checkpointer
from fm_spark_tpu_torch.data.stream import ShardReader, StreamBatches, line_parser
from fm_spark_tpu_torch.train import FMTrainer, TrainConfig

shard_dir, ck_dir, tap_path, steps = sys.argv[1:5]
paths = sorted(os.path.join(shard_dir, f) for f in os.listdir(shard_dir))


class Tap:
    def __init__(self, source, path):
        self._source = source
        self._f = open(path, "a")

    def next_batch(self):
        ids, vals, labels, w = self._source.next_batch()
        self._f.write(",".join(str(int(x)) for x in ids[w > 0][:, 0]))
        self._f.write("\\n")
        self._f.flush()
        return ids, vals, labels, w

    def state(self):
        return self._source.state()

    def restore(self, s):
        self._source.restore(s)

    def __iter__(self):
        return self

    def __next__(self):
        return self.next_batch()


spec = models.FMSpec(num_features=128, rank=4, init_std=0.05)
config = TrainConfig(num_steps=int(steps), batch_size=16,
                     learning_rate=0.1, lr_schedule="constant",
                     log_every=1)
ck = Checkpointer(ck_dir, save_every=4)
batches = Tap(StreamBatches(ShardReader(paths, chunk_bytes=64),
                            line_parser("libsvm"), 16, 3,
                            num_features=128), tap_path)
trainer = FMTrainer(spec, config, device="cpu")
trainer.fit(batches, checkpointer=ck)
ck.close()
print(json.dumps({{"done": trainer.step_count}}), flush=True)
"""


class _Tap:
    """The real record ids each step consumed, one line per step."""

    def __init__(self, source, path):
        self._source = source
        self._path = path

    def next_batch(self):
        ids, vals, labels, w = self._source.next_batch()
        with open(self._path, "a") as f:
            f.write(",".join(str(int(x)) for x in ids[w > 0][:, 0]) + "\n")
        return ids, vals, labels, w

    def state(self):
        return self._source.state()

    def restore(self, s):
        self._source.restore(s)

    def __iter__(self):
        return self

    def __next__(self):
        return self.next_batch()


def test_sigkill_of_fmtrainer_on_libsvm_resumes_exactly_once(tmp_path):
    """FMTrainer over a 3-shard libSVM stream, killed mid-epoch 3 and
    resumed from its chain: the concatenated record stream and the loss
    curve equal the uninterrupted run's bit for bit."""
    from fm_spark_tpu_torch import models
    from fm_spark_tpu_torch.checkpoint import Checkpointer
    from fm_spark_tpu_torch.train import FMTrainer, TrainConfig

    shard_dir = tmp_path / "shards"
    shard_dir.mkdir()
    j = 0
    paths = []
    for s in range(3):
        p = str(shard_dir / f"shard{s}.svm")
        with open(p, "w") as f:
            for _ in range(32):
                f.write(f"{j % 2} {j + 1}:1.5 {j + 2}:0.5\n")
                j += 1
        paths.append(p)
    steps = 24
    spec = models.FMSpec(num_features=128, rank=4, init_std=0.05)
    config = TrainConfig(num_steps=steps, batch_size=16, learning_rate=0.1,
                         lr_schedule="constant", log_every=1)
    golden_tap = str(tmp_path / "golden.txt")
    golden = FMTrainer(spec, config, device="cpu")
    golden.fit(_Tap(stream.StreamBatches(
        stream.ShardReader(paths, chunk_bytes=64), stream.line_parser(
            "libsvm"), 16, 3, num_features=128), golden_tap))

    script = tmp_path / "child.py"
    script.write_text(_FM_CHILD.format(repo=REPO))
    ck_dir = str(tmp_path / "ck")
    kill_tap = str(tmp_path / "kill.txt")
    _kill_after([sys.executable, str(script), str(shard_dir), ck_dir,
                 kill_tap, str(steps)], 13, ck_dir,
                dict(os.environ, OMP_NUM_THREADS="1"))

    resume_tap = str(tmp_path / "resume.txt")
    ck = Checkpointer(ck_dir, save_every=4)
    resumed = FMTrainer(spec, config, device="cpu")
    resumed.fit(_Tap(stream.StreamBatches(
        stream.ShardReader(paths, chunk_bytes=1 << 16),
        stream.line_parser("libsvm"), 16, 3, num_features=128), resume_tap),
        checkpointer=ck)
    ck.close()
    assert resumed.step_count == golden.step_count == steps
    assert resumed.loss_history == golden.loss_history
    assert torch.equal(golden.params["v"], resumed.params["v"])
    golden_lines = open(golden_tap).read().splitlines()
    kill_lines = open(kill_tap).read().splitlines()
    resume_lines = open(resume_tap).read().splitlines()
    restored = steps - len(resume_lines)
    assert 0 < restored < steps and restored % 4 == 0
    assert kill_lines[:restored] == golden_lines[:restored]
    assert resume_lines == golden_lines[restored:]


def test_quarantined_fit_logs_the_bad_records_line(tmp_path, capsys):
    from fm_spark_tpu_torch import models
    from fm_spark_tpu_torch.train import FMTrainer, TrainConfig

    p = str(tmp_path / "s.svm")
    with open(p, "w") as f:
        for j in range(40):
            f.write("garbage\n" if j == 7 else f"{j % 2} {j + 1}:1.0\n")
    guard = stream.RecordGuard("quarantine", str(tmp_path / "q"))
    src = stream.StreamBatches(stream.ShardReader([p]),
                               stream.line_parser("libsvm"), 8, 2,
                               guard=guard, num_features=64)
    trainer = FMTrainer(models.FMSpec(num_features=64, rank=2),
                        TrainConfig(num_steps=3, batch_size=8, log_every=3),
                        device="cpu")
    trainer.fit(src, prefetch=2)
    out = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert out[-1]["bad_records"] == 1 and out[-1]["good_records"] == 24
    assert trainer.ingest == {"bad_records": 1, "good_records": 24,
                              "dead_letter": guard.dead_letter_path}


# --------------------------------------------- the JAX CLI's field loop


class _Logger:
    def __init__(self):
        self.losses = {}

    def log(self, step, samples=0, **kw):
        if "loss" in kw:
            self.losses[step] = float(kw["loss"])


@pytest.mark.parametrize("lever,steps_per_call", [
    (dict(sparse_update="scatter_add"), 1),
    (dict(sparse_update="dedup", host_dedup=True, compact_cap=256), 2)])
def test_streamed_field_steps_match_the_jax_cli_loop(tmp_path, monkeypatch,
                                                     lever, steps_per_call):
    """A few field-sparse steps over the same dirty Criteo shards: the
    port's ``fit_field_sparse`` on its stream against the JAX CLI's loop on
    JAX's stream, from the same (JAX-drawn) params."""
    from fm_spark_tpu import cli as jcli
    from fm_spark_tpu import train as jtrain
    from fm_spark_tpu.data import MappedBatches as JMapped
    from fm_spark_tpu.data.packed import field_local as jfield_local
    from fm_spark_tpu.models.field_fm import FieldFMSpec as JSpec
    from fm_spark_tpu_torch import models
    from fm_spark_tpu_torch.data import MappedBatches, field_local
    from fm_spark_tpu_torch.train import TrainConfig, fit_field_sparse

    paths = _criteo_shards(tmp_path)
    bucket = 64
    kw = dict(num_features=39 * bucket, num_fields=39, bucket=bucket,
              rank=8, init_std=0.1)
    jspec, pspec = JSpec(**kw), models.FieldFMSpec(**kw)
    cfg = dict(num_steps=3, batch_size=256, learning_rate=0.05,
               reg_factors=1e-4, reg_linear=1e-5, seed=2, log_every=1,
               **lever)
    jl = _Logger()
    jsrc = JMapped(jstream.StreamBatches(
        jstream.ShardReader(paths), jstream.line_parser("criteo", bucket),
        256, 39, guard=jstream.RecordGuard("quarantine",
                                           str(tmp_path / "qj")),
        num_features=39 * bucket),
        lambda b: (jfield_local(b[0], bucket), *b[1:]))
    jparams = jcli._fit_field_sparse(jspec, jtrain.TrainConfig(**cfg), jsrc,
                                     jl, steps_per_call=steps_per_call,
                                     devices=jax.devices()[:1])
    jp0 = jspec.init(jax.random.key(2))
    flat = {"w0": np.asarray(jp0["w0"])}
    flat.update({f"vw/{f}": np.asarray(t) for f, t in enumerate(jp0["vw"])})
    monkeypatch.setattr(models.FieldFMSpec, "init", lambda self, g=None,
                        device=None: models.params_from_numpy(self, flat,
                                                              "cpu"))
    pl = _Logger()
    psrc = MappedBatches(stream.StreamBatches(
        stream.ShardReader(paths), stream.line_parser("criteo", bucket), 256,
        39, guard=stream.RecordGuard("quarantine", str(tmp_path / "qp")),
        num_features=39 * bucket),
        lambda b: (field_local(b[0], bucket), *b[1:]))
    params = fit_field_sparse(pspec, TrainConfig(**cfg), psrc, device="cpu",
                              steps_per_call=steps_per_call, logger=pl,
                              prefetch=0)
    assert sorted(pl.losses) == sorted(jl.losses)
    for k in jl.losses:
        assert abs(pl.losses[k] - jl.losses[k]) < 1e-6
    for f in range(39):
        np.testing.assert_allclose(params["vw"][f].numpy(),
                                   np.asarray(jparams["vw"][f]), rtol=0,
                                   atol=1e-5)
    assert abs(float(params["w0"]) - float(jparams["w0"])) < 1e-5
    assert psrc.state() == jsrc.state()
