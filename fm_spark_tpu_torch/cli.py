"""Command-line entry point of the port (``python -m fm_spark_tpu_torch``
or ``fmtorch``), mirroring ``fm_spark_tpu``'s CLI:

- ``preprocess --config NAME --input FILE... --out-dir DIR`` hashes raw
  Criteo TSV or Avazu CSV into a packed dir, globally shuffled unless
  ``--no-shuffle``;
- ``cap-advise --data DIR --batch-size B`` scans packed batches as
  training draws them and recommends a ``--compact-cap``;
- ``train --config NAME (--data PATH | --synthetic N) --steps S ...``
  trains any registered config: strategies ``single`` and ``dp`` (the
  flat FM of configs 1 and 2, or any config by ``--strategy``) by
  ``FMTrainer``'s dense step, a FieldFM, FieldFFM or FieldDeepFM config
  (``field_sparse``) by the fused sparse step (on the card each a
  captured CUDA graph per step; FieldDeepFM's MLP and bias by
  ``--optimizer``, Adam for config 5). ``--distributed`` joins a
  ``torch.distributed`` group (torchrun's environment or
  ``--coordinator/--num-processes/--process-id``; one rank a card):
  ``field_sparse`` then runs the field-sharded step (``--row-shards``,
  ``--ckpt-sharded``), ``dp`` all-reduces the gradient, and ``row``
  row-shards a flat FM's tables (``--force`` past 1M features). It
  prints one JSON loss line every ``--log-every`` steps, then
  ``{"eval": {...}}`` on the held-out ``--test-fraction`` and
  ``{"saved": DIR}`` with ``--model-out``. ``--data`` takes a packed dir
  (streamed; the held-out rows are its tail), a comma-separated list of
  Criteo TSV or Avazu CSV shards (the raw-text stream, read in bounded
  memory with an exactly-once cursor, natively parsed with
  ``--native-ingest``; ``--test-fraction 0``), or a small file of the
  config's dataset: a MovieLens ratings file, a Criteo TSV or an Avazu
  CSV (parsed in memory). A malformed line raises with ``path:lineno``
  under ``--data-policy strict``; under ``quarantine`` it goes to
  ``--quarantine-dir``'s dead-letter journal, a
  ``{"bad_records", "good_records", "dead_letter"}`` line is printed, and
  ``--max-bad-frac`` aborts a run whose bad-record rate exceeds it.
  ``--checkpoint-dir`` keeps a crash-consistent
  checkpoint chain every ``--checkpoint-every`` steps, and the same
  command resumes from its newest verified step; SIGTERM saves and
  stops. A flat config trains over the tiered embedding store with
  ``--embed-tier auto|require --hot-rows R`` (``embed.TieredTrainer``),
  rolls back a diverging run with ``--divergence-guard``, and runs the
  continuous-learning protocol with ``--online`` (day N trains, day N+1
  evaluates, a drift verdict demotes the day's saves; ``online.py``),
  printing ``{"online": {...}}``;
- ``eval (--model DIR | --checkpoint-dir CK --config NAME) (--data PATH
  --config NAME | --synthetic N)`` prints the metrics of a model dir or
  of a chain's newest verified step;
- ``predict --model DIR (--data PATH --config NAME | --synthetic N)``
  scores through the serving engine with one bucket of ``--batch-size``
  rows and writes one ``%.6g`` prediction per line;
- ``serve (--model DIR | --config NAME --checkpoint-dir CK)`` answers a
  request stream (the predict batches, ``--repeat`` passes) through the
  coalescing engine, one CUDA graph per ``--buckets`` bucket on the
  card, and with ``--checkpoint-dir`` hot-swaps every new verified,
  undemoted generation the trainer publishes (polled every
  ``--reload-poll-s``); it prints a ``serving`` line after warm-up and a
  ``serve_summary`` line at the end;
- ``list-configs [--verbose]`` lists the registered configs.

``train`` and ``serve`` run the telemetry plane (``obs/``) under
``--obs-dir`` (default ``FM_SPARK_OBS_DIR``, else ``artifacts/obs``;
``none`` switches it off): the run id is the first JSON line, and spans,
the flight recorder, metrics snapshots, capture bundles, a defaulted
dead-letter journal and serve's ``serve_health.jsonl`` land under
``<obs-dir>/<run_id>/``. ``--metrics-port`` serves ``/metrics`` and
``/healthz``; ``train --metrics FILE`` appends the loss lines to FILE,
``train --profile DIR`` writes a ``torch.profiler`` Chrome trace of the
run; ``serve --slo-ms`` arms the ``serve_request`` deadline. A fault
plan in ``FM_SPARK_FAULTS`` reaches the named points
(:mod:`.resilience.faults`); a run that ends by an error leaves a
``run_failed`` flight dump.

Every command that computes runs on the CUDA device unless ``--device
cpu`` is given. A JSON summary (eager kernel launches; for ``predict``
and ``serve`` also the graph replays and the kernel runs they made, by
wrapper name; for ``train`` the step, aux, capture and checkpoint times)
goes to standard error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from fm_spark_tpu_torch.cli_levers import (_LEVERS, _add_lever_args,
                                           _lever_overrides, check_levers_any,
                                           field_caps, field_only_levers)


def load_dataset(cfg, synthetic: int):
    """``(ids, vals, labels, num_features)`` of ``synthetic`` planted-FM
    examples shaped like the config (seed ``cfg.seed``; field-local ids
    for field-partitioned models), as the JAX CLI's ``--synthetic``."""
    from fm_spark_tpu_torch import data

    num_features = cfg.num_features if cfg.bucket > 0 else 4096
    ids, vals, labels = data.synthetic_ctr(synthetic, num_features,
                                           cfg.num_fields, seed=cfg.seed)
    if cfg.field_local_ids:
        ids = data.field_local(ids, cfg.bucket)
    return ids, vals, labels, num_features


def _ingest_guard(args, windowed: bool = True):
    """The per-record error policy of ``--data-policy``,
    ``--quarantine-dir`` and ``--max-bad-frac`` (the reference's
    ``_ingest_guard``; strict by default, and for commands without the
    flags): a :class:`~fm_spark_tpu_torch.data.stream.RecordGuard`. The
    in-memory loaders pass ``windowed=False`` (their good count arrives in
    one bulk after the parse). ``quarantine``'s dead-letter journal lands
    in ``--quarantine-dir``, else in the run's obs directory
    (``obs.run_dir()``); with the plane off (``--obs-dir none``) and no
    ``--quarantine-dir`` it refuses."""
    from fm_spark_tpu_torch import obs
    from fm_spark_tpu_torch.data.stream import RecordGuard

    policy = getattr(args, "data_policy", None) or "strict"
    qdir = getattr(args, "quarantine_dir", None)
    frac = getattr(args, "max_bad_frac", None)
    if policy == "quarantine" and not qdir:
        qdir = obs.run_dir()
        if not qdir:
            raise SystemExit(
                "--data-policy quarantine needs --quarantine-dir or an obs "
                "directory (--obs-dir is 'none'): the dead-letter journal "
                "has to land somewhere")
    return RecordGuard(policy=policy, quarantine_dir=qdir,
                       max_bad_frac=1.0 if frac is None else frac,
                       windowed=windowed)


def load_text(cfg, path: str, args=None):
    """``(ids, vals, labels, num_features)`` of a small file of the
    config's dataset, parsed in memory (the reference's ``load_dataset``
    for files): a MovieLens ratings file (``num_features`` = users +
    items), or a Criteo TSV or Avazu CSV (the config's hashed size;
    field-local ids for field-partitioned models, unit vals). Labels are
    float32. A malformed Criteo or Avazu line goes through
    :func:`_ingest_guard` of ``args`` (strict without them: it raises
    :class:`~fm_spark_tpu_torch.data.records.BadRecord` with
    ``path:lineno``), and the whole-load breaker then holds the overall
    bad fraction to ``--max-bad-frac``."""
    import numpy as np

    from fm_spark_tpu_torch.data import avazu, criteo, field_local, movielens

    if cfg.dataset == "movielens":
        (ids, vals, labels), meta = movielens.load_ratings(path,
                                                           task=cfg.task)
        return ids, vals, labels, meta["num_features"]
    mod = {"criteo": criteo, "avazu": avazu}.get(cfg.dataset)
    if mod is None:
        raise SystemExit(f"don't know how to load dataset kind "
                         f"{cfg.dataset!r} (config {cfg.name!r})")
    with open(path, "rb") as f:
        lines = f.read().splitlines()
    header = 0
    if cfg.dataset == "avazu" and lines and lines[0].startswith(b"id,"):
        lines, header = lines[1:], 1
    guard = _ingest_guard(args, windowed=False)
    ids, labels = mod.parse_lines(lines, cfg.bucket, per_field=True,
                                  on_error=guard.on_error, path=path,
                                  start_lineno=1 + header)
    guard.ok_many(len(labels))
    guard.check_overall()
    guard.close()
    if cfg.field_local_ids:
        ids = field_local(ids, cfg.bucket)
    return (ids, np.ones(ids.shape, np.float32), labels.astype(np.float32),
            cfg.num_features)


def _is_shard_list(cfg, data) -> bool:
    """``--data a,b,c`` of a Criteo or Avazu config: the raw-text stream."""
    return (cfg.dataset in ("criteo", "avazu") and bool(data)
            and "," in data)


def _stream_source(args, cfg, tconfig):
    """The raw-text stream of ``--data a,b,c`` (the reference's streaming
    branch of ``train``): the shards in order through a
    :class:`~fm_spark_tpu_torch.data.stream.ShardReader` (an Avazu header
    skipped by match, never by position) and :func:`_ingest_guard`,
    parsed natively with ``--native-ingest`` (a configuration outside the
    native contract falls back to the Python parser, with the reason on
    stderr), with field-local ids for field-partitioned models. It
    refuses a missing shard, ``--test-fraction > 0`` and more than one
    process. Returns ``(source, stream)``: the source to train from and
    the stream under its wrappers."""
    from fm_spark_tpu_torch.data import MappedBatches
    from fm_spark_tpu_torch.data.native_stream import (
        NativeStreamBatches, make_stream_batches,
        native_stream_unsupported_reason)
    from fm_spark_tpu_torch.data.stream import ShardReader

    paths = [p for p in args.data.split(",") if p]
    missing = [p for p in paths if not os.path.isfile(p)]
    if missing:
        raise SystemExit(f"missing shard file(s): {', '.join(missing)}")
    if args.test_fraction > 0:
        raise SystemExit(
            "streaming text ingest (--data with a comma-separated shard "
            "list) holds out no eval split; pass --test-fraction 0, or "
            "preprocess to a packed dir for held-out metrics")
    if max(_world(), int(os.environ.get("WORLD_SIZE", "1"))) > 1:
        raise SystemExit("streaming text ingest is single-process; "
                         "preprocess to a packed dir for multi-host runs")
    reader = ShardReader(paths, header_prefix=(
        b"id," if cfg.dataset == "avazu" else None))
    stream = make_stream_batches(
        reader, cfg.dataset, tconfig.batch_size, max_nnz=cfg.num_fields,
        guard=_ingest_guard(args), num_features=cfg.num_features,
        bucket=cfg.bucket, native_ingest="auto" if args.native_ingest
        else False)
    if args.native_ingest and not isinstance(stream, NativeStreamBatches):
        print("cli: --native-ingest fell back to the pure-Python streaming "
              "parser: " + str(native_stream_unsupported_reason(
                  cfg.dataset, cfg.num_fields, cfg.bucket)), file=sys.stderr)
    source = stream
    if cfg.field_local_ids:
        # On the producer thread; the guard passes through the wrapper.
        source = MappedBatches(stream,
                               lambda b: _field_local_rows(b, cfg.bucket))
    return source, stream


def _field_local_rows(batch, bucket: int):
    """A stream batch with field-local ids; the epoch tail's padding rows
    (weight 0, global ids 0) take local id 0, where ``field_local`` alone
    would make them negative, which the host aux refuses."""
    from fm_spark_tpu_torch.data import field_local

    ids, vals, labels, weights = batch
    ids = field_local(ids, bucket)
    ids[weights == 0] = 0
    return ids, vals, labels, weights


def _print_ingest(counts, summary: dict, stream) -> None:
    """The reference's quarantine line, ``{"bad_records", "good_records",
    "dead_letter"}``, when the stream's guard quarantined anything; the
    stream's parse rate goes to the stderr ``summary``."""
    from fm_spark_tpu_torch.data.native_stream import NativeStreamBatches

    if stream is None:
        return
    summary["ingest_rows_per_sec"] = stream.rows_per_sec
    summary["native_ingest"] = isinstance(stream, NativeStreamBatches)
    if counts is not None and counts["bad_records"]:
        print(json.dumps(counts), flush=True)


def _synthetic_for_model(spec, n: int):
    """``n`` seeded examples (seed 1) shaped by a model's own spec."""
    from fm_spark_tpu_torch import data

    nnz = getattr(spec, "num_fields", 0) or min(8, spec.num_features)
    ids, vals, labels = data.synthetic_ctr(n, spec.num_features, nnz, seed=1)
    if getattr(spec, "field_local_ids", False):
        ids = data.field_local(ids, spec.bucket)
    return ids, vals, labels


def _batches_for_model(args, spec):
    """One ordered pass of eval/predict batches for a trained model: its
    own synthetic examples, or ``--data`` read with ``--config``'s
    loader (a packed dir streamed, a text file parsed)."""
    from fm_spark_tpu_torch import configs, data

    if args.synthetic:
        return data.iterate_once(*_synthetic_for_model(spec, args.synthetic),
                                 args.batch_size)
    if not args.data:
        raise SystemExit(f"{args.cmd} needs --data PATH or --synthetic N")
    if args.config is None:
        raise SystemExit(f"{args.cmd} with --data needs --config to name "
                         "the dataset loader")
    cfg = configs.get_config(args.config, bucket=args.bucket)
    if cfg.bucket > 0 and cfg.num_features != spec.num_features:
        raise SystemExit(
            f"config {cfg.name!r} encodes {cfg.num_features} features but "
            f"the model was trained with {spec.num_features}; ids would be "
            "silently clamped — pass the config the model was trained with")
    bucket = cfg.bucket if cfg.field_local_ids else 0
    if os.path.isdir(args.data):
        return data.iter_packed_once(data.PackedDataset(args.data),
                                     args.batch_size, bucket=bucket)
    ids, vals, labels, num_features = load_text(cfg, args.data)
    if cfg.bucket <= 0 and num_features > spec.num_features:
        raise SystemExit(
            f"dataset has {num_features} features but the model was trained "
            f"with {spec.num_features}; out-of-range ids would be silently "
            "clamped — evaluate on data from the training feature space")
    return data.iterate_once(ids, vals, labels, args.batch_size)


def _launches() -> dict:
    from fm_spark_tpu_torch.ops import kernel_launches

    return kernel_launches()


def _since(before: dict) -> dict:
    return {k: v - before[k] for k, v in _launches().items()}


def cmd_preprocess(args) -> int:
    import shutil

    from fm_spark_tpu_torch import configs
    from fm_spark_tpu_torch.data import avazu, criteo, shuffle_packed

    cfg = configs.get_config(args.config, bucket=args.bucket)
    mod = {"criteo": criteo, "avazu": avazu}.get(cfg.dataset)
    if mod is None:
        raise SystemExit("preprocess supports criteo/avazu configs")
    t0 = time.perf_counter()
    if args.shuffle:
        # Source text is in raw (often temporal) order; the global shuffle
        # makes train's tail holdout (--test-fraction) a random split.
        tmp = args.out_dir.rstrip("/") + ".unshuffled.tmp"
        count = mod.preprocess(args.input, tmp, cfg.bucket)
        t1 = time.perf_counter()
        shuffle_packed(tmp, args.out_dir, seed=cfg.seed, remove_src=True)
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
    else:
        count = mod.preprocess(args.input, args.out_dir, cfg.bucket)
        t1 = time.perf_counter()
    t2 = time.perf_counter()
    print(json.dumps({"out_dir": args.out_dir, "num_examples": count,
                      "shuffled": bool(args.shuffle),
                      "parse_s": t1 - t0, "shuffle_s": t2 - t1}), flush=True)
    return 0


def cmd_cap_advise(args) -> int:
    """Recommend a ``--compact-cap`` for a packed dir at a batch size:
    the largest per-field unique-id count over ``--batches`` batches drawn
    as training draws them, plus ``--headroom``, rounded up to a multiple
    of 512 and clamped to the batch size (a batch never holds more
    unique ids than rows)."""
    import numpy as np

    from fm_spark_tpu_torch.data import PackedBatches, PackedDataset

    ds = PackedDataset(args.data)
    batches = PackedBatches(ds, args.batch_size, seed=args.seed)
    overall = 0
    per_field_max = np.zeros((ds.num_fields,), np.int64)
    maxima = []
    for _ in range(args.batches):
        ids = next(batches)[0]
        counts = np.array([np.unique(ids[:, f]).size
                           for f in range(ids.shape[1])])
        per_field_max = np.maximum(per_field_max, counts)
        maxima.append(int(counts.max()))
        overall = max(overall, maxima[-1])
    pad = max(64, int(overall * args.headroom))
    recommended = ((overall + pad) + 511) // 512 * 512
    note = ("cap must bound EVERY future batch; rounded to a 512 multiple "
            f"with {int(args.headroom * 100)}% headroom over the scanned "
            "max — rescan after changing batch size, hashing, or data "
            "distribution")
    if recommended > args.batch_size:
        recommended = args.batch_size
        note = ("cap must bound EVERY future batch; clamped to batch_size "
                "(a batch's unique count is bounded by it) — rescan after "
                "changing batch size, hashing, or data distribution")
    print(json.dumps({
        "data": args.data,
        "batch_size": args.batch_size,
        "batches_scanned": args.batches,
        "max_unique_per_field_overall": overall,
        "per_batch_max": maxima,
        "per_field_max": per_field_max.tolist(),
        "recommended_compact_cap": int(recommended),
        "note": note,
    }), flush=True)
    return 0


def _obs_setup(args) -> str | None:
    """The telemetry plane of ``--obs-dir`` (the reference's): on unless
    it is ``none``, every stream the run emits (spans, metrics snapshots,
    the flight recorder, capture bundles, a defaulted dead-letter journal,
    the serving journal) lands under ``<obs-dir>/<run_id>/``, SIGTERM
    dumps the flight window, and the deep-capture engine is armed there.
    The run id is echoed as the first JSON line. Returns the run dir, or
    None with the plane off."""
    obs_dir = getattr(args, "obs_dir", None)
    if not obs_dir or obs_dir.lower() == "none":
        return None
    from fm_spark_tpu_torch import obs
    from fm_spark_tpu_torch.obs import introspect

    run = obs.new_run_id()
    obs.configure(os.path.join(obs_dir, run), run_id=run,
                  install_signals=True)
    introspect.configure(obs.run_dir(), run_id=run)
    print(json.dumps({"run_id": run, "obs_dir": obs.run_dir()}), flush=True)
    return obs.run_dir()


def _start_metrics_endpoint(args) -> None:
    """``--metrics-port``: the live registry over stdlib HTTP on
    127.0.0.1 (``/metrics`` Prometheus text, ``/healthz`` JSON), on a
    daemon thread that ``main`` stops; the bound port (0 = chosen by the
    OS) is echoed as a JSON line."""
    port = getattr(args, "metrics_port", None)
    if port is None:
        return
    from fm_spark_tpu_torch.obs import export

    srv = export.start_metrics_server(port)
    print(json.dumps({"metrics_port": srv.port, "metrics_url": srv.url,
                      "endpoints": ["/metrics", "/healthz"]}), flush=True)


class _Profile:
    """``train --profile DIR``: a ``torch.profiler`` session (CPU and, on
    the card, CUDA activity) over the whole training run, written as a
    Chrome trace ``DIR/trace.json`` when the run ends (also when it ends
    by an error). The steps' CUDA graphs are captured inside the session.
    """

    def __init__(self, out_dir: str | None):
        self.out_dir = out_dir
        self._prof = None

    def __enter__(self):
        if not self.out_dir:
            return self
        import torch

        os.makedirs(self.out_dir, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.stop()
            path = os.path.join(self.out_dir, "trace.json")
            self._prof.export_chrome_trace(path)
            print(json.dumps({"profile": path}), flush=True)
            self._prof = None
        return False


_CACHE_COUNTS = ("requests", "hits", "misses")


def _compile_cache(args) -> str | None:
    """``--compile-cache [DIR]`` (bare: the default dir), else
    ``FM_SPARK_COMPILE_CACHE``: the kernel build cache's dir, or None.
    Notes the cache's counts so far on ``args`` (:func:`_cache_counts`)."""
    from fm_spark_tpu_torch.utils import compile_cache

    if getattr(args, "compile_cache", None) is not None:
        d = compile_cache.enable(args.compile_cache or None)
    else:
        d = compile_cache.enable_from_env()
    st = compile_cache.cache_stats()
    args.cache_base = {k: st[k] for k in _CACHE_COUNTS}
    return d


def _cache_counts(args) -> dict:
    """The kernel build cache's counts for a command's summary: the
    libraries this command asked for, found built (hits) and built
    (misses), whatever the process did before it."""
    from fm_spark_tpu_torch.utils import compile_cache

    st = compile_cache.cache_stats()
    return {"enabled": st["enabled"], **{
        k: st[k] - args.cache_base[k] for k in _CACHE_COUNTS}}


def cmd_train(args) -> int:
    _compile_cache(args)
    _obs_setup(args)
    _start_metrics_endpoint(args)
    ok = False
    try:
        with _Profile(args.profile):
            rc = _cmd_train(args)
        ok = True
        return rc
    finally:
        _finish_distributed(ok)


def _cmd_train(args) -> int:
    from fm_spark_tpu_torch import configs, models
    from fm_spark_tpu_torch.train import evaluate_params, fit_field_sparse

    if bool(args.synthetic) == bool(args.data):
        raise SystemExit("train needs one of --data PATH or --synthetic N")
    if args.elastic and (args.distributed or "RANK" in os.environ):
        # The reference's refusal, and the port's way round it: the
        # elastic parent launches (and relaunches) the ranks itself.
        raise SystemExit(
            "--elastic is single-process: a multi-host gang cannot "
            "shrink without a coordinated re-initialize (the port's "
            "--elastic is that re-initialize: it launches its own ranks, "
            "one per card or --num-processes N, and relaunches them on "
            "half the cards; run it without --distributed, outside "
            "torchrun)")
    world = _maybe_init_distributed(args)
    batch_size = args.batch_size
    if args.batch_per_chip is not None:
        if batch_size is not None:
            raise SystemExit(
                "--batch-per-chip and --batch-size are exclusive "
                "(weak scaling derives the global batch from the mesh)")
        batch_size = args.batch_per_chip * world
    cfg = configs.get_config(args.config, bucket=args.bucket,
                             param_dtype=args.param_dtype,
                             compute_dtype=args.compute_dtype,
                             use_pallas=True if args.use_pallas else None,
                             optimizer=args.optimizer,
                             learning_rate=args.lr, loss=args.loss,
                             seed=args.seed, table_layout=args.table_layout,
                             strategy=args.strategy)
    if cfg.strategy not in STRATEGIES:
        raise SystemExit(f"unknown strategy {cfg.strategy!r} (config "
                         f"{cfg.name!r}); expected one of {STRATEGIES}")
    warn = check_row_scale(cfg.strategy, cfg.num_features
                           if cfg.strategy == "row" and cfg.bucket > 0
                           else 0)
    if warn:
        if not args.force:
            raise SystemExit(warn)
        print(f"warning: {warn}", file=sys.stderr)
    if world > 1:
        # Only the sharded loops reduce across processes; 'single' would
        # train a different model on each process's data shard.
        if cfg.strategy == "single":
            raise SystemExit(
                f"multi-process training supports strategy 'field_sparse' "
                f"(and the port's 'dp' and 'row') only; config {cfg.name!r} "
                f"resolves to strategy {cfg.strategy!r}")
        bs = batch_size or cfg.batch_size
        if bs % world:
            raise SystemExit(f"batch_size={bs} must be divisible by the "
                             f"process count ({world})")
    tconfig = cfg.train_config(
        num_steps=args.steps, batch_size=batch_size,
        log_every=args.log_every, eval_every=args.eval_every,
        metrics_path=args.metrics, sparse_update=args.sparse_update,
        **_lever_overrides(args))
    msg = check_levers_any(tconfig)
    if msg:
        raise SystemExit(msg)
    if args.online:
        if world > 1:
            raise SystemExit("--online is single-process")
        return _run_online_cmd(args, cfg, tconfig)
    if args.divergence_guard is not None and (
            cfg.strategy in ("field_sparse", "row") or not args.checkpoint_dir
            or (cfg.strategy == "dp" and args.distributed)):
        # The guard rolls back FMTrainer's single step ('dp' without a
        # process group is that step on one card).
        raise SystemExit(
            "--divergence-guard requires strategy 'single' and "
            "--checkpoint-dir (rollback restores the last good "
            f"checkpoint; config {cfg.name!r} resolves to strategy "
            f"{cfg.strategy!r})")
    _check_supervise(args, cfg)
    if args.elastic and cfg.strategy == "field_sparse":
        return _train_elastic(args, tconfig)
    if cfg.strategy != "field_sparse":
        return _train_flat(args, cfg, tconfig, world)
    spec = cfg.spec()
    _tier_plan(spec, tconfig, cfg.strategy)
    sharded = bool(args.distributed)
    _validate_field_caps(args, spec, tconfig, world, sharded)
    dev = _rank_device(args)
    batches, eval_source, stream, _ = _train_source(
        args, cfg, tconfig, (_rank(), world) if sharded else (0, 1))
    checkpointer, journal = _checkpointer(args)
    stats = {}
    before = _launches()
    try:
        with _preemption(checkpointer) as guard:
            if sharded:
                from fm_spark_tpu_torch import parallel

                mesh = parallel.make_field_mesh(n_row=args.row_shards,
                                                device=dev)
                params = parallel.fit_field_sharded(
                    spec, tconfig, batches, mesh,
                    steps_per_call=args.steps_per_call,
                    prefetch=args.prefetch, logger=_logger(tconfig, world),
                    stats=stats, checkpointer=checkpointer,
                    ckpt_sharded=args.ckpt_sharded,
                    eval_source=eval_source, preemption_guard=guard)
            else:
                params = fit_field_sparse(
                    spec, tconfig, batches, device=dev,
                    steps_per_call=args.steps_per_call,
                    prefetch=args.prefetch, logger=_logger(tconfig, world),
                    stats=stats,
                    checkpointer=checkpointer, eval_source=eval_source,
                    preemption_guard=guard)
    finally:
        if checkpointer is not None:
            checkpointer.close()
            journal.close()
        if stream is not None:
            stream.close()
            stream.guard.close()
    if stats["resumed"] is not None:
        print(json.dumps({"resumed": stats["resumed"]}), flush=True)
    summary = {"device": str(dev), "kernel_launches": _since(before),
               "step_ms": stats["step_ms"], "aux_ms": stats["aux_ms"],
               "capture_s": stats["capture_s"], "saves": stats["saves"],
               "world": world, "compile_cache": _cache_counts(args)}
    _print_ingest(stats["ingest"], summary, stream)
    if stats["end"] < tconfig.num_steps:
        # Preempted: the chain holds the step reached; the same command
        # resumes it.
        print(json.dumps({"preempted": stats["end"]}), flush=True)
        print(json.dumps(summary), file=sys.stderr)
        return 0
    if sharded:
        # The tables stay sharded: eval on the layout, the model gathered
        # into rank 0's host memory only when asked for.
        if eval_source is not None:
            metrics = parallel.evaluate_field_sharded(spec, mesh, params,
                                                      eval_source())
            print(json.dumps({"eval": metrics}), flush=True)
        if args.model_out:
            params = parallel.gather_field_params(spec, params, mesh, root=0)
    elif eval_source is not None:
        metrics = evaluate_params(spec, params, eval_source())
        print(json.dumps({"eval": metrics}), flush=True)
    if args.model_out and _rank() == 0:
        models.save_model(args.model_out, spec, params)
        print(json.dumps({"saved": args.model_out}), flush=True)
    summary["kernel_launches"] = _since(before)
    print(json.dumps(summary), file=sys.stderr)
    return 0


def _logger(tconfig, world: int):
    """A training loop's ``MetricsLogger``: every rank prints its lines,
    rank 0 alone appends them to ``--metrics`` (one line per log step)."""
    from fm_spark_tpu_torch.utils.logging import MetricsLogger

    return MetricsLogger(path=tconfig.metrics_path if _rank() == 0
                         else None, n_chips=world)


def _check_supervise(args, cfg) -> None:
    """The reference's guards of ``--supervise`` and ``--elastic``, in its
    words. ``dp`` without ``--distributed`` is the single step on one
    card, so it counts as ``single`` (as for ``--divergence-guard``)."""
    single = cfg.strategy == "single" or (cfg.strategy == "dp"
                                          and not args.distributed)
    if args.supervise and (not single or not args.checkpoint_dir):
        raise SystemExit(
            "--supervise requires strategy 'single' and --checkpoint-dir "
            "(device-loss recovery resumes from committed checkpoints; "
            f"config {cfg.name!r} resolves to strategy {cfg.strategy!r})")
    if not args.elastic:
        return
    if not args.checkpoint_dir:
        raise SystemExit(
            "--elastic requires --checkpoint-dir (degraded-mode resume "
            "restores the last good checkpoint onto the shrunk mesh)")
    if not single and cfg.strategy != "field_sparse":
        raise SystemExit(
            "--elastic supports strategies 'single' (with --supervise) and "
            f"'field_sparse'; config {cfg.name!r} resolves to "
            f"{cfg.strategy!r}")
    if single and not args.supervise:
        raise SystemExit(
            "--elastic with strategy 'single' requires --supervise (the "
            "shrink trigger is the supervisor's permanent-fault verdict)")
    if args.ckpt_sharded:
        raise SystemExit(
            "--elastic and --ckpt-sharded are exclusive: sharded "
            "checkpoints resume only onto the same mesh, but the whole "
            "point of elastic mode is resuming onto a smaller one (use the "
            "default canonical layout)")
    if args.row_shards > 1:
        raise SystemExit(
            "--elastic requires --row-shards 1: a shrunk device set cannot "
            "honor a fixed row-shard extent (the halved count stops "
            "dividing by it) — the 2-D mesh's row capacity is a commitment "
            "elastic mode cannot keep")
    if single and args.num_processes is not None:
        raise SystemExit("--num-processes with --elastic sizes the gang of "
                         "strategy 'field_sparse'; strategy 'single' runs "
                         "one process")


#: The elastic parent's own flags, left out of its ranks' command lines
#: (the parent serves ``--metrics-port`` itself): ``(flag, takes a
#: value)``.
_ELASTIC_PARENT_FLAGS = (("--elastic", False), ("--max-shrinks", True),
                         ("--num-processes", True), ("--metrics-port", True))


def _rank_argv(argv: list) -> list:
    """``argv`` (the parent's ``train`` command line) without the elastic
    parent's own flags: each rank's command line, before its triple."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
            continue
        for flag, value in _ELASTIC_PARENT_FLAGS:
            if a == flag:
                skip = value
                break
            if value and a.startswith(flag + "="):
                break
        else:
            out.append(a)
    return out


def _train_elastic(args, tconfig) -> int:
    """``train --elastic`` on a ``field_sparse`` config: the elastic
    parent (the port's counterpart of the reference's
    ``_fit_field_sparse_elastic``). It launches a gang of ranks, one per
    visible card (or ``--num-processes N``; ``--device cpu`` runs gloo
    ranks), each a ``--distributed`` rank on a fresh rendezvous
    (:func:`~fm_spark_tpu_torch.parallel.gang.run_gang`). A failed gang
    is ended and its first rank's error, by its text, goes to the
    :class:`~fm_spark_tpu_torch.resilience.Supervisor` (probe, bounded
    backoff; checkpointed progress between two losses clears the run of
    failures); on a PERMANENT verdict the
    :class:`~fm_spark_tpu_torch.resilience.ElasticController` halves the
    gang and it is relaunched, every launch resuming from the chain's
    canonical layout. A failure that is not a device loss propagates,
    as does a mixed-mode circuit open. Rank 0's lines are relayed."""
    import torch

    from fm_spark_tpu_torch.checkpoint import ChainFollower
    from fm_spark_tpu_torch.parallel import gang
    from fm_spark_tpu_torch.resilience import (BackoffPolicy, CircuitOpen,
                                               ElasticController, Supervisor,
                                               is_device_loss)
    from fm_spark_tpu_torch.utils.logging import EventLog

    cpu = args.device == "cpu"
    n = args.num_processes or (1 if cpu else torch.cuda.device_count())
    if n < 1:
        raise SystemExit("--elastic found no card to launch a rank on "
                         "(pass --device cpu for gloo ranks)")
    os.makedirs(args.checkpoint_dir, exist_ok=True)
    journal = EventLog(os.path.join(args.checkpoint_dir, "health.jsonl"),
                       mirror_to_flight=True)
    supervisor = Supervisor(
        policy=BackoffPolicy(initial=1.0, multiplier=2.0, max_delay=15.0),
        journal=journal, breaker_threshold=3,
        device="cpu" if cpu else None)
    elastic = ElasticController(devices=list(range(n)),
                                max_shrinks=args.max_shrinks,
                                journal=journal)
    argv = _rank_argv(args.argv)
    log_dir = os.path.join(args.checkpoint_dir, "elastic")
    launches = []
    step_at_last_failure = None
    try:
        while True:
            world = elastic.n_chips
            res = gang.run_gang(argv, world, log_dir,
                                tag=f"launch{len(launches)}")
            launches.append({"world": world, "rcs": res.rcs,
                             "killed": res.killed,
                             "seconds": round(res.seconds, 3)})
            sys.stdout.write(res.stdout)
            sys.stdout.flush()
            if res.ok:
                supervisor.note_success("train")
                if elastic.degraded:
                    journal.emit("degraded_complete", **elastic.summary())
                summary = {}
                errs = [x for x in res.stderr.splitlines()
                        if x.startswith("{")]
                if errs:
                    summary = json.loads(errs[-1])
                summary.update(elastic=elastic.summary(), launches=launches)
                print(json.dumps(summary), file=sys.stderr)
                return 0
            failure = res.failure
            print(json.dumps({"gang_failed": str(failure),
                              "world": world}), file=sys.stderr, flush=True)
            if not is_device_loss(failure):
                raise failure
            committed = ChainFollower(args.checkpoint_dir).last_good_step()
            if (step_at_last_failure is not None and committed is not None
                    and committed > step_at_last_failure):
                supervisor.note_success("train")
            step_at_last_failure = committed
            try:
                supervisor.recover("train", failure)
            except CircuitOpen:
                if not supervisor.permanent() or not elastic.can_shrink():
                    raise
                ranks = elastic.shrink("train")
                if tconfig.batch_size % len(ranks):
                    raise SystemExit(
                        f"elastic shrink reached {len(ranks)} device(s) but "
                        f"batch_size={tconfig.batch_size} does not divide "
                        "by it; pick a batch divisible by every shrink step "
                        "(halving from the initial mesh) or lower "
                        "--max-shrinks") from failure
                supervisor.reset("train")
    finally:
        journal.close()


#: train's strategies (the reference's ``--strategy`` choices).
STRATEGIES = ("single", "field_sparse", "dp", "row")


def check_row_scale(strategy: str, num_features: int) -> str | None:
    """The reference's ≥1M-feature guard of strategy ``row``, which
    materializes a dense per-shard gradient table every step: the warning
    text, or None when the combination is fine (``--force`` runs it)."""
    if strategy != "row" or num_features < 1_000_000:
        return None
    return (
        f"strategy 'row' with {num_features:,} features materializes a "
        "dense per-shard gradient table every step — measured ~8x below "
        "the fused sparse path at CTR scale (parallel/step.py SCALE "
        "CAVEAT). Use --strategy field_sparse for tables this size, or "
        "pass --force to run 'row' anyway (exact optimizer parity is "
        "its one remaining use).")


def _maybe_init_distributed(args) -> int:
    """``--distributed``: join the default process group before the first
    touch of a card (``parallel.init_distributed``: NCCL on the card, gloo
    with ``--device cpu``) and return the world size (1 without the
    flag). The explicit triple ``--coordinator/--num-processes/
    --process-id`` gives the store; without it torchrun's environment
    does (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``). A partial triple raises rather than rendezvous
    against the wrong cluster."""
    if not args.distributed:
        # --num-processes alone sizes the elastic parent's gang.
        if (args.coordinator is not None or args.process_id is not None
                or (args.num_processes is not None and not args.elastic)):
            raise SystemExit(
                "--coordinator/--num-processes/--process-id require "
                "--distributed")
        return 1
    explicit = (args.coordinator, args.num_processes, args.process_id)
    if any(x is not None for x in explicit) and None in explicit:
        raise SystemExit(
            "--coordinator, --num-processes and --process-id must be "
            "given together (a partial triple would auto-detect against "
            "the wrong cluster)")
    if args.coordinator is None and "MASTER_ADDR" not in os.environ:
        raise SystemExit(
            "--distributed needs the explicit triple (--coordinator, "
            "--num-processes, --process-id) or a torchrun environment "
            "(MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK)")
    import torch.distributed as dist

    from fm_spark_tpu_torch import parallel

    parallel.init_distributed(args.device, coordinator=args.coordinator,
                              num_processes=args.num_processes,
                              process_id=args.process_id)
    return dist.get_world_size()


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def _rank_device(args):
    """This process's device: under ``--distributed`` the rank's card
    (``cuda:LOCAL_RANK``) or the CPU, else ``--device``'s."""
    import torch.distributed as dist

    from fm_spark_tpu_torch import resolve_device

    if args.distributed and dist.is_initialized():
        if args.device == "cpu":
            return resolve_device("cpu")
        return resolve_device(f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}")
    return resolve_device(args.device)


def _finish_distributed(ok: bool) -> None:
    """Leave the process group (after a barrier when the run ended well:
    no rank tears it down under another's last collective)."""
    import torch.distributed as dist

    if dist.is_initialized():
        if ok:
            dist.barrier()
        dist.destroy_process_group()


def _validate_field_caps(args, spec, tconfig, n: int, sharded: bool):
    """The reference's field_sparse guards (``_validate_field_caps``) with
    its messages, for the port's sharded steps: ``n`` ranks, ``sharded``
    under ``--distributed`` (a mesh of one included)."""
    from fm_spark_tpu_torch import models

    row_shards = args.row_shards
    deep = isinstance(spec, models.FieldDeepFMSpec)
    if row_shards < 1:
        raise SystemExit(f"--row-shards must be >= 1, got {row_shards}")
    if row_shards > 1 and not sharded:
        raise SystemExit(
            f"--row-shards={row_shards} needs multiple devices and a "
            f"model family with a 2-D (feat, row) sharded step "
            f"(found {n} device(s), {type(spec).__name__})")
    if args.ckpt_sharded and not sharded:
        raise SystemExit(
            "--ckpt-sharded applies to multi-device field-sharded runs "
            f"(found {n} device(s)); the default canonical layout "
            "already serves single-chip runs")
    compact_sharded = (tconfig.host_dedup and tconfig.compact_cap > 0
                       and sharded)
    if compact_sharded and deep:
        raise SystemExit(
            f"host-built --compact-cap is not supported by the sharded "
            f"{type(spec).__name__} step")
    if compact_sharded and (row_shards > 1 or n > 1):
        raise SystemExit(
            "host-built --compact-cap on multiple chips requires a 1-D "
            "field mesh (no --row-shards) and a single process; add "
            "--compact-device to build the aux in-step, which composes "
            "with both")
    if tconfig.host_dedup and sharded and not compact_sharded:
        raise SystemExit(
            f"--host-dedup on {n} devices requires --compact-cap "
            "(or drop --host-dedup / run on 1 chip)")
    # Registry-driven per-lever guards (one validate per _Lever row).
    ctx = dict(spec=spec, cap=field_caps(spec), n=n, pc=n, sharded=sharded,
               row_shards=row_shards)
    for lv in _LEVERS:
        if lv.validate is not None:
            msg = lv.validate(tconfig, ctx)
            if msg:
                raise SystemExit(msg)
    if not sharded:
        return
    if args.steps_per_call > 1 and compact_sharded:
        raise SystemExit("--steps-per-call > 1 does not take the host-built "
                         "compact aux; use --compact-device")
    if tconfig.batch_size % n:
        raise SystemExit(
            f"batch_size={tconfig.batch_size} must be divisible by the "
            f"device count ({n}) for the field-sharded strategy")
    if n % row_shards:
        raise SystemExit(f"--row-shards={row_shards} must divide the device "
                         f"count ({n})")


def _train_parallel(args, cfg, spec, tconfig, dev, batches, eval_source,
                    checkpointer, journal, stream, world: int) -> int:
    """``dp`` (under ``--distributed``: each rank reads its own rows) or
    ``row`` (every rank reads every row) over a ``(data, feat)`` mesh of
    every rank (``row``: ``feat`` over every rank)."""
    from fm_spark_tpu_torch import models, parallel

    if cfg.strategy == "row":
        try:
            parallel.param_specs(spec, "row")     # the FM family only
        except ValueError as e:
            raise SystemExit(str(e)) from e
        mesh = parallel.make_mesh(1, world, device=dev)
    else:
        mesh = parallel.make_mesh(world, 1, device=dev)
    stats = {}
    before = _launches()
    try:
        with _preemption(checkpointer) as guard:
            params = parallel.fit_parallel(
                spec, tconfig, batches, mesh, cfg.strategy,
                prefetch=args.prefetch, logger=_logger(tconfig, world),
                checkpointer=checkpointer, preemption_guard=guard,
                stats=stats, eval_source=eval_source)
    finally:
        if checkpointer is not None:
            checkpointer.close()
            journal.close()
        if stream is not None:
            stream.close()
            stream.guard.close()
    if stats["resumed"] is not None:
        print(json.dumps({"resumed": stats["resumed"]}), flush=True)
    summary = {"device": str(dev), "strategy": cfg.strategy, "world": world,
               "kernel_launches": _since(before),
               "capture_s": stats["capture_s"]}
    if stats["end"] < tconfig.num_steps:
        print(json.dumps({"preempted": stats["end"]}), flush=True)
    else:
        if eval_source is not None:
            metrics = parallel.evaluate_parallel(spec, mesh, params,
                                                 eval_source(), cfg.strategy)
            print(json.dumps({"eval": metrics}), flush=True)
        if args.model_out:
            params = parallel.gather_tree(params, mesh, spec, cfg.strategy,
                                          root=0)
            if _rank() == 0:
                models.save_model(args.model_out, spec, params)
                print(json.dumps({"saved": args.model_out}), flush=True)
    print(json.dumps(summary), file=sys.stderr)
    return 0


def _tier_plan(spec, tconfig, strategy):
    """The embed-tier decision (the reference's, at one point:
    ``embed.tier_plan``): ``"tiered"`` or None; ``require`` with a None
    verdict exits with its reason, ``auto`` says on stderr that it falls
    back to the in-memory tables."""
    if tconfig.embed_tier == "off":
        return None
    from fm_spark_tpu_torch import embed

    mode, reason = embed.tier_plan(spec, tconfig, strategy)
    if mode is None:
        if tconfig.embed_tier == "require":
            raise SystemExit(f"--embed-tier require cannot be served: "
                             f"{reason}")
        print(f"embed-tier auto: in-HBM fallback ({reason})",
              file=sys.stderr)
    return mode


def _train_source(args, cfg, tconfig, part=(0, 1)):
    """``(training source, eval source or None, raw-text stream or None,
    num_features of in-memory data or None)`` of ``--data``/
    ``--synthetic``. ``part = (p, n)``: the p-th of n processes reads its
    own rows, batches of ``batch_size / n`` (the reference's multi-host
    ingest): a packed dir's p-th contiguous slice of the training rows, or
    every n-th in-memory row from p, each trimmed to one length so the
    ranks' cursors stay in lockstep; its saved cursor leaves out the slice
    bounds, and every rank restores rank 0's. The held-out rows (the
    eval source) stay whole: every rank evaluates the global batches. A
    packed dir holds out its TAIL rows (a random split when preprocess
    shuffled the dir); in-memory data a random split."""
    from fm_spark_tpu_torch import data

    p, n = part
    bs = tconfig.batch_size
    local_bs = bs // n
    if _is_shard_list(cfg, args.data):
        batches, stream = _stream_source(args, cfg, tconfig)
        return batches, None, stream, None
    if args.data and os.path.isdir(args.data):
        ds = data.PackedDataset(args.data)
        cut = (max(1, int(len(ds) * (1.0 - args.test_fraction)))
               if args.test_fraction > 0 else len(ds))
        # Global ids (field offset + hash) for a flat table, field-local
        # ones (the bucket's) for a field-partitioned model.
        bucket = cfg.bucket if cfg.field_local_ids else 0
        per = cut // n
        batches = data.PackedBatches(ds, local_bs, seed=cfg.seed,
                                     row_range=(p * per, (p + 1) * per),
                                     bucket=bucket)
        eval_source = (
            (lambda: data.iter_packed_once(ds, bs, bucket=bucket,
                                           row_range=(cut, len(ds))))
            if cut < len(ds) else None)
        return _RankCursor(batches) if n > 1 else batches, eval_source, \
            None, None
    ids, vals, labels, num_features = (
        load_text(cfg, args.data, args) if args.data
        else load_dataset(cfg, args.synthetic))
    te = None
    if args.test_fraction > 0:
        (ids, vals, labels), te = data.train_test_split(
            ids, vals, labels, args.test_fraction, seed=cfg.seed)
    if n > 1:
        end = ids.shape[0] - ids.shape[0] % n
        ids, vals, labels = (a[p:end:n] for a in (ids, vals, labels))
    batches = data.Batches(ids, vals, labels, local_bs, seed=cfg.seed)
    return batches, ((lambda: data.iterate_once(*te, bs))
                     if te is not None else None), None, num_features


class _RankCursor:
    """A per-rank slice's source whose cursor leaves out the slice bounds
    (``lo``/``hi``): rank 0 saves it and every rank restores it onto its
    own slice (the reference's multi-host ``pipe_state``)."""

    def __init__(self, source):
        self._source = source

    def next_batch(self):
        return self._source.next_batch()

    def state(self):
        return {k: v for k, v in self._source.state().items()
                if k not in ("lo", "hi")}

    def restore(self, state) -> None:
        self._source.restore(state)


def _checkpointer(args):
    """``(Checkpointer, its journal)`` of ``--checkpoint-dir``, or Nones."""
    if not args.checkpoint_dir:
        return None, None
    from fm_spark_tpu_torch.checkpoint import Checkpointer
    from fm_spark_tpu_torch.utils.logging import EventLog

    os.makedirs(args.checkpoint_dir, exist_ok=True)
    # A supervised or guarded run mirrors each health event into the
    # flight ring, so its fault timeline carries the retry story too.
    journal = EventLog(os.path.join(args.checkpoint_dir, "health.jsonl"),
                       mirror_to_flight=bool(
                           getattr(args, "supervise", False)
                           or getattr(args, "divergence_guard", None)
                           is not None))
    return Checkpointer(args.checkpoint_dir,
                        save_every=args.checkpoint_every,
                        max_to_keep=args.checkpoint_keep,
                        journal=journal), journal


def _train_flat(args, cfg, tconfig, world: int = 1) -> int:
    """``train`` by the dense step (strategies ``single``, ``dp`` and
    ``row``) of a flat config or, with ``--strategy single|dp``, a field
    config (the field families' generic dense step): ``single``, and
    ``dp`` without ``--distributed``, by
    :class:`~fm_spark_tpu_torch.train.FMTrainer` on one device (``dp`` on
    a mesh of one); ``dp`` under ``--distributed`` and ``row`` by
    :func:`~fm_spark_tpu_torch.parallel.step.fit_parallel` over the
    ranks. ``dp`` with more than one visible card and no process group
    raises, never training on one of several."""
    import torch

    from fm_spark_tpu_torch import models
    from fm_spark_tpu_torch.train import FMTrainer

    # train's levers of the fused field steps, refused by the flat
    # family's dense step, as the reference's CLI refuses them off
    # ``field_sparse``.
    for dest, flag in field_only_levers():
        if getattr(args, dest):
            raise SystemExit(f"{flag} requires strategy 'field_sparse' "
                             f"(config {cfg.name!r} resolves to "
                             f"{cfg.strategy!r})")
    if args.steps_per_call > 1:
        raise SystemExit(f"--steps-per-call requires strategy "
                         f"'field_sparse' (config {cfg.name!r} resolves to "
                         f"{cfg.strategy!r})")
    for flag in ("row_shards", "ckpt_sharded"):
        if getattr(args, flag) not in (None, False, 1):
            raise SystemExit(
                f"--{flag.replace('_', '-')} applies to the field-sharded "
                f"strategy 'field_sparse' (config {cfg.name!r} resolves to "
                f"{cfg.strategy!r})")
    if (cfg.strategy == "dp" and not args.distributed
            and args.device != "cpu" and torch.cuda.device_count() > 1):
        raise SystemExit(
            f"strategy 'dp' over {torch.cuda.device_count()} visible cards "
            "runs one process per card: launch it under torchrun with "
            "--distributed (or pass --distributed with --coordinator, "
            "--num-processes and --process-id to each), or make one card "
            "visible (CUDA_VISIBLE_DEVICES) to run it on one")
    parallel_run = cfg.strategy == "row" or (cfg.strategy == "dp"
                                             and args.distributed)
    dev = _rank_device(args)
    # dp's ranks each read their own rows; row's all read every row.
    batches, eval_source, stream, num_features = _train_source(
        args, cfg, tconfig,
        (_rank(), world) if cfg.strategy == "dp" and parallel_run
        else (0, 1))
    spec = cfg.spec(num_features if num_features is not None
                    and cfg.bucket <= 0 else None)
    # dp without a process group is the single step on one card (checked
    # above); the parallel strategies shard or replicate their tables.
    tiered = _tier_plan(spec, tconfig, cfg.strategy if parallel_run
                        else "single") == "tiered"
    if tiered and (args.divergence_guard is not None or args.supervise):
        raise SystemExit(
            "--embed-tier is exclusive with --divergence-guard and "
            "--supervise: the tiered trainer runs its own fit loop")
    if tiered and tconfig.eval_every > 0:
        raise SystemExit(
            "--embed-tier does not run periodic in-fit eval (eval_every > "
            "0): held-out metrics come from the merged view once at end "
            "of fit")
    checkpointer, journal = _checkpointer(args)
    if tiered:
        return _train_tiered(args, spec, tconfig, dev, batches, eval_source,
                             checkpointer, journal, stream)
    if parallel_run:
        return _train_parallel(args, cfg, spec, tconfig, dev, batches,
                               eval_source, checkpointer, journal, stream,
                               world)
    guard_div = None
    if args.divergence_guard is not None:
        from fm_spark_tpu_torch.resilience.divergence import DivergenceGuard

        guard_div = DivergenceGuard(spike_factor=args.divergence_guard,
                                    journal=journal)
    supervisor = elastic = None
    if args.supervise:
        from fm_spark_tpu_torch.resilience import Supervisor

        supervisor = Supervisor(journal=journal, device=dev)
    if args.elastic:
        from fm_spark_tpu_torch.resilience import ElasticController

        elastic = ElasticController(
            devices=[0] if dev.type == "cpu"
            else list(range(torch.cuda.device_count())),
            max_shrinks=args.max_shrinks, journal=journal)
    trainer = FMTrainer(spec, tconfig, device=dev,
                        n_chips=elastic.n_chips if elastic else 1)
    before = _launches()
    try:
        with _preemption(checkpointer) as guard:
            trainer.fit(batches, checkpointer=checkpointer,
                        preemption_guard=guard, prefetch=args.prefetch,
                        eval_batches=(eval_source if tconfig.eval_every > 0
                                      else None),
                        divergence_guard=guard_div, supervisor=supervisor,
                        elastic=elastic)
    finally:
        if checkpointer is not None:
            checkpointer.close()
            journal.close()
        if stream is not None:
            stream.close()
            stream.guard.close()
    if trainer.resumed is not None:
        print(json.dumps({"resumed": trainer.resumed}), flush=True)
    summary = {"device": str(dev), "strategy": cfg.strategy,
               "kernel_launches": _since(before),
               "capture_s": trainer._train_step.captured.capture_s,
               "saves": list(checkpointer.timings) if checkpointer else []}
    summary["compile_cache"] = _cache_counts(args)
    if supervisor is not None:
        summary["supervisor"] = {"verdict": supervisor.health_verdict(),
                                 "failures": supervisor.total_failures}
    if elastic is not None:
        summary["elastic"] = elastic.summary()
    _print_ingest(trainer.ingest, summary, stream)
    if trainer.step_count < tconfig.num_steps:
        print(json.dumps({"preempted": trainer.step_count}), flush=True)
        print(json.dumps(summary), file=sys.stderr)
        return 0
    if eval_source is not None:
        metrics = trainer.last_eval or trainer.evaluate(eval_source())
        print(json.dumps({"eval": metrics}), flush=True)
    if args.model_out:
        models.save_model(args.model_out, spec, trainer.params)
        print(json.dumps({"saved": args.model_out}), flush=True)
    print(json.dumps(summary), file=sys.stderr)
    return 0


def _train_tiered(args, spec, tconfig, dev, batches, eval_source,
                  checkpointer, journal, stream) -> int:
    """``train --embed-tier`` when the tiered trainer serves it: the fit
    over the hot-bucket store, then the held-out eval and the saved model
    from its merged full-axis view."""
    from fm_spark_tpu_torch import models
    from fm_spark_tpu_torch.embed import TieredTrainer
    from fm_spark_tpu_torch.train import evaluate_params

    trainer = TieredTrainer(spec, tconfig, device=dev)
    before = _launches()
    try:
        trainer.fit(batches, checkpointer=checkpointer,
                    prefetch=args.prefetch)
    finally:
        if checkpointer is not None:
            checkpointer.close()
            journal.close()
        if stream is not None:
            stream.close()
            stream.guard.close()
    log_every = max(tconfig.log_every, 1)
    for i, loss in enumerate(trainer.loss_history):
        if (i + 1) % log_every == 0 or i + 1 == len(trainer.loss_history):
            print(json.dumps({"step": i + 1, "loss": loss}), flush=True)
    params = trainer.merged_torch_params()
    if eval_source is not None:
        metrics = evaluate_params(spec, params, eval_source())
        print(json.dumps({"eval": metrics}), flush=True)
    if args.model_out:
        models.save_model(args.model_out, spec, params)
        print(json.dumps({"saved": args.model_out}), flush=True)
    print(json.dumps({"device": str(dev), "embed_tier": "tiered",
                      "kernel_launches": _since(before),
                      "tier": trainer.store.stats(),
                      "capture_s": trainer._step.captured.capture_s}),
          file=sys.stderr)
    return 0


def _online_days(args, cfg):
    """The time-ordered days of ``train --online`` (the reference's
    ``_online_days``): ``--synthetic N`` split into ``--online-days``
    slices (with the ``--drift-inject`` label-flip drill), or ``--data
    d0,d1,...``, one text shard per day, parsed in memory (Criteo TSV,
    Avazu CSV or libsvm, through ``--data-policy``'s guard)."""
    import numpy as np

    from fm_spark_tpu_torch import data, online

    if args.synthetic:
        num_features = cfg.num_features if cfg.bucket > 0 else 4096
        ids, vals, labels = data.synthetic_ctr(
            args.synthetic, num_features, cfg.num_fields, seed=cfg.seed)
        days = online.split_days(ids, vals, labels, args.online_days)
        if args.drift_inject is not None:
            days = online.flip_labels(days, args.drift_inject)
        return days, num_features
    if not args.data or "," not in args.data:
        raise SystemExit(
            "--online needs time-ordered days: --data d0,d1,... (one "
            "shard per day) or --synthetic N with --online-days")
    if args.drift_inject is not None:
        raise SystemExit("--drift-inject is the synthetic drill lever; "
                         "real day shards carry their own drift")
    paths = [p for p in args.data.split(",") if p]
    days = []
    if cfg.dataset in ("criteo", "avazu"):
        for path in paths:
            ids, vals, labels, _ = load_text(cfg, path, args)
            days.append((ids, vals, labels))
        return days, cfg.num_features
    if cfg.dataset == "libsvm":
        num_features = 0
        for path in paths:
            guard = _ingest_guard(args, windowed=False)
            ids, vals, labels = data.load_libsvm(path,
                                                 on_error=guard.on_error)
            guard.ok_many(labels.shape[0])
            guard.check_overall()
            guard.close()
            num_features = max(num_features,
                               int(ids.max()) + 1 if ids.size else 1)
            days.append((ids, vals, labels.astype(np.float32)))
        return days, num_features
    raise SystemExit(
        f"--online day shards support criteo/avazu/libsvm text "
        f"(config {cfg.name!r} is dataset {cfg.dataset!r}); use "
        "--synthetic N for a config-free run")


def _run_online_cmd(args, cfg, tconfig) -> int:
    """``train --online``: the continuous-learning protocol (the
    reference's ``_run_online_cmd``; the loop is :mod:`.online`). The
    journal is ``health.jsonl`` in the checkpoint dir; the run's spans
    (``online/train_day``, ``online/eval_day``) and events go to the run
    dir of ``--obs-dir``, or, with the plane off, to a run dir that is
    the checkpoint dir itself (its ``trace.jsonl``, flight spool and
    metrics snapshots beside the chain). Strategy ``dp``
    on one visible card is the single step (as in :func:`_train_flat`);
    the fused ``field_sparse`` strategy is refused, as the reference
    refuses every strategy but ``single``."""
    import torch

    from fm_spark_tpu_torch import models, obs, online, resolve_device
    from fm_spark_tpu_torch.checkpoint import Checkpointer
    from fm_spark_tpu_torch.train import FMTrainer
    from fm_spark_tpu_torch.utils.logging import EventLog

    one_card = cfg.strategy == "single" or (
        cfg.strategy == "dp" and torch.cuda.device_count() <= 1)
    if not one_card or not args.checkpoint_dir:
        raise SystemExit(
            "--online requires strategy 'single' and --checkpoint-dir "
            "(day-granular rollback restores demoted generations from "
            f"the chain; config {cfg.name!r} resolves to strategy "
            f"{cfg.strategy!r})")
    if cfg.task != "classification":
        raise SystemExit("--online watches eval AUC; config "
                         f"{cfg.name!r} is task {cfg.task!r}")
    days, num_features = _online_days(args, cfg)
    spec = cfg.spec(num_features if cfg.bucket <= 0 else None)
    dev = resolve_device(args.device)
    os.makedirs(args.checkpoint_dir, exist_ok=True)
    journal = EventLog(os.path.join(args.checkpoint_dir, "health.jsonl"))
    own_plane = not obs.enabled()
    if own_plane:
        obs.configure(args.checkpoint_dir, reset_metrics=False)
    run_id = obs.run_id()
    checkpointer = Checkpointer(args.checkpoint_dir,
                                save_every=args.checkpoint_every,
                                max_to_keep=args.checkpoint_keep,
                                journal=journal)
    trainer = FMTrainer(spec, tconfig, device=dev)
    sentry = online.drift_guard(
        drop_factor=args.drift_drop_factor,
        max_rollbacks=args.drift_max_rollbacks, journal=journal)
    ledger = leg = fingerprint = None
    if args.quality_ledger:
        from fm_spark_tpu_torch.obs.ledger import (PerfLedger,
                                                   measurement_fingerprint,
                                                   runtime_versions)

        ledger = PerfLedger(args.quality_ledger)
        leg = f"{online.QUALITY_LEG_PREFIX}{cfg.name}/{tconfig.optimizer}"
        fingerprint = measurement_fingerprint(
            variant=leg, model=cfg.model, batch=tconfig.batch_size,
            rank=cfg.rank,
            extra={"optimizer": tconfig.optimizer,
                   "lr": tconfig.learning_rate},
            n_chips=1, **runtime_versions())
    before = _launches()
    try:
        summary = online.run_online(
            trainer, days, checkpointer, sentry=sentry, journal=journal,
            ledger=ledger, leg=leg, fingerprint=fingerprint, run_id=run_id)
    finally:
        checkpointer.close()
        journal.close()
        if own_plane:
            obs.shutdown()
    print(json.dumps({"online": summary}), flush=True)
    if args.model_out:
        models.save_model(args.model_out, spec, trainer.params)
        print(json.dumps({"saved": args.model_out}), flush=True)
    print(json.dumps({"device": str(dev), "online": True,
                      "kernel_launches": _since(before),
                      "capture_s": trainer._train_step.captured.capture_s}),
          file=sys.stderr)
    return 0


def _preemption(checkpointer):
    """A SIGTERM guard when there is a chain to flush into, else nothing."""
    import contextlib

    from fm_spark_tpu_torch.checkpoint import PreemptionGuard

    return PreemptionGuard() if checkpointer is not None \
        else contextlib.nullcontext()


def cmd_eval(args) -> int:
    from fm_spark_tpu_torch import models, resolve_device
    from fm_spark_tpu_torch.train import _tree_map, evaluate_params

    if bool(args.model) == bool(args.checkpoint_dir):
        raise SystemExit("eval needs one of --model DIR or --checkpoint-dir "
                         "DIR (with --config)")
    if args.model:
        spec, params = models.load_model(args.model, device=args.device)
    else:
        if args.config is None:
            raise SystemExit("eval --checkpoint-dir needs --config")
        spec, params, step = _serve_from_chain(args)
        dev = resolve_device(args.device)
        params = _tree_map(lambda t: t.to(dev), params)
        print(json.dumps({"checkpoint_step": step}), flush=True)
    batches = _batches_for_model(args, spec)
    before = _launches()
    metrics = evaluate_params(spec, params, batches)
    print(json.dumps(metrics), flush=True)
    print(json.dumps({"device": str(params["w0"].device),
                      "kernel_launches": _since(before)}), file=sys.stderr)
    return 0


def _replay_counts(engine) -> dict:
    """The engine's graph replays and the kernel runs they made, by
    wrapper name (replays launch past the wrappers' launch counts)."""
    return {"graph_replays": engine.graph_replays,
            "kernel_runs_in_replays": engine.kernel_runs()}


def cmd_predict(args) -> int:
    from fm_spark_tpu_torch import models
    from fm_spark_tpu_torch.serve import PredictEngine

    _compile_cache(args)
    spec, params = models.load_model(args.model, device=args.device)
    batches = _batches_for_model(args, spec)
    engine = None
    before = _launches()
    rows = 0
    out = sys.stdout if args.out in (None, "-") else open(args.out, "w")
    try:
        for bids, bvals, _, w in batches:
            if engine is None:
                # One bucket = the batch size: every batch is padded to
                # it; the row width is the data's (a flat FM's nnz).
                engine = PredictEngine(spec, params, nnz=bids.shape[1],
                                       buckets=(args.batch_size,),
                                       latency_budget_ms=0.0,
                                       device=args.device)
                engine.warmup()
                before = _launches()
            preds = engine.score(bids, bvals)
            for p in preds[w > 0]:
                out.write(f"{float(p):.6g}\n")
                rows += 1
    finally:
        if out is not sys.stdout:
            out.close()
    print(json.dumps({"predicted": rows,
                      "device": str(params["w0"].device),
                      "kernel_launches": _since(before),
                      **(_replay_counts(engine) if engine else {})}),
          file=sys.stderr)
    return 0


#: serve's flags that configure the front door and its fleet: with
#: ``--fleet`` only, as ``(dest, flag)``.
_FLEET_FLAGS = (("autoscale_max", "--autoscale-max"),
                ("frontdoor_port", "--frontdoor-port"),
                ("classes", "--classes"),
                ("serve_seconds", "--serve-seconds"),
                ("trace_sample", "--trace-sample"))


def _serve_from_chain(args):
    """``(spec, params, step)`` of the newest verified step of the chain,
    read through the same read-only follower the hot reload polls. The
    spec is ``--config``'s (with ``--bucket`` and ``--compute-dtype``),
    its table dtype the chain's."""
    import dataclasses

    from fm_spark_tpu_torch import configs
    from fm_spark_tpu_torch.checkpoint import ChainFollower
    from fm_spark_tpu_torch.models.io import flatten, param_names, unflatten

    cfg = configs.get_config(args.config, bucket=args.bucket,
                             compute_dtype=args.compute_dtype)
    try:
        spec = cfg.spec()
    except ValueError as e:
        raise SystemExit(f"serve --config {cfg.name}: {e}") from e
    names = param_names(spec)
    chain = ChainFollower(args.checkpoint_dir)
    restored = chain.restore(unflatten(dict.fromkeys(names), names))
    chain.close()
    if restored is None:
        raise SystemExit(f"no verified checkpoint to serve under "
                         f"{args.checkpoint_dir} (the follower trusts only "
                         "manifest-verified steps)")
    if restored["layout"] not in ("canonical", "sharded"):
        raise SystemExit(f"chain holds {restored['layout']}-layout "
                         "checkpoints; serving follows canonical layouts "
                         "(and sharded ones, read back as canonical) only")
    table = flatten(restored["params"])[names[1]]
    spec = dataclasses.replace(
        spec, param_dtype=str(table.dtype).removeprefix("torch."))
    return spec, restored["params"], restored["step"]


def cmd_serve(args) -> int:
    """Online serving (the reference's single-engine ``serve``): the
    coalescing engine over a bounded request stream, with hot reload
    from a checkpoint chain; one summary line of request latency, QPS,
    swaps, reload failures and staleness. With the obs plane on
    (``--obs-dir``), the engine's and the follower's journal is
    ``serve_health.jsonl`` in the run dir (never in the chain it
    follows), mirrored into the flight ring, and ends with the run's
    ``serve_summary``; ``--slo-ms`` arms the
    ``serve_request`` watchdog phase at that deadline (an overrun fails
    its batch with ``HangDetected`` and fires the SLO capture), unless a
    watchdog is already configured (``FM_SPARK_WATCHDOG``)."""
    from fm_spark_tpu_torch import obs
    from fm_spark_tpu_torch.resilience import watchdog
    from fm_spark_tpu_torch.utils.logging import EventLog

    if not args.fleet:
        for dest, flag in _FLEET_FLAGS:
            if getattr(args, dest) is not None:
                raise SystemExit(f"serve {flag} requires --fleet N (it "
                                 "configures the front door of the replica "
                                 "fleet)")
    elif args.synthetic or args.data or args.out:
        raise SystemExit("serve --fleet answers HTTP requests at its front "
                         "door; --synthetic, --data and --out drive the "
                         "single engine's request stream")
    buckets = tuple(sorted({int(b) for b in args.buckets.split(",") if b}))
    if not buckets:
        raise SystemExit(f"--buckets parsed empty from {args.buckets!r}")
    cache_dir = _compile_cache(args)
    _obs_setup(args)
    _start_metrics_endpoint(args)
    slo_armed = args.slo_ms is not None and not watchdog.active()
    if slo_armed:
        watchdog.configure({"serve_request": args.slo_ms / 1e3},
                           action="raise")
    journal = None
    if obs.run_dir():
        journal = EventLog(os.path.join(obs.run_dir(), "serve_health.jsonl"),
                           keep=False, mirror_to_flight=True)
    try:
        if args.fleet:
            return _serve_fleet(args, journal, cache_dir)
        return _serve(args, buckets, journal)
    finally:
        if slo_armed:
            watchdog.clear()
        if journal is not None:
            journal.close()


def _serve_fleet(args, journal, cache_dir) -> int:
    """``serve --fleet N``: N replica processes (each its own engine on
    ``--device`` and, with ``--checkpoint-dir``, its own read-only chain
    follower) behind one HTTP front door with deadline-aware admission
    control (``--classes``), serving until SIGINT/SIGTERM or
    ``--serve-seconds``. Prints the front door's URL first and one
    ``serve_summary`` line (admission counters, per-replica health with
    each replica's ``fresh_compiles`` and kernel runs) at the end. With
    the obs plane on, the fleet's journal is ``fleet_health.jsonl`` in
    the run dir and each replica opens its own run dir beside it."""
    import dataclasses
    import shutil
    import signal
    import tempfile
    import threading

    from fm_spark_tpu_torch import obs
    from fm_spark_tpu_torch.serve.fleet import Fleet
    from fm_spark_tpu_torch.serve.frontdoor import (AdmissionController,
                                                    FrontDoor)
    from fm_spark_tpu_torch.utils.logging import EventLog

    if not args.model:
        raise SystemExit(
            "--fleet needs --model DIR: each replica loads the saved "
            "model, then (with --checkpoint-dir) hot-follows the chain "
            "through its own read-only follower")
    # Without the obs plane the replicas' port files, journals and stderr
    # go to a temporary dir, removed when the fleet stops.
    scratch = None if obs.run_dir() else tempfile.mkdtemp(prefix="fm_fleet_")
    work_dir = scratch or os.path.join(obs.run_dir(), "fleet")
    if obs.run_dir():
        journal = EventLog(os.path.join(obs.run_dir(), "fleet_health.jsonl"),
                           mirror_to_flight=True)
    obs_root = os.path.dirname(obs.run_dir()) if obs.run_dir() else None
    replica_env = {}
    if args.slo_ms is not None:
        # The serve_request deadline runs in the replicas' engines.
        replica_env = {"FM_SPARK_WATCHDOG":
                       f"serve_request={args.slo_ms / 1e3}",
                       "FM_SPARK_WATCHDOG_ACTION": "raise"}
    autoscaler = None
    if args.autoscale_max:
        from fm_spark_tpu_torch.serve.autoscale import Autoscaler

        autoscaler = Autoscaler(min_replicas=1,
                                max_replicas=max(args.autoscale_max,
                                                 args.fleet))
    fleet = Fleet(args.model, n_replicas=args.fleet,
                  chain_dir=args.checkpoint_dir, work_dir=work_dir,
                  journal=journal, buckets=args.buckets,
                  latency_budget_ms=args.latency_budget_ms,
                  reload_poll_s=args.reload_poll_s,
                  compile_cache_dir=cache_dir, obs_root=obs_root,
                  replica_env=replica_env, autoscaler=autoscaler,
                  device=args.device)
    door = None
    try:
        fleet.start()
        admission = (AdmissionController(args.classes) if args.classes
                     else AdmissionController())
        door = FrontDoor(fleet, admission=admission,
                         port=args.frontdoor_port or 0, journal=journal,
                         trace_sample=(1.0 if args.trace_sample is None
                                       else args.trace_sample)).start()
        print(json.dumps({"frontdoor": {
            "url": door.url, "replicas": args.fleet, "work_dir": work_dir,
            "classes": [dataclasses.asdict(c)
                        for c in admission.classes]}}), flush=True)
        stop = threading.Event()
        for sig in (signal.SIGINT, signal.SIGTERM):
            signal.signal(sig, lambda *_: stop.set())
        if args.serve_seconds:
            stop.wait(args.serve_seconds)
        else:
            while not stop.wait(0.5):
                pass
        stats = door.stats()
        health = fleet.healthz()
    finally:
        if door is not None:
            door.stop()          # closes the fleet with it
        else:
            fleet.close()
        if journal is not None and obs.run_dir():
            journal.close()
        if scratch is not None:
            shutil.rmtree(scratch, ignore_errors=True)
    summary = {"frontdoor": stats,
               "fleet": {k: health[k] for k in ("ready", "n_replicas",
                                                 "capacity", "elastic")},
               "replicas": health["replicas"]}
    if fleet.autoscaler is not None:
        summary["autoscale"] = fleet.autoscaler.summary()
    print(json.dumps({"serve_summary": summary}), flush=True)
    obs.export_snapshot()
    return 0


def _serve(args, buckets, journal) -> int:
    from fm_spark_tpu_torch import models, obs, resolve_device
    from fm_spark_tpu_torch.serve import PredictEngine, ReloadFollower

    dev = resolve_device(args.device)
    step0 = 0
    if args.model:
        spec, params = models.load_model(args.model, device=dev)
    else:
        if not (args.checkpoint_dir and args.config):
            raise SystemExit("serve needs --model DIR, or --checkpoint-dir "
                             "with --config to follow a training chain")
        spec, params, step0 = _serve_from_chain(args)
    engine = follower = None
    out = None
    if args.out:
        out = sys.stdout if args.out == "-" else open(args.out, "w")
    # Synthetic rows are drawn once (a full-width planted model takes
    # seconds to draw); --data streams again on every pass.
    stream = list(_batches_for_model(args, spec)) if args.synthetic else None
    before = _launches()
    n_requests = n_rows = 0
    t0 = time.perf_counter()
    try:
        for _ in range(max(args.repeat, 1)):
            for bids, bvals, _, w in (stream if stream is not None
                                      else _batches_for_model(args, spec)):
                if engine is None:
                    engine = PredictEngine(
                        spec, params, nnz=bids.shape[1], step=step0,
                        buckets=buckets,
                        latency_budget_ms=args.latency_budget_ms, device=dev,
                        journal=journal)
                    warm = engine.warmup()
                    # fresh_compiles: the kernel libraries the warm-up
                    # built (0 on a warm build cache); captures: its CUDA
                    # graphs, which every process captures anew.
                    print(json.dumps({
                        "serving": True, "step": step0,
                        "buckets": list(buckets), "warmup_s": warm["seconds"],
                        "fresh_compiles": warm["fresh_compiles"],
                        "captures": warm["captures"],
                        "capture_s": warm["capture_s"]}), flush=True)
                    if args.checkpoint_dir and args.reload_poll_s > 0:
                        follower = ReloadFollower(
                            engine, args.checkpoint_dir,
                            poll_s=args.reload_poll_s,
                            journal=journal).start()
                preds = engine.predict(bids, bvals)
                if out is not None:
                    for p in preds[w > 0]:
                        out.write(f"{float(p):.6g}\n")
                n_requests += 1
                n_rows += int((w > 0).sum())
                if args.max_requests and n_requests >= args.max_requests:
                    break
            else:
                continue
            break
    finally:
        if follower is not None:
            follower.stop()
        if engine is not None:
            engine.close()
        if out is not None and out is not sys.stdout:
            out.close()
    elapsed = time.perf_counter() - t0
    req = obs.histogram("serve/request_ms").summary()
    summary = {
        "served_requests": n_requests,
        "served_rows": n_rows,
        "elapsed_s": round(elapsed, 3),
        "qps": round(n_requests / elapsed, 2) if elapsed > 0 else None,
        "request_ms": {k: req[k] for k in ("count", "mean", "p50", "p95",
                                           "p99")},
        "generation_step": (engine.generation().step
                            if engine is not None else None),
        "swaps": follower.reloads if follower is not None else 0,
        "reload_failures": follower.failures if follower is not None else 0,
        "staleness_steps": int(obs.gauge("serve/staleness_steps").value or 0),
        "degraded": bool(obs.gauge("serve/degraded").value or 0),
    }
    if journal is not None:
        # The run's closing books in its journal, as the fleet's door
        # journals frontdoor_summary: the run doctor reads them there.
        journal.emit("serve_summary", **summary)
    print(json.dumps({"serve_summary": summary}), flush=True)
    obs.export_snapshot()
    print(json.dumps({
        "device": str(dev), "kernel_launches": _since(before),
        **(_replay_counts(engine) if engine is not None else {}),
        "batch_ms": obs.histogram("serve/batch_ms").summary(),
        "last_swap": follower.last_swap if follower is not None else None,
    }), file=sys.stderr)
    return 0


def cmd_list_configs(args) -> int:
    import dataclasses

    from fm_spark_tpu_torch import configs

    for name, cfg in sorted(configs.CONFIGS.items()):
        if args.verbose:
            print(json.dumps(dataclasses.asdict(cfg)))
        else:
            print(f"{name:24s} {cfg.description}")
    return 0


def _default_obs_dir() -> str:
    """``--obs-dir``'s default: ``FM_SPARK_OBS_DIR``, else
    ``artifacts/obs``."""
    return os.environ.get("FM_SPARK_OBS_DIR", "artifacts/obs")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fmtorch", description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    device_help = "'cuda' (default) or 'cpu' (the kernels' plain versions)"

    t = sub.add_parser("train", help="train a registered config")
    t.add_argument("--config", required=True, help="registered config name")
    t.add_argument("--data", help="a packed dir (see preprocess), a "
                                  "comma-separated list of Criteo TSV or "
                                  "Avazu CSV shards (streamed), or a small "
                                  "file of the config's dataset (MovieLens "
                                  "ratings, Criteo TSV, Avazu CSV)")
    t.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="train on N seeded synthetic examples")
    t.add_argument("--steps", type=int, required=True)
    t.add_argument("--lr", type=float, default=None,
                   help="learning rate in place of the config's")
    t.add_argument("--loss", choices=["logistic", "squared", "hinge"],
                   help="loss in place of the config's (task compatibility "
                        "is checked by the spec)")
    t.add_argument("--seed", type=int, default=None,
                   help="seed in place of the config's (init, shuffles, "
                        "SR bits)")
    t.add_argument("--optimizer", choices=["sgd", "adam", "adagrad", "ftrl"],
                   help="the flat FM's optimizer, or FieldDeepFM's dense "
                        "one (MLP and bias), in place of the config's; the "
                        "field FM/FFM steps take sgd")
    t.add_argument("--batch-size", type=int, default=None)
    t.add_argument("--bucket", type=int, default=None,
                   help="per-field bucket count in place of the config's "
                        "(a narrower copy of the config)")
    t.add_argument("--param-dtype", choices=["float32", "bfloat16"])
    t.add_argument("--compute-dtype", choices=["float32", "bfloat16"])
    t.add_argument("--table-layout", choices=["row", "col"],
                   help="FieldFM's table orientation; col = transposed "
                        "[width, bucket] tables holding the same values "
                        "(bitwise-equivalent; needs --compact-cap)")
    t.add_argument("--sparse-update", choices=["scatter_add", "dedup",
                                               "dedup_sr"])
    t.add_argument("--use-pallas", action="store_true",
                   help="row gathers and scatter_add/dedup writes by the "
                        "row kernels (gather_rows, update_rows_add)")
    _add_lever_args(t)
    t.add_argument("--steps-per-call", type=int, default=1)
    t.add_argument("--strategy", default=None, choices=list(STRATEGIES),
                   help="override the config's strategy: single (one "
                        "device, the dense step), field_sparse (the fused "
                        "step; field-sharded under --distributed), dp "
                        "(data parallel, every family), row (the flat FM's "
                        "row-sharded tables; --force past 1M features)")
    t.add_argument("--force", action="store_true",
                   help="run strategy 'row' on a table of 1M features or "
                        "more")
    t.add_argument("--distributed", action="store_true",
                   help="join a torch.distributed process group (NCCL; "
                        "gloo with --device cpu) before training: under "
                        "torchrun from its environment, else with "
                        "--coordinator/--num-processes/--process-id; one "
                        "rank per card")
    t.add_argument("--coordinator", default=None,
                   help="rendezvous host:port (with --distributed)")
    t.add_argument("--num-processes", type=int, default=None,
                   dest="num_processes",
                   help="total process count (with --distributed)")
    t.add_argument("--process-id", type=int, default=None, dest="process_id",
                   help="this process's rank (with --distributed)")
    t.add_argument("--row-shards", type=int, default=1, dest="row_shards",
                   help="field_sparse under --distributed: shard each "
                        "field's bucket dimension over this many ranks (a "
                        "2-D feat x row mesh)")
    t.add_argument("--ckpt-sharded", action="store_true",
                   dest="ckpt_sharded",
                   help="field_sparse under --distributed: each rank "
                        "writes the fields it owns into the chain; resumes "
                        "only onto the same mesh, reads back as canonical "
                        "tables (eval, predict, serve)")
    t.add_argument("--batch-per-chip", type=int, default=None,
                   dest="batch_per_chip",
                   help="weak scaling: global batch = N x the process count "
                        "(exclusive with --batch-size)")
    t.add_argument("--test-fraction", type=float, default=0.2)
    t.add_argument("--log-every", type=int, default=1)
    t.add_argument("--eval-every", type=int, default=None,
                   help="held-out eval every N steps during training")
    t.add_argument("--checkpoint-dir",
                   help="checkpoint chain directory; a run resumes from its "
                        "newest verified step")
    t.add_argument("--checkpoint-every", type=int, default=1000)
    t.add_argument("--checkpoint-keep", type=int, default=3,
                   help="steps the chain keeps (max_to_keep)")
    t.add_argument("--model-out", help="directory to save the final model")
    t.add_argument("--prefetch", type=int, default=2,
                   help="background batch read-ahead depth (0 = off): "
                        "batches are built and moved to the device off the "
                        "step's critical path")
    t.add_argument("--native-ingest", action="store_true",
                   help="parse the raw-text shards of --data a,b,c with "
                        "the C++ chunk parser: the Python path's record "
                        "stream, cursor and quarantine records at native "
                        "rate; a config outside the native contract falls "
                        "back to the Python parser (reason on stderr)")
    t.add_argument("--data-policy", default="strict",
                   choices=["strict", "quarantine"],
                   help="per-record error policy of the text loaders: "
                        "strict = the first malformed or out-of-contract "
                        "record raises with path:lineno; quarantine = bad "
                        "records go to <quarantine-dir>/deadletter.jsonl "
                        "and training continues")
    t.add_argument("--quarantine-dir",
                   help="dead-letter directory of --data-policy quarantine "
                        "(one JSONL record per bad line: path, lineno, "
                        "reason, repr-escaped preview)")
    t.add_argument("--max-bad-frac", type=float, default=1.0, metavar="FRAC",
                   help="bad-record-rate breaker (quarantine): abort when "
                        "more than FRAC of a trailing window of records is "
                        "bad (1.0 = never)")
    t.add_argument("--supervise", action="store_true",
                   help="wrap single-strategy training in the device-fault "
                        "supervisor (resilience/): a device loss probes the "
                        "card, backs off with bounded exponential delay, "
                        "and restores the newest verified step in place, "
                        "ending bit for bit where the uninterrupted run "
                        "does; health events land in "
                        "<checkpoint-dir>/health.jsonl. Requires "
                        "--checkpoint-dir")
    t.add_argument("--elastic", action="store_true",
                   help="elastic degraded mode (resilience/elastic.py): N "
                        "identical consecutive device losses are classified "
                        "PERMANENT and the run sheds capacity instead of "
                        "dying. field_sparse: this process launches the "
                        "ranks (one per card, or --num-processes N) and "
                        "relaunches them on half the cards (8>4>2>1) from "
                        "the last good checkpoint; single (with "
                        "--supervise): per-chip metrics re-normalize. "
                        "Requires --checkpoint-dir; exclusive with "
                        "--ckpt-sharded")
    t.add_argument("--max-shrinks", type=int, default=3, dest="max_shrinks",
                   help="with --elastic: how many times the device set may "
                        "halve before a permanent fault propagates (3 = an "
                        "8-card gang degrades down to 1)")
    t.add_argument("--compile-cache", nargs="?", const="", default=None,
                   metavar="DIR", dest="compile_cache",
                   help="the kernel build cache at DIR (bare flag = the "
                        "repo-local default dir): a warm process loads "
                        "every nvcc and g++ library built before instead "
                        "of building it (utils/compile_cache.py). "
                        "FM_SPARK_COMPILE_CACHE=<dir|1> does the same "
                        "without the flag")
    t.add_argument("--divergence-guard", type=float, nargs="?", const=10.0,
                   default=None, dest="divergence_guard", metavar="FACTOR",
                   help="flat configs with --checkpoint-dir: a NaN/Inf "
                        "loss or one above FACTOR x the trailing median "
                        "(bare flag: 10x) rolls back to the last good "
                        "checkpoint and resumes with a reduced step budget;"
                        " one loss fetch per step")
    t.add_argument("--online", action="store_true",
                   help="continuous learning (flat configs, needs "
                        "--checkpoint-dir): train day N, evaluate AUC on "
                        "day N+1, save per day; a drift verdict demotes the"
                        " day's saves and rolls the weights back. Days from"
                        " --data d0,d1,... or --synthetic N with "
                        "--online-days")
    t.add_argument("--online-days", type=int, default=8, dest="online_days",
                   help="with --online --synthetic: the number of "
                        "time-ordered day slices")
    t.add_argument("--drift-drop-factor", type=float, default=1.15,
                   dest="drift_drop_factor", metavar="FACTOR",
                   help="drift sentry: eval AUC below trailing-median / "
                        "FACTOR is a drift verdict")
    t.add_argument("--drift-max-rollbacks", type=int, default=2,
                   dest="drift_max_rollbacks",
                   help="drift rollbacks absorbed before the verdict "
                        "propagates")
    t.add_argument("--drift-inject", type=int, default=None,
                   dest="drift_inject", metavar="DAY",
                   help="drill: flip the labels of every synthetic day >= "
                        "DAY (a planted concept drift)")
    t.add_argument("--quality-ledger", dest="quality_ledger", default=None,
                   metavar="PATH",
                   help="append one quality_eval record per online eval "
                        "day to this ledger JSONL")
    t.add_argument("--metrics", metavar="FILE",
                   help="append the loss lines (one JSON object per "
                        "--log-every steps, as printed) to this JSONL file")
    t.add_argument("--obs-dir", dest="obs_dir", default=_default_obs_dir(),
                   help="telemetry root: span traces (trace.jsonl), metrics "
                        "snapshots, the flight recorder, capture bundles and "
                        "a defaulted dead-letter journal land under "
                        "<obs-dir>/<run_id>/ (the run id is the first JSON "
                        "line); 'none' switches the plane off. Default: "
                        "$FM_SPARK_OBS_DIR, else artifacts/obs")
    t.add_argument("--metrics-port", type=int, default=None,
                   dest="metrics_port", metavar="PORT",
                   help="serve the live metrics registry on 127.0.0.1:PORT "
                        "(0 = chosen by the OS, echoed as a JSON line): "
                        "/metrics Prometheus text, /healthz a JSON liveness "
                        "document")
    t.add_argument("--profile", metavar="DIR",
                   help="write a torch.profiler Chrome trace of the run "
                        "(CPU and CUDA activity, the captured steps' "
                        "kernels by name) to DIR/trace.json")
    t.add_argument("--device", default=None, help=device_help)
    t.set_defaults(fn=cmd_train)

    def add_data_args(sp, batch_size):
        sp.add_argument("--data", help="a packed dir or a text file of "
                                       "--config's dataset")
        sp.add_argument("--config", help="config naming the dataset loader")
        sp.add_argument("--bucket", type=int, default=None,
                        help="the per-field bucket count the model and data "
                             "were made with, in place of the config's")
        sp.add_argument("--synthetic", type=int, default=0, metavar="N",
                        help="N seeded synthetic examples shaped by the model")
        sp.add_argument("--batch-size", type=int, default=batch_size)
        sp.add_argument("--device", default=None, help=device_help)

    e = sub.add_parser("eval", help="evaluate a saved model")
    e.add_argument("--model", help="model dir (spec.json + params.npz)")
    e.add_argument("--checkpoint-dir", dest="checkpoint_dir",
                   help="evaluate the newest verified step of a chain "
                        "instead (with --config; a sharded chain reads "
                        "back as canonical tables)")
    e.add_argument("--compute-dtype", choices=["float32", "bfloat16"],
                   default=None, dest="compute_dtype")
    add_data_args(e, 8192)
    e.set_defaults(fn=cmd_eval)

    pr = sub.add_parser("predict", help="write predictions for a dataset")
    pr.add_argument("--model", required=True, help="model dir (spec.json + params.npz)")
    add_data_args(pr, 8192)
    pr.add_argument("--out", help="output file ('-' = stdout)")
    pr.add_argument("--compile-cache", nargs="?", const="", default=None,
                    metavar="DIR", dest="compile_cache",
                    help="the kernel build cache (as train's)")
    pr.set_defaults(fn=cmd_predict)

    sv = sub.add_parser(
        "serve", help="online serving: the micro-batched engine (a CUDA "
                      "graph per bucket) with hot reload from a checkpoint "
                      "chain")
    sv.add_argument("--model", help="saved model dir (spec.json + params.npz)")
    add_data_args(sv, 256)
    sv.add_argument("--compute-dtype", choices=["float32", "bfloat16"],
                    help="with --config and no --model: the compute dtype "
                         "in place of the config's (the tables keep the "
                         "chain's dtype)")
    sv.add_argument("--optimizer", default=None,
                    help="accepted and ignored: the port's chain is keyed by "
                         "name and the follower reads the params only, so "
                         "no optimizer-state example is rebuilt")
    sv.add_argument("--checkpoint-dir", dest="checkpoint_dir",
                    help="training chain to follow: without --model the "
                         "first generation is its newest verified step, and "
                         "with --reload-poll-s > 0 each new last_good that "
                         "verifies and is not demoted hot-swaps in")
    sv.add_argument("--latency-budget-ms", type=float, default=2.0,
                    dest="latency_budget_ms",
                    help="how long the coalescer may hold a request waiting "
                         "for batch-mates (0 = dispatch at once)")
    sv.add_argument("--buckets", default="1,8,64,512",
                    help="comma-separated padded-batch buckets, one CUDA "
                         "graph each on the card")
    sv.add_argument("--reload-poll-s", type=float, default=2.0,
                    dest="reload_poll_s",
                    help="how often the follower polls last_good.json "
                         "(0 = no hot reload)")
    sv.add_argument("--repeat", type=int, default=1,
                    help="passes over the request stream")
    sv.add_argument("--max-requests", type=int, default=0,
                    dest="max_requests",
                    help="stop after N requests (0 = the whole stream)")
    sv.add_argument("--out", help="write predictions here ('-' = stdout)")
    sv.add_argument("--slo-ms", type=float, default=None, dest="slo_ms",
                    help="arm the serve_request watchdog phase at this "
                         "deadline: an overrun fails its batch with a "
                         "structured HangDetected, a flight dump and a "
                         "capture bundle")
    sv.add_argument("--obs-dir", dest="obs_dir", default=_default_obs_dir(),
                    help="telemetry root (as train's): spans, the flight "
                         "recorder, captures and serve_health.jsonl under "
                         "<obs-dir>/<run_id>/; 'none' switches it off")
    sv.add_argument("--metrics-port", type=int, default=None,
                    dest="metrics_port", metavar="PORT",
                    help="the live metrics endpoint (as train's), served "
                         "from a daemon thread off the request path")
    sv.add_argument("--compile-cache", nargs="?", const="", default=None,
                    metavar="DIR", dest="compile_cache",
                    help="the kernel build cache (as train's); the replicas "
                         "of --fleet share it: the first builds, the rest "
                         "load (each replica's fresh_compiles)")
    sv.add_argument("--fleet", type=int, default=0,
                    help="the production front door: run N replica "
                         "processes (each its own engine on --device; "
                         "several share a card) behind one HTTP front door "
                         "with deadline-aware admission control (requires "
                         "--model; --checkpoint-dir adds per-replica hot "
                         "reload)")
    sv.add_argument("--autoscale-max", type=int, default=None,
                    dest="autoscale_max", metavar="N",
                    help="with --fleet: the bidirectional autoscaler with "
                         "this replica ceiling — grows on sustained "
                         "front-door shed, parks idle replicas on low "
                         "coalescer fill; decisions journal as "
                         "autoscale_decision events (default: a fixed-size "
                         "fleet)")
    sv.add_argument("--frontdoor-port", type=int, default=None,
                    dest="frontdoor_port", metavar="PORT",
                    help="with --fleet: the front door's listen port "
                         "(default: ephemeral, printed at startup)")
    sv.add_argument("--classes", default=None,
                    help="with --fleet: admission classes as "
                         "'name:queue_cap:deadline_ms,...' in priority "
                         "order (default: interactive:64:500,batch:64:2000,"
                         "background:32:8000)")
    sv.add_argument("--serve-seconds", type=float, default=None,
                    dest="serve_seconds",
                    help="with --fleet: serve for this long, then exit "
                         "cleanly (default: until SIGINT/SIGTERM)")
    sv.add_argument("--trace-sample", type=float, default=None,
                    dest="trace_sample", metavar="FRAC",
                    help="with --fleet: the fraction of accepted requests "
                         "that get a distributed trace (default 1.0; spans "
                         "cost one JSONL write per hop)")
    sv.set_defaults(fn=cmd_serve)

    lc = sub.add_parser("list-configs", help="list the registered configs")
    lc.add_argument("--verbose", action="store_true",
                    help="every field of each config, one JSON per line")
    lc.set_defaults(fn=cmd_list_configs)

    pp = sub.add_parser("preprocess",
                        help="hash raw criteo/avazu text → packed binary")
    pp.add_argument("--config", required=True)
    pp.add_argument("--input", required=True, nargs="+")
    pp.add_argument("--out-dir", required=True)
    pp.add_argument("--bucket", type=int, default=None,
                    help="per-field bucket count in place of the config's "
                         "(for train --bucket of the same value)")
    pp.add_argument("--no-shuffle", dest="shuffle", action="store_false",
                    help="keep raw source order (tail holdouts become "
                         "temporal splits — see train --test-fraction)")
    pp.set_defaults(fn=cmd_preprocess, shuffle=True)

    ca = sub.add_parser(
        "cap-advise",
        help="scan a packed dir and recommend a --compact-cap "
             "(bounds the per-field per-batch unique-id count)")
    ca.add_argument("--data", required=True, help="packed dir")
    ca.add_argument("--batch-size", type=int, required=True,
                    help="the training batch size the cap must serve")
    ca.add_argument("--batches", type=int, default=20,
                    help="batches to scan (chunk-shuffled, like training)")
    ca.add_argument("--seed", type=int, default=0)
    ca.add_argument("--headroom", type=float, default=0.10,
                    help="fractional headroom over the scanned max "
                         "before rounding up to a multiple of 512")
    ca.set_defaults(fn=cmd_cap_advise)
    return p


def main(argv=None) -> int:
    argv = [str(a) for a in (sys.argv[1:] if argv is None else argv)]
    args = build_parser().parse_args(argv)
    args.argv = argv               # the elastic parent relaunches it
    reason = "run_end"
    try:
        return args.fn(args)
    except BaseException as e:
        # The run's ending on its flight timeline: the dump below then
        # holds the window that led to it (a device loss classified as
        # such), and the error propagates unchanged.
        from fm_spark_tpu_torch import obs
        from fm_spark_tpu_torch.resilience import faults

        reason = "run_failed"
        obs.event("run_failed", error=f"{type(e).__name__}: "
                  f"{(str(e).splitlines() or [''])[0][:200]}",
                  device_loss=faults.is_device_loss(e))
        raise
    finally:
        # The live endpoint stops first (a scrape racing the flush reads
        # a consistent registry), then the plane writes its final metrics
        # snapshot and flight dump and disarms the capture engine: also
        # when the command exits by SystemExit or an error.
        from fm_spark_tpu_torch import obs
        from fm_spark_tpu_torch.obs import export

        export.stop_metrics_server()
        obs.shutdown(reason)


if __name__ == "__main__":
    sys.exit(main())
