"""Smoke run of the PyTorch/CUDA port (``fm_spark_tpu_torch``) on one GPU.

Run from the repository root on a machine with a CUDA card::

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

1. the card's name and power limit, and the torch/CUDA versions;
2. build every kernel from ``fm_spark_tpu_torch/csrc`` (timed);
3. the forward kernel (``fm_fused_scores``) against its plain PyTorch
   version at config 3's full width (39 fields x 262,144 buckets x 65
   columns), fp32 and bf16 storage: uniform ids at B in {1, 8, 64, 512,
   131072}, all four storage/compute pairs at B = 512 and 131,072, the
   bench's Zipf(1.3) ids (``BenchStream``) at B = 512 and 131,072, and
   one wide row (w = 129, a quarter of the bucket); every row within
   ATOL/RTOL of the plain version and repeated bit for bit (and the
   uniform eval batch's first 512 rows equal bit for bit to a call on
   those rows alone), with max errors, kernel and plain times (CUDA events, median of 20 warm calls
   over 20 distinct id sets; device time with the host's issue hidden
   behind a sleep kernel, and the kernel's call time on an idle card) and
   the byte bound of this run's distinct rows at 3.35 TB/s. Then
   ``train.evaluate_params`` of a config-3 model over three bench batches
   (B = 131,072): wall ms and device-busy ms per batch, one launch each;
4. serving: a config-3 FieldFM made on the card from a seeded generator,
   ``PredictEngine(buckets=(1, 8, 64, 512))`` (a CUDA graph per bucket),
   4 threads submitting 400 requests of 1-512 Zipf rows with one
   generation swap (a recapture) mid-run, under torch.profiler; every
   request must be answered once, by one generation, matching the plain
   version; the kernel must run in the replays, counted by its symbol in
   the profile (the replays launch past the wrapper's count);
5. the CLI: ``python -m fm_spark_tpu_torch predict`` on a saved model
   dir (16,384 buckets per field, to keep the npz short), checked line
   by line against the plain version, the kernel run in its graphs'
   replays (its ``kernel_runs_in_replays``); then ``train`` on a config-3 copy
   with 16,384 buckets per field (bf16, dedup_sr, compact, the fused
   backward; 3 steps) and ``eval`` of the model it wrote;
6. the training kernels against their plain versions at full width on
   the bench batch (B = 131,072 Zipf(1.3) ids): segment totals (kernel
   A) on one field in the three forms the paths call it (the compact
   update's, cap 12,288 at w = 65; the device dedup's, cap = B at
   w = 65 and at config 4's w = 369), each within 1e-5 of each
   segment's sum of |term| of the float64 sums, with device, plain,
   ``index_add`` times and the bound; the fused backward (kernel B) over
   all 39 fields on the compact aux in fp32 and bf16 compute; each also
   repeated, which must give the same bits;
7. training on the card: a config-3 FieldFM (bf16 tables and compute,
   dedup_sr, compact 12,288) made from a seeded generator, trained 7
   steps by ``fit_field_sparse`` on a stream of bench batches, once per
   leg (``segtotal``: gfull + kernel A; ``fusedbwd``: kernel B); the
   loss must be finite and fall and the leg's kernel must launch; one
   more step from the trained params must equal, within the bf16
   tolerance, the same step with the plain versions swapped in;
8. the FFM kernels (``ffm_sel_scores``, ``ffm_sel_bwd``) against their
   plain versions at config 4's width (23 fields, rank 16) on rows
   gathered from a seeded table by bench ids (``zipf(1.3) % 16384``),
   B in {512, 8192, 131072}, fp32 and bf16: errors, a bitwise repeat,
   device, call and plain times and the byte bound;
9. FFM serving: a config-4 FieldFFM made on the card from a seeded
   generator behind ``PredictEngine(buckets=(1, 8, 64, 512))``, 4
   threads submitting 200 requests of 1-512 rows with one swap, checked
   as in phase 4 against the plain version;
10. FFM training at full width (23 x 16,384 x 369 fp32 tables, B =
   131,072 bench batches): ``fit_field_sparse`` 7 steps per leg of the
   ``selblk-pallas`` recipe (scatter_add, sel_blocked, fused_embed
   require) in bf16 and in fp32 compute; the loss must be finite and
   fall, each kernel launch once per step, and one more step equal the
   same step with the plain versions within the stated tolerance;
11. the row kernels (``gather_rows``, ``update_rows_add``) against their
   plain versions at full width on the bench batch's ids: config 3's
   39 x 262,144 x 65 tables in fp32 and bf16 and config 4's
   23 x 16,384 x 369 fp32 tables, every field bit for bit and a bitwise
   repeat; the update writes the device dedup (``scatter._dedup``) of one
   field's fp32 deltas in the dedup's form (per-segment totals and ids,
   the segment count on the device). On the field with the most
   distinct ids: device,
   call, plain and library times (``index_select``; ``index_add_`` of the
   masked deltas) and the byte bound from the batch's distinct rows. Then
   the native and numpy host aux builders on the config-3 bench batch;
12. ``use_pallas`` training at full width through ``fit_field_sparse``, 7
   steps per leg on bench batches: ``fm-pallas`` (config 3, fp32 tables
   and compute, scatter_add) and ``ffm-selblk-pallas-rows`` (config 4,
   fp32 tables, bf16 compute, scatter_add, sel_blocked, fused_embed
   require); the loss must be finite and fall, each row kernel and
   kernel A (the device dedup's sums) launch F times per step (the FFM
   kernels once), one more step run twice on two copies of the params
   give the same bits, that step equal the same step with the plain
   versions within the stated tolerance, and the profile of three steps
   hold no ``index_add`` op or kernel;
13. the captured step: the SR bits kernel (``sr_bits``, JAX's threefry
   key schedule) against its plain version bit for bit at [12,288, 65]
   and [12,288, 369]; the compact update's blocked-prefix segment sums
   on one field in three forms (the parent tree's ``cumsum``, one add per
   element of a run, the package's ``cumsum`` per run), the last two bit
   for bit equal to each other and to the CPU, with device-busy ms and
   device ops per call; then six training legs at full width on the same
   seeded bench batches, each eagerly (``make_field_*_sgd_body``) on one
   copy of the params and captured (``make_field_*_sgd_step``: one CUDA
   graph, replayed) on another, the losses and params equal bit for bit
   after each of 7 steps and after 3 profiled steps: compact (bf16,
   dedup_sr, cap 12,288, native host aux) in its plain form and with
   ``segtotal`` and ``fusedbwd``, ``devaux`` (``compact_device``, gfull +
   kernel A, overflow 'error'), ``fm-pallas`` and
   ``ffm-selblk-pallas-rows``; for each, the capture's seconds, wall ms
   per step (host clock to a synchronise, steps 3-7) and, over the 3
   profiled steps, device-busy ms and host launches per step, eager
   against captured. The wrappers count the eager steps' launches and
   none in the replays; the profiler counts each port kernel's runs by
   its symbol (``KERNEL_SYMBOLS``): the leg's own must run in the
   replays, at least once per step, and no kernel more often per step
   than the eager step launches it (the trace misses a kernel record now
   and then, so a count may fall short). Then the roll (``make_field_sparse_multistep``, n = 4: a
   graph of 4 steps and one of the tail of 3) against 7 eager steps of
   the ``fusedbwd`` leg, bit for bit;
14. real data and resumable training through ``fmtorch`` (``cli.main``,
   in this process): a 327,680-row Criteo TSV written by whole columns
   (``zipf(1.3)`` hex tokens, 5 % missing), ``preprocess`` at config 3's
   full bucket (shuffled) and ``cap-advise`` (its scanned maximum must
   fit cap 12,288), the packed reader's ``assemble`` timed on the host;
   then three legs, each trained uninterrupted, stopped, and resumed by
   the same command into a checkpoint chain kept in a temporary
   directory (``--checkpoint-keep 2``): leg A, config 3 at full width
   (bf16, ``dedup_sr``, host compact aux at 12,288, the fused backward,
   batch 131,072, 6 steps over two epoch boundaries, resumed at 3), with
   ``eval --data`` and ``predict --data`` on the holdout; leg B, the same
   with ``segtotal`` and ``--steps-per-call 2`` (4 steps, resumed at 2);
   leg C, config 4 from an Avazu CSV (``--use-pallas``, ``sel_blocked``,
   the FFM kernels, batch 8,192, resumed at 3) and ``eval --data``. The
   resumed run's loss lines and final saved step (and in legs A and C its
   params.npz) must equal the uninterrupted run's bit for bit, its steps
   replays of graphs captured after the restore (the equality is the
   witness that they read the restored tensors). Every kernel
   counter is set to 0 before the legs and each must have launched. It
   prints preprocess rows/s, assemble, aux and step ms per batch, save
   (snapshot, crc, write) and restore ms, with the card's name and power
   limit;
15. config 5 (FieldDeepFM, ``criteo1tb_deepfm``) at full width: 39 x
   262,144 x 17 tables (bf16), an MLP of 624 -> 400 -> 400 -> 400 -> 1
   trained by Adam, B = 16,384 bench batches (``zipf(1.3) % bucket``).
   First the kernels at its 17 columns against their plain versions:
   ``gather_rows`` and ``update_rows_add`` on bf16 and fp32 tables (every
   field bit for bit), kernel A on fp32 deltas in the compact update's
   form (cap 16,384) and the device dedup's (cap = B), the SR bits at
   [16,384, 17]. Then three legs, each 4 steps eagerly and captured (one
   CUDA graph over the params and Adam's state) from the same seeded
   params, the loss, params and Adam's moments and count equal bit for
   bit after every step, and 3 profiled steps of each: A, the registered
   recipe (bf16, ``dedup_sr``, host compact aux at 16,384); B, the same
   with ``segtotal_pallas``; C, ``use_pallas`` with ``dedup`` (the row
   kernels and kernel A at cap = B; under ``use_pallas`` ``dedup_sr``
   writes by its set, as the reference's). Per leg the captured step's
   CUDA-event ms, samples/s, device-busy ms and idle share, host
   launches eager against replayed, each kernel's runs per replay; once,
   the MLP's forward and backward ms beside its FLOP bound and one Adam
   update's ms. Then leg A through ``fmtorch`` on a packed dir of bench
   ids: trained uninterrupted, stopped and resumed into a checkpoint
   chain (the resumed run's losses and final step, Adam's arrays
   included, bit for bit), ``eval`` and ``predict`` of its model dir,
   and 400 requests served from it with a generation swap. Every kernel
   counter is set to 0 before the legs; each kernel the legs reach must
   have launched;
16. serving through the graphs and the chain (``serve_chain_phase``):
   leg A, ``fmtorch train`` publishes step 2 of a config-3 chain (bf16,
   full width, bench ids, B = 16,384), ``fmtorch serve --config ...
   --checkpoint-dir`` starts from it, and the same train command resumes
   to step 6 (saves every 2) while serve answers 4,160 requests paced by
   a 5 ms budget: serve must swap at least once, with no reload failure,
   not degraded, end on step 6, and its last pass equal the plain
   version on step 6's params; leg B (in this process, meanwhile), the
   chain's drills at config 5's width with a client served throughout:
   a demoted tip refused, ``demote_newer_than`` moving the pointer back,
   a corrupt tip and a torn ``last_good`` walked past, a demotion racing
   a reload refused, every poll leaving the chain's sizes and mtimes and
   the last three its bytes as they were, every answer one installed
   generation's; leg D, FieldDeepFM's rows served in each bucket against
   the same rows in a batch of 512, raw scores (bf16 and fp32, torch's bf16
   reduced-precision flag on and off), the parent's whole-batch head
   measured beside the row-tiled one, which must be 0; leg C (alone on
   the card), per bucket of configs 3 (fp32, bf16), 4 and 5 at full
   width: the replay bit for bit equal to an eager ``spec.predict`` of
   the same padded bucket, dispatch ms eager against replayed, host
   launches and device-busy ms per batch, the forward kernels' runs per
   replay by symbol; a swap from host params (H2D and capture seconds)
   after which every answer is the new generation's; and config 3
   bf16's memory after 3 swaps;
17. configs 1 and 2, the flat FM (``flat_fm_phase``): kernel A against
   its plain version at each dense step's shape (the device dedup of the
   batch's B·nnz lanes, w = rank + 1, cap = B·nnz), with device, call,
   plain and ``index_add`` times and the bound; then every kernel count
   set to 0 and, for config 2 (``criteo_kaggle_fm_r32`` at full width:
   1,277,952 x 32 fp32, B = 16,384 x 39 global Zipf ids) and config 1
   (``movielens_fm_r8`` on an ML-100K-shaped ratings file synthesized
   from a seed: 943 users, 1,682 items, 100,000 ratings, B = 4,096), the
   dense step (``train.make_train_step``) 5 steps eagerly and captured
   from the same seeded params, loss, ``grad_norm``, params and the
   schedule's count equal bit for bit after every step, wall ms per step,
   3 profiled steps of each (device-busy ms, idle share, host launches,
   kernel A's runs per replay by symbol), the eager step repeated on two
   copies bit for bit, and one step on the card against the plain CPU
   step (params and scores within rtol 1e-5, atol 1e-6: float32 sums in
   another order); config 2 behind ``PredictEngine``, each bucket's
   replay equal to eager bit for bit, with dispatch ms; ``fmtorch``
   preprocess of a 98,304-row Criteo-shaped TSV at config 2's bucket,
   train uninterrupted and stopped and resumed (bit for bit), eval and
   predict ``--data``; config 1 trained and evaluated through ``fmtorch``.
   Kernel A must have launched;
18. the other families and optimizers (``families_phase``), every kernel
   count set to 0 before its legs: leg A, FTRL, the dense step at config
   2's full width as phase 17's legs are held (eager against captured bit
   for bit with FTRL's ``z``/``n``, against the CPU step), ``fmtorch
   train --optimizer ftrl`` on 81,920 synthetic rows stopped at 2 and
   resumed to 4 (bit for bit), config 5's recipe with its dense head by
   FTRL (eager against captured); leg B, the sparse adaptive step at
   config 2's width for FTRL and AdaGrad (eager against captured bit for
   bit, untouched rows and slots unchanged, against the CPU step, step ms,
   kernel A per replay); leg C, a config-4 FieldFFM's params through
   ``to_flat_params`` (the flat FFM's scores against FieldFFM's), the sel
   kernels and kernel A (w = 369, lanes = B·23) at the flat FFM step's
   shape against their plain versions, the dense FFM step at B = 16,384
   as a phase 17 leg; leg D, the flat DeepFM at config 5's widths (39 x
   262,144 x 16, MLP 400-400-400, Adam, fp32, B = 16,384) as a phase 17
   leg, and served per bucket; leg E, ``FMWithLBFGS`` on config 1's
   ratings (the card's objective against the CPU's), ``FFMWithSGD`` on
   20,000 Avazu-shaped rows, and the first 159,744 rows of config 2's
   trained model through ``save_libfm``/``load_libfm`` (scores bit for
   bit). Kernel A, both sel
   kernels and the SR bits must have launched;
19. training straight off raw-text shards (``stream_phase``): phase 14's
   327,680-row Criteo TSV in three shards with 0.5 % of its lines
   corrupted (placed from a seed; a wrong field count, a non-numeric
   label, a bad token by turns). Leg C: the first 1,024 rows of each
   shard through the Python and the native parser, batches and cursors
   equal, host rows/s of each. Leg A: ``fmtorch train --native-ingest
   --data-policy quarantine --max-bad-frac 0.05`` at config 3's full
   width (bf16, dedup_sr, compact 12,288, the fused backward, B =
   131,072, 6 steps over two epoch tails, a save every 2) uninterrupted,
   and as a subprocess SIGKILLed after its step-3 loss line and resumed
   by the same command: losses, the last step, ``params.npz``, the
   bad/good counts and the dead-letter records equal, kernel B and the
   SR bits in the resumed run's replays by symbol; then the same path in
   this process, three steps under the profiler (step ms, device-busy
   ms, idle share). Leg B: config 4 from an Avazu CSV in three shards
   (the header in shard 0 only), ``--native-ingest --use-pallas``, 3
   steps. Leg D: FieldFM's col layout at config 3's width (bf16,
   dedup_sr, compact, kernel A) eager against captured and against the
   row layout bit for bit, the unfused form (fp32, scatter_add) eager
   against captured, and both forms' scores on the library path against
   the CPU's, timed beside the row kernel;
20. the tiered embedding store and continuous learning
   (``tier_phase``) at config 2's widths (rank 32, fp32, 39 ids a row, B
   = 16,384) on the reference ladder's stream (32 Zipf buckets of 1,024
   rows, drifting one bucket a step; a hot tier of 48 buckets; 32
   steps): kernel A against its plain version at the tiered step's
   shape (the B·nnz lanes sorted by global id); then every count set to
   0 and leg A, at 10,000,384 features (dense cold tier) for SGD, FTRL
   and AdaGrad, the tiered run through the prefetcher (depth 2) against
   the untiered captured step over the whole table from the same init:
   every step's loss and the merged planes (slots too) bit for bit, with
   hit rate, misses, evictions, stall ms, H2D/D2H bytes, ``begin_batch``
   host ms, examples/s and, over 3 profiled steps each, device-busy ms,
   idle share and kernel A's runs per replay by symbol; leg C, FTRL at
   leg A's sizes with a chain every 16 steps, killed at the 10th eviction
   (``faults.inject`` patched) and resumed by a new trainer: its merged
   planes after 32 steps equal leg A's bit for bit; leg B, the lazy
   rungs at 100,000,768 and 1,000,000,512 features (SGD): examples/s,
   gathered rows/s, hit rate, stall, the cold tier's host bytes (the
   touched buckets only), RSS growth and peak, the card's peak memory;
   leg D, ``fmtorch train --online`` at config 2's full width (524,288
   synthetic rows in 8 days, a label flip planted at day 5, FTRL) as
   subprocesses: one uninterrupted, a ``ReloadFollower`` on its chain
   throughout (never a step tombstoned at its swap, ending on the
   republished tip), one SIGKILLed once day 3's save is the chain's last
   good step and resumed by the same command (the pending eval
   replayed; its AUC series, demoted steps and params.npz equal the
   uninterrupted run's bit for bit), one from four Criteo day shards,
   per-day AUC and train/eval seconds from the run's spans, and the loop
   in this process under the profiler (kernel A in the replays); leg E,
   ``FMTrainer.fit(divergence_guard=...)`` at config 2 with FTRL and a
   chain every 4 steps, batch 10 poisoned: it rolls back and ends at step
   9, params and FTRL state equal to an unpoisoned run's bit for bit.
   Kernel A must have launched;
21. the obs and fault planes at config 3's full width (``obs_phase``):
   leg A, ``fmtorch train`` (bf16, dedup_sr, compact 12,288, kernel B,
   B = 131,072 synthetic rows, 4 steps, one save) with ``--obs-dir``,
   ``--profile``, ``--metrics`` and ``--metrics-port 0``: the run id is
   the first line, the loss lines are finite and equal the metrics file,
   the run dir holds the trace (window, save and verify spans), the
   flight spool and dump and the final snapshot, and the profile names
   every kernel the run launched by its symbol; leg B, ``fmtorch serve``
   of the chain leg A saved (fp32 compute) with ``--slo-ms``,
   ``--metrics-port 0``, ``--obs-dir`` and ``--repeat``, in a thread:
   ``/metrics`` and ``/healthz`` scraped while it serves,
   ``serve_health.jsonl`` and one ``serve/batch`` span per request in its
   run dir, every answer within 1e-5 relative and ATOL/4 of the plain
   version; leg C, a planted ``train_step@2=device_loss`` ends the run
   with ``InjectedDeviceLoss`` and a flight dump naming it; leg D, the
   plane's cost: the same captured step's wall ms and CUDA-event ms with
   ``--obs-dir none`` and with the plane on;
22. training over ``torch.distributed`` (``parallel_phase``): an NCCL
   group of one rank made here (a TCP store on a free localhost port);
   every count set to 0; the field-sharded FieldFM step at config 3's
   full width (bf16, dedup_sr, the device aux at 12,288, gfull + kernel
   A, B = 131,072) captured against the single-card captured step from
   the same params and bench batches, losses and all 39 tables the same
   bits after each of 3 steps and 2 profiled ones (wall and device-busy
   ms each, kernel A's and ``sr_bits``' runs per replayed step by
   symbol); FieldFFM (config 4's fields, rank 16) and FieldDeepFM
   (config 5, Adam; replicated and deep-sharded heads) sharded steps at
   4,096 rows a field (B = 8,192) against the single card within their
   stated tolerances; config 2 under ``dp`` at full width against the
   single dense step bit for bit; the generic dense step of each field
   family at 4,096 rows a field, captured against eager bit for bit;
   the tier's bf16 planes at 10,000,384 features (24 steps, SGD)
   against the untiered bf16 step bit for bit; last, once the phase's
   group is gone, ``fmtorch train --distributed --ckpt-sharded`` at
   config 3's full width (2 steps and one sharded save, world 1, a group
   of its own from a torchrun-style environment) in this process
   (``cli.main``), then ``fmtorch eval --checkpoint-dir`` of its sharded
   chain. Kernel A and ``sr_bits`` must have launched.

Phases 7, 10 and 12 train through ``fit_field_sparse``, which runs the
captured step on the card: a kernel wrapper counts its launches in the
warm-up step (on clones of the params, before the capture); the capture
records the kernels and the replays run them past the wrappers, which
phase 13 counts on the card. Phase 6 also holds kernel B against its
plain version on the device-built aux of the bench batch at cap 8,192,
where lanes lie past the cap (``compact_device``'s 'drop').

Phase 5 also trains config 4 at 4,096 buckets per field through both
FFM kernels (bf16 compute) and evaluates and predicts with the model it
wrote, and trains config 3 at 16,384 buckets with ``--use-pallas``.
Phase 7's host aux is the native counting sort's.

It prints the kernels' JSON line, then the card line, then, last,
``{"ok": true, "device": {...}}``; details go to
``chiprun_out/chip_smoke.json``. It needs one card and imports nothing
of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))

F, BUCKET, RANK = 39, 1 << 18, 64        # config 3, criteo1tb_fm_r64
WIDTH = RANK + 1
BATCHES = (1, 8, 64, 512, 131072)
HBM_BYTES_PER_S = 3.35e12                # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12                 # the same, outside the tensor cores
TRAIN_B, CAP = 131072, 12288             # bench.py's config-3 batch and cap
DROP_CAP = 8192                          # below the bench batch's distinct ids
TRAIN_STEPS, WARM_STEPS = 7, 2
PROFILED_STEPS = 3                       # phase 13: after the 7 compared
REPS = 20
FFM_F, FFM_BUCKET, FFM_RANK = 23, 1 << 14, 16   # config 4, avazu_ffm_r16
FFM_BATCHES = (512, 8192, 131072)
# fp32 accumulation in another order than the plain version: the two
# cancelling terms sum s^2 and ssq are each ~25 at N(0, 0.1) rows, so
# their rounding differences reach ~1e-5 absolute.
ATOL, RTOL = 1e-4, 1e-5


def _check(cond: bool, msg: str) -> None:
    if not cond:
        print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
        sys.exit(1)


def _median_ms(fn, reps: int = REPS, hide_host_ms: float = 0.0,
               before=None) -> float:
    """Median over ``reps`` warm calls of the CUDA-event time around one
    ``fn(r)``. With ``hide_host_ms`` > 0 a sleep kernel that long runs
    first, so the host has enqueued the whole call before the start
    event fires: the span is then device time alone. Without it the span
    also holds the host's time to issue the call (the idle-card latency
    a caller sees). ``before()``, when given, is enqueued after the sleep
    and before the start event (an L2 flush, untimed)."""
    import torch

    fn(0)
    fn(1)
    torch.cuda.synchronize()
    # At most ~2e6 SM cycles per ms (H100 boost clock 1.98 GHz), so the
    # sleep lasts at least hide_host_ms.
    cycles = int(hide_host_ms * 2e6)
    times = []
    for r in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if cycles:
            torch.cuda._sleep(cycles)
        if before is not None:
            before()
        start.record()
        fn(r)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _close(got, want) -> bool:
    return bool(((got - want).abs() <= ATOL + RTOL * want.abs()).all())


def _rel_err(got, want) -> float:
    """Largest |got - want| / |want| over entries with |want| >= 1e-2."""
    big = want.abs() >= 1e-2
    if not bool(big.any()):
        return 0.0
    return float(((got - want).abs()[big] / want.abs()[big]).max())


def _fwd_rows(dev, tables, bucket, id_sets, vals, cases, tag):
    """The forward kernel against its plain version on ``tables`` for each
    ``(B, compute_bf16)`` of ``cases``: ``id_sets[B]`` holds REPS id sets
    ``[B, F]`` and ``vals[B]`` REPS value sets (or one shared tensor).
    Each case: max errors, a repeat that must give the same bits, device,
    call and plain ms, and the bound from this run's distinct rows."""
    import torch

    from fm_spark_tpu_torch.ops import fused_fwd

    num_fields = len(tables)
    width = tables[0].shape[1]
    sb = tables[0].element_size()
    dtype = str(tables[0].dtype).removeprefix("torch.")
    w0 = torch.tensor(0.25, device=dev)
    rows = []
    for b, cd_bf16 in cases:
        ids = id_sets[b]
        vs = vals[b] if isinstance(vals[b], list) else [vals[b]] * REPS
        got_s, got_a = fused_fwd.fm_fused_scores(
            tables, ids[0], vs[0], w0=w0, compute_bf16=cd_bf16)
        again_s, again_a = fused_fwd.fm_fused_scores(
            tables, ids[0], vs[0], w0=w0, compute_bf16=cd_bf16)
        torch.cuda.synchronize()
        ref_s, ref_a = fused_fwd.fm_fused_scores_plain(
            tables, ids[0], vs[0], w0=w0, compute_bf16=cd_bf16)
        name = (f"{dtype} {tag} w={width} B={b}"
                f"{' cd-bf16' if cd_bf16 else ''}")
        _check(bool(torch.isfinite(got_s).all()), f"{name}: non-finite scores")
        _check(got_s.shape == (b,) and got_a.shape == (b, width),
               f"{name}: output shapes {got_s.shape} / {got_a.shape}")
        _check(_close(got_s, ref_s) and _close(got_a, ref_a),
               f"{name}: kernel disagrees with plain version")
        _check(_same_bits(got_s, again_s) and _same_bits(got_a, again_a),
               f"{name}: a repeated call gave other bits")

        def kernel(r):
            fused_fwd.fm_fused_scores(tables, ids[r], vs[r], w0=w0,
                                      compute_bf16=cd_bf16)

        def plain(r):
            fused_fwd.fm_fused_scores_plain(tables, ids[r], vs[r], w0=w0,
                                            compute_bf16=cd_bf16)

        ms = _median_ms(kernel, hide_host_ms=2.0)
        call_ms = _median_ms(kernel)
        plain_ms = _median_ms(plain, hide_host_ms=30.0)
        # Bytes this run's data needs: each distinct (field, id) row
        # once, ids + vals once, scores + acc written once.
        offs = torch.arange(num_fields, device=dev, dtype=torch.int64) * bucket
        uniq = statistics.mean(
            int(torch.unique(i.long().clamp(0, bucket - 1) + offs).numel())
            for i in ids)
        nbytes = (uniq * width * sb + b * num_fields * 8 + b * 4
                  + b * width * 4 + 4)
        row = {
            "dtype": dtype, "ids": tag, "width": width, "fields": num_fields,
            "bucket": bucket, "B": b,
            "compute": "bfloat16" if cd_bf16 else "float32",
            "max_abs_err": float((got_s - ref_s).abs().max()),
            "max_abs_err_acc": float((got_a - ref_a).abs().max()),
            "max_rel_err": _rel_err(got_s, ref_s), "repeat_bitwise": True,
            "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bytes": nbytes, "unique_rows": uniq,
        }
        row["achieved_GBps"] = nbytes / (ms * 1e-3) / 1e9
        row["bound_share"] = row["bound_ms"] / ms
        rows.append(row)
        print("kernel", json.dumps(row), flush=True)
    return rows


def kernel_phase(dev, report):
    import torch

    from fm_spark_tpu_torch.ops import fused_fwd

    g = torch.Generator(device=dev).manual_seed(3)
    # Uniform ids at every serving bucket and the eval batch; all four
    # storage/compute pairs at B = 512 and 131,072.
    uni_ids, uni_vals = {}, {}
    for b in BATCHES:
        uni_ids[b] = [torch.randint(0, BUCKET, (b, F), generator=g, device=dev,
                                    dtype=torch.int32) for _ in range(REPS)]
        uni_vals[b] = [torch.rand(b, F, generator=g, device=dev) + 0.5
                       for _ in range(REPS)]
    # The bench's Zipf(1.3) ids (vals all 1) that serving and eval see.
    zipf_ids, zipf_vals = {}, {}
    for b in (512, TRAIN_B):
        stream = BenchStream(seed=0, batch=b, fields=F, bucket=BUCKET)
        zipf_ids[b] = [torch.from_numpy(stream.next_batch()[0]).to(dev)
                       for _ in range(REPS)]
        zipf_vals[b] = torch.ones(b, F, device=dev)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        tables = [(torch.randn(BUCKET, WIDTH, generator=g, device=dev) * 0.1)
                  .to(dtype) for _ in range(F)]
        both = [(b, cd) for b in (512, TRAIN_B) for cd in (False, True)]
        rows += _fwd_rows(dev, tables, BUCKET, uni_ids, uni_vals,
                          [(b, False) for b in BATCHES] + [
                              (512, True), (TRAIN_B, True)], "uniform")
        rows += _fwd_rows(dev, tables, BUCKET, zipf_ids, zipf_vals, both,
                          "zipf")
        # A sample's bits do not hang on the batch it came in (nor on the
        # launch form that batch takes): the eval batch's first 512 rows
        # against a call on those 512 alone.
        ids, vs = uni_ids[TRAIN_B][0], uni_vals[TRAIN_B][0]
        for cd in (False, True):
            full = fused_fwd.fm_fused_scores(tables, ids, vs, compute_bf16=cd)
            part = fused_fwd.fm_fused_scores(tables, ids[:512], vs[:512],
                                             compute_bf16=cd)
            _check(all(_same_bits(p, f[:512]) for p, f in zip(part, full)),
                   f"{dtype} cd_bf16={cd}: rows scored at B = 512 and in "
                   f"the B = {TRAIN_B} batch differ in their bits")
        del tables
        torch.cuda.empty_cache()
    # One wide row: rank 128 (w = 129, past the 128 columns the first
    # kernel took) at a quarter of the bucket.
    wide_bucket = BUCKET // 4
    tables = [torch.randn(wide_bucket, 129, generator=g, device=dev) * 0.07
              for _ in range(F)]
    wide_ids = {TRAIN_B: [i % wide_bucket for i in uni_ids[TRAIN_B]]}
    rows += _fwd_rows(dev, tables, wide_bucket, wide_ids, uni_vals,
                      [(TRAIN_B, False)], "uniform")
    del tables, uni_ids, zipf_ids
    torch.cuda.empty_cache()
    report["kernel_vs_plain"] = rows
    return rows


def eval_phase(dev, report):
    """``train.evaluate_params`` of a config-3 FieldFM over three bench
    batches (B = 131,072, Zipf ids): wall ms per batch on the host clock
    (host input included) and the device's busy ms per batch under the
    profiler."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fm_spark_tpu_torch.ops import fused_fwd
    from fm_spark_tpu_torch.train import evaluate_params

    spec, params = _config3_model(dev, seed=5)
    stream = BenchStream(seed=1, batch=TRAIN_B, fields=F, bucket=BUCKET)
    batches = [stream.next_batch() for _ in range(3)]
    evaluate_params(spec, params, batches[:1])      # warm
    torch.cuda.synchronize()
    fused_fwd.launches = 0
    t0 = time.perf_counter()
    metrics = evaluate_params(spec, params, batches)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    launches = fused_fwd.launches
    _check(launches == len(batches),
           f"eval launched the forward kernel {launches} times, not 3")
    _check(bool(np.isfinite(metrics["logloss"])) and metrics["count"] > 0,
           f"eval metrics {metrics}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        evaluate_params(spec, params, batches)
        torch.cuda.synchronize()
    on_dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = (_union_ms(on_dev) / len(batches) if on_dev else "not measured")
    fwd = [e for e in on_dev if "fm_fused_fwd" in e.name]
    out = {"batches": len(batches), "B": TRAIN_B, "wall_ms_per_batch": wall_ms,
           "device_busy_ms_per_batch": busy,
           "forward_kernel_ms_per_batch": (
               sum(e.time_range.elapsed_us() for e in fwd) / 1e3 / len(batches)
               if fwd else "not measured"),
           "launches": launches, "metrics": metrics}
    print("eval", json.dumps(out), flush=True)
    report["eval"] = out
    del params
    torch.cuda.empty_cache()
    return out


def _config3_model(dev, seed: int, bucket: int = BUCKET,
                   dtype: str = "float32"):
    """A config-3 FieldFM with random weights from ``seed`` (tables and
    compute in ``dtype``); the linear column and bias are filled too, as a
    trained model's would be."""
    import torch

    from fm_spark_tpu_torch import models

    spec = models.FieldFMSpec(num_features=F * bucket, rank=RANK,
                              num_fields=F, bucket=bucket, init_std=0.1,
                              param_dtype=dtype, compute_dtype=dtype)
    g = torch.Generator(device=dev).manual_seed(seed)
    params = spec.init(g, device=dev)
    for t in params["vw"]:
        t[:, RANK] = torch.randn(bucket, generator=g, device=dev) * 0.1
    params["w0"].fill_(0.05)
    return spec, params


def _plain_predict(spec, params, ids, vals, dev):
    """``spec.predict`` on the card with every kernel's plain version
    swapped in."""
    import torch

    with _plain_versions():
        return spec.predict(params, torch.from_numpy(ids).to(dev),
                            torch.from_numpy(vals).to(dev)).float().cpu()


def _serve(dev, spec, params, params1, num_fields, bucket, n_req, kernel,
           atol: float = 2e-5):
    """4 threads submit ``n_req`` requests of 1-512 rows to a
    ``PredictEngine`` (a CUDA graph per bucket) and the generation is
    swapped from ``params`` to ``params1`` half way (a recapture); every
    request must be answered once, by one generation, matching
    the plain version within ``RTOL`` and ``atol``. ``kernel`` (a wrapper's
    name, None for a model served without a kernel) must run in the
    replays: the run is profiled and the kernel's device events counted by
    symbol (the replays launch past the wrapper's count)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from fm_spark_tpu_torch import data, obs
    from fm_spark_tpu_torch.serve import PredictEngine

    engine = PredictEngine(spec, params, buckets=(1, 8, 64, 512),
                           latency_budget_ms=2.0, device=dev)
    warm = engine.warmup()
    print(f"serve warmup {warm['seconds']:.3f} s ({warm['captures']} "
          f"captures, {warm['capture_s']:.3f} s)", flush=True)

    ids_pool, vals_pool, _ = data.synthetic_ctr(20000, spec.num_features,
                                                num_fields, seed=2)
    ids_pool = data.field_local(ids_pool, bucket)
    rng = np.random.default_rng(7)
    sizes = rng.choice([1, 1, 2, 3, 8, 17, 64, 100, 255, 512], size=n_req)
    starts = rng.integers(0, len(ids_pool) - 512, size=n_req)
    reqs = [(int(s), int(o)) for s, o in zip(sizes, starts)]
    futures: list = [None] * len(reqs)
    half_done = threading.Event()
    errors = []

    def client(t):
        pace = np.random.default_rng(100 + t)
        try:
            for i in range(t, len(reqs), 4):
                if i >= len(reqs) // 2:     # the second half follows the swap
                    half_done.wait(60)
                n, o = reqs[i]
                futures[i] = engine.submit(ids_pool[o:o + n], vals_pool[o:o + n])
                time.sleep(float(pace.random()) * 1e-3)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    # Counts start at 0 just before the main path and are read just after.
    obs.registry().reset()
    runs0 = engine.kernel_runs()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        torch.cuda._sleep(2_000_000)       # the trace's warm-up cycle
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(4)]
        for th in threads:
            th.start()
        give_up = time.monotonic() + 120
        while sum(f is not None and f.done() for f in futures) < len(reqs) // 2:
            _check(time.monotonic() < give_up and not errors,
                   f"first half of the requests not answered: {errors!r}")
            time.sleep(1e-3)
        gen1 = engine.swap_generation(params1, step=1)
        half_done.set()
        for th in threads:
            th.join(120)
        results = [f.result(120) for f in futures]
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        prof.step()
    on_dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    symbols, _ = _symbol_counts(on_dev)
    runs = engine.kernel_runs()
    launches = symbols[kernel] if kernel is not None else None
    snap = obs.registry().snapshot()
    engine.close()
    _check(not errors, f"client thread failed: {errors!r}")

    all_ids = np.concatenate([ids_pool[o:o + n] for n, o in reqs])
    all_vals = np.concatenate([vals_pool[o:o + n] for n, o in reqs])
    want = [_plain_predict(spec, p, all_ids, all_vals, dev).numpy()
            for p in (params, params1)]
    by_gen = [0, 0]
    off = 0
    err = 0.0
    for (n, _), got in zip(reqs, results):
        _check(got.shape == (n,) and bool(np.isfinite(got).all()),
               "bad result shape or non-finite prediction")
        match = [np.allclose(got, w[off:off + n], rtol=RTOL, atol=atol)
                 for w in want]
        _check(any(match), "request matches neither generation")
        by_gen[0 if match[0] else 1] += 1
        err = max(err, min(float(np.abs(got - w[off:off + n]).max())
                           for w in want))
        off += n
    c = snap["counters"]
    _check(c.get("serve.requests_total") == len(reqs),
           "requests_total != requests submitted")
    _check(c.get("serve.rows_total") == float(sum(sizes)),
           "rows scored != rows submitted (a request answered twice or never)")
    _check(c.get("serve.batch_failures_total", 0) == 0, "a batch failed")
    _check(by_gen[0] > 0 and by_gen[1] > 0, f"swap not observed: {by_gen}")
    _check(kernel is None or launches > 0,
           f"serving never ran {kernel} in the profile: {symbols}")
    hist = snap["histograms"]["serve/request_ms"]
    return {"requests": len(reqs), "rows": int(sum(sizes)),
            "batches": c.get("serve.batches_total"), "wall_s": wall,
            "request_ms_p50": hist["p50"], "request_ms_p99": hist["p99"],
            "batch_ms_p50": snap["histograms"]["serve/batch_ms"]["p50"],
            "answers_by_generation": by_gen, "launches": launches,
            "kernel_runs_by_engine": {k: runs.get(k, 0) - runs0.get(k, 0)
                                      for k in runs},
            "warmup": warm, "swap_h2d_s": gen1.h2d_s,
            "swap_capture_s": gen1.capture_s, "max_abs_err": err}


def serve_phase(dev, report):
    spec, params = _config3_model(dev, seed=5)
    params1 = {"w0": params["w0"] + 0.5, "vw": params["vw"]}
    out = _serve(dev, spec, params, params1, F, BUCKET, 400,
                 "fm_fused_scores")
    print("serve", json.dumps(out), flush=True)
    report["serve"] = out
    return out["launches"]


def cli_phase(dev, report):
    import numpy as np

    from fm_spark_tpu_torch import data, models

    bucket = 1 << 14
    spec, params = _config3_model(dev, seed=9, bucket=bucket)
    model_dir = os.path.join(HERE, "build", "chip_smoke", "model")
    out_path = os.path.join(HERE, "build", "chip_smoke", "preds.txt")
    models.save_model(model_dir, spec, params)
    proc = subprocess.run(
        [sys.executable, "-m", "fm_spark_tpu_torch", "predict",
         "--model", model_dir, "--synthetic", "4096", "--batch-size", "512",
         "--out", out_path],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    _check(proc.returncode == 0, f"cli predict exited {proc.returncode}:\n"
           f"{proc.stderr[-4000:]}")
    summary = json.loads(proc.stderr.strip().splitlines()[-1])
    got = np.loadtxt(out_path)
    ids, vals, _ = data.synthetic_ctr(4096, spec.num_features, F, seed=1)
    ids = data.field_local(ids, bucket)
    want = _plain_predict(spec, params, ids, vals, dev).numpy()
    _check(got.shape == (4096,), f"cli wrote {got.shape} lines, want 4096")
    # %.6g output: 6 significant digits.
    _check(np.allclose(got, want, rtol=1e-5, atol=1e-6),
           f"cli predictions disagree: max err {np.abs(got - want).max()}")
    # The engine's graphs replay the kernel past its wrapper's count.
    _check(summary["kernel_runs_in_replays"].get("fm_fused_scores", 0) > 0,
           f"cli predict never ran the kernel: {summary}")
    out = {"lines": int(got.shape[0]),
           "max_abs_err": float(np.abs(got - want).max()),
           "cli": summary}

    # train on a config-3 copy of 16,384 buckets per field, then eval.
    train_dir = os.path.join(HERE, "build", "chip_smoke", "trained")
    proc = subprocess.run(
        [sys.executable, "-m", "fm_spark_tpu_torch", "train",
         "--config", "criteo1tb_fm_r64", "--bucket", str(bucket),
         "--synthetic", "20000", "--steps", "3", "--batch-size", "4096",
         "--param-dtype", "bfloat16", "--compute-dtype", "bfloat16",
         "--sparse-update", "dedup_sr", "--host-dedup", "--compact-cap",
         "4096", "--fused-embed", "require", "--model-out", train_dir],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    _check(proc.returncode == 0, f"cli train exited {proc.returncode}:\n"
           f"{proc.stderr[-4000:]}")
    lines = [json.loads(x) for x in proc.stdout.splitlines()]
    losses = [x["loss"] for x in lines if "loss" in x]
    _check(len(losses) == 3 and all(np.isfinite(losses)),
           f"cli train loss lines: {losses}")
    evals = [x["eval"] for x in lines if "eval" in x]
    _check(len(evals) == 1 and np.isfinite(evals[0]["logloss"]),
           f"cli train eval line: {evals}")
    train_launches = json.loads(proc.stderr.strip().splitlines()[-1])
    # The captured step: the warm-up step before the capture launches the
    # kernel; the capture records it and the replays run it uncounted.
    _check(train_launches["kernel_launches"]["fm_bwd_segment_totals"] == 1,
           f"cli train did not run the fused backward: {train_launches}")
    proc = subprocess.run(
        [sys.executable, "-m", "fm_spark_tpu_torch", "eval", "--model",
         train_dir, "--synthetic", "4096", "--batch-size", "1024"],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    _check(proc.returncode == 0, f"cli eval exited {proc.returncode}:\n"
           f"{proc.stderr[-4000:]}")
    metrics = json.loads(proc.stdout.strip().splitlines()[-1])
    _check(metrics["count"] == 4096.0 and np.isfinite(metrics["logloss"])
           and 0.0 <= metrics["auc"] <= 1.0, f"cli eval: {metrics}")
    out.update(train_loss=losses, train_eval=evals[0],
               train_launches=train_launches["kernel_launches"],
               eval=metrics)
    out["use_pallas"] = _pallas_cli(bucket)
    out["ffm"] = _ffm_cli(dev)
    print("cli", json.dumps(out), flush=True)
    report["cli"] = out


def _pallas_cli(bucket: int):
    """``train --use-pallas`` on a config-3 copy of ``bucket`` buckets per
    field (fp32, scatter_add, 3 steps): both row kernels F times a step."""
    import numpy as np

    proc = subprocess.run(
        [sys.executable, "-m", "fm_spark_tpu_torch", "train",
         "--config", "criteo1tb_fm_r64", "--bucket", str(bucket),
         "--synthetic", "20000", "--steps", "3", "--batch-size", "4096",
         "--use-pallas"],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    _check(proc.returncode == 0, f"cli train --use-pallas exited "
           f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    lines = [json.loads(x) for x in proc.stdout.splitlines()]
    losses = [x["loss"] for x in lines if "loss" in x]
    _check(len(losses) == 3 and all(np.isfinite(losses)),
           f"cli train --use-pallas loss lines: {losses}")
    k = json.loads(proc.stderr.strip().splitlines()[-1])["kernel_launches"]
    # F each in the warm-up step (the replays run them uncounted).
    _check(k["gather_rows"] == F and k["update_rows_add"] == F,
           f"cli train --use-pallas did not run the row kernels: {k}")
    return {"train_loss": losses, "train_launches": k}


def _ffm_cli(dev):
    """``train`` on a config-4 copy of 4,096 buckets per field through both
    FFM kernels (bf16 compute, 3 steps), then ``eval`` and ``predict`` of
    the model it wrote, predictions checked against the plain version."""
    import numpy as np

    from fm_spark_tpu_torch import data, models

    base = os.path.join(HERE, "build", "chip_smoke")
    model_dir = os.path.join(base, "ffm_trained")
    out_path = os.path.join(base, "ffm_preds.txt")

    def run(*args):
        proc = subprocess.run(
            [sys.executable, "-m", "fm_spark_tpu_torch", *args], cwd=HERE,
            capture_output=True, text=True, timeout=600)
        _check(proc.returncode == 0, f"cli {args[0]} (ffm) exited "
               f"{proc.returncode}:\n{proc.stderr[-4000:]}")
        return proc, json.loads(proc.stderr.strip().splitlines()[-1])

    proc, launched = run(
        "train", "--config", "avazu_ffm_r16", "--bucket", "4096",
        "--synthetic", "20000", "--steps", "3", "--batch-size", "4096",
        "--compute-dtype", "bfloat16", "--sel-blocked", "--fused-embed",
        "require", "--model-out", model_dir)
    lines = [json.loads(x) for x in proc.stdout.splitlines()]
    losses = [x["loss"] for x in lines if "loss" in x]
    evals = [x["eval"] for x in lines if "eval" in x]
    _check(len(losses) == 3 and all(np.isfinite(losses)),
           f"cli train (ffm) loss lines: {losses}")
    _check(len(evals) == 1 and np.isfinite(evals[0]["logloss"]),
           f"cli train (ffm) eval line: {evals}")
    k = launched["kernel_launches"]
    # The warm-up step's launches, and the held-out eval's forward.
    _check(k["ffm_sel_bwd"] == 1 and k["ffm_sel_scores"] > 1,
           f"cli train (ffm) did not run both FFM kernels: {k}")
    proc, eval_launched = run("eval", "--model", model_dir, "--synthetic",
                              "4096", "--batch-size", "1024")
    metrics = json.loads(proc.stdout.strip().splitlines()[-1])
    _check(metrics["count"] == 4096.0 and np.isfinite(metrics["logloss"])
           and eval_launched["kernel_launches"]["ffm_sel_scores"] == 4,
           f"cli eval (ffm): {metrics} {eval_launched}")
    _, pred_launched = run("predict", "--model", model_dir, "--synthetic",
                           "1024", "--batch-size", "512", "--out", out_path)
    got = np.loadtxt(out_path)
    spec, params = models.load_model(model_dir, device=dev)
    ids, vals, _ = data.synthetic_ctr(1024, spec.num_features,
                                      spec.num_fields, seed=1)
    ids = data.field_local(ids, spec.bucket)
    want = _plain_predict(spec, params, ids, vals, dev).numpy()
    # %.6g output of bf16 predictions: 6 significant digits.
    _check(got.shape == (1024,) and np.allclose(got, want, rtol=1e-5,
                                                atol=1e-6),
           f"cli predict (ffm) disagrees: max err {np.abs(got - want).max()}")
    # The engine's graphs replay the kernel past its wrapper's count.
    _check(pred_launched["kernel_runs_in_replays"].get("ffm_sel_scores", 0)
           > 0, f"cli predict (ffm) never ran the kernel: {pred_launched}")
    return {"train_loss": losses, "train_eval": evals[0],
            "train_launches": k, "eval": metrics,
            "eval_launches": eval_launched["kernel_launches"],
            "predict_lines": int(got.shape[0]),
            "predict_max_abs_err": float(np.abs(got - want).max()),
            "predict_launches": pred_launched["kernel_launches"],
            "predict_runs_in_replays": pred_launched["kernel_runs_in_replays"]}


class BenchStream:
    """bench.py's batch as a stream: each batch draws ids
    ``zipf(1.3) % bucket`` ([B, fields], so the first batch's ids are the
    bench batch's), then its labels, from one ``default_rng(seed)``;
    vals and weights are all 1. Labels are Bernoulli(0.25) rather than
    the bench's fair coin, so a model has a bias to learn in a few
    steps. Config 3's shape by default.

    Every stream of one ``(seed, batch, fields, bucket)`` yields the same
    batches, so each is drawn once per run and handed out as a copy (a
    draw at config 3's shape takes about a second on the host, and the
    phases draw the same seeds again and again)."""

    _draws: dict = {}                     # key → {"rng", "batches"}
    _draws_lock = threading.Lock()

    def __init__(self, seed: int = 0, batch: int = TRAIN_B, fields: int = F,
                 bucket: int = BUCKET):
        self._key = (seed, batch, fields, bucket)
        self._b = batch
        self._f, self._bucket = fields, bucket
        self._drawn = 0

    def state(self) -> dict:
        return {"batches": self._drawn}

    def next_batch(self):
        import numpy as np

        with BenchStream._draws_lock:
            rec = BenchStream._draws.setdefault(self._key, {
                "rng": np.random.default_rng(self._key[0]), "batches": []})
            while len(rec["batches"]) <= self._drawn:
                ids = (rec["rng"].zipf(1.3, size=(self._b, self._f))
                       % self._bucket).astype(np.int32)
                labels = (rec["rng"].random(self._b) < 0.25).astype(
                    np.float32)
                rec["batches"].append((ids, labels))
            ids, labels = rec["batches"][self._drawn]
        self._drawn += 1
        return (ids.copy(), np.ones((self._b, self._f), np.float32),
                labels.copy(), np.ones(self._b, np.float32))


def _bound_ms(nbytes: float, flops: float = 0.0):
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def _kernel_a_row(dev, case, delta, seg, cap, order32, zero_tail):
    """Kernel A (``segment_totals``) against its plain version on one
    field's deltas ``[B, w]`` read through the sort order ``order32`` at
    the sorted ranks ``seg``: a bitwise repeat, kernel and plain version
    each within 1e-5 of each segment's sum of |x| of the float64 sums;
    device, call, plain and ``index_add`` times and the bound."""
    import torch

    from fm_spark_tpu_torch.ops import segsum

    b, w = delta.shape
    segs = int(seg[-1]) + 1
    rows = cap if zero_tail else min(cap, segs)

    def call(r):
        return segsum.segment_totals(delta, seg, cap, order=order32,
                                     zero_tail=zero_tail)

    got = call(0)
    again = call(1)
    torch.cuda.synchronize()
    plain = segsum.segment_totals_plain(delta, seg, cap, order32)
    exact = segsum.segment_totals_plain(delta.double(), seg, cap, order32)
    bound = 1e-5 * segsum.segment_totals_plain(delta.abs().double(), seg,
                                               cap, order32)
    _check(torch.equal(got[:rows], again[:rows]),
           f"segment_totals {case}: a repeat differs")
    # Each within 1e-5 of its segment's sum of |x| from the exact
    # total: fp32 sums in another order on each side.
    _check(bool(((got[:rows].double() - exact[:rows]).abs()
                 <= bound[:rows]).all())
           and bool(((plain.double() - exact).abs() <= bound).all()),
           f"segment_totals {case}: kernel or plain version off the "
           "exact sums")
    # One PyTorch call of the same function: index_add of each
    # original lane's delta at its segment.
    lane_seg = torch.empty_like(seg)
    lane_seg[order32.long()] = seg
    idx = torch.where(lane_seg < cap, lane_seg, cap).long()
    base = torch.zeros(cap + 1, w, device=dev)
    nbytes = b * w * 4 + 8 * b + rows * w * 4
    bms, bby = _bound_ms(nbytes, b * w)
    row = {
        "case": case, "field": 0, "width": w, "cap": cap, "B": b,
        "segments": segs, "rows_written": rows,
        "head_run": int(torch.bincount(seg).max()),
        "max_abs_err": float((got[:rows] - plain[:rows]).abs().max()),
        "max_rel_err": _rel_err(got[:rows], plain[:rows]),
        "max_abs_err_vs_exact": float(
            (got[:rows].double() - exact[:rows]).abs().max()),
        "bitwise_repeat": True,
        "ms": _median_ms(call, hide_host_ms=2.0),
        "call_ms": _median_ms(call),
        "plain_ms": _median_ms(
            lambda r: segsum.segment_totals_plain(delta, seg, cap,
                                                  order32),
            hide_host_ms=5.0),
        "library_ms": _median_ms(lambda r: base.index_add(0, idx, delta),
                                 hide_host_ms=2.0),
        "library": "torch.index_add",
        "bound_ms": bms, "bound_by": bby, "bytes": nbytes,
    }
    row["pct_of_bound_rate"] = 100.0 * bms / row["ms"]
    print("segment_totals", json.dumps(row), flush=True)
    del got, again, plain, exact, bound, base, idx, lane_seg
    torch.cuda.empty_cache()
    return row


def training_kernels_phase(dev, report):
    """Kernels A and B against their plain versions at full width."""
    import numpy as np
    import torch

    from fm_spark_tpu_torch.ops import fused_bwd, scatter, segsum

    ids = BenchStream(0).next_batch()[0]
    t0 = time.perf_counter()
    aux = scatter.compact_aux(ids, CAP)
    aux_ms = (time.perf_counter() - t0) * 1e3
    nseg = [int((u < BUCKET).sum()) for u in aux[0]]
    order, inv = (torch.from_numpy(a).to(dev) for a in (aux[3], aux[4]))
    g = torch.Generator(device=dev).manual_seed(11)
    out = {"aux_ms": aux_ms, "unique_ids_per_field_max": max(nseg),
           "unique_ids_per_field_min": min(nseg)}

    # Kernel A in the three forms the main paths call it, each on field 0
    # of a bench batch with deltas at the scale of -lr·g, read unsorted
    # through the sort order: the compact update's (cap 12,288, every row
    # written) and the device dedup's at config 3 and config 4 widths
    # (cap = B, rows past the last rank not written).
    a_rows = []
    ffm_ids = BenchStream(0, TRAIN_B, FFM_F, FFM_BUCKET).next_batch()[0]
    for case, w, cap in (("compact", WIDTH, CAP), ("dedup-fm", WIDTH, TRAIN_B),
                         ("dedup-ffm", FFM_F * FFM_RANK + 1, TRAIN_B)):
        if case == "compact":
            order32 = order[0].contiguous()
            seg = inv[0][order32.long()].contiguous()
            zero_tail = True
        else:
            col = torch.from_numpy(
                (ids if case == "dedup-fm" else ffm_ids)[:, 0].copy()).to(dev)
            o64, _, _, seg = scatter._sort_segments(col)
            order32 = o64.to(torch.int32)
            zero_tail = False
        delta = torch.randn(TRAIN_B, w, generator=g, device=dev) * 0.01
        a_rows.append(_kernel_a_row(dev, case, delta, seg, cap, order32,
                                    zero_tail))
    out["segment_totals"] = a_rows

    # Kernel B over all fields, as the step calls it.
    b_rows = []
    ones = torch.ones(TRAIN_B, F, device=dev)
    weights = torch.ones(TRAIN_B, device=dev)
    for store, cd in ((torch.float32, torch.float32),
                      (torch.bfloat16, torch.bfloat16)):
        urows = [(torch.randn(CAP, WIDTH, generator=g, device=dev) * 0.01)
                 .to(store) for _ in range(F)]
        s1 = torch.cat([torch.randn(TRAIN_B, RANK, generator=g, device=dev)
                        * 0.1, torch.ones(TRAIN_B, 1, device=dev)], 1).to(cd)
        ds = (torch.randn(TRAIN_B, generator=g, device=dev) * 1e-5).to(cd)
        args = (urows, s1, ds, ones, weights, order, inv, -0.05, (1e-6, 0.0))
        got = fused_bwd.fm_bwd_segment_totals(*args, cap=CAP)
        again = fused_bwd.fm_bwd_segment_totals(*args, cap=CAP)
        torch.cuda.synchronize()
        want = fused_bwd.fm_bwd_segment_totals_plain(*args, cap=CAP)
        name = f"store={str(store)[6:]} compute={str(cd)[6:]}"
        _check(torch.equal(got, again), f"fm_bwd {name}: a repeat differs")
        # The same roundings elementwise; the fp32 segment sums differ in
        # order (the plain version's index_add_ in atomic order, another
        # each run): kernel and plain version each within 1e-5 of the
        # segment's sum of |term| from the exact (float64) total.
        terms = fused_bwd.fm_bwd_sorted_deltas(*args, cap=CAP)
        exact = torch.stack([segsum.segment_totals_plain(d.double(), s, CAP)
                             for d, s in terms])
        bound = 1e-5 * torch.stack([
            segsum.segment_totals_plain(d.abs().double(), s, CAP)
            for d, s in terms])
        del terms
        _check(bool(((got.double() - exact).abs() <= bound).all())
               and bool(((want.double() - exact).abs() <= bound).all()),
               f"fm_bwd {name}: kernel or plain version off the exact sums")
        cdb, sb = s1.element_size(), urows[0].element_size()
        nbytes = (TRAIN_B * WIDTH * cdb + TRAIN_B * cdb + TRAIN_B * F * 4
                  + TRAIN_B * 4 + 2 * F * TRAIN_B * 4
                  + F * CAP * WIDTH * (sb + 4))
        # ~12 fp32 operations per element of each field's lane rows.
        bms, bby = _bound_ms(nbytes, 12.0 * F * TRAIN_B * WIDTH)
        row = {
            "store": str(store)[6:], "compute": str(cd)[6:],
            "max_abs_err": float((got - want).abs().max()),
            "max_rel_err": _rel_err(got, want),
            "max_abs_err_vs_exact": float((got.double() - exact).abs().max()),
            "bitwise_repeat": True,
            "ms": _median_ms(
                lambda r: fused_bwd.fm_bwd_segment_totals(*args, cap=CAP),
                hide_host_ms=2.0),
            "plain_ms": _median_ms(
                lambda r: fused_bwd.fm_bwd_segment_totals_plain(*args, cap=CAP),
                reps=5, hide_host_ms=40.0),
            "library_ms": None, "bound_ms": bms, "bound_by": bby,
            "bytes": nbytes,
        }
        print("fm_bwd_segment_totals", json.dumps(row), flush=True)
        b_rows.append(row)
        del urows, s1, ds, got, again, want, exact, bound
        torch.cuda.empty_cache()
    out["fm_bwd_segment_totals"] = b_rows

    # Kernel B on the device-built aux (compact_device) of the bench batch
    # at a cap below its fields' distinct counts ('drop'): the lanes with
    # inv >= cap read a zero row and write nothing.
    cap = DROP_CAP
    daux, nseg = scatter.device_compact_aux(torch.from_numpy(ids).to(dev),
                                            cap)
    past = int((nseg > cap).sum())
    _check(past > 0 and bool((daux[4] >= cap).any()),
           f"kernel B past the cap: no field has more than {cap} ids")
    urows = [(torch.randn(cap, WIDTH, generator=g, device=dev) * 0.01)
             .to(torch.bfloat16) for _ in range(F)]
    s1 = torch.cat([torch.randn(TRAIN_B, RANK, generator=g, device=dev) * 0.1,
                    torch.ones(TRAIN_B, 1, device=dev)], 1).to(torch.bfloat16)
    ds = (torch.randn(TRAIN_B, generator=g, device=dev) * 1e-5).to(
        torch.bfloat16)
    args = (urows, s1, ds, ones, weights, daux[3], daux[4], -0.05,
            (1e-6, 0.0))
    got = fused_bwd.fm_bwd_segment_totals(*args, cap=cap)
    again = fused_bwd.fm_bwd_segment_totals(*args, cap=cap)
    torch.cuda.synchronize()
    want = fused_bwd.fm_bwd_segment_totals_plain(*args, cap=cap)
    terms = fused_bwd.fm_bwd_sorted_deltas(*args, cap=cap)
    exact = torch.stack([segsum.segment_totals_plain(d.double(), s, cap)
                         for d, s in terms])
    bound = 1e-5 * torch.stack([
        segsum.segment_totals_plain(d.abs().double(), s, cap)
        for d, s in terms])
    del terms
    _check(torch.equal(got, again), "fm_bwd past the cap: a repeat differs")
    _check(bool(((got.double() - exact).abs() <= bound).all())
           and bool(((want.double() - exact).abs() <= bound).all()),
           "fm_bwd past the cap: kernel or plain version off the exact sums")
    out["fm_bwd_past_cap"] = {
        "store": "bfloat16", "compute": "bfloat16", "cap": cap,
        "fields_past_cap": past, "segments_max": int(nseg.max()),
        "lanes_past_cap": int((daux[4] >= cap).sum()),
        "max_abs_err": float((got - want).abs().max()),
        "max_abs_err_vs_exact": float((got.double() - exact).abs().max()),
        "bitwise_repeat": True}
    print("fm_bwd_past_cap", json.dumps(out["fm_bwd_past_cap"]), flush=True)
    del urows, s1, ds, got, again, want, exact, bound, daux
    torch.cuda.empty_cache()
    report["training_kernels"] = out
    return a_rows, b_rows


def sr_bits_phase(dev, report):
    """The SR bits kernel against its plain version (JAX's threefry
    schedule in int64 ops, here on the card) at the compact update's
    shape and config 4's row width; the step read from the device."""
    rows = [_sr_bits_row(dev, shape)
            for shape in ((CAP, WIDTH), (CAP, FFM_F * FFM_RANK + 1))]
    report["sr_bits"] = rows
    return rows


def _sr_bits_row(dev, shape):
    """The SR bits kernel against its plain version at ``shape``, bit for
    bit, with its times and bound."""
    import torch

    from fm_spark_tpu_torch.ops import srbits

    step = torch.full((), 5, dtype=torch.int32, device=dev)

    def call(r):
        return srbits.sr_bits(0x5EED, step, 7, shape, dev)

    got, again = call(0), call(1)
    plain = srbits.sr_bits_plain(0x5EED, step, 7, shape, dev)
    torch.cuda.synchronize()
    _check(torch.equal(got, again) and torch.equal(got, plain),
           f"sr_bits {shape}: kernel != plain version")
    n = got.numel()
    # The output written once; ~80 integer operations per element (20
    # threefry rounds of add, rotate and xor, and the key injections),
    # rated at the card's fp32 rate outside the tensor cores.
    bms, bby = _bound_ms(4.0 * n, 80.0 * n)
    row = {"shape": list(shape), "max_abs_err": 0, "bitwise": True,
           "ms": _median_ms(call, hide_host_ms=2.0),
           "call_ms": _median_ms(call),
           "plain_ms": _median_ms(
               lambda r: srbits.sr_bits_plain(0x5EED, step, 7, shape, dev),
               hide_host_ms=5.0),
           "library_ms": None, "bound_ms": bms, "bound_by": bby,
           "bytes": 4 * n}
    print("sr_bits", json.dumps(row), flush=True)
    return row


@contextlib.contextmanager
def _plain_versions():
    """Swap every kernel's wrapper for its plain version (the models and
    steps look them up at call time)."""
    from fm_spark_tpu_torch.ops import (ffm_sel, fused_bwd, fused_fwd, rows,
                                        segsum)

    swaps = [(fused_fwd, "fm_fused_scores"), (segsum, "segment_totals"),
             (fused_bwd, "fm_bwd_segment_totals"),
             (ffm_sel, "ffm_sel_scores"), (ffm_sel, "ffm_sel_bwd"),
             (rows, "gather_rows"), (rows, "update_rows_add")]
    saved = [getattr(m, n) for m, n in swaps]
    for m, n in swaps:
        setattr(m, n, getattr(m, n + "_plain"))
    try:
        yield
    finally:
        for (m, n), fn in zip(swaps, saved):
            setattr(m, n, fn)


def _union_ms(on_dev) -> float:
    """Milliseconds of the union of the device events' intervals (the
    device's busy time)."""
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted((e.time_range.start, e.time_range.end)
                         for e in on_dev):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy / 1e3


def train_phase(dev, report):
    """Both config-3 training legs through fit_field_sparse."""
    import numpy as np
    import torch

    from fm_spark_tpu_torch import models, sparse
    from fm_spark_tpu_torch.data import iterate_once
    from fm_spark_tpu_torch.ops import fused_bwd, scatter, segsum, srbits
    from fm_spark_tpu_torch.train import (TrainConfig, evaluate_params,
                                          fit_field_sparse)

    spec = models.FieldFMSpec(num_features=F * BUCKET, rank=RANK,
                              num_fields=F, bucket=BUCKET, init_std=0.01,
                              param_dtype="bfloat16", compute_dtype="bfloat16")
    legs = {"segtotal": dict(gfull_fused=True, segtotal_pallas=True),
            "fusedbwd": dict(fused_embed="require")}
    out, launches = {}, {}
    for leg, lever in legs.items():
        cfg = TrainConfig(num_steps=TRAIN_STEPS, batch_size=TRAIN_B,
                          learning_rate=0.05, lr_schedule="constant",
                          reg_factors=1e-6, sparse_update="dedup_sr",
                          host_dedup=True, compact_cap=CAP, **lever)
        params = spec.init(torch.Generator(device=dev).manual_seed(21), dev)
        stats = {}
        torch.cuda.synchronize()
        # Counts start at 0 just before the main path and are read just after.
        segsum.launches = fused_bwd.launches = srbits.launches = 0
        t0 = time.perf_counter()
        params = fit_field_sparse(spec, cfg, BenchStream(0), device=dev,
                                  stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        # The warm-up step's launches (the replays run uncounted).
        counts = {"segment_totals": segsum.launches,
                  "fm_bwd_segment_totals": fused_bwd.launches,
                  "sr_bits": srbits.launches}
        loss = stats["loss"]
        _check(all(np.isfinite(loss)), f"{leg}: non-finite loss {loss}")
        _check(loss[-1] < loss[0], f"{leg}: loss did not fall: {loss}")
        mine = "segment_totals" if leg == "segtotal" else "fm_bwd_segment_totals"
        _check(counts[mine] > 0 and counts["sr_bits"] > 0,
               f"{leg}: {mine} or sr_bits never launched: {counts}")
        launches[mine] = counts[mine]
        launches["sr_bits"] = launches.get("sr_bits", 0) + counts["sr_bits"]
        step_ms = statistics.median(stats["step_ms"][WARM_STEPS:])

        # One more step from the trained params, kernels vs plain versions.
        batch = BenchStream(1).next_batch()
        aux = tuple(torch.from_numpy(a).to(dev)
                    for a in scatter.compact_aux(batch[0], CAP))
        batch = [torch.from_numpy(a).to(dev) for a in batch]
        copy = {"w0": params["w0"].clone(),
                "vw": [t.clone() for t in params["vw"]]}
        before = segsum.launches + fused_bwd.launches
        _, lk = sparse.make_field_sparse_sgd_body(spec, cfg)(
            params, TRAIN_STEPS, *batch, aux)
        mid = segsum.launches + fused_bwd.launches
        with _plain_versions():
            _, lp = sparse.make_field_sparse_sgd_body(spec, cfg)(
                copy, TRAIN_STEPS, *batch, aux)
        torch.cuda.synchronize()
        _check(mid > before,
               f"{leg}: the kernel step launched no kernel")
        _check(segsum.launches + fused_bwd.launches == mid,
               f"{leg}: the plain step launched a kernel")
        diff = max(float((a.float() - b.float()).abs().max())
                   for a, b in zip(params["vw"], copy["vw"]))
        differ = sum(int((a != b).sum()) for a, b in zip(params["vw"],
                                                         copy["vw"]))
        # bf16 tolerances of the reference: the totals' fp32 order can
        # flip a stochastic rounding by one bf16 ulp.
        _check(abs(float(lk) - float(lp)) < 1e-3 and diff < 1e-2
               and abs(float(params["w0"]) - float(copy["w0"])) < 1e-2,
               f"{leg}: kernel step != plain step (max |dw| {diff})")
        del copy
        body = sparse.make_field_sparse_sgd_body(spec, cfg)
        prof = _profile_calls(
            lambda j: body(params, j, *batch, aux),
            range(TRAIN_STEPS + 1, TRAIN_STEPS + 4))
        metrics = evaluate_params(spec, params, iterate_once(
            *BenchStream(2).next_batch()[:3], 16384))
        _check(np.isfinite(metrics["logloss"]), f"{leg}: eval {metrics}")
        row = {
            "leg": f"bfloat16/dedup_sr/compact{CAP}/cd-bf16/"
                   + ("gfull/segtotal" if leg == "segtotal" else "fusedbwd"),
            "loss": loss, "step_ms": stats["step_ms"],
            "step_ms_median": step_ms,
            "samples_per_s": TRAIN_B / (step_ms * 1e-3),
            "host_aux_ms_median": statistics.median(stats["aux_ms"]),
            "wall_s": wall, "launches": counts,
            "vs_plain_max_abs_diff": diff, "vs_plain_elements_differing": differ,
            "vs_plain_loss_diff": abs(float(lk) - float(lp)),
            "eval": metrics, "profile": prof,
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        }
        print("train", json.dumps(row), flush=True)
        out[leg] = row
        del params
        torch.cuda.empty_cache()
    report["train"] = out
    return launches


def _ffm_bound(b: int, elem: int, bwd: bool):
    """Bound of one ffm_sel call on ``b`` rows: the slab read once (the
    backward also writes one), vals, and acc or dscores; 4 operations per
    slab value forward (sel, selT, their product, the add), 3 backward."""
    slab = b * FFM_F * FFM_F * FFM_RANK
    nbytes = (slab + b * FFM_F + b) * elem + (slab * elem if bwd else 0)
    return _bound_ms(nbytes, (3 if bwd else 4) * slab), nbytes


def ffm_kernel_phase(dev, report):
    """The FFM kernels against their plain versions at config 4's width."""
    import torch

    from fm_spark_tpu_torch.ops import ffm_sel

    fk = FFM_F * FFM_RANK
    g = torch.Generator(device=dev).manual_seed(13)
    table = [torch.randn(FFM_BUCKET, fk, generator=g, device=dev) * 0.1
             for _ in range(FFM_F)]
    ids_all = torch.from_numpy(BenchStream(0, FFM_BATCHES[-1], FFM_F,
                                           FFM_BUCKET).next_batch()[0]).to(dev)
    rows = []
    for b in FFM_BATCHES:
        ids = ids_all[:b].long()
        base = torch.stack([t[ids[:, f]] for f, t in enumerate(table)], dim=1)
        ds32 = torch.randn(b, generator=g, device=dev) * 1e-3
        for dtype in (torch.float32, torch.bfloat16):
            r = base.to(dtype)
            x = torch.ones(b, FFM_F, dtype=dtype, device=dev)
            ds = ds32.to(dtype)
            acc = ffm_sel.ffm_sel_scores(r, x)
            acc2 = ffm_sel.ffm_sel_scores(r, x)
            dvs = ffm_sel.ffm_sel_bwd(r, x, ds)
            dvs2 = ffm_sel.ffm_sel_bwd(r, x, ds)
            torch.cuda.synchronize()
            pacc = ffm_sel.ffm_sel_scores_plain(r, x)
            pdvs = ffm_sel.ffm_sel_bwd_plain(r, x, ds)
            name = f"ffm_sel {str(dtype)[6:]} B={b}"
            _check(bool(torch.isfinite(acc).all() and torch.isfinite(dvs).all()),
                   f"{name}: non-finite output")
            _check(torch.equal(acc, acc2) and torch.equal(dvs, dvs2),
                   f"{name}: a repeat differs")
            # The same roundings in the same order and fp32 sums in index
            # order on both sides: the kernels equal the plain versions
            # bit for bit.
            _check(torch.equal(acc, pacc) and torch.equal(dvs, pdvs),
                   f"{name}: kernel disagrees with plain version")
            elem = r.element_size()
            (fb, fby), fbytes = _ffm_bound(b, elem, bwd=False)
            (bb, bby), bbytes = _ffm_bound(b, elem, bwd=True)
            slow = 40.0 if b > 8192 else 10.0
            row = {
                "dtype": str(dtype)[6:], "B": b,
                "scores": {
                    "max_abs_err": float((acc.float() - pacc.float()).abs().max()),
                    "max_rel_err": _rel_err(acc.float(), pacc.float()),
                    "bitwise_repeat": True,
                    "ms": _median_ms(lambda i: ffm_sel.ffm_sel_scores(r, x),
                                     hide_host_ms=2.0),
                    "call_ms": _median_ms(lambda i: ffm_sel.ffm_sel_scores(r, x)),
                    "plain_ms": _median_ms(
                        lambda i: ffm_sel.ffm_sel_scores_plain(r, x), reps=5,
                        hide_host_ms=slow),
                    "library_ms": None, "bound_ms": fb, "bound_by": fby,
                    "bytes": fbytes},
                "bwd": {
                    "max_abs_err": float((dvs.float() - pdvs.float()).abs().max()),
                    "max_rel_err": _rel_err(dvs.float(), pdvs.float()),
                    "bitwise_repeat": True,
                    "ms": _median_ms(lambda i: ffm_sel.ffm_sel_bwd(r, x, ds),
                                     hide_host_ms=2.0),
                    "call_ms": _median_ms(lambda i: ffm_sel.ffm_sel_bwd(r, x, ds)),
                    "plain_ms": _median_ms(
                        lambda i: ffm_sel.ffm_sel_bwd_plain(r, x, ds), reps=5,
                        hide_host_ms=slow),
                    "library_ms": None, "bound_ms": bb, "bound_by": bby,
                    "bytes": bbytes},
            }
            for k in ("scores", "bwd"):
                row[k]["achieved_GBps"] = (row[k]["bytes"]
                                           / (row[k]["ms"] * 1e-3) / 1e9)
            print("ffm_kernels", json.dumps(row), flush=True)
            rows.append(row)
            del r, x, ds, acc, acc2, dvs, dvs2, pacc, pdvs
        del base
        torch.cuda.empty_cache()
    del table
    torch.cuda.empty_cache()
    report["ffm_kernels"] = rows
    return rows


def _config4_model(dev, seed: int, bucket: int = FFM_BUCKET):
    """A config-4 FieldFFM with random weights from ``seed``; the linear
    column and bias are filled too, as a trained model's would be."""
    import torch

    from fm_spark_tpu_torch import models

    spec = models.FieldFFMSpec(num_features=FFM_F * bucket, rank=FFM_RANK,
                               num_fields=FFM_F, bucket=bucket, init_std=0.1)
    g = torch.Generator(device=dev).manual_seed(seed)
    params = spec.init(g, device=dev)
    for t in params["vw"]:
        t[:, -1] = torch.randn(bucket, generator=g, device=dev) * 0.1
    params["w0"].fill_(0.05)
    return spec, params


def ffm_serve_phase(dev, report):
    spec, params = _config4_model(dev, seed=6)
    params1 = {"w0": params["w0"] + 0.5, "vw": params["vw"]}
    out = _serve(dev, spec, params, params1, FFM_F, FFM_BUCKET, 200,
                 "ffm_sel_scores")
    print("ffm_serve", json.dumps(out), flush=True)
    report["ffm_serve"] = out
    return out["launches"]


def ffm_train_phase(dev, report):
    """Config 4's selblk-pallas recipe through fit_field_sparse, in bf16
    and in fp32 compute."""
    import numpy as np
    import torch

    from fm_spark_tpu_torch import models, sparse
    from fm_spark_tpu_torch.ops import ffm_sel
    from fm_spark_tpu_torch.train import TrainConfig, fit_field_sparse

    out, launches = {}, {"ffm_sel_scores": 0, "ffm_sel_bwd": 0}
    cfg = TrainConfig(num_steps=TRAIN_STEPS, batch_size=TRAIN_B,
                      learning_rate=0.05, lr_schedule="constant",
                      reg_factors=1e-6, sparse_update="scatter_add",
                      sel_blocked=True, fused_embed="require")
    for cd in ("bfloat16", "float32"):
        leg = f"float32/scatter_add/cd-{'bf16' if cd == 'bfloat16' else 'fp32'}" \
              "/selblk-pallas"
        spec = models.FieldFFMSpec(num_features=FFM_F * FFM_BUCKET,
                                   rank=FFM_RANK, num_fields=FFM_F,
                                   bucket=FFM_BUCKET, init_std=0.01,
                                   compute_dtype=cd)
        stats = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        # Counts start at 0 just before the main path and are read just after.
        ffm_sel.scores_launches = ffm_sel.bwd_launches = 0
        t0 = time.perf_counter()
        params = fit_field_sparse(
            spec, cfg, BenchStream(0, TRAIN_B, FFM_F, FFM_BUCKET), device=dev,
            stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"ffm_sel_scores": ffm_sel.scores_launches,
                  "ffm_sel_bwd": ffm_sel.bwd_launches}
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        loss = stats["loss"]
        _check(all(np.isfinite(loss)), f"{leg}: non-finite loss {loss}")
        _check(loss[-1] < loss[0], f"{leg}: loss did not fall: {loss}")
        # One each in the warm-up step on clones of the params before the
        # capture; the replays run them uncounted (phase 13 counts them).
        _check(counts == {"ffm_sel_scores": 1, "ffm_sel_bwd": 1},
               f"{leg}: not one launch of each kernel per step: {counts}")
        for k in launches:
            launches[k] += counts[k]
        step_ms = statistics.median(stats["step_ms"][WARM_STEPS:])

        # One more step from the trained params, kernels vs plain versions.
        batch = [torch.from_numpy(a).to(dev) for a in
                 BenchStream(1, TRAIN_B, FFM_F, FFM_BUCKET).next_batch()]
        copy = {"w0": params["w0"].clone(),
                "vw": [t.clone() for t in params["vw"]]}
        step = sparse.make_field_ffm_sparse_sgd_body(spec, cfg)
        _, lk = step(params, TRAIN_STEPS, *batch)
        mid = ffm_sel.scores_launches + ffm_sel.bwd_launches
        with _plain_versions():
            _, lp = step(copy, TRAIN_STEPS, *batch)
        torch.cuda.synchronize()
        _check(ffm_sel.scores_launches + ffm_sel.bwd_launches == mid,
               f"{leg}: the plain step launched a kernel")
        # The kernels equal their plain versions bit for bit, so the loss
        # is the same; index_add_ on the card adds atomically in no fixed
        # order, so the tables agree within the reference's fp32
        # tolerance (tests/test_sel_blocked.py).
        diff = max(float((a - b).abs().max())
                   for a, b in zip(params["vw"], copy["vw"]))
        close = all(torch.allclose(a, b, rtol=2e-5, atol=2e-6)
                    for a, b in zip(params["vw"], copy["vw"]))
        _check(float(lk) == float(lp) and close
               and torch.allclose(params["w0"], copy["w0"], rtol=2e-5,
                                  atol=2e-6),
               f"{leg}: kernel step != plain step (max |dw| {diff}, loss "
               f"{float(lk)} vs {float(lp)})")
        del copy
        prof = _profile_calls(lambda j: step(params, j, *batch),
                              range(TRAIN_STEPS + 1, TRAIN_STEPS + 4))
        row = {
            "leg": leg, "loss": loss, "step_ms": stats["step_ms"],
            "step_ms_median": step_ms,
            "samples_per_s": TRAIN_B / (step_ms * 1e-3),
            "wall_s": wall, "launches": counts,
            "vs_plain_max_abs_diff": diff, "vs_plain_loss": [float(lk), float(lp)],
            "profile": prof, "peak_mem_gb": peak,
        }
        print("ffm_train", json.dumps(row), flush=True)
        out[leg] = row
        del params, batch
        torch.cuda.empty_cache()
    report["ffm_train"] = out
    return launches


def _same_bits(a, b) -> bool:
    """Bit-for-bit equality of two float tensors (-0.0 and 0.0 differ)."""
    import torch

    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.contiguous().view(view),
                                              b.contiguous().view(view))


def _host_cpu() -> str:
    """The host's CPU model and core count, for host-clock figures."""
    model = "unknown CPU"
    with contextlib.suppress(OSError):
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                    break
    return f"{model}, {os.cpu_count()} cores"


def _dedup_update_args(scatter, col, delta, bucket):
    """The update's operands as the device dedup hands them over
    (``scatter._pallas_dedup_add``: per-segment ids and totals, every lane
    valid, the segment count on the device), and the mask of the lanes it
    writes."""
    import torch

    d = scatter._dedup(col, delta)
    lanes = torch.arange(col.shape[0], device=col.device)
    writes = (lanes < d.count) & (d.useg >= 0) & (d.useg < bucket)
    return d.useg.to(torch.int32), d.totals, d.count, writes


def _row_kernel_case(dev, name, nf, bucket, w, dtype, batch, g, flush):
    """The row kernels against their plain versions on ``nf`` tables
    ``[bucket, w]`` of ``dtype`` and the bench batch's ids at ``batch``
    rows, every field bit for bit and a bitwise repeat (the update in the
    device dedup's count form); on the field with the most distinct ids,
    device, call, plain and library times and the byte bound."""
    import numpy as np
    import torch

    from fm_spark_tpu_torch.ops import rows, scatter

    ids = torch.from_numpy(BenchStream(0, batch, nf, bucket)
                           .next_batch()[0]).to(dev)
    cols = [ids[:, f].contiguous() for f in range(nf)]
    uniq = [int(torch.unique(c).numel()) for c in cols]
    tables = [(torch.randn(bucket, w, generator=g, device=dev) * 0.1)
              .to(dtype) for _ in range(nf)]
    for f in range(nf):
        got = rows.gather_rows(tables[f], cols[f])
        again = rows.gather_rows(tables[f], cols[f])
        torch.cuda.synchronize()
        _check(_same_bits(got, again), f"gather_rows {name} field {f}: "
               "a repeat differs")
        _check(_same_bits(got, rows.gather_rows_plain(tables[f], cols[f])),
               f"gather_rows {name} field {f}: kernel disagrees with "
               "plain version")
        delta = torch.randn(batch, w, generator=g, device=dev) * 0.01
        sid, summed, cnt, _ = _dedup_update_args(scatter, cols[f],
                                                 delta, bucket)
        t1, t2, t3 = (tables[f].clone() for _ in range(3))
        rows.update_rows_add(t1, sid, None, summed, count=cnt)
        rows.update_rows_add(t2, sid, None, summed, count=cnt)
        rows.update_rows_add_plain(t3, sid, None, summed, count=cnt)
        torch.cuda.synchronize()
        _check(_same_bits(t1, t2), f"update_rows_add {name} field {f}: "
               "a repeat differs")
        _check(_same_bits(t1, t3), f"update_rows_add {name} field {f}: "
               "kernel disagrees with plain version")
        _check(not _same_bits(t1, tables[f]),
               f"update_rows_add {name} field {f}: wrote nothing")
        del t1, t2, t3
    fmax = int(np.argmax(uniq))
    table, col = tables[fmax], cols[fmax]
    e = table.element_size()
    delta = torch.randn(batch, w, generator=g, device=dev) * 0.01
    sid, summed, cnt, vmask = _dedup_update_args(scatter, col, delta,
                                                 bucket)
    nvalid, segs = int(vmask.sum()), int(cnt)
    scratch = table.clone()

    def timed(fn, hide):
        return _median_ms(fn, hide_host_ms=hide, before=flush.zero_)

    gbytes = lambda u: u * w * e + batch * w * e + 4 * batch
    # The written rows and their deltas, and the ids of the lanes the
    # count covers (the dedup's: one per distinct id).
    ubytes = lambda v, lanes: v * (2 * w * e + 4 * w) + 4 * lanes
    col_l = col.long()
    idx_l = torch.where(vmask, sid, 0).long()
    masked = torch.where(vmask[:, None], summed, 0.0)
    gather = {
        "ms": timed(lambda r: rows.gather_rows(table, col), 1.0),
        "call_ms": _median_ms(lambda r: rows.gather_rows(table, col)),
        "plain_ms": timed(lambda r: rows.gather_rows_plain(table, col),
                          2.0),
        "library_ms": timed(lambda r: torch.index_select(table, 0, col_l),
                            1.0),
        "library": "torch.index_select",
        "bound_ms": gbytes(uniq[fmax]) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "bytes": gbytes(uniq[fmax]),
        "step_bound_ms": sum(gbytes(u) for u in uniq)
        / HBM_BYTES_PER_S * 1e3,
        "max_abs_err": 0.0, "bitwise": True,
    }
    update = {
        "ms": timed(lambda r: rows.update_rows_add(
            scratch, sid, None, summed, count=cnt), 1.0),
        "call_ms": _median_ms(lambda r: rows.update_rows_add(
            scratch, sid, None, summed, count=cnt)),
        "plain_ms": timed(lambda r: rows.update_rows_add_plain(
            scratch, sid, None, summed, count=cnt), 2.0),
        # One call computes it only for an fp32 table: index_add_ of a
        # bf16 table takes bf16 deltas, rounded before the add.
        "library_ms": (timed(lambda r: scratch.index_add_(0, idx_l,
                                                          masked), 1.0)
                       if dtype == torch.float32 else None),
        "library": ("index_add_ of the masked deltas"
                    if dtype == torch.float32 else "none"),
        "bound_ms": ubytes(nvalid, segs) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "bytes": ubytes(nvalid, segs),
        "step_bound_ms": sum(ubytes(u, u) for u in uniq)
        / HBM_BYTES_PER_S * 1e3,
        "max_abs_err": 0.0, "bitwise": True,
    }
    for k in (gather, update):
        k["achieved_GBps"] = k["bytes"] / (k["ms"] * 1e-3) / 1e9
    row = {"case": name, "fields": nf, "bucket": bucket, "width": w,
           "dtype": str(dtype)[6:], "B": batch, "field": fmax,
           "unique_max": uniq[fmax], "unique_sum": sum(uniq),
           "valid_lanes": nvalid, "gather": gather, "update": update}
    print("row_kernels", json.dumps(row), flush=True)
    del tables, scratch, delta, summed, masked
    torch.cuda.empty_cache()
    return row


def row_kernel_phase(dev, report):
    """The row kernels against their plain versions at full width, and the
    host aux builders, native against numpy."""
    import numpy as np
    import torch

    from fm_spark_tpu_torch.ops import scatter

    ffm_w = FFM_F * FFM_RANK + 1
    cases = (("config3-fp32", F, BUCKET, WIDTH, torch.float32),
             ("config3-bf16", F, BUCKET, WIDTH, torch.bfloat16),
             ("config4-fp32", FFM_F, FFM_BUCKET, ffm_w, torch.float32))
    g = torch.Generator(device=dev).manual_seed(17)
    # Written before every timed call: the 50 MB L2 holds no table rows,
    # as in the step, where 38 other fields' traffic passes between two
    # calls on one table.
    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)
    out = [_row_kernel_case(dev, name, nf, bucket, w, dtype, TRAIN_B, g,
                            flush)
           for name, nf, bucket, w, dtype in cases]
    del flush
    torch.cuda.empty_cache()

    # The host aux builders on the config-3 bench batch (host clock).
    ids = BenchStream(0).next_batch()[0]
    aux, got = {"host": _host_cpu()}, {}
    for label, fn in (("compact_native", lambda: scatter.compact_aux(ids, CAP)),
                      ("compact_numpy",
                       lambda: scatter.compact_aux_plain(ids, CAP)),
                      ("dedup_native", lambda: scatter.dedup_aux(ids)),
                      ("dedup_numpy", lambda: scatter.dedup_aux_plain(ids))):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            got[label] = fn()
            times.append((time.perf_counter() - t0) * 1e3)
        aux[label] = {"ms": times, "ms_median": statistics.median(times)}
    for kind in ("compact", "dedup"):
        _check(all(np.array_equal(a, b) for a, b in
                   zip(got[f"{kind}_native"], got[f"{kind}_numpy"])),
               f"native {kind}_aux != numpy {kind}_aux on the bench batch")
    print("host_aux", json.dumps(aux), flush=True)
    report["row_kernels"] = out
    report["host_aux"] = aux
    return out


def pallas_train_phase(dev, report):
    """Both use_pallas legs through fit_field_sparse at full width."""
    import numpy as np
    import torch

    from fm_spark_tpu_torch import models, sparse
    from fm_spark_tpu_torch.ops import ffm_sel, rows, segsum
    from fm_spark_tpu_torch.train import TrainConfig, fit_field_sparse

    common = dict(num_steps=TRAIN_STEPS, batch_size=TRAIN_B,
                  learning_rate=0.05, lr_schedule="constant",
                  reg_factors=1e-6, sparse_update="scatter_add",
                  use_pallas=True)
    legs = (
        ("fm-pallas", F, BUCKET,
         models.FieldFMSpec(num_features=F * BUCKET, rank=RANK, num_fields=F,
                            bucket=BUCKET, init_std=0.01),
         TrainConfig(**common)),
        ("ffm-selblk-pallas-rows", FFM_F, FFM_BUCKET,
         models.FieldFFMSpec(num_features=FFM_F * FFM_BUCKET, rank=FFM_RANK,
                             num_fields=FFM_F, bucket=FFM_BUCKET,
                             init_std=0.01, compute_dtype="bfloat16"),
         TrainConfig(**common, sel_blocked=True, fused_embed="require")),
    )
    names = ("gather_rows", "update_rows_add", "segment_totals",
             "ffm_sel_scores", "ffm_sel_bwd")

    def counts():
        return dict(zip(names, (rows.gather_launches, rows.update_launches,
                                segsum.launches, ffm_sel.scores_launches,
                                ffm_sel.bwd_launches)))

    out, launches = {}, dict.fromkeys(names, 0)
    for leg, nf, bucket, spec, cfg in legs:
        ffm = nf == FFM_F
        stats = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        # Counts start at 0 just before the main path and are read just after.
        rows.gather_launches = rows.update_launches = segsum.launches = 0
        ffm_sel.scores_launches = ffm_sel.bwd_launches = 0
        t0 = time.perf_counter()
        params = fit_field_sparse(spec, cfg, BenchStream(0, TRAIN_B, nf,
                                                         bucket),
                                  device=dev, stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counts()
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        loss = stats["loss"]
        _check(all(np.isfinite(loss)), f"{leg}: non-finite loss {loss}")
        _check(loss[-1] < loss[0], f"{leg}: loss did not fall: {loss}")
        # Per step, in the warm-up step on clones of the params before the
        # capture; the replays run them uncounted (phase 13 counts them).
        want = {"gather_rows": nf, "update_rows_add": nf,
                "segment_totals": nf, "ffm_sel_scores": int(ffm),
                "ffm_sel_bwd": int(ffm)}
        _check(got == want, f"{leg}: launches {got}, want {want}")
        for k in launches:
            launches[k] += got[k]
        step_ms = statistics.median(stats["step_ms"][WARM_STEPS:])

        # One more step from the trained params on two copies: the device
        # dedup sums through kernel A, so the two give the same bits.
        batch = [torch.from_numpy(a).to(dev) for a in
                 BenchStream(1, TRAIN_B, nf, bucket).next_batch()]
        step = (sparse.make_field_ffm_sparse_sgd_body if ffm
                else sparse.make_field_sparse_sgd_body)(spec, cfg)

        def copy_of(p):
            return {"w0": p["w0"].clone(), "vw": [t.clone() for t in p["vw"]]}

        twin, copy = copy_of(params), copy_of(params)
        _, lk = step(params, TRAIN_STEPS, *batch)
        _, lt = step(twin, TRAIN_STEPS, *batch)
        torch.cuda.synchronize()
        _check(float(lk) == float(lt)
               and _same_bits(params["w0"], twin["w0"])
               and all(_same_bits(a, b)
                       for a, b in zip(params["vw"], twin["vw"])),
               f"{leg}: a repeat of one step differs")
        del twin
        # Then the same step with the plain versions.
        mid = counts()
        with _plain_versions():
            _, lp = step(copy, TRAIN_STEPS, *batch)
        torch.cuda.synchronize()
        _check(counts() == mid, f"{leg}: the plain step launched a kernel")
        # The kernels equal their plain versions bit for bit, but for
        # kernel A's sums: its plain version is an index_add_ on the card,
        # in atomic order (another each run), so the tables agree within
        # the reference's fp32 tolerance (tests/test_sparse_pallas.py).
        diff = max(float((a - b).abs().max())
                   for a, b in zip(params["vw"], copy["vw"]))
        close = all(torch.allclose(a, b, rtol=1e-4, atol=1e-6)
                    for a, b in zip(params["vw"], copy["vw"]))
        _check(float(lk) == float(lp) and close
               and torch.allclose(params["w0"], copy["w0"], rtol=1e-4,
                                  atol=1e-6),
               f"{leg}: kernel step != plain step (max |dw| {diff}, loss "
               f"{float(lk)} vs {float(lp)})")
        del copy
        prof = _profile_calls(lambda j: step(params, j, *batch),
                              range(TRAIN_STEPS + 1, TRAIN_STEPS + 4))
        # The dedup sums through kernel A: no index_add_ is left in the
        # step, on the host or on the card.
        _check(not prof["index_add_events"],
               f"{leg}: index_add in the step: {prof['index_add_events']}")
        row = {
            "leg": leg, "loss": loss, "step_ms": stats["step_ms"],
            "step_ms_median": step_ms,
            "samples_per_s": TRAIN_B / (step_ms * 1e-3),
            "wall_s": wall, "launches": got,
            "vs_plain_max_abs_diff": diff,
            "vs_plain_loss": [float(lk), float(lp)],
            "profile": prof, "peak_mem_gb": peak,
        }
        print("pallas_train", json.dumps(row), flush=True)
        out[leg] = row
        del params, batch, step
        torch.cuda.empty_cache()
    report["pallas_train"] = out
    return launches


#: Host calls that put work on the card: kernel launches (by the runtime
#: or the CUDA driver API), graph launches, and async copies and sets.
_KERNEL_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                    "cuLaunchKernel", "cuLaunchKernelEx")
_HOST_LAUNCHES = _KERNEL_LAUNCHES + ("cudaGraphLaunch", "cudaMemcpyAsync",
                                     "cudaMemsetAsync")


#: Each kernel wrapper's one kernel symbol that runs once per launch of
#: the wrapper (the other kernels of a wrapper, such as kernel A's fold or
#: kernel B's transpose and carry passes, are not counted).
KERNEL_SYMBOLS = {
    "fm_fused_scores": ("fm_fused_fwd_kernel", "fm_fused_fwd_warp_kernel"),
    "segment_totals": ("first_pass",),
    "fm_bwd_segment_totals": ("bwd_first_pass",),
    "ffm_sel_scores": ("ffm_fwd_kernel",),
    "ffm_sel_bwd": ("ffm_bwd_kernel",),
    "gather_rows": ("gather_elems",),
    "update_rows_add": ("update_elems",),
    "sr_bits": ("sr_bits_kernel",),
}


def _symbol_counts(on_dev):
    """Device kernel events by wrapper, from their kernel symbols, whether
    the trace names a kernel demangled or mangled (``first_pass`` is also
    a part of ``bwd_first_pass``: the longest symbol found wins); and the
    names seen for each wrapper."""
    counts = dict.fromkeys(KERNEL_SYMBOLS, 0)
    names = {k: set() for k in KERNEL_SYMBOLS}
    for e in on_dev:
        found = [(len(sym), k) for k, syms in KERNEL_SYMBOLS.items()
                 for sym in syms if sym in e.name]
        if found:
            k = max(found)[1]
            counts[k] += 1
            names[k].add(e.name[:100])
    return counts, {k: sorted(v) for k, v in names.items() if v}


def _profile_calls(call, steps) -> dict:
    """``call(step)`` for each step under torch.profiler: the wall time per
    step, the device's busy time per step (the union of its kernel and
    copy intervals) and its idle share, kernel launches and all host
    launches per step (graph launches and async copies too), the kernels
    that take the most device time, each port kernel's device events per
    step by symbol (:data:`KERNEL_SYMBOLS`; a graph's replays included),
    and any ``index_add`` on the host or the card. Device figures read
    "not measured" when the profiler records no device activity.

    The card's tracing may miss the first device work after it starts, so
    the profile opens with a warm-up cycle (tracing on, its events
    dropped: marker kernels and pauses) and reads only the steps' cycle;
    range annotations are not device work."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(3):
            torch.cuda._sleep(2_000_000)
            torch.cuda.synchronize()
            time.sleep(0.02)
        prof.step()
        t0 = time.perf_counter()
        for j in steps:
            call(j)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / len(steps)
        prof.step()
    events = prof.events()
    n = len(steps)
    # index_add by name: the ATen op on the host and its kernels
    # (indexFuncSmallIndex / indexFuncLargeIndex) on the device.
    index_add = sorted({e.name[:80] for e in events
                        if e.name.startswith("aten::index_add")
                        or "indexFunc" in e.name or "index_add" in e.name})
    out = {"wall_ms_per_step": wall_ms,
           "launches_per_step": sum(e.name in _KERNEL_LAUNCHES
                                    for e in events) / n,
           "host_launches_per_step": sum(e.name in _HOST_LAUNCHES
                                         for e in events) / n,
           "graph_launches_per_step": sum(e.name == "cudaGraphLaunch"
                                          for e in events) / n,
           "index_add_events": index_add}
    on_dev = [e for e in events if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and not e.name.startswith("ProfilerStep")]
    if not on_dev:
        return {**out, "device_ms_per_step": "not measured",
                "idle_share": "not measured"}
    by_name = collections.Counter()
    for e in on_dev:
        by_name[e.name[:80]] += e.time_range.elapsed_us()
    device_ms = _union_ms(on_dev) / n
    runs, run_names = _symbol_counts(on_dev)
    return {**out, "device_ms_per_step": device_ms,
            "idle_share": max(0.0, 1.0 - device_ms / wall_ms),
            "device_ops_per_step": len(on_dev) / n,
            "kernel_runs_per_step": {k: v / n for k, v in runs.items()},
            "kernel_names": run_names,
            "top_kernels_ms_per_step": [[k, v / 1e3 / n] for k, v in
                                        by_name.most_common(8)]}


def _same_tree(a, b) -> bool:
    """Every leaf of two trees (params, optimizer state) the same bits."""
    from fm_spark_tpu_torch.models.io import flatten

    fa, fb = flatten(a), flatten(b)
    return sorted(fa) == sorted(fb) and all(_same_bits(fa[k], fb[k])
                                            for k in fa)


def _blocked_sums_ab(dev, report):
    """The compact update's blocked-prefix segment sums on one field of the
    bench batch (B = 131,072, cap 12,288, w = 65, fp32), in three forms:
    the parent tree's two ``torch.cumsum`` calls, the XLA-order prefix by
    one add per element of a run (the form first written for the CPU's
    bit parity) and the package's (a ``cumsum`` per run level on the
    card). The last two must give the same bits, and those of the CPU;
    device-busy ms and device ops per call from the profiler."""
    import torch

    from fm_spark_tpu_torch.ops import scatter

    ids = BenchStream(0).next_batch()[0]
    caux = scatter.compact_aux(ids[:, :1], CAP)
    start, end = (torch.from_numpy(a[0]).to(dev) for a in caux[1:3])
    g = torch.Generator(device=dev).manual_seed(3)
    sdelta = torch.randn(TRAIN_B, WIDTH, generator=g, device=dev) * 1e-3
    blk = 512

    def parent(x, dim):
        return torch.cumsum(x, dim)

    def adds(x, dim):
        x = x.movedim(dim, 0)
        n = x.shape[0]
        if n <= 16:
            parts = list(x.unbind(0))
            for j in range(1, n):
                parts[j] = parts[j - 1] + parts[j]
            return torch.stack(parts, 0).movedim(0, dim)
        pad = (-n) % 16
        if pad:
            x = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))], 0)
        runs = adds(x.reshape(-1, 16, *x.shape[1:]), 1)
        off = adds(runs[:, -1], 0)
        off = torch.cat([torch.zeros_like(off[:1]), off[:-1]], 0)
        return (runs + off[:, None]).reshape(-1, *x.shape[1:])[:n].movedim(
            0, dim)

    def sums(prefix):
        bl = prefix(sdelta.reshape(-1, blk, WIDTH), 1)
        off = prefix(bl[:, -1, :], 0)
        off = torch.cat([torch.zeros_like(off[:1]), off[:-1]], 0)
        at = lambda p: bl[p // blk, p % blk] + off[p // blk]
        s, e = start.long(), end.long()
        return at(e) - at(s) + sdelta[s]

    forms = {"parent_cumsum": lambda: sums(parent),
             "per_element_adds": lambda: sums(adds),
             "run_cumsum": lambda: scatter._blocked_segment_sums(
                 sdelta, start, end)}
    got = {k: f() for k, f in forms.items()}
    cpu = scatter._blocked_segment_sums(sdelta.cpu(), start.cpu(), end.cpu())
    torch.cuda.synchronize()
    bits = lambda t: t.cpu().view(torch.int32)
    _check(torch.equal(bits(got["run_cumsum"]), bits(got["per_element_adds"]))
           and torch.equal(bits(got["run_cumsum"]), bits(cpu)),
           "blocked prefix: the card's run cumsum != the per-element adds")
    out = {"shape": f"one field, B={TRAIN_B}, cap={CAP}, w={WIDTH}, fp32",
           "bitwise_equal_adds_and_cpu": True}
    for k, f in forms.items():
        prof = _profile_calls(lambda j, f=f: f(), range(5))
        out[k] = {"device_ms": prof["device_ms_per_step"],
                  "device_ops": prof.get("device_ops_per_step"),
                  "launches": prof["launches_per_step"],
                  "max_abs_diff_vs_package": float(
                      (got[k] - got["run_cumsum"]).abs().max())}
    print("blocked_sums", json.dumps(out), flush=True)
    report["blocked_sums"] = out


def capture_phase(dev, report):
    """Phase 13: each training leg eagerly on one copy of the params and
    captured (one CUDA graph, replayed) on another, from the same seed and
    batches, the same bits after every step; then the roll of 4 over 7
    steps on one leg."""
    import numpy as np
    import torch

    from fm_spark_tpu_torch import models, sparse
    from fm_spark_tpu_torch.ops import kernel_launches
    from fm_spark_tpu_torch.ops import scatter
    from fm_spark_tpu_torch.train import TrainConfig

    fm_bf16 = models.FieldFMSpec(
        num_features=F * BUCKET, rank=RANK, num_fields=F, bucket=BUCKET,
        init_std=0.01, param_dtype="bfloat16", compute_dtype="bfloat16")
    fm_fp32 = models.FieldFMSpec(num_features=F * BUCKET, rank=RANK,
                                 num_fields=F, bucket=BUCKET, init_std=0.01)
    ffm = models.FieldFFMSpec(
        num_features=FFM_F * FFM_BUCKET, rank=FFM_RANK, num_fields=FFM_F,
        bucket=FFM_BUCKET, init_std=0.01, compute_dtype="bfloat16")
    # The inverse-sqrt schedule: the learning rate moves every step, read
    # by the graph from its step counter on the card.
    common = dict(batch_size=TRAIN_B, learning_rate=0.05, reg_factors=1e-6)
    sr = dict(common, sparse_update="dedup_sr")
    pallas = dict(common, sparse_update="scatter_add", use_pallas=True)
    legs = (
        # The plain compact form: the blocked prefix's segment sums in
        # PyTorch (no segtotal_pallas, no fused backward).
        ("compact", fm_bf16, TrainConfig(**sr, host_dedup=True,
                                         compact_cap=CAP), ("sr_bits",)),
        ("segtotal", fm_bf16, TrainConfig(**sr, host_dedup=True,
                                          compact_cap=CAP, gfull_fused=True,
                                          segtotal_pallas=True),
         ("segment_totals", "sr_bits")),
        ("fusedbwd", fm_bf16, TrainConfig(**sr, host_dedup=True,
                                          compact_cap=CAP,
                                          fused_embed="require"),
         ("fm_bwd_segment_totals", "sr_bits")),
        ("devaux", fm_bf16, TrainConfig(**sr, compact_device=True,
                                        compact_cap=CAP, gfull_fused=True,
                                        segtotal_pallas=True),
         ("segment_totals", "sr_bits")),
        ("fm-pallas", fm_fp32, TrainConfig(**pallas),
         ("gather_rows", "update_rows_add", "segment_totals")),
        ("ffm-selblk-pallas-rows", ffm,
         TrainConfig(**pallas, sel_blocked=True, fused_embed="require"),
         ("gather_rows", "update_rows_add", "segment_totals",
          "ffm_sel_scores", "ffm_sel_bwd")),
    )
    _blocked_sums_ab(dev, report)
    total = TRAIN_STEPS + PROFILED_STEPS
    out, launches = {}, {}
    for leg, spec, cfg, kernels in legs:
        ffm_leg = spec is ffm
        stream = (BenchStream(0, TRAIN_B, FFM_F, FFM_BUCKET) if ffm_leg
                  else BenchStream(0))
        batches = []
        for _ in range(total):
            ids, vals, labels, weights = stream.next_batch()
            aux = None
            if cfg.host_dedup:
                aux = tuple(torch.from_numpy(a).to(dev)
                            for a in scatter.compact_aux(ids, cfg.compact_cap))
            batches.append((*(torch.from_numpy(a).to(dev)
                              for a in (ids, vals, labels, weights)), aux))
        body = (sparse.make_field_ffm_sparse_sgd_body if ffm_leg
                else sparse.make_field_sparse_sgd_body)(spec, cfg)
        step = (sparse.make_field_ffm_sparse_sgd_step if ffm_leg
                else sparse.make_field_sparse_sgd_step)(spec, cfg)
        eager = spec.init(torch.Generator(device=dev).manual_seed(21), dev)
        graphed = {"w0": eager["w0"].clone(),
                   "vw": [t.clone() for t in eager["vw"]]}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        walls = {"eager": [], "captured": []}
        losses = []
        # The wrappers' counts of the eager steps, and of the captured
        # calls after the first (the replays: none may count).
        counted = {"eager": dict.fromkeys(kernel_launches(), 0),
                   "replays": dict.fromkeys(kernel_launches(), 0)}

        def run(mode, j):
            nonlocal eager, graphed
            before = kernel_launches()
            if mode == "eager":
                eager, loss = body(eager, j, *batches[j])
            else:
                graphed, loss = step(graphed, j, *batches[j])
            if j < TRAIN_STEPS and (mode == "eager" or j > 0):
                after = kernel_launches()
                into = counted["eager" if mode == "eager" else "replays"]
                for k in into:
                    into[k] += after[k] - before[k]
            return loss

        for j in range(TRAIN_STEPS):
            for mode in ("eager", "captured"):
                t0 = time.perf_counter()
                loss = run(mode, j)
                torch.cuda.synchronize()
                walls[mode].append((time.perf_counter() - t0) * 1e3)
                if mode == "eager":
                    le = loss
            _check(torch.equal(le.view(torch.int32), loss.view(torch.int32))
                   and _same_tree(eager, graphed),
                   f"{leg}: captured step {j} != eager step "
                   f"(loss {float(loss)} vs {float(le)})")
            losses.append(float(le))
        _check(all(np.isfinite(losses)), f"{leg}: non-finite loss {losses}")
        _check(len(step.captured.capture_s) == 1,
               f"{leg}: captured {len(step.captured.capture_s)} times")
        per_step = {k: v / TRAIN_STEPS for k, v in counted["eager"].items()}
        missing = [k for k in kernels if per_step[k] <= 0]
        _check(not missing, f"{leg}: never launched {missing}: {per_step}")
        _check(not any(counted["replays"].values()),
               f"{leg}: the replays counted launches {counted['replays']}")
        prof = {mode: _profile_calls(
            lambda j, mode=mode: run(mode, j), range(TRAIN_STEPS, total))
            for mode in ("eager", "captured")}
        torch.cuda.synchronize()
        _check(_same_tree(eager, graphed),
               f"{leg}: captured != eager after the profiled steps")
        # The replays' kernels, counted on the card by symbol: each of the
        # leg's kernels runs at least once per replayed step, and no port
        # kernel more often than the eager step launches it. The trace misses a
        # gather_rows record now and then, in eager profiles too (where
        # the wrapper's count is exact), so a count may fall short of the
        # launches; both are kept.
        replayed = prof["captured"].get("kernel_runs_per_step")
        _check(replayed is not None
               and all(replayed[k] >= 1 for k in kernels)
               and all(replayed[k] <= per_step[k] for k in per_step),
               f"{leg}: kernel runs per replay {replayed}, launches per "
               f"eager step {per_step}")
        row = {
            "leg": leg, "loss": losses,
            "capture_s": step.captured.capture_s[0],
            "wall_ms": walls,
            "wall_ms_median_steps_3_7": {
                m: statistics.median(w[WARM_STEPS:]) for m, w in walls.items()},
            "profile_steps_8_10": prof,
            # The wrappers' count per eager step, and the profiler's count
            # of each kernel's runs per replay.
            "launches_per_eager_step": {k: per_step[k] for k in kernels},
            "kernel_runs_per_replay": {k: replayed[k] for k in kernels},
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "bitwise_equal_every_step": True,
        }
        print("capture", json.dumps(row), flush=True)
        out[leg] = row
        for k in kernels:
            launches.setdefault(k, {})[leg] = replayed[k]

        if leg == "fusedbwd":
            # The roll: a graph of 4 steps and one of the tail of 3 against
            # 7 eager steps from fresh params.
            mstep = sparse.make_field_sparse_multistep(spec, cfg, 4)
            eager = spec.init(torch.Generator(device=dev).manual_seed(22),
                              dev)
            graphed = {"w0": eager["w0"].clone(),
                       "vw": [t.clone() for t in eager["vw"]]}
            le = []
            for j in range(TRAIN_STEPS):
                eager, loss = body(eager, j, *batches[j])
                le.append(loss)
            got = []
            for lo, hi in ((0, 4), (4, TRAIN_STEPS)):
                group = batches[lo:hi]
                stacked = [torch.stack(p) for p in zip(*[g[:4] for g in group])]
                aux = tuple(torch.stack(a) for a in zip(*[g[4] for g in group]))
                graphed, loss = mstep(graphed, lo, hi - lo, *stacked, aux)
                got.append(loss)
            torch.cuda.synchronize()
            _check(torch.equal(got[0], le[3]) and torch.equal(got[1], le[-1])
                   and _same_tree(eager, graphed),
                   "roll of 4 over 7 steps != 7 eager steps")
            out["roll"] = {"leg": leg, "n": 4, "steps": TRAIN_STEPS,
                           "graphs": len(mstep.captured.capture_s),
                           "capture_s": mstep.captured.capture_s,
                           "bitwise_equal": True}
            print("capture_roll", json.dumps(out["roll"]), flush=True)
            del mstep
        del eager, graphed, body, step, batches
        torch.cuda.empty_cache()
    report["capture"] = out
    return launches


INGEST_ROWS = 327680                     # phase 14: 262,144 train rows
INGEST_AVAZU_ROWS = 40000
INGEST_FFM_B = 8192


def _criteo_tsv(path: str, rows: int, seed: int) -> int:
    """A Criteo-shaped TSV written by whole columns: 40 tab-separated
    columns per line (a 0/1 label at P(1) = 0.25, 13 counts
    ``zipf(1.5) - 1`` in decimal, 26 tokens ``zipf(1.3)`` as 8 hex
    digits), each count or token missing (empty) at 5 %. Every line is
    laid out in a fixed-width byte matrix and the bytes of empty fields
    and leading zeros are masked out. Returns the file's size."""
    import numpy as np

    rng = np.random.default_rng(seed)
    label = rng.random(rows) < 0.25
    counts = np.minimum(rng.zipf(1.5, (rows, 13)) - 1, 10**9 - 1)
    tokens = (rng.zipf(1.3, (rows, 26)) % (1 << 32)).astype(np.uint64)
    missing = rng.random((rows, 39)) < 0.05
    width = 1 + 13 * 10 + 26 * 9 + 1
    mat = np.empty((rows, width), np.uint8)
    keep = np.ones((rows, width), bool)
    mat[:, 0] = np.where(label, ord("1"), ord("0"))
    col = 1
    tens = 10 ** np.arange(8, -1, -1, dtype=np.int64)        # 9 digits
    for f in range(13):
        mat[:, col] = ord("\t")
        digits = (counts[:, f:f + 1] // tens) % 10
        mat[:, col + 1:col + 10] = digits + ord("0")
        lead = np.cumsum(digits != 0, axis=1) > 0
        lead[:, -1] = True                                    # "0"
        keep[:, col + 1:col + 10] = lead & ~missing[:, f:f + 1]
        col += 10
    hexdigits = np.frombuffer(b"0123456789abcdef", np.uint8)
    shifts = np.arange(28, -1, -4, dtype=np.uint64)           # 8 nibbles
    for f in range(26):
        mat[:, col] = ord("\t")
        nibbles = (tokens[:, f:f + 1] >> shifts) & np.uint64(15)
        mat[:, col + 1:col + 9] = hexdigits[nibbles.astype(np.int64)]
        keep[:, col + 1:col + 9] = ~missing[:, 13 + f:14 + f]
        col += 9
    mat[:, col] = ord("\n")
    body = mat[keep].tobytes()
    with open(path, "wb") as f:
        f.write(body)
    return len(body)


def _cli(*argv):
    """``fmtorch`` run in this process (``cli.main``, the console
    script's entry point): its stdout's JSON lines and stderr's last
    JSON line. A failure raises."""
    import gc
    import io

    import torch

    from fm_spark_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main([str(a) for a in argv])
    _check(rc == 0, f"fmtorch {argv[0]} returned {rc}: {err.getvalue()[-4000:]}")
    gc.collect()
    torch.cuda.empty_cache()
    lines = [json.loads(x) for x in out.getvalue().splitlines()
             if x.startswith("{")]
    errs = [json.loads(x) for x in err.getvalue().splitlines()
            if x.startswith("{")]
    return lines, (errs[-1] if errs else None)


def _losses(lines) -> dict:
    return {x["step"]: x["loss"] for x in lines if "loss" in x}


def _one(lines, key):
    got = [x[key] for x in lines if key in x]
    _check(len(got) == 1, f"want one {key!r} line, got {got}")
    return got[0]


def _chain_step(ckdir: str, step: int) -> dict:
    """The arrays (bf16 as their uint16 bits) and manifest of one saved
    step of a checkpoint chain."""
    import numpy as np

    d = os.path.join(ckdir, str(step))
    with open(os.path.join(d, "state.json")) as f:
        state = json.load(f)
    with open(os.path.join(ckdir, "manifests", f"{step}.json")) as f:
        manifest = json.load(f)
    arrays = {k: np.load(os.path.join(d, v["file"]))
              for k, v in state["arrays"].items()}
    return {"arrays": arrays, "checksums": manifest["checksums"],
            "pipeline": state["pipeline"]}


def _same_chain_step(a: dict, b: dict) -> bool:
    import numpy as np

    return (a["checksums"] == b["checksums"] and a["pipeline"] == b["pipeline"]
            and sorted(a["arrays"]) == sorted(b["arrays"])
            and all(np.array_equal(a["arrays"][k], b["arrays"][k])
                    for k in a["arrays"]))


def _resume_leg(name, common, base, tag, steps, stop, models=False):
    """One leg of phase 14: ``train`` uninterrupted for ``steps`` into a
    chain; ``stop`` steps into a fresh chain; the same command at
    ``steps`` again, which resumes from ``stop``. The resumed run's loss
    lines and final saved step (arrays, crc32s and cursor) must equal the
    uninterrupted run's bit for bit, and its steps must run as replays of
    the graphs it captured after the restore (the equality is the witness
    that those graphs read the restored tensors; fit restores before its
    first call). With ``models`` both full runs write a
    model dir (``<tag>_full``, ``<tag>_resumed``) whose params.npz must be
    equal too."""
    import numpy as np

    chains = [os.path.join(base, f"{tag}{i}") for i in (1, 2)]
    outs = [os.path.join(base, f"{tag}_{k}") for k in ("full", "resumed")]

    def model_args(i):
        return ["--model-out", outs[i]] if models else []
    full, full_sum = _cli(*common, "--steps", steps, "--checkpoint-dir",
                          chains[0], *model_args(0))
    part, part_sum = _cli(*common, "--steps", stop, "--checkpoint-dir",
                          chains[1])
    rest, rest_sum = _cli(*common, "--steps", steps, "--checkpoint-dir",
                          chains[1], *model_args(1))
    lf, lp, lr = _losses(full), _losses(part), _losses(rest)
    _check(all(lp[k] == lf[k] for k in lp) and max(lp) == stop,
           f"{name}: the stopped run's losses {lp} != {lf}")
    _check(lr and all(lr[k] == lf[k] for k in lr) and min(lr) > stop
           and max(lr) == steps,
           f"{name}: the resumed run's losses {lr} != the uninterrupted {lf}")
    resumed = _one(rest, "resumed")
    _check(resumed["step"] == stop and len(rest_sum["capture_s"]) >= 1,
           f"{name}: resumed {resumed}, captured {rest_sum['capture_s']}")
    _check(_same_chain_step(_chain_step(chains[0], steps),
                            _chain_step(chains[1], steps)),
           f"{name}: the resumed run's step {steps} differs from the "
           "uninterrupted run's")
    for d in chains:
        shutil.rmtree(d)
    if models:
        with np.load(os.path.join(outs[0], "params.npz")) as a, \
                np.load(os.path.join(outs[1], "params.npz")) as b:
            _check(sorted(a.files) == sorted(b.files) and all(
                np.array_equal(a[k], b[k]) for k in a.files),
                f"{name}: the resumed params.npz differs from the "
                "uninterrupted run's")
        shutil.rmtree(outs[0])
    return {"losses": lf, "resumed_losses": lr, "resumed": resumed,
            # Wall-clock samples/s between loss lines (the logger's): at
            # a step whose previous step saved nothing, one step end to
            # end, host input included.
            "samples_per_s": {x["step"]: x.get("samples_per_sec")
                              for x in full if "loss" in x},
            "full": full_sum, "stopped": part_sum, "resumed_run": rest_sum,
            "full_eval": _one(full, "eval"), "resumed_eval": _one(rest, "eval"),
            "model": outs[1] if models else None}


def _leg_numbers(leg) -> dict:
    """The leg's host and device times: step and aux ms per batch (the
    uninterrupted run), save ms by part, restore ms."""
    full = leg["full"]
    saves = full["saves"]
    med = statistics.median
    return {
        "samples_per_s": leg["samples_per_s"],
        "step_ms_median": med(full["step_ms"][1:] or full["step_ms"]),
        "step_ms": full["step_ms"],
        "aux_ms_median": med(full["aux_ms"]) if full["aux_ms"] else None,
        "capture_s": full["capture_s"],
        "save_snapshot_ms": [x["snapshot_ms"] for x in saves],
        "save_crc_ms": med(x["crc_ms"] for x in saves),
        "save_write_ms": med(x["write_ms"] for x in saves),
        "save_bytes": saves[0]["bytes"],
        "restore_ms": leg["resumed"]["restore_ms"],
        "restore_read_ms": leg["resumed"]["read_ms"],
        "restore_verify_ms": leg["resumed"]["verify_ms"],
        "restore_bytes": leg["resumed"]["bytes"],
    }


def ingest_phase(dev, report):
    """Phase 14: real data and resumable training through ``fmtorch``."""
    import importlib
    import tempfile

    import numpy as np

    from fm_spark_tpu_torch import data, models, native
    from fm_spark_tpu_torch.data import avazu
    from fm_spark_tpu_torch.ops import KERNEL_COUNTERS, kernel_launches

    root = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(root, exist_ok=True)
    base = tempfile.mkdtemp(prefix="ingest.", dir=root)
    out = {"card": report["card"]}
    try:
        # The preprocessing library builds at first use: apart from the
        # parse's time.
        t0 = time.perf_counter()
        native.load_fast()
        out["native_build_s"] = time.perf_counter() - t0
        # Data: the Criteo TSV, preprocess at config 3's full bucket.
        tsv = os.path.join(base, "day.tsv")
        t0 = time.perf_counter()
        out["tsv_bytes"] = _criteo_tsv(tsv, INGEST_ROWS, seed=14)
        out["tsv_write_s"] = time.perf_counter() - t0
        packed = os.path.join(base, "criteo")
        lines, _ = _cli("preprocess", "--config", "criteo1tb_fm_r64",
                        "--input", tsv, "--out-dir", packed)
        pre = lines[-1]
        _check(pre["num_examples"] == INGEST_ROWS and pre["shuffled"],
               f"preprocess: {pre}")
        os.unlink(tsv)
        out["preprocess"] = {
            **pre, "parse_rows_per_s": INGEST_ROWS / pre["parse_s"],
            "rows_per_s": INGEST_ROWS / (pre["parse_s"] + pre["shuffle_s"])}
        lines, _ = _cli("cap-advise", "--data", packed, "--batch-size",
                        TRAIN_B, "--batches", 4)
        advice = lines[-1]
        _check(advice["max_unique_per_field_overall"] <= CAP,
               f"cap-advise: a batch holds more than {CAP} ids per field: "
               f"{advice['max_unique_per_field_overall']}")
        out["cap_advise"] = {k: advice[k] for k in (
            "max_unique_per_field_overall", "recommended_compact_cap")}
        ds = data.PackedDataset(packed)
        cut = int(len(ds) * (1.0 - 0.2))           # train's tail holdout
        rng = np.random.default_rng(0)
        times = []
        for _ in range(5):
            sel = rng.permutation(cut)[:TRAIN_B]
            t0 = time.perf_counter()
            ds.assemble(sel, bucket=BUCKET)
            times.append((time.perf_counter() - t0) * 1e3)
        out["assemble_ms_per_batch"] = statistics.median(times)
        holdout = os.path.join(base, "criteo_holdout")
        with data.PackedWriter(holdout, F, store_vals=False) as w:
            w.append(np.asarray(ds.ids[cut:]), np.asarray(ds.labels[cut:]))

        # Counts start at 0 just before the legs and are read just after.
        for _, mod, attr in KERNEL_COUNTERS:
            setattr(importlib.import_module(f"fm_spark_tpu_torch.ops.{mod}"),
                    attr, 0)
        config3 = ["train", "--config", "criteo1tb_fm_r64", "--data", packed,
                   "--batch-size", TRAIN_B, "--param-dtype", "bfloat16",
                   "--compute-dtype", "bfloat16", "--sparse-update",
                   "dedup_sr", "--host-dedup", "--compact-cap", CAP,
                   "--test-fraction", "0.2", "--checkpoint-every", 2,
                   "--checkpoint-keep", 2]
        # Leg A: the fused backward, 6 steps over two epoch boundaries.
        leg_a = _resume_leg("leg A", config3 + ["--fused-embed", "require"],
                            base, "a", 6, 3, models=True)
        model = leg_a["model"]
        lines, ev = _cli("eval", "--model", model, "--config",
                         "criteo1tb_fm_r64", "--data", holdout,
                         "--batch-size", TRAIN_B)
        metrics = lines[-1]
        want = leg_a["resumed_eval"]
        _check(metrics["count"] == len(ds) - cut and all(
            abs(metrics[k] - want[k]) <= 1e-6 for k in ("auc", "logloss")),
            f"eval --data: {metrics} != the training run's holdout {want}")
        _check(ev["kernel_launches"]["fm_fused_scores"] > 0,
               f"eval --data launched no forward kernel: {ev}")
        preds = os.path.join(base, "preds.txt")
        _, pr = _cli("predict", "--model", model, "--config",
                     "criteo1tb_fm_r64", "--data", holdout, "--batch-size",
                     16384, "--out", preds)
        got = np.loadtxt(preds)
        spec, params = models.load_model(model, device=dev)
        ids, vals, _ = ds.assemble(np.s_[cut:cut + 4096], bucket=BUCKET)
        want = _plain_predict(spec, params, ids, np.array(vals), dev).numpy()
        del params
        _check(got.shape == (len(ds) - cut,)
               and np.allclose(got[:4096], want, rtol=1e-5, atol=1e-6),
               f"predict --data: {got.shape} lines, max err "
               f"{np.abs(got[:4096] - want).max()}")
        _check(pr["kernel_runs_in_replays"].get("fm_fused_scores", 0) > 0,
               f"predict --data ran no forward kernel: {pr}")
        shutil.rmtree(model)
        out["leg_a"] = {**_leg_numbers(leg_a), "losses": leg_a["losses"],
                        "eval": metrics, "predict_lines": int(got.shape[0])}

        # Leg B: kernel A's segment totals, two steps per call, resumed
        # at a stride boundary.
        leg_b = _resume_leg(
            "leg B", config3 + ["--gfull-fused", "--segtotal-pallas",
                                "--steps-per-call", 2], base, "b", 4, 2)
        out["leg_b"] = {**_leg_numbers(leg_b), "losses": leg_b["losses"]}
        shutil.rmtree(packed)
        shutil.rmtree(holdout)

        # Leg C: config 4 from an Avazu CSV, the FFM kernels and the row
        # kernels (deterministic scatter_add under --use-pallas).
        csv = os.path.join(base, "train.csv")
        t0 = time.perf_counter()
        avazu.synthesize_csv(csv, INGEST_AVAZU_ROWS, seed=14)
        out["avazu_csv_write_s"] = time.perf_counter() - t0
        packed_c = os.path.join(base, "avazu")
        lines, _ = _cli("preprocess", "--config", "avazu_ffm_r16",
                        "--input", csv, "--out-dir", packed_c)
        _check(lines[-1]["num_examples"] == INGEST_AVAZU_ROWS,
               f"preprocess (avazu): {lines[-1]}")
        out["preprocess_avazu"] = lines[-1]
        leg_c = _resume_leg(
            "leg C", ["train", "--config", "avazu_ffm_r16", "--data",
                      packed_c, "--batch-size", INGEST_FFM_B,
                      "--compute-dtype", "bfloat16", "--sel-blocked",
                      "--fused-embed", "require", "--use-pallas",
                      "--test-fraction", "0.2", "--checkpoint-every", 2,
                      "--checkpoint-keep", 2], base, "c", 6, 3, models=True)
        lines, ev = _cli("eval", "--model", leg_c["model"], "--config",
                         "avazu_ffm_r16", "--data", packed_c,
                         "--batch-size", INGEST_FFM_B)
        _check(lines[-1]["count"] == INGEST_AVAZU_ROWS
               and np.isfinite(lines[-1]["logloss"])
               and ev["kernel_launches"]["ffm_sel_scores"] > 0,
               f"eval --data (avazu): {lines[-1]} {ev}")
        out["leg_c"] = {**_leg_numbers(leg_c), "losses": leg_c["losses"],
                        "eval": lines[-1]}
        launches = kernel_launches()
        out["launches"] = launches
        _check(all(v > 0 for v in launches.values()),
               f"a kernel of the ingest legs never launched: {launches}")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    print("ingest", json.dumps(out), flush=True)
    report["ingest"] = out
    return launches


DEEPFM_RANK, DEEPFM_MLP = 16, (400, 400, 400)   # config 5, criteo1tb_deepfm
DEEPFM_W = DEEPFM_RANK + 1
DEEPFM_B = DEEPFM_CAP = 16384            # its batch, and the recipe's cap
DEEPFM_ROWS = 131072                     # phase 15's packed dir
DEEPFM_STEPS = 4                         # eager against captured, per leg


def _deepfm_leg(dev, spec, cfg, kernels, leg):
    """One leg of phases 15 and 18: ``DEEPFM_STEPS`` steps of the eager
    body on one copy of seeded params and of the captured step on
    another, over the same bench batches, the loss, params and the dense
    optimizer's state (Adam's, or FTRL's) the same bits
    after each; then 3 profiled steps of each (device-busy ms, idle
    share, host launches, each kernel's runs per replay by symbol)."""
    import numpy as np
    import torch

    from fm_spark_tpu_torch import sparse
    from fm_spark_tpu_torch.graphs import _clone
    from fm_spark_tpu_torch.ops import kernel_launches, scatter

    total = DEEPFM_STEPS + PROFILED_STEPS
    stream = BenchStream(0, DEEPFM_B)
    batches, aux_ms = [], []
    for _ in range(total):
        ids, vals, labels, weights = stream.next_batch()
        aux = None
        if cfg.host_dedup:
            t0 = time.perf_counter()
            host = scatter.compact_aux(ids, cfg.compact_cap)
            aux_ms.append((time.perf_counter() - t0) * 1e3)
            aux = tuple(torch.from_numpy(a).to(dev) for a in host)
        batches.append((*(torch.from_numpy(a).to(dev)
                          for a in (ids, vals, labels, weights)), aux))
    body, init = sparse.make_field_deepfm_sparse_body(spec, cfg)
    step = sparse.make_field_deepfm_sparse_step(spec, cfg)
    eager = spec.init(torch.Generator(device=dev).manual_seed(25), dev)
    graphed = _clone(eager)
    oe, og = init(eager), step.init_opt_state(graphed)
    counted = dict.fromkeys(kernel_launches(), 0)

    def run(mode, j):
        nonlocal eager, graphed, oe, og
        before = kernel_launches()
        if mode == "eager":
            eager, oe, loss = body(eager, oe, j, *batches[j])
            if j < DEEPFM_STEPS:
                after = kernel_launches()
                for k in counted:
                    counted[k] += after[k] - before[k]
        else:
            graphed, og, loss = step(graphed, og, j, *batches[j])
        return loss

    step_ms, losses = [], []
    for j in range(DEEPFM_STEPS):
        le = run("eager", j)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        lc = run("captured", j)
        t1.record()
        torch.cuda.synchronize()
        if j > 0:                                # the first call captures
            step_ms.append(t0.elapsed_time(t1))
        _check(torch.equal(le.view(torch.int32), lc.view(torch.int32))
               and _same_tree(eager, graphed) and _same_tree(oe, og),
               f"deepfm {leg}: captured step {j} != eager step "
               f"(loss {float(lc)} vs {float(le)})")
        losses.append(float(le))
    _check(all(np.isfinite(losses)), f"deepfm {leg}: loss {losses}")
    _check(len(step.captured.capture_s) == 1,
           f"deepfm {leg}: captured {len(step.captured.capture_s)} times")
    per_step = {k: v / DEEPFM_STEPS for k, v in counted.items()}
    _check(all(per_step[k] > 0 for k in kernels),
           f"deepfm {leg}: a kernel never launched: {per_step}")
    prof = {mode: _profile_calls(lambda j, mode=mode: run(mode, j),
                                 range(DEEPFM_STEPS, total))
            for mode in ("eager", "captured")}
    torch.cuda.synchronize()
    _check(_same_tree(eager, graphed) and _same_tree(oe, og)
           and ("count" not in og or int(og["count"]) == total),
           f"deepfm {leg}: captured != eager after the profiled steps")
    replayed = prof["captured"].get("kernel_runs_per_step")
    _check(replayed is not None
           and all(replayed[k] >= 1 for k in kernels)
           and all(replayed[k] <= per_step[k] for k in per_step),
           f"deepfm {leg}: kernel runs per replay {replayed}, launches per "
           f"eager step {per_step}")
    ms = statistics.median(step_ms)
    row = {
        "leg": leg, "loss": losses,
        "capture_s": step.captured.capture_s[0],
        "captured_step_ms": step_ms, "captured_step_ms_median": ms,
        "samples_per_s": DEEPFM_B / (ms * 1e-3),
        "device_ms_per_step": prof["captured"]["device_ms_per_step"],
        "idle_share": prof["captured"]["idle_share"],
        "host_launches_per_eager_step":
            prof["eager"]["host_launches_per_step"],
        "host_launches_per_replay":
            prof["captured"]["host_launches_per_step"],
        "launches_per_eager_step": {k: per_step[k] for k in kernels},
        "kernel_runs_per_replay": {k: replayed[k] for k in kernels},
        "top_kernels_ms_per_step":
            prof["captured"].get("top_kernels_ms_per_step"),
        "aux_ms_median": statistics.median(aux_ms) if aux_ms else None,
        "bitwise_equal_every_step": True,
    }
    print("deepfm_leg", json.dumps(row), flush=True)
    del eager, oe, og, body, step, batches
    torch.cuda.empty_cache()
    return row, graphed


def _deepfm_dense_ms(dev, spec, cfg, params):
    """The MLP's forward and backward at B = 16,384 (bf16, the step's
    ``_mlp_forward``/``_mlp_backward``) and one Adam update of the dense
    side, in CUDA-event ms beside their bounds."""
    import torch

    from fm_spark_tpu_torch import sparse
    from fm_spark_tpu_torch.graphs import _clone
    from fm_spark_tpu_torch.models.io import flatten
    from fm_spark_tpu_torch.train import apply_updates, make_optimizer

    g = torch.Generator(device=dev).manual_seed(16)
    h = (torch.randn(DEEPFM_B, F * DEEPFM_RANK, generator=g, device=dev)
         * 0.1).to(spec.cdtype)
    ds = (torch.randn(DEEPFM_B, generator=g, device=dev) * 1e-4).to(
        spec.cdtype)

    def mlp(r):
        kernels, ins, pres, _ = sparse._mlp_forward(spec, params["mlp"], h)
        return sparse._mlp_backward(spec, kernels, ins, pres, ds)

    dims = (F * DEEPFM_RANK, *DEEPFM_MLP, 1)
    macs = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    flops = 3 * 2 * DEEPFM_B * macs            # forward, g_in, g_kernel
    dense = _clone({"w0": params["w0"], "mlp": params["mlp"]})
    opt = make_optimizer(cfg)
    state = opt.init(dense)
    grads = _clone(dense)
    n = sum(t.numel() for t in flatten(dense).values())
    adam_bytes = 7 * 4 * n          # read p, g, mu, nu; write p, mu, nu
    out = {
        "mlp_fwd_bwd_ms": _median_ms(mlp, hide_host_ms=2.0),
        "mlp_flops": flops,
        "mlp_bound_ms_bf16_peak": flops / 989e12 * 1e3,
        "mlp_bound_ms_fp32_peak": flops / FP32_FLOPS_PER_S * 1e3,
        "mlp_params": n,
        "adam_ms": _median_ms(lambda r: apply_updates(
            dense, opt.update(grads, state, dense)), hide_host_ms=2.0),
        "adam_call_ms": _median_ms(lambda r: apply_updates(
            dense, opt.update(grads, state, dense))),
        "adam_bound_ms": adam_bytes / HBM_BYTES_PER_S * 1e3,
        "adam_bytes": adam_bytes,
    }
    print("deepfm_dense", json.dumps(out), flush=True)
    return out


def deepfm_phase(dev, report):
    """Phase 15: config 5 (FieldDeepFM) at full width."""
    import importlib
    import tempfile

    import numpy as np
    import torch

    from fm_spark_tpu_torch import configs, data, models
    from fm_spark_tpu_torch.ops import (KERNEL_COUNTERS, kernel_launches,
                                        scatter)

    out = {"card": report["card"]}
    # The kernels at config 5's width against their plain versions: the
    # row kernels on bf16 and fp32 tables, kernel A in its two forms on
    # fp32 deltas (the compact update's cap 16,384 and the device dedup's
    # cap = B), the SR bits.
    g = torch.Generator(device=dev).manual_seed(15)
    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)
    w17 = {"rows": [_row_kernel_case(dev, f"config5-{n}", F, BUCKET,
                                     DEEPFM_W, dt, DEEPFM_B, g, flush)
                    for n, dt in (("bf16", torch.bfloat16),
                                  ("fp32", torch.float32))]}
    del flush
    ids = BenchStream(0, DEEPFM_B).next_batch()[0]
    caux = scatter.compact_aux(ids[:, :1], DEEPFM_CAP)
    order = torch.from_numpy(caux[3][0]).to(dev)
    seg = torch.from_numpy(caux[4][0]).to(dev)[order.long()].contiguous()
    col = torch.from_numpy(ids[:, 0].copy()).to(dev)
    o64, _, _, dseg = scatter._sort_segments(col)
    delta = torch.randn(DEEPFM_B, DEEPFM_W, generator=g, device=dev) * 0.01
    w17["segment_totals"] = [
        _kernel_a_row(dev, "compact-config5", delta, seg, DEEPFM_CAP, order,
                      True),
        _kernel_a_row(dev, "dedup-config5", delta, dseg, DEEPFM_B,
                      o64.to(torch.int32), False)]
    w17["sr_bits"] = _sr_bits_row(dev, (DEEPFM_CAP, DEEPFM_W))
    del delta, order, seg, col, o64, dseg
    out["w17"] = w17

    cfg5 = configs.get_config("criteo1tb_deepfm", param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    spec = cfg5.spec()
    recipe = dict(sparse_update="dedup_sr", host_dedup=True,
                  compact_cap=DEEPFM_CAP)
    legs = (("A-recipe", cfg5.train_config(**recipe), ("sr_bits",)),
            ("B-segtotal", cfg5.train_config(**recipe, segtotal_pallas=True),
             ("segment_totals", "sr_bits")),
            # dedup_sr writes by its set under use_pallas (as JAX's); dedup
            # is the form that reaches update_rows_add.
            ("C-use-pallas", cfg5.train_config(sparse_update="dedup",
                                               use_pallas=True),
             ("gather_rows", "update_rows_add", "segment_totals")))
    root = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(root, exist_ok=True)
    base = tempfile.mkdtemp(prefix="deepfm.", dir=root)
    try:
        # Counts start at 0 just before the legs and are read just after.
        for _, mod, attr in KERNEL_COUNTERS:
            setattr(importlib.import_module(f"fm_spark_tpu_torch.ops.{mod}"),
                    attr, 0)
        for leg, cfg, kernels in legs:
            row, params = _deepfm_leg(dev, spec, cfg, kernels, leg)
            out[leg] = row
            if leg == "A-recipe":
                out["dense"] = _deepfm_dense_ms(dev, spec, cfg, params)
            del params
            torch.cuda.empty_cache()

        # Leg A through fmtorch: a packed dir of bench ids (zipf(1.3) %
        # bucket per field), the registered recipe trained uninterrupted,
        # stopped and resumed into a checkpoint chain, then eval and
        # predict of the model dir and 400 requests served from it.
        rng = np.random.default_rng(15)
        packed = os.path.join(base, "zipf")
        local = rng.zipf(1.3, (DEEPFM_ROWS, F)) % BUCKET
        with data.PackedWriter(packed, F, store_vals=False) as w:
            w.append((local + np.arange(F) * BUCKET).astype(np.int32),
                     (rng.random(DEEPFM_ROWS) < 0.25).astype(np.int8))
        common = ["train", "--config", "criteo1tb_deepfm", "--data", packed,
                  "--batch-size", DEEPFM_B, "--param-dtype", "bfloat16",
                  "--compute-dtype", "bfloat16", "--sparse-update",
                  "dedup_sr", "--host-dedup", "--compact-cap", DEEPFM_CAP,
                  "--test-fraction", "0.2", "--checkpoint-every", 2,
                  "--checkpoint-keep", 2]
        cli_a = _resume_leg("deepfm leg A", common, base, "d", 6, 3,
                            models=True)
        model = cli_a["model"]
        ds = data.PackedDataset(packed)
        cut = int(len(ds) * (1.0 - 0.2))
        holdout = os.path.join(base, "holdout")
        with data.PackedWriter(holdout, F, store_vals=False) as w:
            w.append(np.asarray(ds.ids[cut:]), np.asarray(ds.labels[cut:]))
        lines, _ = _cli("eval", "--model", model, "--config",
                        "criteo1tb_deepfm", "--data", holdout,
                        "--batch-size", DEEPFM_B)
        metrics, want = lines[-1], cli_a["resumed_eval"]
        _check(metrics["count"] == len(ds) - cut and all(
            abs(metrics[k] - want[k]) <= 1e-6 for k in ("auc", "logloss")),
            f"deepfm eval --data: {metrics} != the training run's {want}")
        preds = os.path.join(base, "preds.txt")
        _cli("predict", "--model", model, "--config", "criteo1tb_deepfm",
             "--data", holdout, "--batch-size", DEEPFM_B, "--out", preds)
        got = np.loadtxt(preds)
        mspec, params = models.load_model(model, device=dev)
        hid, hvals, _ = ds.assemble(np.s_[cut:cut + DEEPFM_B], bucket=BUCKET)
        with torch.no_grad():
            want = mspec.predict(params, torch.from_numpy(hid).to(dev),
                                 torch.from_numpy(np.array(hvals)).to(dev))
        want = want.float().cpu().numpy()
        _check(got.shape == (len(ds) - cut,)
               and np.allclose(got[:DEEPFM_B], want, rtol=1e-5, atol=1e-6),
               f"deepfm predict --data: {got.shape} lines, max err "
               f"{np.abs(got[:DEEPFM_B] - want).max()}")
        params1 = {**params, "w0": params["w0"] + 3.0}
        # The head's fixed row tiles: served rows equal the plain
        # version's rows of one 44,540-row batch bit for bit (products
        # over the whole batch differed by up to 0.00098), so they are
        # held at the other models' bound.
        serve = _serve(dev, mspec, params, params1, F, BUCKET, 400,
                       kernel=None)
        print("deepfm_serve", json.dumps(serve), flush=True)
        out["A-cli"] = {**_leg_numbers(cli_a), "losses": cli_a["losses"],
                        "resumed_losses": cli_a["resumed_losses"],
                        "eval": metrics, "predict_lines": int(got.shape[0]),
                        "serve": serve}
        del params, params1
        launches = kernel_launches()
        out["launches"] = launches
        reached = ("gather_rows", "update_rows_add", "segment_totals",
                   "sr_bits")
        _check(all(launches[k] > 0 for k in reached),
               f"a kernel of the deepfm legs never launched: {launches}")
    finally:
        shutil.rmtree(base, ignore_errors=True)
        torch.cuda.empty_cache()
    print("deepfm", json.dumps({k: out[k] for k in (
        "card", "launches")}), flush=True)
    report["deepfm"] = out
    return launches, w17


SERVE_BUCKETS = (1, 8, 64, 512)
SERVE_TRAIN_B = 16384                    # phase 16 leg A: the trainer's batch
SERVE_TRAIN_ROWS = 65536
SERVE_TRAIN_STEPS = 6                    # saves every 2 steps: 2, 4, 6
SERVE_REPEAT = 65                        # leg A: passes of 64 requests
SERVE_REPS = 30                          # leg C: timed dispatches per case


def _chain_stat(d, digest: bool = False) -> dict:
    """Every file and directory under ``d``: size and mtime, and with
    ``digest`` the crc32 of each file's bytes."""
    import zlib

    out = {}
    for root, dirs, files in os.walk(d):
        for name in dirs:
            p = os.path.join(root, name)
            out[os.path.relpath(p, d)] = (None, os.stat(p).st_mtime_ns)
        for name in files:
            p = os.path.join(root, name)
            st = os.stat(p)
            entry = (st.st_size, st.st_mtime_ns)
            if digest:
                crc = 0
                with open(p, "rb") as f:
                    for chunk in iter(lambda: f.read(1 << 24), b""):
                        crc = zlib.crc32(chunk, crc)
                entry += (crc,)
            out[os.path.relpath(p, d)] = entry
    return out


class _LiveChain:
    """Phase 16 leg A: ``fmtorch serve`` follows a live config-3 chain (bf16,
    full width) on bench ids. In a thread: ``fmtorch train`` publishes step
    2, then ``fmtorch serve`` starts from it, and once it serves the same
    train command resumes to step ``SERVE_TRAIN_STEPS``, saving every 2
    steps, while serve answers its stream. The phase goes on in this
    process meanwhile."""

    def __init__(self, base):
        import numpy as np

        from fm_spark_tpu_torch import data

        rng = np.random.default_rng(16)
        packed = os.path.join(base, "zipf3")
        local = rng.zipf(1.3, (SERVE_TRAIN_ROWS, F)) % BUCKET
        with data.PackedWriter(packed, F, store_vals=False) as w:
            w.append((local + np.arange(F) * BUCKET).astype(np.int32),
                     (rng.random(SERVE_TRAIN_ROWS) < 0.25).astype(np.int8))
        self.chain = os.path.join(base, "chain3")
        self.out_path = os.path.join(base, "served.txt")
        dtypes = ["--param-dtype", "bfloat16", "--compute-dtype", "bfloat16"]
        fmtorch = [sys.executable, "-m", "fm_spark_tpu_torch"]
        self.train_argv = fmtorch + [
            "train", "--config", "criteo1tb_fm_r64", "--data", packed,
            "--batch-size", str(SERVE_TRAIN_B), *dtypes, "--sparse-update",
            "dedup_sr", "--host-dedup", "--compact-cap", str(CAP),
            "--fused-embed", "require", "--test-fraction", "0",
            "--log-every", "1", "--checkpoint-dir", self.chain,
            "--checkpoint-every", "2", "--checkpoint-keep", "3", "--steps"]
        # The budget paces the stream: a lone request waits 5 ms for
        # batch-mates, so the stream outlasts the resumed trainer.
        self.serve_argv = fmtorch + [
            "serve", "--config", "criteo1tb_fm_r64", "--compute-dtype",
            "bfloat16",
            "--checkpoint-dir", self.chain, "--synthetic", "4096",
            "--batch-size", "64", "--latency-budget-ms", "5",
            "--reload-poll-s", "0.2", "--repeat", str(SERVE_REPEAT),
            "--out", self.out_path]
        self.logs = {k: open(os.path.join(base, f"{k}.log"), "w+")
                     for k in ("train1.out", "train1.err", "train2.out",
                               "train2.err", "serve.out", "serve.err")}
        self.procs: dict = {}
        self.marks: dict = {}
        self.error = None
        self.t0 = time.perf_counter()
        self._sequence = threading.Thread(target=self._run, daemon=True)
        self._sequence.start()

    def _spawn(self, name, argv):
        self.marks[f"{name}_started_s"] = time.perf_counter() - self.t0
        self.procs[name] = subprocess.Popen(
            argv, cwd=HERE, stdout=self.logs[f"{name}.out"],
            stderr=self.logs[f"{name}.err"])
        return self.procs[name]

    def _run(self):
        try:
            rc = self._spawn("train1", self.train_argv + ["2"]).wait(400)
            if rc != 0:
                self.error = f"the first train exited {rc}"
                return
            server = self._spawn("serve", self.serve_argv)
            give_up = time.monotonic() + 300
            while '"serving"' not in self._peek("serve.out"):
                if server.poll() is not None or time.monotonic() > give_up:
                    self.error = "serve never reached its serving line"
                    return
                time.sleep(0.05)
            self.marks["serving_s"] = time.perf_counter() - self.t0
            self._spawn("train2", self.train_argv + [str(SERVE_TRAIN_STEPS)])
        except Exception as e:  # noqa: BLE001 — reported by finish()
            self.error = f"{type(e).__name__}: {e}"

    def _peek(self, key):
        with open(self.logs[key].name) as f:
            return f.read()

    def _read(self, key):
        f = self.logs[key]
        f.flush()
        f.seek(0)
        return f.read()

    def stop(self):
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in self.logs.values():
            f.close()

    def finish(self, dev) -> dict:
        """Wait for the three processes and check leg A's contract."""
        import numpy as np

        from fm_spark_tpu_torch import configs
        from fm_spark_tpu_torch.checkpoint import ChainFollower
        from fm_spark_tpu_torch.cli import _synthetic_for_model
        from fm_spark_tpu_torch.models.io import param_names, unflatten

        self._sequence.join(400)
        _check(self.error is None and "train2" in self.procs,
               f"leg A: {self.error}:\n{self._read('train1.err')[-3000:]}\n"
               f"{self._read('serve.err')[-3000:]}")
        for name in ("train2", "serve"):
            rc = self.procs[name].wait(timeout=400)
            self.marks[f"{name}_ended_s"] = time.perf_counter() - self.t0
            _check(rc == 0, f"leg A {name} exited {rc}:\n"
                   f"{self._read(name + '.err')[-4000:]}")
        lines = [json.loads(x) for x in self._read("serve.out").splitlines()
                 if x.startswith("{")]
        summary = next(x["serve_summary"] for x in lines
                       if "serve_summary" in x)
        serving = next(x for x in lines if "serving" in x)
        counts = json.loads(self._read("serve.err").strip().splitlines()[-1])
        losses = [json.loads(x)["loss"] for k in ("train1.out", "train2.out")
                  for x in self._read(k).splitlines() if '"loss"' in x]
        spec = configs.get_config("criteo1tb_fm_r64", param_dtype="bfloat16",
                                  compute_dtype="bfloat16").spec()
        names = param_names(spec)
        final = ChainFollower(self.chain).restore(
            unflatten(dict.fromkeys(names), names))
        _check(final is not None and final["step"] == SERVE_TRAIN_STEPS,
               f"leg A: the chain's newest verified step is "
               f"{final and final['step']}, not {SERVE_TRAIN_STEPS}")
        _check(summary["swaps"] >= 1 and summary["reload_failures"] == 0
               and not summary["degraded"],
               f"leg A serve_summary: {summary}")
        _check(summary["generation_step"] == SERVE_TRAIN_STEPS,
               f"leg A served step {summary['generation_step']} at the end, "
               f"not the trainer's last {SERVE_TRAIN_STEPS}")
        _check(counts["kernel_runs_in_replays"].get("fm_fused_scores", 0) > 0,
               f"leg A: serve never ran the forward kernel: {counts}")
        got = np.loadtxt(self.out_path)
        ids, vals, _ = _synthetic_for_model(spec, 4096)
        params = {"w0": final["params"]["w0"].to(dev),
                  "vw": [t.to(dev) for t in final["params"]["vw"]]}
        want = _plain_predict(spec, params, ids, vals, dev).numpy()
        _check(got.shape == (summary["served_rows"],),
               f"leg A wrote {got.shape} predictions")
        # bf16 compute: the kernel within phase 3's tolerance of the
        # plain version; %.6g output.
        last = got[-4096:]
        _check(np.allclose(last, want, rtol=RTOL, atol=ATOL),
               f"leg A: the last pass differs from the plain version on step "
               f"{SERVE_TRAIN_STEPS}: max err {np.abs(last - want).max()}")
        return {**self.marks, "losses": losses, "serving": serving,
                "summary": summary, "serve_counts": counts,
                "last_pass_max_abs_err": float(np.abs(last - want).max())}


def _chain_drills(dev, base) -> dict:
    """Phase 16 leg B: the chain's drills at config 5's full width while a
    client thread is served: a demoted tip refused, ``demote_newer_than``
    moving the pointer back, a corrupt tip and a torn ``last_good``
    walked past, a demotion racing a reload refused; the chain unchanged
    (sizes, mtimes) by every poll, and byte for byte by the last three."""
    import numpy as np
    import torch

    from fm_spark_tpu_torch import configs
    from fm_spark_tpu_torch.checkpoint import Checkpointer
    from fm_spark_tpu_torch.serve import PredictEngine, ReloadFollower
    from fm_spark_tpu_torch.utils.logging import EventLog

    spec = configs.get_config("criteo1tb_deepfm", param_dtype="bfloat16",
                              compute_dtype="bfloat16").spec()
    params = spec.init(torch.Generator(device=dev).manual_seed(16), dev)

    def gen(step):      # generations told apart by the bias alone
        return {**params, "w0": params["w0"] + 0.4 * step}

    chain = os.path.join(base, "chain5")
    ck = Checkpointer(chain, max_to_keep=3)
    journal = EventLog()
    engine = PredictEngine(spec, gen(0), device=dev, journal=journal)
    engine.warmup()
    fol = ReloadFollower(engine, chain, journal=journal)
    stop = threading.Event()
    sent = []

    def client():
        rng = np.random.default_rng(16)
        while not stop.is_set():
            n = int(rng.integers(1, 17))
            ids = (rng.zipf(1.3, (n, F)) % BUCKET).astype(np.int32)
            vals = np.ones((n, F), np.float32)
            sent.append((ids, vals, engine.submit(ids, vals)))
            time.sleep(0.005)

    def save(step):
        ck.save(step, gen(step))
        ck.wait()

    def poll(writer_inside=False):
        before = _chain_stat(chain)
        outcome = fol.poll_once()
        _check(writer_inside or _chain_stat(chain) == before,
               f"a follower's poll changed the chain ({outcome})")
        return outcome, engine.generation().step

    steps = []
    th = threading.Thread(target=client, daemon=True)
    th.start()
    try:
        save(1)
        save(2)
        steps.append(("first", poll(), ("swapped", 2)))
        save(3)
        ck.demote(3, reason="drift verdict")       # before any poll sees 3
        steps.append(("demoted tip", poll(), ("fresh", 2)))
        with open(os.path.join(chain, "last_good.json"), "w") as f:
            json.dump({"step": 3}, f)           # the crash window's pointer
        steps.append(("stale pointer to it", poll(), ("stale_chain", 2)))
        _check(ck.demote_newer_than(1, reason="drift day") == [2]
               and ck.last_good_step() == 1,
               f"demote_newer_than(1): pointer {ck.last_good_step()}")
        steps.append(("pointer moved back", poll(), ("fresh", 2)))
        save(4)
        steps.append(("past the range", poll(), ("swapped", 4)))
        save(5)
        for root, _, files in os.walk(os.path.join(chain, "5")):
            for name in files:
                if name.endswith(".npy"):
                    with open(os.path.join(root, name), "r+b") as f:
                        f.seek(-4, os.SEEK_END)
                        f.write(b"\xde\xad\xbe\xef")
        steps.append(("corrupt tip", poll(), ("stale_chain", 4)))
        with open(os.path.join(chain, "last_good.json"), "w") as f:
            f.write("")
        steps.append(("torn last_good", poll(), ("no_checkpoint", 4)))
        with open(os.path.join(chain, "last_good.json"), "w") as f:
            json.dump({"step": 5}, f)
        save(6)
        steps.append(("a good step again", poll(), ("swapped", 6)))
        save(7)
        restore = fol.chain.restore

        def restore_then_demote(*a, **kw):
            got = restore(*a, **kw)
            ck.demote(7, reason="drift verdict racing the reload")
            return got
        fol.chain.restore = restore_then_demote
        steps.append(("demotion racing the reload",
                      poll(writer_inside=True), ("demoted", 6)))
        fol.chain.restore = restore
        with open(os.path.join(chain, "last_good.json"), "w") as f:
            json.dump({"step": 7}, f)           # vouches for the demoted 7
        before = _chain_stat(chain, digest=True)
        tail = [poll() for _ in range(3)]
        _check(_chain_stat(chain, digest=True) == before,
               "the follower's polls changed the chain's bytes")
        _check(len({tuple(t) for t in tail}) == 1, f"leg B tail {tail}")
        steps.append(("three more polls", tail[-1], ("stale_chain", 6)))
    finally:
        stop.set()
        th.join(30)
    for name, got, want in steps:
        _check(tuple(got) == want, f"leg B {name}: {got}, want {want}")
    swaps = [e for e in journal.records if e["event"] == "serve_swap"]
    results = [(ids, fut.result(60)) for ids, _, fut in sent]
    engine.close()
    ck.close()
    # Each answer is one installed generation's, never a demoted one's.
    ids_all = np.concatenate([i for i, _ in results])
    got_all = np.concatenate([r for _, r in results])
    cands = {}
    for step in (0, 2, 3, 4, 5, 6, 7):
        with torch.no_grad():
            cands[step] = spec.predict(
                gen(step), torch.from_numpy(ids_all).to(dev),
                torch.ones(ids_all.shape, device=dev)).float().cpu().numpy()
    # bf16 predictions, the bias steps 0.4 apart: 2^-6 tells them apart.
    order = sorted(cands)
    match = np.abs(np.stack([cands[k] for k in order]) - got_all) <= 2.0 ** -6
    _check(bool((match.sum(0) == 1).all()),
           "leg B: an answer matches no generation or several")
    which = np.array(order)[match.argmax(0)]
    by_gen = {int(k): int((which == k).sum()) for k in order}
    _check(by_gen[3] == by_gen[5] == by_gen[7] == 0,
           f"leg B: a demoted or corrupt generation answered: {by_gen}")
    return {"polls": [[name, list(got)] for name, got, _ in steps],
            "requests": len(results), "rows_by_generation": by_gen,
            "journal": sorted({e["event"] for e in journal.records}),
            "swaps": len(swaps), "reloads": fol.reloads,
            "failures": fol.failures, "last_swap": fol.last_swap,
            "step_bytes": sum(t.numel() * t.element_size()
                              for t in params["vw"])}


def _raw_scores_spec(spec, whole_batch: bool):
    """``spec`` whose ``predict`` returns the raw scores (a bf16 sigmoid
    saturates and would hide a difference), with ``whole_batch`` the
    parent tree's head: each product over the whole batch."""
    import dataclasses

    import torch

    @dataclasses.dataclass(frozen=True)
    class Raw(type(spec)):
        def predict(self, params, ids, vals):
            return self.scores(params, ids, vals)

    @dataclasses.dataclass(frozen=True)
    class Whole(Raw):
        def deep_scores(self, mlp, h):
            cd = self.cdtype
            for li, layer in enumerate(mlp):
                h = torch.matmul(h, layer["kernel"].to(cd)) + \
                    layer["bias"].to(cd)
                if li < len(self.mlp_dims):
                    h = torch.relu(h)
            return h[:, 0]

    cls = Whole if whole_batch else Raw
    return cls(**{f.name: getattr(spec, f.name)
                  for f in dataclasses.fields(spec)})


def _deepfm_batch_measure(dev) -> dict:
    """Phase 16 leg D: config 5's rows served in each bucket against the
    same rows in a batch of 512, max |Δ| of the raw scores, bf16 and
    fp32, with torch's bf16 reduced-precision flag at its default and off:
    the parent's head (products over the whole batch, served eagerly as
    the parent's engine did) and the package's (products over fixed row
    tiles) through the engine's graphs. The package's must be 0
    everywhere."""
    import numpy as np
    import torch

    from fm_spark_tpu_torch import configs
    from fm_spark_tpu_torch.serve import PredictEngine

    matmul = torch.backends.cuda.matmul
    default = matmul.allow_bf16_reduced_precision_reduction
    ids, vals = BenchStream(17, batch=512).next_batch()[:2]
    ns = (1, 5, 8, 33, 64, 300, 512)
    out = {"flag_default": default, "scores": {}}
    try:
        for cd in ("bfloat16", "float32"):
            spec = configs.get_config("criteo1tb_deepfm", param_dtype=cd,
                                      compute_dtype=cd).spec()
            params = spec.init(torch.Generator(device=dev).manual_seed(18),
                               dev)
            for t in params["vw"]:      # rows at a trained scale (std 0.1)
                t.mul_(10.0)
            whole, tiles = (_raw_scores_spec(spec, True),
                            _raw_scores_spec(spec, False))
            for flag in (True, False):
                matmul.allow_bf16_reduced_precision_reduction = flag

                def padded(n):
                    b = next(x for x in SERVE_BUCKETS if x >= n)
                    pi = np.zeros((b, F), np.int32)
                    pv = np.zeros((b, F), np.float32)
                    pi[:n], pv[:n] = ids[:n], vals[:n]
                    return (torch.from_numpy(pi).to(dev),
                            torch.from_numpy(pv).to(dev))

                with torch.no_grad():
                    full = whole.predict(params, *padded(512)).float()
                    untiled = {n: float((whole.predict(
                        params, *padded(n)).float()[:n]
                        - full[:n]).abs().max()) for n in ns}
                eng = PredictEngine(tiles, params, buckets=SERVE_BUCKETS,
                                    device=dev)
                eng.warmup()
                efull = eng.score(ids, vals)
                tiled = {n: float(np.abs(eng.score(ids[:n], vals[:n])
                                         - efull[:n]).max()) for n in ns}
                eng.close()
                out[f"{cd} flag={flag}"] = {"untiled": untiled,
                                            "tiled": tiled}
            out["scores"][cd] = {"abs_max": float(full.abs().max()),
                                 "abs_median": float(full.abs().median())}
            del params
            torch.cuda.empty_cache()
    finally:
        matmul.allow_bf16_reduced_precision_reduction = default
    bad = {k: v["tiled"] for k, v in out.items()
           if isinstance(v, dict) and "tiled" in v and any(v["tiled"].values())}
    _check(not bad, f"leg D: served FieldDeepFM rows depend on the batch: "
           f"{bad}")
    return out


def _host_copy(params, shift):
    """``params`` on the host (pageable, as a restore returns them), the
    bias shifted by ``shift``."""
    out = {k: ([t.cpu() for t in v] if isinstance(v, list) else v.cpu())
           for k, v in params.items() if k != "mlp"}
    if "mlp" in params:
        out["mlp"] = [{k: t.cpu() for k, t in layer.items()}
                      for layer in params["mlp"]]
    out["w0"] = out["w0"] + shift
    return out


def _graphs_vs_eager(dev) -> dict:
    """Phase 16 leg C: per served model at full width, each bucket's replay
    against an eager ``spec.predict`` on the same padded bucket (bit for
    bit), their dispatch ms (host clock to the answer on the host, median
    of ``SERVE_REPS``) and, profiled, host launches and device-busy ms per
    batch; then swaps from host params (H2D and capture seconds), after
    which every answer is the new generation's, and the memory after 3
    swaps."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from fm_spark_tpu_torch import configs
    from fm_spark_tpu_torch.serve import PredictEngine

    def config5(d):
        spec = configs.get_config("criteo1tb_deepfm", param_dtype="bfloat16",
                                  compute_dtype="bfloat16").spec()
        return spec, spec.init(torch.Generator(device=d).manual_seed(19), d)

    def config4(d):
        spec, params = _config4_model(d, seed=6)
        return dataclasses.replace(spec, compute_dtype="bfloat16"), params

    cases = (("config3-fp32", lambda d: _config3_model(d, seed=5), F, BUCKET,
              "fm_fused_scores"),
             ("config3-bf16", lambda d: _config3_model(d, seed=5,
                                                       dtype="bfloat16"),
              F, BUCKET, "fm_fused_scores"),
             ("config4-bf16-compute", config4, FFM_F, FFM_BUCKET,
              "ffm_sel_scores"),
             ("config5-bf16", config5, F, BUCKET, None))
    out = {}
    for name, make, nf, bucket, kernel in cases:
        spec, params = make(dev)
        eng = PredictEngine(spec, params, buckets=SERVE_BUCKETS, device=dev)
        warm = eng.warmup()
        gen0 = eng.generation()
        row = {"warmup": warm, "buckets": {}}
        for b in SERVE_BUCKETS:
            ids, vals = BenchStream(20 + b, batch=b, fields=nf,
                                    bucket=bucket).next_batch()[:2]
            ids_h = torch.from_numpy(ids).pin_memory()
            vals_h = torch.from_numpy(vals).pin_memory()

            def eager(_=None):
                with torch.no_grad():
                    return spec.predict(params, ids_h.to(dev, non_blocking=True),
                                        vals_h.to(dev, non_blocking=True)
                                        ).float().cpu().numpy()

            def replay(_=None):
                return eng._dispatch(gen0, ids, vals)

            got, want = replay(), eager()
            _check(np.array_equal(got, want),
                   f"leg C {name} bucket {b}: replay != eager, max |Δ| "
                   f"{np.abs(got - want).max()}")
            times = {"eager": [], "replay": []}
            for _ in range(SERVE_REPS):
                for mode, fn in (("eager", eager), ("replay", replay)):
                    t0 = time.perf_counter()
                    fn()
                    times[mode].append((time.perf_counter() - t0) * 1e3)
            prof = {mode: _profile_calls(fn, range(5))
                    for mode, fn in (("eager", eager), ("replay", replay))}
            row["buckets"][b] = {
                "batch_ms_p50_eager": statistics.median(times["eager"]),
                "batch_ms_p50_replay": statistics.median(times["replay"]),
                **{f"{k}_{mode}": prof[mode].get(k) for mode in prof
                   for k in ("host_launches_per_step", "device_ms_per_step",
                             "graph_launches_per_step")},
                "kernel_runs_per_replay": (
                    prof["replay"].get("kernel_runs_per_step", {}).get(kernel)
                    if kernel else None)}
        # Swaps from host params: the H2D and the capture, then no answer
        # from the old generation.
        swaps = []
        host1 = _host_copy(params, 0.5)
        gen = eng.swap_generation(host1, step=1)
        swaps.append({"h2d_s": gen.h2d_s, "capture_s": gen.capture_s})
        for b in SERVE_BUCKETS:
            ids, vals = BenchStream(40 + b, batch=b, fields=nf,
                                    bucket=bucket).next_batch()[:2]
            d_ids, d_vals = (torch.from_numpy(ids).to(dev),
                             torch.from_numpy(vals).to(dev))
            with torch.no_grad():
                old = spec.predict(params, d_ids, d_vals).float().cpu().numpy()
                new = spec.predict(gen.params, d_ids,
                                   d_vals).float().cpu().numpy()
            got = eng.score(ids, vals)
            _check(np.array_equal(got, new) and np.array_equal(
                got != old, new != old) and bool((new != old).any()),
                f"leg C {name} bucket {b}: an answer after the swap is not "
                "the new generation's")
        del gen0
        if name == "config3-bf16":
            gc.collect()
            torch.cuda.synchronize()
            mem = [torch.cuda.memory_allocated()]
            for step in (2, 3):
                gen = eng.swap_generation(_host_copy(params, 0.5 * step), step)
                swaps.append({"h2d_s": gen.h2d_s, "capture_s": gen.capture_s})
                gc.collect()
                torch.cuda.synchronize()
                mem.append(torch.cuda.memory_allocated())
            row["memory_allocated_after_swaps"] = mem
            _check(mem[-1] <= mem[0] + (64 << 20),
                   f"leg C: an old generation's memory was kept: {mem}")
        row["swaps"] = swaps
        eng.close()
        del eng, gen, params, host1
        gc.collect()
        torch.cuda.empty_cache()
        out[name] = row
        print(f"serve graphs {name}", json.dumps(row), flush=True)
    return out


def serve_chain_phase(dev, report):
    """Phase 16: ``fmtorch serve`` following a live chain (leg A, in two
    processes, while legs B and D run here), the chain's drills (B), the
    FieldDeepFM batch measurement (D), then graphs against eager per
    bucket (C) with the card to itself."""
    import tempfile

    root = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(root, exist_ok=True)
    base = tempfile.mkdtemp(prefix="serve.", dir=root)
    live = None
    t0 = time.perf_counter()
    try:
        live = _LiveChain(base)
        drills = _chain_drills(dev, base)
        print("serve_chain B", json.dumps(drills), flush=True)
        batch = _deepfm_batch_measure(dev)
        print("serve_chain D", json.dumps(batch), flush=True)
        leg_a = live.finish(dev)
        print("serve_chain A", json.dumps(leg_a), flush=True)
        graphs = _graphs_vs_eager(dev)
    finally:
        if live is not None:
            live.stop()
        shutil.rmtree(base, ignore_errors=True)
    out = {"card": report["card"], "A": leg_a, "B": drills, "C": graphs,
           "D": batch, "seconds": time.perf_counter() - t0,
           "request_ms_under_4_threads": {
               k: {q: report[k][q] for q in ("request_ms_p50",
                                             "request_ms_p99",
                                             "batch_ms_p50")}
               for k in ("serve", "ffm_serve") if k in report}}
    if "deepfm" in report:
        out["request_ms_under_4_threads"]["deepfm"] = {
            q: report["deepfm"]["A-cli"]["serve"][q]
            for q in ("request_ms_p50", "request_ms_p99", "batch_ms_p50")}
    report["serve_chain"] = out
    print(f"serve_chain {out['seconds']:.1f} s", flush=True)
    runs = {"fm_fused_scores": 0, "ffm_sel_scores": 0}
    for name, row in graphs.items():
        kernel = ("ffm_sel_scores" if name.startswith("config4")
                  else "fm_fused_scores" if name.startswith("config3")
                  else None)
        if kernel:
            runs[kernel] += sum(5 * (r["kernel_runs_per_replay"] or 0)
                                for r in row["buckets"].values())
    return runs


FLAT_STEPS = 5                           # phase 17: eager against captured
FLAT_C2 = dict(name="criteo_kaggle_fm_r32", fields=39, bucket=1 << 15,
               rank=32, batch=16384)         # config 2
FLAT_C1 = dict(name="movielens_fm_r8", users=943, items=1682,
               ratings=100000, rank=8, batch=4096)   # config 1, ML-100K's shape
FLAT_TSV_ROWS = 98304                    # phase 17's Criteo TSV (4 steps + holdout)
# The card's step against the plain CPU step from the same params: float32
# sums (the batch's, and each id's lanes) in another order on each side.
FLAT_RTOL, FLAT_ATOL = 1e-5, 1e-6


class _FlatConfig2Stream:
    """Config 2's batch: ``BenchStream``'s Zipf(1.3) ids per field, made
    global (``field·32768 + id``, the flat table's ids). Other widths give
    the flat table of another config (config 4's for the flat FFM, config
    5's for the flat DeepFM)."""

    def __init__(self, seed: int, batch: int = FLAT_C2["batch"],
                 fields: int = FLAT_C2["fields"],
                 bucket: int = FLAT_C2["bucket"]):
        import numpy as np

        self._inner = BenchStream(seed, batch=batch, fields=fields,
                                  bucket=bucket)
        self._offsets = np.arange(fields, dtype=np.int32) * bucket

    def next_batch(self):
        ids, vals, labels, weights = self._inner.next_batch()
        return ids + self._offsets, vals, labels, weights


#: A coordinate's CPU gradient is clear of summation noise above this
#: many times its floor (:func:`_grad_floor`): a gradient held within
#: the floor then differs by at most 1e-3 of itself, and a scale-free
#: step (``lr·g/(|g| + eps)``) by at most ``1e-3·lr``.
GRAD_CLEAR = 1e3


@contextlib.contextmanager
def _uncounted():
    """Kernel launches inside the block are a check's, not the main
    path's: every wrapper's count is set back to its value before it."""
    import importlib

    from fm_spark_tpu_torch.ops import KERNEL_COUNTERS

    counters = [(importlib.import_module(f"fm_spark_tpu_torch.ops.{mod}"),
                 attr) for _, mod, attr in KERNEL_COUNTERS]
    before = [getattr(mod, attr) for mod, attr in counters]
    try:
        yield
    finally:
        for (mod, attr), value in zip(counters, before):
            setattr(mod, attr, value)


def _grad_floor(g):
    """The absolute floor of a float32 gradient against another device's:
    ``FLAT_RTOL`` of the largest magnitude in each row (in the whole leaf
    for a leaf of one dimension or none), the error a total that cancels
    keeps when its terms are summed in another order."""
    a = g.float().abs()
    if a.dim() >= 2:
        rows = a.reshape(a.shape[0], -1).amax(1)
        return FLAT_RTOL * rows.reshape(-1, *([1] * (a.dim() - 1)))
    return FLAT_RTOL * (a.max() if a.numel() else a.sum())


def _grads_near(name, got, want):
    """A gradient tree on the card against the plain CPU one: each element
    within ``FLAT_RTOL`` of the CPU's value plus its floor
    (:func:`_grad_floor`), so a row the CPU leaves zero (no id touched
    it) is zero on the card. Returns each leaf's max abs error and the
    CPU's leaves with their floors, by keypath."""
    from fm_spark_tpu_torch.models.io import flatten

    ref_leaves = flatten(want)
    errs, ref = {}, {}
    for key, t in flatten(got).items():
        w = ref_leaves[key].float()
        diff = (t.cpu().float() - w).abs()
        floor = _grad_floor(w)
        errs[key] = float(diff.max()) if diff.numel() else 0.0
        over = diff - (FLAT_RTOL * w.abs() + floor)
        at = int(over.argmax()) if over.numel() else 0
        _check(bool((over <= 0).all()),
               f"{name}: the gradient {key} on the card differs from the "
               f"CPU's by {errs[key]}; at flat index {at}: card "
               f"{float(t.reshape(-1)[at])}, CPU {float(w.reshape(-1)[at])}, "
               f"floor {float(floor.expand_as(w).reshape(-1)[at])}")
        ref[key] = (w, floor)
    return errs, ref


def _relu_ties(spec, p_card, p_cpu, ids, vals):
    """The rows of a DeepFM batch whose MLP's ReLUs decide differently on
    the card and the CPU (``[B]`` bool, on the CPU). The MLP's input, the
    gathered rows times their values, is the same bits on both; a hidden
    pre-activation within rounding of 0 then takes either side, which
    moves that row's whole gradient through the unit, not its rounding."""
    import torch

    from fm_spark_tpu_torch.ops import fm as fm_ops
    from fm_spark_tpu_torch.sparse import _mlp_forward

    masks = []
    with torch.no_grad(), _uncounted():
        for p, i, x in ((p_card, ids, vals),
                        (p_cpu, ids.cpu(), vals.cpu())):
            v = p["v"]
            xv = (v[fm_ops.gather_index(i, v.shape[0])].to(spec.cdtype)
                  * x.to(spec.cdtype)[..., None])
            pres = _mlp_forward(spec, p["mlp"], xv.reshape(xv.shape[0], -1))[2]
            masks.append([(t > 0).cpu() for t in pres[:len(spec.mlp_dims)]])
    differ = torch.zeros(ids.shape[0], dtype=torch.bool)
    for a, b in zip(*masks):
        differ |= (a != b).any(1)
    return differ


def _near_cpu(got, want, optimizer: str, lr: float, grad=None) -> bool:
    """A parameter after one step on the card against the plain CPU step
    from the same params: within ``FLAT_RTOL``/``FLAT_ATOL`` (float32 sums
    in another order). Adam's and AdaGrad's first step is scale-free where
    the gradient is small (``lr·g/(|g| + eps)``): a total that cancels to
    summation noise may step either way, so there each coordinate is held
    to the most two such steps can differ, ``2·lr``, and each coordinate
    whose CPU gradient (``grad``: the gradient and its floor, the
    optimizer's view with the L2 added) is ``GRAD_CLEAR`` times clear of
    its floor to the CPU tests' ``FLAT_RTOL`` plus ``1e-3·lr``. Returns
    whether it holds and, for Adam and AdaGrad, the share of coordinates
    clear of the noise and their largest error."""
    import torch

    if optimizer in ("adam", "adagrad"):
        diff = (got - want).abs()
        g, floor = grad
        clear = (g.abs() > GRAD_CLEAR * floor).reshape(diff.shape)
        ok = bool((diff <= 2 * lr + FLAT_ATOL).all()) and bool(
            (diff[clear] <= FLAT_RTOL * want.abs()[clear] + 1e-3 * lr).all())
        return ok, {"clear_share": float(clear.float().mean()),
                    "clear_max_abs_err": float(diff[clear].max())
                    if bool(clear.any()) else 0.0}
    return torch.allclose(got, want, rtol=FLAT_RTOL, atol=FLAT_ATOL), None


def _near_cpu_state(got, want) -> bool:
    """An optimizer's state after one step on the card against the plain
    CPU step's: counts equal; moments and slots (the gradient, its square,
    FTRL's ``z``) within ``FLAT_RTOL`` and ``FLAT_RTOL`` of the leaf's
    largest magnitude (a sum that cancels keeps its absolute error)."""
    import torch

    if not want.is_floating_point():
        return torch.equal(got, want)
    scale = float(want.abs().max()) if want.numel() else 0.0
    return torch.allclose(got, want, rtol=FLAT_RTOL,
                          atol=FLAT_ATOL + FLAT_RTOL * scale)


def _flat_leg(dev, name, spec, tcfg, batches):
    """One leg of phases 17 and 18 (``name`` begins with the phase): the
    dense step (``train.make_train_step``) of a flat family
    ``FLAT_STEPS`` steps eagerly (its body) on one copy of seeded params
    and captured on another, loss, ``grad_norm``, params and the
    schedule's count equal bit for bit after each step; wall ms per step
    (host clock to a synchronise, steps 2-5), then 3 profiled steps of
    each (device-busy ms, idle share, host launches, kernel A's runs by
    symbol); the eager body repeated on two copies of the same params and
    state (the same bits); one step on the card against the plain CPU
    step from the same params: its gradient (:func:`_grads_near`), the
    params (:func:`_near_cpu`) and the optimizer's state
    (:func:`_near_cpu_state`); and the card's scores against the CPU's at
    the card's stepped params."""
    import numpy as np
    import torch

    from fm_spark_tpu_torch import train
    from fm_spark_tpu_torch.models.deepfm import DeepFMSpec
    from fm_spark_tpu_torch.models.io import flatten
    from fm_spark_tpu_torch.ops import segsum

    def batch_on(b, d):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(d) for a in b]

    from fm_spark_tpu_torch.graphs import _clone

    host = [batches.next_batch() for _ in range(FLAT_STEPS + 4)]
    on_dev = [batch_on(b, dev) for b in host]
    p0 = spec.init(torch.Generator(device=dev).manual_seed(17), device=dev)

    def fresh():
        params = _clone(p0)
        opt = train.make_optimizer(tcfg)
        return params, opt.init(params), opt

    pe, se, opt_e = fresh()
    pc, sc, opt_c = fresh()
    eager = train.make_train_step(spec, tcfg, opt_e).body
    captured = train.make_train_step(spec, tcfg, opt_c)
    walls = {"eager": [], "captured": []}
    losses = []
    a0 = segsum.launches
    for i in range(FLAT_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        le, ne = eager(pe, se, *on_dev[i])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mc = captured(pc, sc, *on_dev[i])[2]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        walls["eager"].append((t1 - t0) * 1e3)
        walls["captured"].append((t2 - t1) * 1e3)
        _check(_same_bits(le, mc["loss"]) and _same_bits(ne, mc["grad_norm"])
               and _same_tree(pe, pc) and _same_tree(se, sc),
               f"{name}: the captured step {i} differs from the "
               f"eager one (loss {float(le)} / {float(mc['loss'])})")
        losses.append(float(le))
        _check(np.isfinite(losses[-1]), f"{name}: loss {losses[-1]}")
    eager_launches = segsum.launches - a0
    # The eager steps and the capture's warm-up each launch kernel A once.
    _check(eager_launches == FLAT_STEPS + 1,
           f"{name}: kernel A launched {eager_launches} times in "
           f"{FLAT_STEPS} eager steps and one warm-up")
    k = FLAT_STEPS
    # The trace may hold no device event at all (PERF.md §7): a second
    # profile of both forms then, each stepping its params alike.
    for _ in range(2):
        prof = {
            "eager": _profile_calls(lambda j: eager(pe, se, *on_dev[k + j]),
                                    range(PROFILED_STEPS)),
            "captured": _profile_calls(
                lambda j: captured(pc, sc, *on_dev[k + j]),
                range(PROFILED_STEPS))}
        if all(p.get("device_ms_per_step") != "not measured"
               for p in prof.values()):
            break
    _check(_same_tree(pe, pc) and _same_tree(se, sc),
           f"{name}: the profiled steps differ")
    replay_runs = prof["captured"].get("kernel_runs_per_step", {}).get(
        "segment_totals")
    # The trace misses a kernel record now and then (PERF.md §7): the
    # replays must show kernel A, at most once a step.
    if replay_runs is not None:
        _check(0 < replay_runs <= 1,
               f"{name}: kernel A ran {replay_runs} times per "
               "replayed step (want 1)")
    # The batch of the repeat and of the card-against-CPU step below. A
    # DeepFM row whose ReLUs decide differently on the two devices takes
    # no part in it (weight 0 on both sides): its gradient through the
    # unit moves by far more than the rounding.
    pcpu = _clone(p0, "cpu")
    host_b = batch_on(host[-1], "cpu")
    check_b, check_h = list(on_dev[-1]), list(host_b)
    ties = 0
    if isinstance(spec, DeepFMSpec):
        tied = _relu_ties(spec, p0, pcpu, *on_dev[-1][:2])
        ties = int(tied.sum())
        check_h[3] = torch.where(tied, 0.0, host_b[3])
        check_b[3] = check_h[3].to(dev)
    # The eager body twice on the same params, state and batch.
    pa, sa, opt_a = fresh()
    pb, sb, opt_b = fresh()
    la = train.make_train_step(spec, tcfg, opt_a).body(pa, sa, *check_b)
    lb = train.make_train_step(spec, tcfg, opt_b).body(pb, sb, *check_b)
    _check(all(_same_bits(x, y) for x, y in zip(la, lb))
           and _same_tree(pa, pb),
           f"{name}: the dense step repeated on the same inputs "
           "gave other bits")
    # One step from p0 on the card (pa) against the plain CPU step: first
    # its gradient (the launches a check's, uncounted), then the params.
    grads_fn = train._dense_grads_fn(spec)
    with torch.no_grad():
        with _uncounted():
            g_card = grads_fn(p0, *check_b)[1]
        g_cpu = grads_fn(pcpu, *check_h)[1]
    grad_errs, g_ref = _grads_near(name, g_card, g_cpu)
    g_opt = {key: (g.float(), g_ref[key][1]) for key, g in flatten(
        train._group_reg(tcfg)(g_cpu, pcpu)).items()}
    del g_card, g_cpu
    opt_h = train.make_optimizer(tcfg)
    scpu = opt_h.init(pcpu)
    lh, nh = train.make_train_step(spec, tcfg, opt_h).body(
        pcpu, scpu, *check_h)
    errs, clear = {}, {}
    flat_cpu = {**flatten(pcpu), **flatten(scpu, "opt")}
    for key, t in {**flatten(pa), **flatten(sa, "opt")}.items():
        ref = flat_cpu[key]
        errs[key] = float((t.cpu().double() - ref.double()).abs().max())
        if key.startswith("opt/"):
            ok = _near_cpu_state(t.cpu(), ref)
        else:
            ok, clear[key] = _near_cpu(t.cpu(), ref, tcfg.optimizer,
                                       tcfg.learning_rate, g_opt.get(key))
        _check(ok, f"{name}: {key} after the card's step differs from "
                   f"the plain CPU step by {errs[key]} ({clear.get(key)})")
    _check(abs(float(la[0]) - float(lh)) <= FLAT_RTOL * abs(float(lh)),
           f"{name}: loss {float(la[0])} on the card, {float(lh)} "
           "on the CPU")
    ids, vals = on_dev[0][:2]
    # The forward on the card against the CPU's at the params the card's
    # step reached.
    with torch.no_grad():
        s_card = spec.scores(pa, ids, vals).cpu()
        s_cpu = spec.scores(_clone(pa, "cpu"), ids.cpu(), vals.cpu())
    score_err = float((s_card - s_cpu).abs().max())
    _check(torch.allclose(s_card, s_cpu, rtol=FLAT_RTOL, atol=FLAT_ATOL),
           f"{name}: the card's scores differ from the CPU's by "
           f"{score_err}")
    med = statistics.median
    row = {
        "num_features": spec.num_features, "rank": spec.rank,
        "batch": int(host[0][0].shape[0]), "ids_per_row": int(
            host[0][0].shape[1]),
        "lanes": int(host[0][0].size),
        "distinct_ids_first_batch": int(np.unique(host[0][0]).size),
        "wall_ms_eager": med(walls["eager"][1:]),
        "wall_ms_captured": med(walls["captured"][1:]),
        "capture_s": captured.captured.capture_s,
        "kernel_a_eager_launches": eager_launches,
        "kernel_a_runs_per_replay": replay_runs,
        "max_abs_err_vs_cpu": errs, "score_max_abs_err_vs_cpu": score_err,
        "grad_max_abs_err_vs_cpu": grad_errs, "relu_tie_rows": ties,
        "scale_free_clear": clear, "losses": losses, "loss_card_vs_cpu": [float(la[0]), float(lh)],
        **{f"{k}_{mode}": prof[mode].get(k) for mode in prof
           for k in ("wall_ms_per_step", "device_ms_per_step", "idle_share",
                     "host_launches_per_step", "graph_launches_per_step",
                     "top_kernels_ms_per_step")}}
    del pe, pc, pa, pb, se, sc, on_dev, pcpu, scpu, g_opt
    torch.cuda.empty_cache()
    return row, p0


def _flat_serve(dev, spec, params, stream=None, tag="phase 17") -> dict:
    """A flat model behind ``PredictEngine`` (a CUDA graph per bucket;
    config 2 and its stream by default): each bucket's replay against an
    eager ``spec.predict`` of the same padded bucket (bit for bit),
    dispatch ms eager against replayed (host clock to the answer, median
    of ``SERVE_REPS``)."""
    import numpy as np
    import torch

    from fm_spark_tpu_torch.serve import PredictEngine

    stream = stream or _FlatConfig2Stream(23)
    nnz = stream.next_batch()[0].shape[1]
    eng = PredictEngine(spec, params, nnz=nnz, buckets=SERVE_BUCKETS,
                        device=dev)
    warm = eng.warmup()
    gen = eng.generation()
    out = {"warmup_s": warm["seconds"], "capture_s": warm["capture_s"]}
    for b in SERVE_BUCKETS:
        ids, vals = stream.next_batch()[:2]
        ids, vals = ids[:b], vals[:b]
        ids_h = torch.from_numpy(ids).pin_memory()
        vals_h = torch.from_numpy(vals).pin_memory()

        def eager():
            with torch.no_grad():
                return spec.predict(params, ids_h.to(dev, non_blocking=True),
                                    vals_h.to(dev, non_blocking=True)
                                    ).float().cpu().numpy()

        def replay():
            return eng._dispatch(gen, ids, vals)

        _check(np.array_equal(replay(), eager()),
               f"{tag} serving bucket {b}: replay != eager")
        times = {"eager": [], "replay": []}
        for _ in range(SERVE_REPS):
            for mode, fn in (("eager", eager), ("replay", replay)):
                t0 = time.perf_counter()
                fn()
                times[mode].append((time.perf_counter() - t0) * 1e3)
        out[b] = {f"dispatch_ms_p50_{m}": statistics.median(t)
                  for m, t in times.items()}
    eng.close()
    return out


def _flat_kernel_a(dev, name, batches, k):
    """Kernel A against its plain version at the dense step's shape: the
    ``[B·nnz, k+1]`` lanes of one batch sorted by id, cap = B·nnz (the
    device dedup's form)."""
    import torch

    from fm_spark_tpu_torch.ops import scatter

    ids = torch.from_numpy(batches.next_batch()[0]).to(dev).reshape(-1)
    order, _, _, seg = scatter._sort_segments(ids.long())
    gen = torch.Generator(device=dev).manual_seed(3)
    delta = torch.randn(ids.shape[0], k + 1, generator=gen, device=dev)
    return _kernel_a_row(dev, f"flat {name} dense step", delta, seg,
                         ids.shape[0], order.to(torch.int32), False)


def flat_fm_phase(dev, report):
    """Phase 17: configs 1 and 2 (the flat FM family) at full width."""
    import importlib
    import tempfile

    import numpy as np

    from fm_spark_tpu_torch import configs, data
    from fm_spark_tpu_torch.data import movielens
    from fm_spark_tpu_torch.ops import KERNEL_COUNTERS, kernel_launches

    root = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(root, exist_ok=True)
    base = tempfile.mkdtemp(prefix="flat.", dir=root)
    t_phase = time.perf_counter()
    out = {"card": report["card"]}
    try:
        ratings = os.path.join(base, "u.data")
        movielens.synthesize_ratings(ratings, FLAT_C1["users"],
                                     FLAT_C1["items"], FLAT_C1["ratings"],
                                     seed=0)
        (ids1, vals1, labels1), meta = movielens.load_ratings(ratings)
        c1 = configs.get_config(FLAT_C1["name"])
        c2 = configs.get_config(FLAT_C2["name"])
        spec1 = c1.spec(meta["num_features"])
        spec2 = c2.spec()
        _check(spec2.num_features == 1277952 and spec2.rank == 32,
               f"phase 17: config 2's spec {spec2}")
        out["kernel_a"] = {
            "config2": _flat_kernel_a(dev, "config2", _FlatConfig2Stream(5),
                                      spec2.rank),
            "config1": _flat_kernel_a(dev, "config1", data.Batches(
                ids1, vals1, labels1, FLAT_C1["batch"], seed=5), spec1.rank)}
        # The main path, with every kernel count set to 0 before it.
        for _, mod, attr in KERNEL_COUNTERS:
            setattr(importlib.import_module(f"fm_spark_tpu_torch.ops.{mod}"),
                    attr, 0)
        out["config2"], p2 = _flat_leg(
            dev, "phase 17 config2", spec2, c2.train_config(),
            _FlatConfig2Stream(7))
        print("flat config2", json.dumps(out["config2"]), flush=True)
        out["config1"], _ = _flat_leg(
            dev, "phase 17 config1", spec1, c1.train_config(),
            data.Batches(ids1, vals1, labels1, FLAT_C1["batch"], seed=0))
        print("flat config1", json.dumps(out["config1"]), flush=True)
        out["serve_config2"] = _flat_serve(dev, spec2, p2)
        print("flat serve", json.dumps(out["serve_config2"]), flush=True)
        del p2
        # fmtorch: config 2 from a Criteo TSV through preprocess, trained
        # uninterrupted and stopped/resumed; config 1 on the ratings file.
        tsv = os.path.join(base, "day.tsv")
        _criteo_tsv(tsv, FLAT_TSV_ROWS, seed=11)
        packed = os.path.join(base, "packed")
        _cli("preprocess", "--config", c2.name, "--input", tsv, "--out-dir",
             packed)
        common = ["train", "--config", c2.name, "--data", packed,
                  "--batch-size", FLAT_C2["batch"], "--log-every", 1,
                  "--checkpoint-every", 2, "--checkpoint-keep", 2]
        leg = _resume_leg("phase 17 config2", common, base, "c2ck", 4, 2,
                          models=True)
        model = leg["model"]
        ev, _ = _cli("eval", "--model", model, "--config", c2.name, "--data",
                     packed)
        pred = os.path.join(base, "pred.txt")
        _cli("predict", "--model", model, "--config", c2.name, "--data",
             packed, "--batch-size", FLAT_C2["batch"], "--out", pred)
        preds = np.loadtxt(pred)
        _check(preds.shape == (FLAT_TSV_ROWS,) and bool(np.isfinite(
            preds).all()) and 0 < preds.min() and preds.max() < 1,
            f"phase 17: predict --data wrote {preds.shape}")
        out["cli_config2"] = {
            "losses": leg["losses"], "resumed": leg["resumed"],
            "eval": leg["full_eval"], "eval_cmd": ev[-1],
            "samples_per_s": leg["samples_per_s"],
            "saves": leg["full"]["saves"],
            "capture_s": leg["full"]["capture_s"]}
        lines, summ = _cli("train", "--config", c1.name, "--data", ratings,
                           "--steps", 20, "--log-every", 5, "--model-out",
                           os.path.join(base, "m1"))
        ev1, _ = _cli("eval", "--model", os.path.join(base, "m1"), "--config",
                      c1.name, "--data", ratings)
        out["cli_config1"] = {"losses": _losses(lines),
                              "eval": _one(lines, "eval"),
                              "eval_cmd": ev1[-1], "capture_s":
                              summ["capture_s"]}
        _check(all(np.isfinite(v) for v in _losses(lines).values()),
               "phase 17: config 1's losses")
        counts = kernel_launches()
    finally:
        shutil.rmtree(base, ignore_errors=True)
    _check(counts["segment_totals"] > 0,
           f"phase 17: kernel A never launched on the flat path: {counts}")
    out["launches"] = counts
    out["seconds"] = time.perf_counter() - t_phase
    report["flat"] = out
    print(f"flat {out['seconds']:.1f} s, launches {json.dumps(counts)}",
          flush=True)
    return counts, out


FAM_B = 16384                            # phase 18's batch (configs 2, 4, 5)
FAM_FTRL_ROWS = 81920                    # phase 18's fmtorch leg: 4 steps + holdout
FAM_LBFGS_ITERS = 100                    # FMWithLBFGS on config 1's ratings
FAM_FFM_ROWS = 20000                     # FFMWithSGD's Avazu-shaped rows
FAM_LIBFM_ROWS = 159744                  # config 2's first rows to libFM
FAM_FFM_ITERS = 10


def _adaptive_leg(dev, spec, opt):
    """Leg B of phase 18: the sparse adaptive step (``optim.
    make_sparse_adaptive_step``) at config 2's width, ``FLAT_STEPS`` steps
    eagerly (its body) and captured from the same seeded params and
    slots, the loss, params and slots equal bit for bit after each; rows
    no lane touched, and their slots, bit-unchanged; kernel A once per
    eager step; captured step ms (CUDA events), 3 profiled steps
    (device-busy ms, kernel A's runs per replay by symbol); one step on
    the card against the plain CPU step: the totals its rule reads
    (``step.grads``, :func:`_grads_near`), the params (:func:`_near_cpu`)
    and the slots (:func:`_near_cpu_state`)."""
    import numpy as np
    import torch

    from fm_spark_tpu_torch import optim, train
    from fm_spark_tpu_torch.graphs import _clone
    from fm_spark_tpu_torch.models.io import flatten
    from fm_spark_tpu_torch.ops import segsum

    name = f"phase 18 sparse {opt}"
    lr = 0.05
    cfg = train.TrainConfig(learning_rate=lr, optimizer=opt)
    stream = _FlatConfig2Stream(31)
    host = [stream.next_batch() for _ in range(FLAT_STEPS + PROFILED_STEPS)]
    on_dev = [[torch.from_numpy(a).to(dev) for a in b] for b in host]
    p0 = spec.init(torch.Generator(device=dev).manual_seed(19), device=dev)
    s0 = optim.init_adaptive_slots(opt, spec, p0)
    if opt == "ftrl":
        optim.seed_ftrl_slots(s0, p0, lr, 1.0)
    step = optim.make_sparse_adaptive_step(spec, cfg)
    pe, se, pc, sc = _clone(p0), _clone(s0), _clone(p0), _clone(s0)
    n = spec.num_features
    touched = torch.zeros(n, dtype=torch.bool, device=dev)
    a0 = segsum.launches
    step_ms = []
    for i in range(FLAT_STEPS):
        le = step.body(pe, se, *on_dev[i])[2]
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        lc = step(pc, sc, *on_dev[i])[2]
        t1.record()
        torch.cuda.synchronize()
        if i > 0:                                # the first call captures
            step_ms.append(t0.elapsed_time(t1))
        touched[on_dev[i][0].reshape(-1).long()] = True
        _check(_same_bits(le, lc) and _same_tree(pe, pc)
               and _same_tree(se, sc),
               f"{name}: the captured step {i} differs from the eager one")
        _check(bool(torch.isfinite(le)), f"{name}: loss {float(le)}")
    eager_launches = segsum.launches - a0
    _check(eager_launches == FLAT_STEPS + 1,
           f"{name}: kernel A launched {eager_launches} times in "
           f"{FLAT_STEPS} eager steps and one warm-up")
    lazy = ~touched
    _check(all(torch.equal(t[lazy], ref[lazy]) for t, ref in (
        (pe["v"], p0["v"]), (pe["w"], p0["w"]),
        *((se[k][j], s0[k][j]) for k in se for j in se[k]))),
        f"{name}: a row no lane touched, or its slots, changed")
    prof = _profile_calls(lambda j: step(pc, sc, *on_dev[FLAT_STEPS + j]),
                          range(PROFILED_STEPS))
    replay_runs = prof.get("kernel_runs_per_step", {}).get("segment_totals")
    if replay_runs is not None:
        _check(0 < replay_runs <= 1,
               f"{name}: kernel A ran {replay_runs} times per replay")
    # One step from p0 on the card against the plain CPU step: first the
    # totals its rule reads (the launches a check's, uncounted).
    pa, sa = _clone(p0), _clone(s0)
    la = step.body(pa, sa, *on_dev[0])[2]
    pcpu, scpu = _clone(p0, "cpu"), _clone(s0, "cpu")
    host0 = [torch.from_numpy(a) for a in host[0]]
    with _uncounted():
        g_card = step.grads(p0, *on_dev[0])
    grad_errs, g_ref = _grads_near(name, g_card, step.grads(pcpu, *host0))
    del g_card
    lh = step.body(pcpu, scpu, *host0)[2]
    errs, clear = {}, {}
    want = {**flatten(pcpu), **flatten(scpu, "slots")}
    for key, t in {**flatten(pa), **flatten(sa, "slots")}.items():
        errs[key] = float((t.cpu() - want[key]).abs().max())
        if key.startswith("slots/"):
            ok = _near_cpu_state(t.cpu(), want[key])
        else:
            ok, clear[key] = _near_cpu(t.cpu(), want[key], opt, lr,
                                       g_ref.get(key))
        _check(ok,
               f"{name}: {key} after the card's step differs from the "
               f"plain CPU step by {errs[key]}")
    _check(abs(float(la) - float(lh)) <= FLAT_RTOL * abs(float(lh)),
           f"{name}: loss {float(la)} on the card, {float(lh)} on the CPU")
    row = {
        "optimizer": opt, "batch": FAM_B, "lanes": int(host[0][0].size),
        "rows_untouched": int(lazy.sum()),
        "captured_step_ms": step_ms,
        "captured_step_ms_median": statistics.median(step_ms),
        "capture_s": step.captured.capture_s,
        "kernel_a_eager_launches": eager_launches,
        "kernel_a_runs_per_replay": replay_runs,
        "max_abs_err_vs_cpu": errs, "grad_max_abs_err_vs_cpu": grad_errs,
        "scale_free_clear": clear,
        **{k: prof.get(k) for k in (
            "wall_ms_per_step", "device_ms_per_step", "idle_share",
            "host_launches_per_step", "top_kernels_ms_per_step")}}
    print("families sparse", json.dumps(row), flush=True)
    del pe, se, pc, sc, pa, sa, on_dev
    torch.cuda.empty_cache()
    return row


def _ffm_step_kernels(dev, flat, spec):
    """The sel kernels at the flat FFM step's shape (B = ``FAM_B`` rows of
    ``[23, 368]`` gathered from the flat table, fp32), each against its
    plain version (bit for bit, as phase 8's) with device, call and plain
    ms and the bound."""
    import torch

    from fm_spark_tpu_torch.ops import ffm_sel

    stream = _FlatConfig2Stream(41, FAM_B, FFM_F, FFM_BUCKET)
    ids = torch.from_numpy(stream.next_batch()[0]).to(dev).long()
    rows = flat["v"][ids].reshape(FAM_B, FFM_F, FFM_F * FFM_RANK)
    x = torch.ones(FAM_B, FFM_F, device=dev)
    ds = torch.randn(FAM_B, generator=torch.Generator(device=dev)
                     .manual_seed(42), device=dev) * 1e-3
    out = {}
    for key, fn, plain, bwd in (
            ("scores", lambda r: ffm_sel.ffm_sel_scores(rows, x),
             lambda r: ffm_sel.ffm_sel_scores_plain(rows, x), False),
            ("bwd", lambda r: ffm_sel.ffm_sel_bwd(rows, x, ds),
             lambda r: ffm_sel.ffm_sel_bwd_plain(rows, x, ds), True)):
        got, want = fn(0), plain(0)
        _check(torch.equal(got, want),
               f"phase 18 ffm_sel {key} at the flat step's shape: kernel "
               "!= plain version")
        (bms, bby), nbytes = _ffm_bound(FAM_B, 4, bwd=bwd)
        ms = _median_ms(fn, hide_host_ms=2.0)
        out[key] = {"max_abs_err": float((got - want).abs().max()),
                    "ms": ms, "call_ms": _median_ms(fn),
                    "plain_ms": _median_ms(plain, reps=5, hide_host_ms=20.0),
                    "bound_ms": bms, "bound_by": bby, "bytes": nbytes,
                    "library_ms": None,
                    "pct_of_bound_rate": 100.0 * bms / ms}
    print("families ffm_sel", json.dumps(out), flush=True)
    del rows, x, ds
    torch.cuda.empty_cache()
    return out


def _lbfgs_leg(dev, base) -> dict:
    """Leg E's L-BFGS: ``FMWithLBFGS.train`` on the ML-100K-shaped ratings
    (config 1's 2,625 x 8, 100,000 rows, ``FAM_LBFGS_ITERS`` iterations,
    config 1's regs) on the card, wall s; then ``fit_lbfgs`` from one
    seeded init on the card and on the CPU (the plain versions): the
    final objectives within 1e-5 relative (float32 sums in another order
    over up to 100 iterations move the path, not the minimum)."""
    import torch

    from fm_spark_tpu_torch import compat, lbfgs
    from fm_spark_tpu_torch.data import movielens
    from fm_spark_tpu_torch.graphs import _clone
    from fm_spark_tpu_torch.train import TrainConfig

    ratings = os.path.join(base, "u.data")
    movielens.synthesize_ratings(ratings, FLAT_C1["users"], FLAT_C1["items"],
                                 FLAT_C1["ratings"], seed=0)
    (ids, vals, labels), meta = movielens.load_ratings(ratings)
    regs = (0.0, 1e-5, 1e-4)                   # config 1's reg_* triple
    entry = compat.FMWithLBFGS(numIterations=FAM_LBFGS_ITERS,
                               dim=(True, True, FLAT_C1["rank"]),
                               regParam=regs, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = entry.run((ids, vals, labels))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _check(model.spec.num_features == meta["num_features"] == 2625
           and all(torch.isfinite(t).all() for t in model.params.values()),
           f"phase 18 FMWithLBFGS: {model.spec}")
    spec = model.spec
    cfg = TrainConfig(reg_bias=regs[0], reg_linear=regs[1],
                      reg_factors=regs[2])
    p0 = spec.init(torch.Generator().manual_seed(5), device="cpu")
    runs = {}
    for where in ("card", "cpu"):
        d = dev if where == "card" else torch.device("cpu")
        t0 = time.perf_counter()
        _, info = lbfgs.fit_lbfgs(spec, _clone(p0, d), ids, vals, labels,
                                  config=cfg, num_iterations=FAM_LBFGS_ITERS)
        runs[where] = {**info, "wall_s": time.perf_counter() - t0}
    rel = abs(runs["card"]["loss"] - runs["cpu"]["loss"]) / abs(
        runs["cpu"]["loss"])
    _check(rel <= 1e-5, f"phase 18 L-BFGS: objective {runs['card']} on the "
                        f"card, {runs['cpu']} on the CPU")
    out = {"entry_point": {**entry.info, "wall_s": wall},
           "fit_card": runs["card"], "fit_cpu": runs["cpu"],
           "objective_rel_diff": rel}
    print("families lbfgs", json.dumps(out), flush=True)
    return out


def _ffm_with_sgd(dev) -> dict:
    """Leg E's ``FFMWithSGD.train`` on ``FAM_FFM_ROWS`` Avazu-shaped rows
    (config 4's 23 fields of Zipf ids, global over 23 x 16,384), full
    batch, ``FAM_FFM_ITERS`` iterations, rank 16: wall s and finite
    predictions."""
    import numpy as np
    import torch

    from fm_spark_tpu_torch import compat

    ids, vals, labels, _ = _FlatConfig2Stream(
        43, FAM_FFM_ROWS, FFM_F, FFM_BUCKET).next_batch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = compat.FFMWithSGD.train((ids, vals, labels),
                                    numIterations=FAM_FFM_ITERS,
                                    dim=(True, True, FFM_RANK), device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    preds = model.predict(ids[:4096], vals[:4096])
    _check(type(model.spec).__name__ == "FFMSpec"
           and model.spec.num_fields == FFM_F
           and bool(np.isfinite(preds).all()) and 0 < preds.min()
           and preds.max() < 1,
           f"phase 18 FFMWithSGD: {model.spec}, predictions "
           f"[{preds.min()}, {preds.max()}]")
    out = {"rows": FAM_FFM_ROWS, "iterations": FAM_FFM_ITERS,
           "num_features": model.spec.num_features, "wall_s": wall,
           "mean_prediction": float(preds.mean())}
    print("families ffm_with_sgd", json.dumps(out), flush=True)
    return out


def _libfm_round_trip(dev, model_dir, base) -> dict:
    """Leg E's libFM: the first ``FAM_LIBFM_ROWS`` rows of config 2's
    trained model through ``save_libfm`` and ``load_libfm`` (on the card):
    the tables and the scores of a batch (its ids taken modulo the rows)
    bit for bit, the seconds of each and the file's size. (The whole
    1,277,952-row table took ~57 s of text formatting and parsing.)"""
    import dataclasses

    import torch

    from fm_spark_tpu_torch import models
    from fm_spark_tpu_torch.models import libfm_io

    spec, params = models.load_model(model_dir, device=dev)
    spec = dataclasses.replace(spec, num_features=FAM_LIBFM_ROWS)
    params = {"w0": params["w0"], "w": params["w"][:FAM_LIBFM_ROWS],
              "v": params["v"][:FAM_LIBFM_ROWS]}
    path = os.path.join(base, "config2.libfm")
    t0 = time.perf_counter()
    libfm_io.save_libfm(path, spec, params)
    t1 = time.perf_counter()
    spec2, params2 = libfm_io.load_libfm(path, device=dev)
    t2 = time.perf_counter()
    ids, vals = (torch.from_numpy(a).to(dev)
                 for a in _FlatConfig2Stream(44).next_batch()[:2])
    ids = ids % FAM_LIBFM_ROWS
    with torch.no_grad():
        same = torch.equal(spec.scores(params, ids, vals),
                           spec2.scores(params2, ids, vals))
    _check(same and all(torch.equal(params[k], params2[k])
                        for k in ("w0", "w", "v")),
           "phase 18 libFM: the round trip changed the model or its scores")
    out = {"num_features": spec2.num_features, "rank": spec2.rank,
           "save_s": t1 - t0, "load_s": t2 - t1,
           "file_mb": os.path.getsize(path) / 1e6,
           "scores_bit_for_bit": True}
    os.remove(path)
    print("families libfm", json.dumps(out), flush=True)
    return out


def families_phase(dev, report):
    """Phase 18: the rest of the model families and optimizers at full
    width: FTRL (the dense step at config 2, fmtorch train resumed, config
    5's dense head), the sparse adaptive step (FTRL, AdaGrad), the flat
    FFM at config 4's width and DeepFM at config 5's, L-BFGS, FFMWithSGD
    and the libFM format."""
    import importlib
    import tempfile

    import torch

    from fm_spark_tpu_torch import configs, models, train
    from fm_spark_tpu_torch.ops import KERNEL_COUNTERS, kernel_launches

    root = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(root, exist_ok=True)
    base = tempfile.mkdtemp(prefix="families.", dir=root)
    t_phase = time.perf_counter()
    out = {"card": report["card"]}
    c2 = configs.get_config(FLAT_C2["name"])
    spec2 = c2.spec()
    c4 = configs.get_config("avazu_ffm_r16")
    cfg5 = configs.get_config("criteo1tb_deepfm", param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    timings, by_leg = {}, {}
    try:
        # Leg C's checks of its kernels, before the counted run: a
        # FieldFFM's params through to_flat_params, the flat FFM's scores
        # against FieldFFM's, the sel kernels and kernel A at the flat
        # step's shape, each against its plain version.
        t0 = time.perf_counter()
        fspec, fparams = _config4_model(dev, seed=18)
        flat_spec = fspec.flat_spec()
        flat = fspec.to_flat_params(fparams)
        ids, vals = (torch.from_numpy(a).to(dev) for a in BenchStream(
            45, FAM_B, FFM_F, FFM_BUCKET).next_batch()[:2])
        with torch.no_grad():
            s_field = fspec.scores(fparams, ids, vals)
            s_flat = flat_spec.scores(flat, fspec.to_global_ids(ids), vals)
        _check(_close(s_flat, s_field),
               "phase 18 ffm: the flat FFM's scores differ from FieldFFM's "
               f"by {float((s_flat - s_field).abs().max())}")
        del fparams
        out["C_ffm_scores_max_abs_err"] = float((s_flat - s_field).abs().max())
        out["C_ffm_kernels"] = _ffm_step_kernels(dev, flat, flat_spec)
        del flat
        torch.cuda.empty_cache()
        out["C_ffm_kernel_a"] = _flat_kernel_a(
            dev, "ffm", _FlatConfig2Stream(46, FAM_B, FFM_F, FFM_BUCKET),
            FFM_F * FFM_RANK)
        timings["C_checks"] = time.perf_counter() - t0
        # The main path, with every kernel count set to 0 before it; each
        # leg's launches read from the counts around it.
        for _, mod, attr in KERNEL_COUNTERS:
            setattr(importlib.import_module(f"fm_spark_tpu_torch.ops.{mod}"),
                    attr, 0)

        def leg_done(key, t0, before):
            timings[key] = time.perf_counter() - t0
            after = kernel_launches()
            by_leg[key] = {k: after[k] - before[k] for k in after}

        # Leg A: FTRL. The dense step at config 2's full width, eager
        # against captured and against the CPU.
        t0, before = time.perf_counter(), kernel_launches()
        out["A_ftrl_config2"], _ = _flat_leg(
            dev, "phase 18 ftrl config2", spec2,
            c2.train_config(optimizer="ftrl"), _FlatConfig2Stream(7))
        print("families ftrl", json.dumps(out["A_ftrl_config2"]), flush=True)
        # fmtorch train --optimizer ftrl, stopped at 2 and resumed to 4.
        common = ["train", "--config", c2.name, "--synthetic", FAM_FTRL_ROWS,
                  "--batch-size", FAM_B, "--optimizer", "ftrl",
                  "--log-every", 1, "--checkpoint-every", 2,
                  "--checkpoint-keep", 2]
        leg = _resume_leg("phase 18 ftrl fmtorch", common, base, "fck", 4,
                          2, models=True)
        out["A_ftrl_fmtorch"] = {
            "losses": leg["losses"], "resumed": leg["resumed"],
            "eval": leg["full_eval"], "capture_s": leg["full"]["capture_s"],
            "samples_per_s": leg["samples_per_s"]}
        # Config 5's dense head by FTRL (its recipe otherwise).
        spec5 = cfg5.spec()
        recipe = dict(sparse_update="dedup_sr", host_dedup=True,
                      compact_cap=DEEPFM_CAP, optimizer="ftrl")
        out["A_ftrl_config5"], p5 = _deepfm_leg(
            dev, spec5, cfg5.train_config(**recipe), ("sr_bits",),
            "phase 18 ftrl")
        del p5
        torch.cuda.empty_cache()
        leg_done("A", t0, before)
        # Leg B: the sparse adaptive step at config 2's width.
        t0, before = time.perf_counter(), kernel_launches()
        out["B_sparse"] = {opt: _adaptive_leg(dev, spec2, opt)
                           for opt in ("ftrl", "adagrad")}
        leg_done("B", t0, before)
        # Leg C: the flat FFM's dense step at config 4's width.
        t0, before = time.perf_counter(), kernel_launches()
        out["C_ffm_step"], _ = _flat_leg(
            dev, "phase 18 ffm", flat_spec, c4.train_config(),
            _FlatConfig2Stream(47, FAM_B, FFM_F, FFM_BUCKET))
        print("families ffm", json.dumps(out["C_ffm_step"]), flush=True)
        leg_done("C", t0, before)
        # Leg D: the flat DeepFM at config 5's widths, Adam, fp32.
        t0, before = time.perf_counter(), kernel_launches()
        dspec = models.DeepFMSpec(num_features=F * BUCKET, rank=DEEPFM_RANK,
                                  num_fields=F, mlp_dims=DEEPFM_MLP)
        dcfg = train.TrainConfig(learning_rate=1e-3, lr_schedule="constant",
                                 optimizer="adam", reg_factors=1e-6)
        stream = _FlatConfig2Stream(48, FAM_B, F, BUCKET)
        out["D_deepfm_step"], dp0 = _flat_leg(dev, "phase 18 deepfm", dspec,
                                              dcfg, stream)
        print("families deepfm", json.dumps(out["D_deepfm_step"]),
              flush=True)
        out["D_deepfm_serve"] = _flat_serve(
            dev, dspec, dp0, _FlatConfig2Stream(49, FAM_B, F, BUCKET),
            "phase 18 deepfm")
        print("families deepfm serve", json.dumps(out["D_deepfm_serve"]),
              flush=True)
        del dp0
        torch.cuda.empty_cache()
        leg_done("D", t0, before)
        # Leg E: the reference API and formats.
        t0, before = time.perf_counter(), kernel_launches()
        out["E_lbfgs"] = _lbfgs_leg(dev, base)
        out["E_ffm_with_sgd"] = _ffm_with_sgd(dev)
        out["E_libfm"] = _libfm_round_trip(dev, leg["model"], base)
        leg_done("E", t0, before)
        counts = kernel_launches()
    finally:
        shutil.rmtree(base, ignore_errors=True)
        torch.cuda.empty_cache()
    # Each leg's path launched its kernels: the dense steps and the sparse
    # steps kernel A once per eager step and capture warm-up, the flat
    # FFM's step the sel kernels as often, config 5's head the SR bits.
    least = FLAT_STEPS + 1
    for key, name, n in (("A", "segment_totals", least),
                         ("A", "sr_bits", 1),
                         ("B", "segment_totals", 2 * least),
                         ("C", "segment_totals", least),
                         ("C", "ffm_sel_scores", least),
                         ("C", "ffm_sel_bwd", least),
                         ("D", "segment_totals", least),
                         ("E", "segment_totals", 1)):
        _check(by_leg[key][name] >= n,
               f"phase 18 leg {key}: {name} launched {by_leg[key][name]} "
               f"times on its path (want at least {n}): {by_leg[key]}")
    out["launches_by_leg"] = by_leg
    out["launches"] = counts
    out["leg_seconds"] = timings
    out["seconds"] = time.perf_counter() - t_phase
    report["families"] = out
    print(f"families {out['seconds']:.1f} s, legs {json.dumps(timings)}, "
          f"launches {json.dumps(counts)}, by leg {json.dumps(by_leg)}",
          flush=True)
    return counts, out


STREAM_BAD_FRAC = 0.005                  # phase 19: corrupted share of lines
STREAM_STEPS = 6                         # leg A: two whole epochs at B
STREAM_KILL_AT = 3                       # leg A: SIGKILL after this loss line
STREAM_PY_ROWS = 1024                    # leg C: rows per shard, both parsers
STREAM_AVAZU_ROWS = 30000                # leg B: 3 steps at 8,192
LAYOUT_STEPS = 4                         # leg D: steps per comparison


def _shards_of(lines, paths, header=None):
    """``lines`` split into len(paths) consecutive shards, each line
    newline-terminated; ``header`` goes into shard 0 only."""
    per = (len(lines) + len(paths) - 1) // len(paths)
    for i, path in enumerate(paths):
        part = lines[i * per:(i + 1) * per]
        with open(path, "wb") as f:
            if header is not None and i == 0:
                f.write(header + b"\n")
            f.write(b"\n".join(part) + b"\n")
    return per


def _corrupt_lines(lines, frac: float, seed: int) -> dict:
    """Corrupt ``frac`` of ``lines`` in place, at places drawn from
    ``seed``, in the three kinds the guard rejects by turns: a wrong field
    count (the last field dropped), a non-numeric label, a bad token (the
    first count not an integer). Returns ``{line index: kind}``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    where = np.sort(rng.choice(len(lines), int(round(frac * len(lines))),
                               replace=False))
    kinds = {}
    for j, i in enumerate(where.tolist()):
        line = lines[i]
        kind = j % 3
        if kind == 0:
            lines[i] = line.rsplit(b"\t", 1)[0]
        elif kind == 1:
            lines[i] = b"x" + line[1:]
        else:
            cols = line.split(b"\t")
            cols[1] = b"12ab"
            lines[i] = b"\t".join(cols)
        kinds[i] = ("field count", "label", "token")[kind]
    return kinds


def _dead_letters(qdir: str) -> set:
    """The distinct ``(path, lineno, reason)`` of a dead-letter journal."""
    from fm_spark_tpu_torch.utils.logging import read_events

    return {(e["path"], e["lineno"], e["reason"])
            for e in read_events(os.path.join(qdir, "deadletter.jsonl"))
            if e["event"] == "bad_record"}


def _parsers_leg(base, lines, out):
    """Leg C: the first STREAM_PY_ROWS rows of each dirty shard through
    the Python parser and the native one, batch for batch and cursor for
    cursor equal; host rows/s of each."""
    import numpy as np

    from fm_spark_tpu_torch.data.native_stream import NativeStreamBatches
    from fm_spark_tpu_torch.data.stream import (RecordGuard, ShardReader,
                                                StreamBatches, line_parser)

    per = (len(lines) + 2) // 3
    paths = [os.path.join(base, f"head{i}.tsv") for i in range(3)]
    heads = [ln for i in range(3)
             for ln in lines[i * per:i * per + STREAM_PY_ROWS]]
    _shards_of(heads, paths)

    def source(kind):
        guard = RecordGuard("quarantine",
                            quarantine_dir=os.path.join(base, f"q_{kind}"))
        reader = ShardReader(paths)
        if kind == "python":
            return StreamBatches(reader, line_parser("criteo", BUCKET),
                                 STREAM_PY_ROWS, F, guard=guard,
                                 num_features=F * BUCKET)
        return NativeStreamBatches(reader, "criteo", STREAM_PY_ROWS, F,
                                   guard=guard, num_features=F * BUCKET,
                                   bucket=BUCKET)

    got = {}
    for kind in ("python", "native"):
        src = source(kind)
        batches, states = [], []
        t0 = time.perf_counter()
        while src.state()["epoch"] == 0:
            batches.append(src.next_batch())
            states.append(src.state())
        secs = time.perf_counter() - t0
        got[kind] = (batches, states, src.guard.n_ok)
        out[f"{kind}_rows_per_s"] = src.guard.n_ok / secs
        out[f"{kind}_s"] = secs
        src.close()
    (pb, ps, pok), (nb, ns, nok) = got["python"], got["native"]
    _check(len(pb) == len(nb) and ps == ns and pok == nok and all(
        np.array_equal(x, y) for a, b in zip(pb, nb) for x, y in zip(a, b)),
        "leg C: the native parser's batches or cursors differ from the "
        "Python parser's")
    _check(_dead_letters(os.path.join(base, "q_python"))
           == _dead_letters(os.path.join(base, "q_native")),
           "leg C: the two parsers' dead-letter records differ")
    out.update(rows=len(heads), good_rows=pok, batches=len(pb),
               cursor=ps[-1])


def _kill_after(argv, line_step: int, ckdir: str) -> dict:
    """``fmtorch`` ``argv`` as a subprocess, SIGKILLed once it has printed
    its loss line of step ``line_step`` and its chain holds a verified
    step below it: what it printed."""
    import signal

    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "fm_spark_tpu_torch", *map(str, argv)],
        cwd=HERE, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    seen = []
    try:
        deadline = time.time() + 300
        for line in proc.stdout:
            if line.startswith("{"):
                seen.append(json.loads(line))
            if any(x.get("step") == line_step and "loss" in x for x in seen):
                break
            _check(time.time() < deadline, "leg A: the killed run never "
                   f"reached step {line_step}")
        good = os.path.join(ckdir, "last_good.json")
        while time.time() < deadline:
            if os.path.exists(good):
                with contextlib.suppress(ValueError, OSError):
                    with open(good) as f:
                        if json.load(f)["step"] >= 2:
                            break
            time.sleep(0.05)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        proc.stdout.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    _check(proc.returncode == -signal.SIGKILL,
           f"leg A: the run to kill exited {proc.returncode} first")
    return {"lines": seen, "last_good": json.load(open(good))["step"]}


def _stream_profile(dev, paths, base) -> dict:
    """Leg A's path in this process (the native stream with quarantine,
    field-local ids and the host aux on the producer thread, the
    prefetcher, the captured step): one captured step, then three steps
    under the profiler, each waiting on the stream as training does."""
    import torch

    from fm_spark_tpu_torch import models, sparse
    from fm_spark_tpu_torch.cli import _field_local_rows
    from fm_spark_tpu_torch.data import (DedupAuxBatches, MappedBatches,
                                         Prefetcher)
    from fm_spark_tpu_torch.data.native_stream import NativeStreamBatches
    from fm_spark_tpu_torch.data.stream import RecordGuard, ShardReader
    from fm_spark_tpu_torch.train import TrainConfig

    spec = models.FieldFMSpec(
        num_features=F * BUCKET, rank=RANK, num_fields=F, bucket=BUCKET,
        init_std=0.01, param_dtype="bfloat16", compute_dtype="bfloat16")
    cfg = TrainConfig(batch_size=TRAIN_B, learning_rate=0.05,
                      lr_schedule="constant", reg_factors=1e-6,
                      sparse_update="dedup_sr", host_dedup=True,
                      compact_cap=CAP, fused_embed="require")
    guard = RecordGuard("quarantine", os.path.join(base, "q_prof"),
                        max_bad_frac=0.05)
    stream = NativeStreamBatches(ShardReader(paths), "criteo", TRAIN_B, F,
                                 guard=guard, num_features=F * BUCKET,
                                 bucket=BUCKET)
    src = DedupAuxBatches(MappedBatches(
        stream, lambda b: _field_local_rows(b, BUCKET)), cap=CAP)
    pf = Prefetcher(src, depth=2, device=dev)
    try:
        step = sparse.make_sgd_step(spec, cfg)
        params = spec.init(torch.Generator(device=dev).manual_seed(0), dev)
        params, _ = step(params, 0, *pf.next_batch())          # the capture
        torch.cuda.synchronize()
        prof = _profile_calls(
            lambda j: step(params, j, *pf.next_batch()), range(1, 4))
    finally:
        pf.close()
        stream.close()
    return {k: prof[k] for k in (
        "wall_ms_per_step", "device_ms_per_step", "idle_share",
        "host_launches_per_step", "graph_launches_per_step")} | {
        "kernel_runs_per_step": prof.get("kernel_runs_per_step"),
        "ingest_rows_per_s": stream.rows_per_sec}


def _layouts_leg(dev, out):
    """Leg D: FieldFM's col layout (config 3, bf16, dedup_sr, compact
    12,288, kernel A) eager against captured and against the row layout,
    bit for bit over LAYOUT_STEPS steps; the unfused form (fp32,
    scatter_add) eager against captured; both forms' scores on the
    library path against the plain version on the CPU, timed."""
    import numpy as np
    import torch

    from fm_spark_tpu_torch import models, ops, sparse
    from fm_spark_tpu_torch.ops import fused_fwd, scatter
    from fm_spark_tpu_torch.train import TrainConfig

    kw = dict(num_features=F * BUCKET, rank=RANK, num_fields=F,
              bucket=BUCKET, init_std=0.01)
    row_spec = models.FieldFMSpec(**kw, param_dtype="bfloat16",
                                  compute_dtype="bfloat16")
    col_spec = models.FieldFMSpec(**kw, param_dtype="bfloat16",
                                  compute_dtype="bfloat16",
                                  table_layout="col")
    cfg = TrainConfig(batch_size=TRAIN_B, learning_rate=0.05,
                      reg_factors=1e-6, sparse_update="dedup_sr",
                      host_dedup=True, compact_cap=CAP,
                      segtotal_pallas=True)
    stream = BenchStream(19, TRAIN_B, F, BUCKET)
    batches = []
    for _ in range(LAYOUT_STEPS):
        ids, vals, labels, weights = stream.next_batch()
        aux = tuple(torch.from_numpy(a).to(dev)
                    for a in scatter.compact_aux(ids, CAP))
        batches.append((*(torch.from_numpy(a).to(dev)
                          for a in (ids, vals, labels, weights)), aux))
    row = row_spec.init(torch.Generator(device=dev).manual_seed(23), dev)
    col_e = {"w0": row["w0"].clone(),
             "vw": [t.t().contiguous() for t in row["vw"]]}
    col_g = {"w0": col_e["w0"].clone(), "vw": [t.clone() for t in col_e["vw"]]}
    rbody = sparse.make_field_sparse_sgd_body(row_spec, cfg)
    cbody = sparse.make_field_sparse_sgd_body(col_spec, cfg)
    cstep = sparse.make_field_sparse_sgd_step(col_spec, cfg)
    walls = {"row_eager": [], "col_eager": [], "col_captured": []}
    losses = []
    for j, batch in enumerate(batches):
        for name, fn in (("row_eager", lambda: rbody(row, j, *batch)),
                         ("col_eager", lambda: cbody(col_e, j, *batch)),
                         ("col_captured", lambda: cstep(col_g, j, *batch))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, loss = fn()
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3)
            losses.append((name, loss))
        lr_, le, lg = (x[1] for x in losses[-3:])
        _check(_same_bits(le, lg) and _same_tree(col_e, col_g),
               f"leg D: the captured col step {j} != the eager one")
        _check(_same_bits(lr_, le) and _same_bits(row["w0"], col_e["w0"])
               and all(_same_bits(r, c.t()) for r, c in
                       zip(row["vw"], col_e["vw"])),
               f"leg D: the col step {j} != the row step, transposed")
    out["col"] = {"steps": LAYOUT_STEPS, "bitwise": True,
                  "losses": [float(x[1]) for x in losses
                             if x[0] == "col_eager"],
                  "wall_ms": walls,
                  "capture_s": cstep.captured.capture_s}
    del row, col_g, rbody, cstep

    # The unfused form, fp32 scatter_add: eager against captured.
    un_spec = models.FieldFMSpec(**kw, fused_linear=False)
    ucfg = TrainConfig(batch_size=TRAIN_B, learning_rate=0.05,
                       reg_factors=1e-6, reg_linear=1e-6,
                       sparse_update="scatter_add")
    un_e = un_spec.init(torch.Generator(device=dev).manual_seed(29), dev)
    un_g = {"w0": un_e["w0"].clone(), "w": [t.clone() for t in un_e["w"]],
            "v": [t.clone() for t in un_e["v"]]}
    ubody = sparse.make_field_sparse_sgd_body(un_spec, ucfg)
    ustep = sparse.make_field_sparse_sgd_step(un_spec, ucfg)
    uwalls = {"eager": [], "captured": []}
    ulosses = []
    for j, batch in enumerate(batches):
        got = {}
        for name, fn in (("eager", lambda: ubody(un_e, j, *batch[:4])),
                         ("captured", lambda: ustep(un_g, j, *batch[:4]))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, got[name] = fn()
            torch.cuda.synchronize()
            uwalls[name].append((time.perf_counter() - t0) * 1e3)
        _check(_same_bits(got["eager"], got["captured"])
               and _same_tree(un_e, un_g),
               f"leg D: the captured unfused step {j} != the eager one")
        ulosses.append(float(got["eager"]))
    _check(all(np.isfinite(ulosses)), f"leg D: unfused losses {ulosses}")
    out["unfused"] = {"steps": LAYOUT_STEPS, "bitwise": True,
                      "losses": ulosses, "wall_ms": uwalls,
                      "capture_s": ustep.captured.capture_s}
    del un_g, ustep

    # Both forms' scores: the library path on the card against the same
    # formula on the CPU (fp32 compute), timed beside the row kernel.
    col32 = models.FieldFMSpec(**kw, param_dtype="bfloat16",
                               table_layout="col")
    row32 = models.FieldFMSpec(**kw, param_dtype="bfloat16")
    scores = {}
    n_check = 16384
    for name, spec, params in (("col", col32, col_e),
                               ("unfused", un_spec, un_e)):
        ids, vals = batches[0][0], batches[0][1]
        lib0 = ops.library_calls()["field_fm_scores_library"]
        launch0 = fused_fwd.launches
        got = spec.scores(params, ids[:n_check], vals[:n_check]).cpu()
        _check(ops.library_calls()["field_fm_scores_library"] == lib0 + 1
               and fused_fwd.launches == launch0,
               f"leg D: {name} scores not on the library path alone")
        host = {k: ([t.cpu() for t in v] if isinstance(v, list) else v.cpu())
                for k, v in params.items()}
        want = spec.scores(host, ids[:n_check].cpu(), vals[:n_check].cpu())
        _check(_close(got, want),
               f"leg D: {name} scores off the plain version by "
               f"{float((got - want).abs().max())}")
        entry = {"max_abs_err": float((got - want).abs().max())}
        for b in (512, TRAIN_B):
            entry[f"library_ms_B{b}"] = _median_ms(
                lambda r, b=b: spec.scores(params, ids[:b], vals[:b]),
                reps=10, hide_host_ms=2.0)
        scores[name] = entry
    # The kernel on the same values in the row layout, for comparison.
    row_tables = [t.t().contiguous() for t in col_e["vw"]]
    rparams = {"w0": col_e["w0"], "vw": row_tables}
    with _uncounted():
        for b in (512, TRAIN_B):
            scores["col"][f"row_kernel_ms_B{b}"] = _median_ms(
                lambda r, b=b: row32.scores(rparams, batches[0][0][:b],
                                            batches[0][1][:b]),
                reps=10, hide_host_ms=2.0)
    out["scores"] = scores


def stream_phase(dev, report):
    """Phase 19: training straight off raw-text shards (the stream, the
    quarantine policy, native ingest) and FieldFM's col and unfused
    forms."""
    import importlib
    import tempfile

    import numpy as np
    import torch

    from fm_spark_tpu_torch import native
    from fm_spark_tpu_torch.data import avazu
    from fm_spark_tpu_torch.ops import KERNEL_COUNTERS, kernel_launches

    root = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(root, exist_ok=True)
    base = tempfile.mkdtemp(prefix="stream.", dir=root)
    out = {"card": report["card"], "host_cpu": _host_cpu()}
    t_phase = time.perf_counter()
    try:
        native.load_fast()
        tsv = os.path.join(base, "day.tsv")
        _criteo_tsv(tsv, INGEST_ROWS, seed=14)
        with open(tsv, "rb") as f:
            lines = f.read().split(b"\n")[:-1]
        os.unlink(tsv)
        kinds = _corrupt_lines(lines, STREAM_BAD_FRAC, seed=19)
        paths = [os.path.join(base, f"s{i}.tsv") for i in range(3)]
        _shards_of(lines, paths)
        out["rows"] = len(lines)
        out["corrupted"] = {k: sum(v == k for v in kinds.values())
                            for k in ("field count", "label", "token")}

        # Leg C first: the parsers on the card's host, no card work.
        out["leg_c"] = {}
        _parsers_leg(base, lines, out["leg_c"])
        del lines

        # Counts start at 0 just before the main path and are read after.
        for _, mod, attr in KERNEL_COUNTERS:
            setattr(importlib.import_module(f"fm_spark_tpu_torch.ops.{mod}"),
                    attr, 0)
        q = [os.path.join(base, f"q{i}") for i in (1, 2)]
        ck = [os.path.join(base, f"ck{i}") for i in (1, 2)]
        mo = [os.path.join(base, f"m{i}") for i in (1, 2)]

        def leg_a(i):
            return ["train", "--config", "criteo1tb_fm_r64", "--data",
                    ",".join(paths), "--native-ingest", "--data-policy",
                    "quarantine", "--quarantine-dir", q[i], "--max-bad-frac",
                    0.05, "--test-fraction", 0, "--batch-size", TRAIN_B,
                    "--param-dtype", "bfloat16", "--compute-dtype",
                    "bfloat16", "--sparse-update", "dedup_sr",
                    "--host-dedup", "--compact-cap", CAP, "--fused-embed",
                    "require", "--steps", STREAM_STEPS, "--checkpoint-dir",
                    ck[i], "--checkpoint-every", 2, "--checkpoint-keep", 2,
                    "--model-out", mo[i]]
        # Leg A: uninterrupted; then killed after step 3 and resumed.
        t0 = time.perf_counter()
        full, full_sum = _cli(*leg_a(0))
        out["leg_a_full_s"] = time.perf_counter() - t0
        _check(full_sum["native_ingest"], f"leg A fell back: {full_sum}")
        killed = _kill_after(leg_a(1), STREAM_KILL_AT, ck[1])
        from torch.profiler import ProfilerActivity, profile
        from torch.autograd import DeviceType
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            rest, rest_sum = _cli(*leg_a(1))
        torch.cuda.synchronize()
        runs, _ = _symbol_counts([e for e in prof.events()
                                  if e.device_type == DeviceType.CUDA])
        lf, lr = _losses(full), _losses(rest)
        resumed = _one(rest, "resumed")
        _check(resumed["step"] in (2, 4) and lr and min(lr) > resumed["step"]
               and all(lr[k] == lf[k] for k in lr) and max(lr)
               == STREAM_STEPS, f"leg A: resumed at {resumed['step']}, "
               f"losses {lr} != the uninterrupted {lf}")
        _check(all(lf[k] == x["loss"] for x in killed["lines"]
                   if "loss" in x for k in [x["step"]]),
               "leg A: the killed run's losses differ")
        _check(_same_chain_step(_chain_step(ck[0], STREAM_STEPS),
                                _chain_step(ck[1], STREAM_STEPS)),
               "leg A: the resumed run's last step differs")
        with np.load(os.path.join(mo[0], "params.npz")) as a, \
                np.load(os.path.join(mo[1], "params.npz")) as b:
            _check(sorted(a.files) == sorted(b.files) and all(
                np.array_equal(a[k], b[k]) for k in a.files),
                "leg A: the resumed params.npz differs")
        # The CLI's quarantine line (the logger's carries no dead_letter).
        _one(full, "dead_letter")
        bf, gf = next((x["bad_records"], x["good_records"]) for x in full
                      if "dead_letter" in x)
        br, gr = next((x["bad_records"], x["good_records"]) for x in rest
                      if "dead_letter" in x)
        _check(_one(rest, "dead_letter") == os.path.join(
            q[1], "deadletter.jsonl"), "leg A: the dead-letter path")
        n_bad = len(kinds)
        cursor = _chain_step(ck[0], STREAM_STEPS)["pipeline"]
        _check(bf == br and gf == gr and cursor["epoch"] == 2
               and cursor["shard"] == 0 and cursor["offset"] == 0
               and bf == 2 * n_bad and gf == 2 * (INGEST_ROWS - n_bad),
               f"leg A: bad/good {bf}/{gf} vs resumed {br}/{gr}, cursor "
               f"{cursor}, {n_bad} corrupted lines")
        dl_full, dl_rest = _dead_letters(q[0]), _dead_letters(q[1])
        _check(dl_full == dl_rest and len(dl_full) == n_bad,
               f"leg A: dead letters {len(dl_full)} vs {len(dl_rest)}, "
               f"{n_bad} corrupted")
        eager_b = rest_sum["kernel_launches"]["fm_bwd_segment_totals"]
        eager_sr = rest_sum["kernel_launches"]["sr_bits"]
        replay_runs = {"fm_bwd_segment_totals": runs["fm_bwd_segment_totals"]
                       - eager_b, "sr_bits": runs["sr_bits"] - eager_sr}
        _check(all(v > 0 for v in replay_runs.values()),
               f"leg A: kernel B or sr_bits ran in no replay: {runs}, "
               f"eager {eager_b}, {eager_sr}")
        sps = {x["step"]: x.get("samples_per_sec") for x in full
               if "loss" in x}
        # End to end over steps 2..6: the samples of five steps over the
        # wall between the first and the last loss line (host input,
        # saves and steps; the first step's capture before the window).
        ts = {x["step"]: x["ts"] for x in full if "loss" in x}
        e2e = (STREAM_STEPS - 1) * TRAIN_B / (ts[STREAM_STEPS] - ts[1])
        packed = report.get("ingest", {}).get("leg_a", {}).get(
            "samples_per_s")
        out["leg_a"] = {
            "losses": lf, "resumed": resumed, "killed_last_good":
            killed["last_good"], "bad_records": bf, "good_records": gf,
            "dead_letters": len(dl_full), "samples_per_s": sps,
            "samples_per_s_steps_2_to_6": e2e,
            "full_run_s": out["leg_a_full_s"],
            "packed_dir_samples_per_s": packed,
            "ingest_rows_per_s": full_sum["ingest_rows_per_sec"],
            "step_ms": full_sum["step_ms"], "aux_ms": full_sum["aux_ms"],
            "replay_runs_by_symbol": replay_runs}
        for d in ck + mo:
            shutil.rmtree(d, ignore_errors=True)
        out["leg_a"]["profile"] = _stream_profile(dev, paths, base)
        _check(out["leg_a"]["profile"]["kernel_runs_per_step"] is None or
               out["leg_a"]["profile"]["kernel_runs_per_step"][
                   "fm_bwd_segment_totals"] > 0,
               f"leg A: no kernel B in the profiled steps: {out['leg_a']}")

        # Leg B: config 4 from an Avazu CSV in three shards, the header in
        # shard 0 only.
        csv = os.path.join(base, "train.csv")
        avazu.synthesize_csv(csv, STREAM_AVAZU_ROWS, seed=19)
        with open(csv, "rb") as f:
            alines = f.read().split(b"\n")[:-1]
        os.unlink(csv)
        apaths = [os.path.join(base, f"a{i}.csv") for i in range(3)]
        _shards_of(alines[1:], apaths, header=alines[0])
        before = kernel_launches()
        lines_b, sum_b = _cli(
            "train", "--config", "avazu_ffm_r16", "--data", ",".join(apaths),
            "--native-ingest", "--batch-size", INGEST_FFM_B,
            "--compute-dtype", "bfloat16", "--sel-blocked", "--fused-embed",
            "require", "--use-pallas", "--test-fraction", 0, "--steps", 3)
        got_b = {k: v - before[k] for k, v in kernel_launches().items()}
        lb = _losses(lines_b)
        _check(sum_b["native_ingest"] and sorted(lb) == [1, 2, 3]
               and all(np.isfinite(list(lb.values()))),
               f"leg B: {lb} {sum_b}")
        _check(all(got_b[k] > 0 for k in ("ffm_sel_scores", "ffm_sel_bwd",
                                          "gather_rows", "update_rows_add")),
               f"leg B: an FFM or row kernel never launched: {got_b}")
        out["leg_b"] = {"losses": lb, "launches": got_b,
                        "ingest_rows_per_s": sum_b["ingest_rows_per_sec"],
                        "step_ms": sum_b["step_ms"]}

        # Leg D: FieldFM's col and unfused forms.
        out["leg_d"] = {}
        _layouts_leg(dev, out["leg_d"])
        launches = kernel_launches()
        out["launches"] = launches
        for k in ("segment_totals", "fm_bwd_segment_totals", "sr_bits",
                  "ffm_sel_scores", "ffm_sel_bwd"):
            _check(launches[k] > 0, f"phase 19: {k} never launched: "
                   f"{launches}")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print("stream", json.dumps(out), flush=True)
    a = out["leg_a"]
    print(f"phase 19 ({report['card']}): parse rows/s native "
          f"{out['leg_c']['native_rows_per_s']:.0f}, python "
          f"{out['leg_c']['python_rows_per_s']:.0f}; leg A samples/s "
          f"{a['samples_per_s_steps_2_to_6']:.0f} over steps 2-6, per step "
          f"{a['samples_per_s']} (packed dir {a['packed_dir_samples_per_s']});"
          f" profiled step {a['profile']['wall_ms_per_step']} ms, busy "
          f"{a['profile']['device_ms_per_step']} ms, idle share "
          f"{a['profile']['idle_share']}", flush=True)
    report["stream"] = out
    return launches


# ------------------------------------------------------------------ phase 20

#: Phase 20 at config 2's widths (flat FM, rank 32, fp32, 39 ids a row,
#: B = 16,384) over the tiered embedding store's ladder stream.
TIER_B, TIER_NNZ = 16384, 39
TIER_BUCKET, TIER_HOT, TIER_WORK = 1024, 48, 32  # the ladder's defaults
TIER_STEPS, TIER_PROFILED = 32, 3
TIER_RUNGS = (10_000_000, 100_000_000, 1_000_000_000)
TIER_LR = 0.05
TIER_KILL_EVICTION = 10
ONLINE_ROWS, ONLINE_DAYS, ONLINE_DRIFT = 1 << 19, 8, 5
ONLINE_SHARD_ROWS, ONLINE_SHARD_B = 2048, 512
DIVERGE_AT, DIVERGE_EVERY = 10, 4


def _tier_stream(n_features: int, steps: int, seed: int = 0) -> list:
    """The reference ladder's id stream (``bench_embed.py``'s
    ``_batch_stream``, copied: that script imports the JAX package): each
    step draws its buckets Zipf-style from a window of ``TIER_WORK``
    buckets whose base drifts one bucket a step, an offset uniform in the
    bucket, ``vals`` standard normal, labels Bernoulli(0.3)."""
    import numpy as np

    n_buckets = n_features // TIER_BUCKET
    rng = np.random.default_rng(np.random.SeedSequence([seed, n_features]))
    ranks = np.arange(1, TIER_WORK + 1, dtype=np.float64)
    probs = (1.0 / ranks) / np.sum(1.0 / ranks)
    out = []
    for i in range(steps):
        base = i % max(n_buckets - TIER_WORK, 1)
        b = rng.choice(TIER_WORK, size=(TIER_B, TIER_NNZ), p=probs) + base
        ids = (b * TIER_BUCKET + rng.integers(
            0, TIER_BUCKET, (TIER_B, TIER_NNZ))).astype(np.int64)
        vals = rng.standard_normal((TIER_B, TIER_NNZ)).astype(np.float32)
        labels = (rng.random(TIER_B) < 0.3).astype(np.float32)
        out.append((ids, vals, labels, np.ones(TIER_B, np.float32)))
    return out


class _ListSource:
    """A resumable batch source over a list (``state``/``restore``)."""

    def __init__(self, batches, start: int = 0):
        self.batches, self.i = batches, start

    def state(self):
        return {"i": self.i}

    def restore(self, state):
        self.i = int(state["i"])

    def __iter__(self):
        return self

    def __next__(self):
        if self.i >= len(self.batches):
            raise StopIteration
        self.i += 1
        return self.batches[self.i - 1]


def _tier_config(opt: str, n_features: int):
    """Config 2's spec at ``n_features`` rows, and the tiered config."""
    from fm_spark_tpu_torch import configs
    from fm_spark_tpu_torch.train import TrainConfig

    spec = configs.get_config("criteo_kaggle_fm_r32").spec(n_features)
    cfg = TrainConfig(num_steps=TIER_STEPS, batch_size=TIER_B,
                      learning_rate=TIER_LR, lr_schedule="constant",
                      optimizer=opt, embed_tier="require",
                      hot_rows=TIER_HOT * TIER_BUCKET,
                      embed_bucket_rows=TIER_BUCKET, seed=0)
    return spec, cfg


def _rss_bytes() -> int:
    """This process's resident set now (``VmRSS``)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


def _tiered_run(dev, spec, cfg, batches, profile_batches, cold="dense"):
    """One tiered run: ``TIER_STEPS`` steps through the prefetcher (depth
    2), then ``TIER_PROFILED`` more steps through a new prefetcher under
    the profiler. Returns the trainer, its losses, its merged planes
    after the ``TIER_STEPS`` steps (dense cold mode) and its figures."""
    import resource

    import torch

    from fm_spark_tpu_torch.embed import BucketPrefetcher, TieredTrainer

    rss0 = _rss_bytes()
    torch.cuda.reset_peak_memory_stats(dev)
    trainer = TieredTrainer(spec, cfg, device=dev, cold=cold)
    bb_ms = []
    begin = trainer.store.begin_batch

    def timed(ids, hot):
        t0 = time.perf_counter()
        out = begin(ids, hot)
        bb_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    trainer.store.begin_batch = timed
    t0 = time.perf_counter()
    trainer.fit(iter(batches), num_steps=len(batches), prefetch=2)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    st = trainer.store.stats()
    losses = list(trainer.loss_history)
    merged = None if cold == "lazy" else _merged_planes(trainer)
    pf = BucketPrefetcher(iter(profile_batches), trainer.store, depth=2)
    try:
        prof = _profile_calls(lambda j: trainer.step_batch(*next(pf)),
                              range(len(profile_batches)))
    finally:
        pf.close()
    n = len(batches)
    out = {"steps": n, "seconds": wall, "examples_per_s": n * TIER_B / wall,
           "rows_gathered_per_s": n * TIER_B * TIER_NNZ / wall,
           "begin_batch_ms": {"median": statistics.median(bb_ms[:n]),
                              "max": max(bb_ms[:n])},
           "hit_rate": st["hit_rate"], "misses": st["misses"],
           "staged_hits": st["staged_hits"], "evictions": st["evictions"],
           "stall_ms": st["stall_ms"], "bytes_h2d": st["bytes_h2d"],
           "bytes_d2h": st["bytes_d2h"],
           "prefetch_stale": st["prefetch_stale"],
           "cold_host_bytes": trainer.store.cold.host_bytes(),
           "touched_buckets": trainer.store.cold.touched_buckets(),
           "rss_growth_bytes": _rss_bytes() - rss0,
           "peak_rss_bytes": resource.getrusage(
               resource.RUSAGE_SELF).ru_maxrss * 1024,
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
           "capture_s": trainer._step.captured.capture_s,
           "profile": prof}
    return trainer, losses, merged, out


def _untiered_run(dev, spec, cfg, batches, profile_batches):
    """The captured in-memory step over the whole table, from the tiered
    trainer's init (``spec.init`` by a generator on the card seeded by
    ``cfg.seed``): losses, the planes and the slot planes on the host,
    and its figures."""
    import dataclasses

    import numpy as np
    import torch

    from fm_spark_tpu_torch import optim, sparse

    off = dataclasses.replace(cfg, embed_tier="off")
    params = spec.init(torch.Generator(device=dev).manual_seed(cfg.seed),
                       device=dev)
    slots = None
    if cfg.optimizer == "sgd":
        step = sparse.make_sparse_sgd_step(spec, off)
    else:
        slots = optim.init_adaptive_slots(cfg.optimizer, spec, params)
        if cfg.optimizer == "ftrl":
            optim.seed_ftrl_slots(slots, params, cfg.learning_rate, 1.0)
        step = optim.make_sparse_adaptive_step(spec, off)

    def run(i, batch):
        b = [torch.from_numpy(a).to(dev) for a in batch]
        if slots is None:
            return step(params, i, *b)[1]
        return step(params, slots, *b)[2]

    t0 = time.perf_counter()
    losses = [float(run(i, b)) for i, b in enumerate(batches)]
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    on_dev = [[torch.from_numpy(a).to(dev) for a in b]
              for b in profile_batches]
    n = len(batches)

    def replay(j):
        b = on_dev[j]
        if slots is None:
            step(params, n + j, *b)
        else:
            step(params, slots, *b)

    from fm_spark_tpu_torch.embed.store import to_host

    # A bf16 table as its bits, as the cold tier keeps it.
    planes = {k: to_host(v.cpu()).copy() for k, v in params.items()}
    for table, d in (slots or {}).items():
        for key, t in d.items():
            planes[f"{table}_{key}"] = np.array(t.cpu())
    prof = _profile_calls(replay, range(len(on_dev)))
    out = {"seconds": wall, "examples_per_s": n * TIER_B / wall,
           "capture_s": step.captured.capture_s, "profile": prof,
           "table_bytes": sum(a.nbytes for a in planes.values())}
    del params, slots, on_dev
    torch.cuda.empty_cache()
    return losses, planes, out


def _merged_planes(trainer) -> dict:
    """A tiered trainer's merged planes (params and slots, the slot
    planes as ``<table>_<slot>``) and ``w0``, on the host."""
    merged = trainer.store.merged_planes(trainer.hot)
    merged["w0"] = trainer._w0.cpu().numpy().copy()
    return merged


def _tier_leg_a(dev, out):
    """Leg A: tiered equals untiered on the card at 10,000,384 features,
    for sgd, ftrl and adagrad. Returns FTRL's merged planes (leg C's
    reference) and the batches."""
    import numpy as np

    n_features = -(-TIER_RUNGS[0] // TIER_BUCKET) * TIER_BUCKET
    batches = _tier_stream(n_features, TIER_STEPS + TIER_PROFILED)
    main, extra = batches[:TIER_STEPS], batches[TIER_STEPS:]
    out["leg_a"] = {"num_features": n_features}
    ftrl = None
    for opt in ("sgd", "ftrl", "adagrad"):
        spec, cfg = _tier_config(opt, n_features)
        trainer, losses, merged, tiered = _tiered_run(dev, spec, cfg, main,
                                                      extra)
        del trainer
        want_losses, want, untiered = _untiered_run(dev, spec, cfg, main,
                                                    extra)
        _check(losses == want_losses,
               f"phase 20 leg A {opt}: tiered losses differ from the "
               f"untiered step's: {losses[:4]} vs {want_losses[:4]}")
        _check(sorted(merged) == sorted(want) and all(
            np.array_equal(merged[k], want[k]) for k in want),
            f"phase 20 leg A {opt}: a merged plane differs from the "
            f"untiered step's ({sorted(merged)} vs {sorted(want)})")
        _check(tiered["evictions"] > 0 and tiered["staged_hits"] > 0,
               f"phase 20 leg A {opt}: no churn or no staged install: "
               f"{tiered}")
        runs = tiered["profile"].get("kernel_runs_per_step")
        _check(runs is None or runs["segment_totals"] >= 1,
               f"phase 20 leg A {opt}: kernel A in no replayed step: {runs}")
        out["leg_a"][opt] = {"tiered": tiered, "untiered": untiered,
                             "bitwise": True, "losses_first_last": [
                                 losses[0], losses[-1]]}
        if opt == "ftrl":
            ftrl = merged
        del merged, want
    return ftrl, main


def _tier_kernel_a(dev, batches) -> dict:
    """Kernel A against its plain version at the tiered step's shape: the
    B·nnz lanes of one batch sorted by their global ids, w = 33, cap =
    B·nnz (the device dedup's form)."""
    import torch

    from fm_spark_tpu_torch.ops import scatter

    ids = torch.from_numpy(batches[0][0]).to(dev).reshape(-1)
    order, _, _, seg = scatter._sort_segments(ids)
    gen = torch.Generator(device=dev).manual_seed(20)
    delta = torch.randn(ids.shape[0], 33, generator=gen, device=dev)
    return _kernel_a_row(dev, "tiered step (global keys)", delta, seg,
                         ids.shape[0], order.to(torch.int32), False)


def _tier_leg_b(dev, out) -> None:
    """Leg B: the lazy rungs (100M and 1B features, sgd)."""
    out["leg_b"] = {}
    for nominal in TIER_RUNGS[1:]:
        n_features = -(-nominal // TIER_BUCKET) * TIER_BUCKET
        batches = _tier_stream(n_features, TIER_STEPS + TIER_PROFILED)
        spec, cfg = _tier_config("sgd", n_features)
        trainer, losses, _, rung = _tiered_run(
            dev, spec, cfg, batches[:TIER_STEPS], batches[TIER_STEPS:],
            cold="lazy")
        per_bucket = TIER_BUCKET * 33 * 4
        _check(rung["cold_host_bytes"]
               == rung["touched_buckets"] * per_bucket
               and rung["touched_buckets"] <= TIER_WORK + TIER_STEPS
               + TIER_PROFILED, f"phase 20 leg B {nominal}: cold bytes "
               f"{rung['cold_host_bytes']} for {rung['touched_buckets']} "
               "touched buckets")
        # Host memory tracks the touched buckets: the batches, the lazy
        # store and the step's buffers, far below the axis (132 GB at 1B).
        _check(rung["rss_growth_bytes"] < 4 << 30,
               f"phase 20 leg B {nominal}: RSS grew "
               f"{rung['rss_growth_bytes']} bytes")
        import math

        _check(all(math.isfinite(x) for x in losses),
               f"phase 20 leg B {nominal}: a loss is not finite")
        rung.update(num_features=n_features,
                    axis_bytes=n_features * 33 * 4,
                    losses_first_last=[losses[0], losses[-1]])
        out["leg_b"][str(nominal)] = rung
        del trainer, batches


class _InjectAt:
    """``faults.inject`` raising an injected fault at the ``at``-th call
    of ``point``."""

    def __init__(self, point: str, at: int):
        self.point, self.at, self.n = point, at, 0

    def __call__(self, point):
        if point == self.point:
            self.n += 1
            if self.n == self.at:
                from fm_spark_tpu_torch.resilience import faults

                raise faults.FaultInjected(
                    f"injected fault at {point}#{self.n}")


def _tier_leg_c(dev, base, batches, golden) -> dict:
    """Leg C: FTRL at leg A's sizes with a chain saved every 16 steps,
    killed at the 10th eviction (``embed_evict``), resumed by a new
    trainer: its merged planes after 32 steps equal leg A's FTRL run's."""
    import numpy as np

    from fm_spark_tpu_torch.checkpoint import Checkpointer
    from fm_spark_tpu_torch.embed import TieredTrainer
    from fm_spark_tpu_torch.resilience import faults

    n_features = -(-TIER_RUNGS[0] // TIER_BUCKET) * TIER_BUCKET
    spec, cfg = _tier_config("ftrl", n_features)
    ckdir = os.path.join(base, "tier_ck")
    t0 = time.perf_counter()
    first = TieredTrainer(spec, cfg, device=dev)
    ck = Checkpointer(ckdir, save_every=16, max_to_keep=2)
    inject = faults.inject
    faults.inject = _InjectAt("embed_evict", TIER_KILL_EVICTION)
    try:
        try:
            first.fit(_ListSource(batches), num_steps=TIER_STEPS,
                      checkpointer=ck, prefetch=2)
            killed = None
        except faults.FaultInjected as e:
            killed = str(e)
    finally:
        faults.inject = inject
        ck.close()
    killed_at = first.step_count
    _check(killed is not None and 0 < killed_at < TIER_STEPS,
           f"phase 20 leg C: the fault did not stop the run ({killed}, step "
           f"{killed_at})")
    del first
    second = TieredTrainer(spec, cfg, device=dev)
    ck = Checkpointer(ckdir, save_every=16, max_to_keep=2)
    second.fit(_ListSource(batches), num_steps=TIER_STEPS, checkpointer=ck,
               prefetch=2)
    resumed_from = (ck.restore_timing or {}).get("step")
    ck.close()
    merged = _merged_planes(second)
    _check(second.step_count == TIER_STEPS and sorted(merged)
           == sorted(golden) and all(np.array_equal(merged[k], golden[k])
                                     for k in golden),
           "phase 20 leg C: the resumed run's merged planes differ from "
           "the uninterrupted run's")
    shutil.rmtree(ckdir, ignore_errors=True)
    return {"killed_at_step": killed_at, "resumed_from": resumed_from,
            "fault": killed, "seconds": time.perf_counter() - t0,
            "saves": len(ck.timings), "bitwise": True}


def _online_argv(ckdir: str, ledger: str, model_out: str) -> list:
    return ["train", "--config", "criteo_kaggle_fm_r32", "--synthetic",
            ONLINE_ROWS, "--online", "--online-days", ONLINE_DAYS,
            "--drift-inject", ONLINE_DRIFT, "--optimizer", "ftrl",
            "--batch-size", TIER_B, "--steps", 0, "--checkpoint-dir", ckdir,
            "--quality-ledger", ledger, "--model-out", model_out]


#: Phase 20's ``fmtorch`` subprocesses, stopped at the phase's end
#: whatever happened (a failed check exits while they may still run).
_SPAWNED: list = []


def _spawn(argv):
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "fm_spark_tpu_torch", *map(str, argv)],
        cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    _SPAWNED.append(proc)
    return proc


def _finish(proc, what: str, timeout: float = 600) -> list:
    """The JSON lines a subprocess printed; it must exit 0."""
    out, err = proc.communicate(timeout=timeout)
    _check(proc.returncode == 0,
           f"phase 20 {what}: exit {proc.returncode}: {err[-3000:]}")
    return [json.loads(x) for x in out.splitlines() if x.startswith("{")]


def _ledger_auc(path: str) -> dict:
    """eval day -> AUC (the newest record of each day) of a quality
    ledger."""
    out = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            out[rec["day"]] = rec["value"]
    return out


def _spans(ckdir: str) -> dict:
    """The online run's per-day train and eval seconds from its
    trace.jsonl spans."""
    out = {"train_s": {}, "eval_s": {}}
    with open(os.path.join(ckdir, "trace.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("event") != "span":
                continue
            key = {"online/train_day": "train_s",
                   "online/eval_day": "eval_s"}.get(rec["name"])
            if key:
                out[key][rec["day"]] = rec["dur_ms"] / 1e3
    return out


def _online_profiled(dev) -> dict:
    """The online loop in this process at config 2's width (FTRL, B =
    16,384, four days of one step) under the profiler: kernel A's runs in
    the dense step's replays, by symbol."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fm_spark_tpu_torch import configs, data, online
    from fm_spark_tpu_torch.checkpoint import Checkpointer
    from fm_spark_tpu_torch.ops import kernel_launches
    from fm_spark_tpu_torch.train import FMTrainer

    cfg = configs.get_config("criteo_kaggle_fm_r32", optimizer="ftrl")
    spec = cfg.spec()
    tcfg = cfg.train_config(num_steps=0, batch_size=TIER_B, log_every=10**6)
    ids, vals, labels = data.synthetic_ctr(4 * TIER_B, spec.num_features, 39,
                                           seed=21)
    days = online.split_days(ids, vals, labels, 4)
    trainer = FMTrainer(spec, tcfg, device=dev)
    trainer.logger._stream = open(os.devnull, "w")
    ckdir = os.path.join(HERE, "build", "chip_smoke", "online_prof")
    shutil.rmtree(ckdir, ignore_errors=True)
    ck = Checkpointer(ckdir, save_every=10**9)
    before = kernel_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        summary = online.run_online(trainer, days, ck,
                                    sentry=online.drift_guard())
        torch.cuda.synchronize(dev)
    ck.close()
    trainer.logger._stream.close()
    shutil.rmtree(ckdir, ignore_errors=True)
    eager = kernel_launches()["segment_totals"] - before["segment_totals"]
    runs, _ = _symbol_counts([e for e in prof.events()
                              if e.device_type == DeviceType.CUDA])
    steps = summary["final_step"]
    return {"steps": steps, "eager_launches": eager,
            "replay_runs": runs["segment_totals"] - eager,
            "runs_per_replayed_step": (runs["segment_totals"] - eager)
            / steps}


def _tier_leg_d(dev, base, report) -> dict:
    """Leg D: ``fmtorch train --online`` at config 2's width."""
    import signal

    import numpy as np
    import torch

    from fm_spark_tpu_torch import configs
    from fm_spark_tpu_torch.checkpoint import ChainFollower
    from fm_spark_tpu_torch.serve import PredictEngine, ReloadFollower
    from fm_spark_tpu_torch.utils.logging import EventLog

    out = {}
    d = {k: os.path.join(base, k) for k in (
        "ck_full", "ck_kill", "mo_full", "mo_kill", "ck_shards")}
    led = {k: os.path.join(base, f"{k}.jsonl") for k in ("full", "kill")}
    t0 = time.perf_counter()
    full = _spawn(_online_argv(d["ck_full"], led["full"], d["mo_full"]))
    kill = _spawn(_online_argv(d["ck_kill"], led["kill"], d["mo_kill"]))
    # A follower on the uninterrupted run's chain while it trains.
    spec = configs.get_config("criteo_kaggle_fm_r32").spec()
    init = spec.init(torch.Generator(device=dev).manual_seed(7), device=dev)
    journal = EventLog()
    eng = PredictEngine(spec, init, nnz=TIER_NNZ, buckets=(16,), device=dev,
                        journal=journal)
    eng.warmup()
    fol = None
    at_swap_tombstoned = []
    # The run to kill: SIGKILL once day 3's save is the chain's last good
    # step (step 16), before that run's next save.
    good = os.path.join(d["ck_kill"], "last_good.json")
    target = 4 * (ONLINE_ROWS // ONLINE_DAYS // TIER_B)
    killed = False
    deadline = time.time() + 600
    while time.time() < deadline and (full.poll() is None or not killed):
        if not killed:
            with contextlib.suppress(OSError, ValueError, KeyError):
                with open(good) as f:
                    if json.load(f)["step"] >= target:
                        kill.send_signal(signal.SIGKILL)
                        kill.wait(timeout=60)
                        killed = True
            if kill.poll() is not None and not killed:
                break
        if fol is None and os.path.exists(os.path.join(d["ck_full"],
                                                       "last_good.json")):
            fol = ReloadFollower(eng, d["ck_full"], journal=journal)
        if fol is not None and fol.poll_once() == "swapped":
            if eng.generation().step in fol.chain.tombstoned_steps():
                at_swap_tombstoned.append(eng.generation().step)
        time.sleep(0.005 if not killed else 0.1)
    _check(killed and kill.returncode == -signal.SIGKILL,
           f"phase 20 leg D: the run to kill exited {kill.returncode}")
    kill.stdout.close()
    kill.stderr.close()
    full_lines = _finish(full, "leg D (uninterrupted)")
    out["full_s"] = time.perf_counter() - t0
    summary = [x["online"] for x in full_lines if "online" in x][-1]
    stones = ChainFollower(d["ck_full"]).tombstoned_steps()
    rolled = [x["eval_day"] for x in summary["days"] if x["rolled_back"]]
    _check(summary["rollbacks"] >= 1 and summary["demoted_steps"]
           and rolled and rolled[0] == ONLINE_DRIFT
           and summary["last_good"] not in stones
           and set(summary["demoted_steps"]) <= stones,
           f"phase 20 leg D: the sentry did not fire at day {ONLINE_DRIFT}:"
           f" {summary}")
    # The follower ends on the republished tip, never a tombstoned step.
    if fol is None:
        fol = ReloadFollower(eng, d["ck_full"], journal=journal)
    for _ in range(3):
        fol.poll_once()
    swapped = [e["step"] for e in journal.records
               if e["event"] == "serve_swap"]
    _check(not at_swap_tombstoned and eng.generation().step
           == summary["last_good"] and eng.generation().step not in stones,
           f"phase 20 leg D: the follower served {eng.generation().step} "
           f"(last good {summary['last_good']}, tombstoned at swap "
           f"{at_swap_tombstoned})")
    fol.stop()
    eng.close()
    out["follower"] = {"swaps": swapped, "final_step": swapped[-1],
                       "later_demoted": sorted(set(swapped) & stones)}
    # The killed run resumed by the same command (and, beside it, the run
    # from day shards).
    events = [json.loads(x) for x in open(os.path.join(d["ck_kill"],
                                                       "health.jsonl"))]
    out["kill"] = {"killed_after_step": target, "eval_day_4_done_before_kill":
                   any(e["event"] == "quality_eval" and e["eval_day"] == 4
                       for e in events)}
    resume = _spawn(_online_argv(d["ck_kill"], led["kill"], d["mo_kill"]))
    shards = [os.path.join(base, f"day{i}.tsv") for i in range(4)]
    tsv = os.path.join(base, "days.tsv")
    _criteo_tsv(tsv, 4 * ONLINE_SHARD_ROWS, seed=14)
    with open(tsv, "rb") as f:
        lines = f.read().split(b"\n")[:-1]
    os.unlink(tsv)
    for i, p in enumerate(shards):
        with open(p, "wb") as f:
            f.write(b"\n".join(lines[i * ONLINE_SHARD_ROWS:
                                     (i + 1) * ONLINE_SHARD_ROWS]) + b"\n")
    shard_run = _spawn(["train", "--config", "criteo_kaggle_fm_r32",
                        "--data", ",".join(shards), "--online", "--optimizer",
                        "ftrl", "--batch-size", ONLINE_SHARD_B, "--steps", 0,
                        "--checkpoint-dir", d["ck_shards"]])
    t1 = time.perf_counter()
    resumed = [x["online"] for x in _finish(resume, "leg D (resumed)")
               if "online" in x][-1]
    out["resumed_s"] = time.perf_counter() - t1
    events = [json.loads(x) for x in open(os.path.join(d["ck_kill"],
                                                       "health.jsonl"))]
    res_ev = [e for e in events if e["event"] == "online_resume"]
    _check(res_ev and res_ev[-1]["evals_done"] < res_ev[-1]["start_day"]
           and resumed["days"][0]["eval_day"] == res_ev[-1]["start_day"]
           == 4, f"phase 20 leg D: the resumed run did not replay the "
           f"pending eval: {res_ev} {resumed['days'][:1]}")
    auc_full, auc_kill = _ledger_auc(led["full"]), _ledger_auc(led["kill"])
    _check(auc_full == auc_kill and resumed["demoted_steps"]
           == summary["demoted_steps"] and resumed["final_step"]
           == summary["final_step"], f"phase 20 leg D: the resumed run's "
           f"AUC series {auc_kill} / demoted {resumed['demoted_steps']} "
           f"differ from {auc_full} / {summary['demoted_steps']}")
    with np.load(os.path.join(d["mo_full"], "params.npz")) as a, \
            np.load(os.path.join(d["mo_kill"], "params.npz")) as b:
        _check(sorted(a.files) == sorted(b.files) and all(
            np.array_equal(a[k], b[k]) for k in a.files),
            "phase 20 leg D: the resumed run's params differ")
    shard_lines = _finish(shard_run, "leg D (day shards)")
    shard_sum = [x["online"] for x in shard_lines if "online" in x][-1]
    _check(shard_sum["days_trained"] == 3 and shard_sum["rollbacks"] == 0
           and shard_sum["records_seen"] == 3 * ONLINE_SHARD_ROWS,
           f"phase 20 leg D: the day-shard run: {shard_sum}")
    spans = _spans(d["ck_full"])
    out.update(
        auc_by_eval_day=auc_full, rolled_back_at=rolled,
        demoted_steps=summary["demoted_steps"],
        last_good=summary["last_good"], final_step=summary["final_step"],
        rollbacks=summary["rollbacks"], train_s_by_day=spans["train_s"],
        eval_s_by_day=spans["eval_s"], resumed_bitwise=True,
        shards={"auc": [x["auc"] for x in shard_sum["days"]],
                "records_seen": shard_sum["records_seen"],
                "spans": _spans(d["ck_shards"])})
    out["profiled"] = _online_profiled(dev)
    _check(out["profiled"]["replay_runs"] > 0,
           f"phase 20 leg D: kernel A in no online replay: "
           f"{out['profiled']}")
    for p in list(d.values()) + list(led.values()) + shards:
        shutil.rmtree(p, ignore_errors=True)
        with contextlib.suppress(OSError):
            os.unlink(p)
    return out


class _Poisoned:
    """A resumable batch source whose ``at``-th batch (from 1, counted on
    its cursor) has its ``vals`` scaled to overflow float32 scores."""

    def __init__(self, inner, at):
        self.inner, self.at, self.n = inner, at, 0

    def state(self):
        return {"inner": self.inner.state(), "n": self.n}

    def restore(self, state):
        self.inner.restore(state["inner"])
        self.n = int(state["n"])

    def next_batch(self):
        ids, vals, labels, weights = self.inner.next_batch()
        self.n += 1
        if self.n == self.at:
            vals = vals * 1e30
        return ids, vals, labels, weights

    def __iter__(self):
        return self

    def __next__(self):
        return self.next_batch()


def _tier_leg_e(dev, base) -> dict:
    """Leg E: ``FMTrainer.fit(divergence_guard=...)`` at config 2 with
    FTRL and a chain every 4 steps; batch 10 poisoned; the run rolls back
    and ends at the reduced target, its params and FTRL state equal to an
    unpoisoned run's at that step."""
    from fm_spark_tpu_torch import configs, data
    from fm_spark_tpu_torch.checkpoint import Checkpointer
    from fm_spark_tpu_torch.resilience.divergence import DivergenceGuard
    from fm_spark_tpu_torch.train import FMTrainer
    from fm_spark_tpu_torch.utils.logging import EventLog

    cfg = configs.get_config("criteo_kaggle_fm_r32", optimizer="ftrl")
    spec = cfg.spec()
    tcfg = cfg.train_config(num_steps=12, batch_size=TIER_B, log_every=10**6)
    ids, vals, labels = data.synthetic_ctr(8 * TIER_B, spec.num_features, 39,
                                           seed=22)
    ckdir = os.path.join(base, "div_ck")
    journal = EventLog()
    guard = DivergenceGuard(spike_factor=10.0, journal=journal)
    t0 = time.perf_counter()
    poisoned = FMTrainer(spec, tcfg, device=dev)
    poisoned.logger._stream = open(os.devnull, "w")
    ck = Checkpointer(ckdir, save_every=DIVERGE_EVERY, journal=journal)
    poisoned.fit(_Poisoned(data.Batches(ids, vals, labels, TIER_B, seed=0),
                           DIVERGE_AT), num_steps=12, checkpointer=ck,
                 divergence_guard=guard)
    ck.close()
    clean = FMTrainer(spec, tcfg, device=dev)
    clean.logger._stream = poisoned.logger._stream
    clean.fit(data.Batches(ids, vals, labels, TIER_B, seed=0),
              num_steps=poisoned.step_count)
    poisoned.logger._stream.close()
    want = DIVERGE_AT - 1
    detected = [e for e in journal.records
                if e["event"] == "divergence_detected"]
    _check(guard.rollbacks == 1 and poisoned.step_count == want
           and detected and detected[0]["step"] == DIVERGE_AT
           and _same_tree(poisoned.params, clean.params)
           and _same_tree(poisoned.opt_state, clean.opt_state),
           f"phase 20 leg E: rollbacks {guard.rollbacks}, ended at "
           f"{poisoned.step_count} (want {want}), {detected}; params or "
           "state differ from the unpoisoned run's")
    shutil.rmtree(ckdir, ignore_errors=True)
    return {"detected_at": DIVERGE_AT, "reason": detected[0]["reason"],
            "restored_step": [e for e in journal.records if e["event"]
                              == "divergence_rollback"][0]["restored_step"],
            "final_step": poisoned.step_count, "bitwise": True,
            "seconds": time.perf_counter() - t0}


def tier_phase(dev, report):
    """Phase 20: the tiered embedding store and continuous learning at
    config 2's widths."""
    import gc
    import importlib
    import tempfile

    import torch

    from fm_spark_tpu_torch.ops import KERNEL_COUNTERS, kernel_launches

    root = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(root, exist_ok=True)
    base = tempfile.mkdtemp(prefix="tier.", dir=root)
    out = {"card": report["card"], "host_cpu": _host_cpu()}
    t_phase = time.perf_counter()
    try:
        with _uncounted():
            a_batches = _tier_stream(
                -(-TIER_RUNGS[0] // TIER_BUCKET) * TIER_BUCKET, 1)
            out["kernel_a"] = _tier_kernel_a(dev, a_batches)
            del a_batches
        # Counts start at 0 just before the main path and are read after.
        for _, mod, attr in KERNEL_COUNTERS:
            setattr(importlib.import_module(f"fm_spark_tpu_torch.ops.{mod}"),
                    attr, 0)
        t0 = time.perf_counter()
        golden, batches = _tier_leg_a(dev, out)
        out["leg_a"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["leg_c"] = _tier_leg_c(dev, base, batches, golden)
        del golden, batches
        gc.collect()
        t0 = time.perf_counter()
        _tier_leg_b(dev, out)
        out["leg_b"]["seconds"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        out["leg_d"] = _tier_leg_d(dev, base, report)
        out["leg_e"] = _tier_leg_e(dev, base)
        launches = kernel_launches()
        out["launches"] = launches
        _check(launches["segment_totals"] > 0,
               f"phase 20: kernel A never launched: {launches}")
    finally:
        for proc in _SPAWNED:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
        _SPAWNED.clear()
        shutil.rmtree(base, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print("tier", json.dumps(out), flush=True)
    a = out["leg_a"]
    for opt in ("sgd", "ftrl", "adagrad"):
        t, u = a[opt]["tiered"], a[opt]["untiered"]
        print(f"phase 20 ({report['card']}) leg A {opt} @ "
              f"{a['num_features']:,}: tiered {t['examples_per_s']:.0f} "
              f"ex/s (profile wall {t['profile']['wall_ms_per_step']} ms, "
              f"busy {t['profile']['device_ms_per_step']} ms, idle "
              f"{t['profile']['idle_share']}), begin_batch "
              f"{t['begin_batch_ms']['median']:.1f} ms, hit rate "
              f"{t['hit_rate']:.4f}, misses {t['misses']}, evictions "
              f"{t['evictions']}, stall {t['stall_ms']:.1f} ms, h2d "
              f"{t['bytes_h2d']} d2h {t['bytes_d2h']}; untiered busy "
              f"{u['profile']['device_ms_per_step']} ms/step", flush=True)
    for rung, r in out["leg_b"].items():
        if rung == "seconds":
            continue
        print(f"phase 20 ({report['card']}) leg B {rung}: "
              f"{r['examples_per_s']:.0f} ex/s, {r['rows_gathered_per_s']:.0f}"
              f" rows/s, hit rate {r['hit_rate']:.4f}, stall "
              f"{r['stall_ms']:.1f} ms, cold {r['cold_host_bytes']} B, RSS "
              f"+{r['rss_growth_bytes']} B (peak {r['peak_rss_bytes']}), card"
              f" {r['max_memory_allocated']} B", flush=True)
    d = out["leg_d"]
    print(f"phase 20 ({report['card']}) leg D: AUC {d['auc_by_eval_day']}, "
          f"rolled back at {d['rolled_back_at']}, demoted "
          f"{d['demoted_steps']}, train s {d['train_s_by_day']}, eval s "
          f"{d['eval_s_by_day']}; phase {out['phase_s']:.1f} s", flush=True)
    report["tier"] = out
    return launches


# ------------------------------------------------------------------ phase 21

#: Phase 21: the obs and fault planes at config 3's full width.
OBS_STEPS, OBS_COST_STEPS, OBS_SERVE_ROWS, OBS_SERVE_B = 4, 10, 4096, 512
OBS_SERVE_REPEAT, OBS_FAULT_B = 60, 16384


def _obs_train_argv(b: int, steps: int):
    """``fmtorch train`` of config 3 at full width (bf16 tables and
    compute, dedup_sr, the compact host aux at ``CAP``, kernel B) on
    ``b`` seeded synthetic rows, ``b`` a batch."""
    return ["train", "--config", "criteo1tb_fm_r64", "--synthetic", b,
            "--batch-size", b, "--steps", steps, "--param-dtype", "bfloat16",
            "--compute-dtype", "bfloat16", "--sparse-update", "dedup_sr",
            "--host-dedup", "--compact-cap", CAP, "--fused-embed", "require",
            "--test-fraction", 0, "--log-every", 1]


def _run_dir_of(root: str) -> str:
    names = os.listdir(root)
    _check(len(names) == 1, f"phase 21: want one run dir under {root}, got "
           f"{names}")
    return os.path.join(root, names[0])


def _jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(x) for x in f if x.strip()]


def _get(url: str) -> str:
    import urllib.request

    with urllib.request.urlopen(url, timeout=30) as resp:
        return resp.read().decode()


def _obs_train_leg(base: str, out: dict) -> str:
    """Leg A: ``fmtorch train`` with ``--obs-dir``, ``--profile``,
    ``--metrics`` and ``--metrics-port 0`` for ``OBS_STEPS`` steps and one
    save; the profile names the leg's kernels by symbol, the loss lines
    are finite and equal the metrics file's, the run dir parses. Returns
    the chain it saved."""
    import math

    obs_root, prof = os.path.join(base, "obs_a"), os.path.join(base, "prof")
    mfile, ck = os.path.join(base, "m.jsonl"), os.path.join(base, "ck")
    t0 = time.perf_counter()
    lines, summary = _cli(*_obs_train_argv(TRAIN_B, OBS_STEPS),
                          "--obs-dir", obs_root, "--profile", prof,
                          "--metrics", mfile, "--metrics-port", 0,
                          "--checkpoint-dir", ck, "--checkpoint-every",
                          OBS_STEPS)
    out["leg_a_s"] = time.perf_counter() - t0
    run = _run_dir_of(obs_root)
    _check(lines[0] == {"run_id": os.path.basename(run), "obs_dir": run},
           f"phase 21: the first line is not the run id: {lines[0]}")
    _check("metrics_port" in lines[1], f"phase 21: no port line {lines[1]}")
    losses = [x for x in lines if "loss" in x]
    _check([x["step"] for x in losses] == list(range(1, OBS_STEPS + 1))
           and all(math.isfinite(x["loss"]) for x in losses),
           f"phase 21: loss lines {losses}")
    _check(_jsonl(mfile) == losses, "phase 21: --metrics differs from the "
           "printed loss lines")
    files = sorted(os.listdir(run))
    _check(files == ["flight.jsonl", "flight_dump.json", "metrics.jsonl",
                     "trace.jsonl"], f"phase 21: run dir holds {files}")
    spans = {}
    for r in _jsonl(os.path.join(run, "trace.jsonl")):
        spans[r["name"]] = spans.get(r["name"], 0) + 1
    _check(spans.get("train/steps") == OBS_STEPS and spans.get(
        "checkpoint/save") == 1 and spans.get("checkpoint/verify") == 1,
        f"phase 21: spans {spans}")
    with open(os.path.join(run, "flight_dump.json")) as f:
        dump = json.load(f)
    snap = _jsonl(os.path.join(run, "metrics.jsonl"))[-1]
    _check(dump["reason"] == "run_end" and snap["counters"][
        "train.samples_total"] == OBS_STEPS * TRAIN_B,
        f"phase 21: dump {dump['reason']}, snapshot {snap['counters']}")
    launched = [k for k, v in summary["kernel_launches"].items() if v > 0]
    _check({"fm_bwd_segment_totals", "sr_bits"} <= set(launched),
           f"phase 21: leg A launched {summary['kernel_launches']}")
    with open(os.path.join(prof, "trace.json")) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
    named = {k: sum(any(sym in n for sym in KERNEL_SYMBOLS[k])
                    for n in names) for k in launched}
    _check(all(named.values()), f"phase 21: the profile misses kernels: "
           f"{named}")
    out["leg_a"] = {"losses": [x["loss"] for x in losses],
                    "samples_per_s": [x.get("samples_per_sec")
                                      for x in losses],
                    "step_ms": summary["step_ms"], "spans": spans,
                    "kernel_events_in_profile": named,
                    "profile_bytes": os.path.getsize(os.path.join(
                        prof, "trace.json")),
                    "capture_s": summary["capture_s"],
                    "saves": summary["saves"]}
    return ck


def _obs_serve_leg(dev, base: str, ck: str, out: dict) -> None:
    """Leg B: ``fmtorch serve`` of the chain leg A saved, with
    ``--slo-ms``, ``--metrics-port 0``, ``--obs-dir`` and ``--repeat``, in
    a thread of this process; ``/metrics`` and ``/healthz`` are scraped
    while it serves; ``serve_health.jsonl`` and the ``serve/batch`` spans
    are in its run dir; every answer matches the plain version."""
    import dataclasses
    import io

    import numpy as np

    from fm_spark_tpu_torch import cli, configs, data, obs
    from fm_spark_tpu_torch.checkpoint import ChainFollower
    from fm_spark_tpu_torch.models.io import param_names, unflatten
    from fm_spark_tpu_torch.obs import export

    obs_root, preds = os.path.join(base, "obs_b"), os.path.join(base, "p.txt")
    argv = ["serve", "--config", "criteo1tb_fm_r64", "--checkpoint-dir", ck,
            "--compute-dtype", "float32", "--synthetic", OBS_SERVE_ROWS,
            "--batch-size", OBS_SERVE_B, "--buckets", f"1,64,{OBS_SERVE_B}",
            "--repeat", OBS_SERVE_REPEAT, "--latency-budget-ms", 0,
            "--slo-ms", 1000, "--metrics-port", 0, "--obs-dir", obs_root,
            "--out", preds]
    result = {}
    stdout, stderr = io.StringIO(), io.StringIO()

    def serve():
        try:
            result["rc"] = cli.main([str(a) for a in argv])
        except BaseException as e:      # noqa: BLE001 — reported below
            result["error"] = repr(e)

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(
            stderr):
        th = threading.Thread(target=serve)
        th.start()
        give_up = time.monotonic() + 300
        while not (export._server is not None and obs.counter(
                "serve.requests_total").value > 0):
            _check(th.is_alive() and time.monotonic() < give_up,
                   f"phase 21: serve never served: {result}")
            time.sleep(0.01)
        url = export._server.url
        metrics = _get(url + "/metrics")
        health = json.loads(_get(url + "/healthz"))
        scraped_alive = th.is_alive()
        th.join(timeout=600)
    out["leg_b_s"] = time.perf_counter() - t0
    _check(result.get("rc") == 0, f"phase 21: serve: {result}, "
           f"{stderr.getvalue()[-3000:]}")
    _check(scraped_alive and 'fm_spark_serve_requests_total{run_id="' in
           metrics and health["status"] == "ok" and health["run_id"]
           and health["degraded"] is False,
           f"phase 21: scrape: alive {scraped_alive}, healthz {health}")
    lines = [json.loads(x) for x in stdout.getvalue().splitlines()
             if x.startswith("{")]
    summary = [x["serve_summary"] for x in lines if "serve_summary" in x][0]
    run = _run_dir_of(obs_root)
    _check(os.path.isfile(os.path.join(run, "serve_health.jsonl")),
           "phase 21: no serve_health.jsonl")
    n_batch = sum(r["name"] == "serve/batch"
                  for r in _jsonl(os.path.join(run, "trace.jsonl")))
    n_req = OBS_SERVE_REPEAT * OBS_SERVE_ROWS // OBS_SERVE_B
    _check(summary["served_requests"] == n_req and n_batch >= n_req,
           f"phase 21: {summary['served_requests']} requests, {n_batch} "
           "serve/batch spans")
    # The plain version on the chain's newest step, on the same rows, with
    # the spec serve built (the config's, fp32 compute, the chain's bf16).
    spec = dataclasses.replace(configs.get_config(
        "criteo1tb_fm_r64", compute_dtype="float32").spec(),
        param_dtype="bfloat16")
    names = param_names(spec)
    restored = ChainFollower(ck).restore(unflatten(dict.fromkeys(names),
                                                   names))
    params = {"w0": restored["params"]["w0"].to(dev),
              "vw": [t.to(dev) for t in restored["params"]["vw"]]}
    ids, vals, _ = data.synthetic_ctr(OBS_SERVE_ROWS, spec.num_features, F,
                                      seed=1)
    want = _plain_predict(spec, params, data.field_local(ids, BUCKET), vals,
                          dev).numpy()
    got = np.loadtxt(preds)
    _check(got.shape == (OBS_SERVE_REPEAT * OBS_SERVE_ROWS,),
           f"phase 21: serve wrote {got.shape} answers")
    err = float(np.abs(got - np.tile(want, OBS_SERVE_REPEAT)).max())
    # fp32 sums in another order (ATOL on the scores) through the sigmoid
    # (slope <= 1/4), printed with %.6g.
    _check(np.allclose(got, np.tile(want, OBS_SERVE_REPEAT), rtol=1e-5,
                       atol=ATOL / 4), f"phase 21: served answers off the "
           f"plain version by {err}")
    out["leg_b"] = {"served_requests": summary["served_requests"],
                    "request_ms": summary["request_ms"], "qps": summary["qps"],
                    "serve_batch_spans": n_batch, "max_abs_err": err,
                    "healthz": health, "scraped_while_serving": scraped_alive}


def _obs_fault_leg(base: str, out: dict) -> None:
    """Leg C: a planted ``train_step@2=device_loss`` on the card ends the
    run with the reference's device-loss class (``InjectedDeviceLoss``,
    ``is_device_loss``) and a flight dump that names it."""
    from fm_spark_tpu_torch import cli
    from fm_spark_tpu_torch.resilience import faults

    root = os.path.join(base, "obs_c")
    faults.activate("train_step@2=device_loss")
    raised = None
    try:
        with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
            cli.main([str(a) for a in (*_obs_train_argv(OBS_FAULT_B, 4),
                                       "--obs-dir", root)])
    except faults.InjectedDeviceLoss as e:      # the planted ending
        raised = e
    finally:
        faults.clear()
    _check(raised is not None and faults.is_device_loss(raised),
           f"phase 21: the planted device loss ended as {raised!r}")
    with open(os.path.join(_run_dir_of(root), "flight_dump.json")) as f:
        dump = json.load(f)
    failed = [e for e in dump["events"] if e["kind"] == "run_failed"
              and "error" in e]
    _check(dump["reason"] == "run_failed" and failed
           and failed[0]["device_loss"] is True,
           f"phase 21: flight dump {dump['reason']}, {failed}")
    out["leg_c"] = {"error": str(raised), "dump_reason": dump["reason"],
                    "events": [e["kind"] for e in dump["events"]]}


def _obs_cost_leg(base: str, out: dict) -> None:
    """Leg D: the plane's cost. The same captured config-3 step for
    ``OBS_COST_STEPS`` steps with ``--obs-dir none`` and with the plane on
    (spans, flight recorder, capture engine, live endpoint), one run each:
    each step's wall ms (the logger's host clock between loss lines, one
    step a window) and its CUDA-event ms (the step's device time), medians
    over the steps after the capture."""
    runs = []
    for i, on in enumerate((False, True)):
        extra = (["--obs-dir", os.path.join(base, f"obs_d{i}"),
                  "--metrics-port", 0] if on else ["--obs-dir", "none"])
        lines, summary = _cli(*_obs_train_argv(TRAIN_B, OBS_COST_STEPS),
                              *extra)
        wall = [TRAIN_B / x["samples_per_sec"] * 1e3 for x in lines
                if x.get("samples_per_sec")][1:]
        runs.append({"plane": "on" if on else "off",
                     "wall_ms": statistics.median(wall),
                     "event_ms": statistics.median(summary["step_ms"][2:])})
    med = {k: {p: statistics.median(r[k] for r in runs if r["plane"] == p)
               for p in ("off", "on")} for k in ("wall_ms", "event_ms")}
    out["leg_d"] = {"runs": runs, "median": med,
                    "wall_cost_share": med["wall_ms"]["on"]
                    / med["wall_ms"]["off"] - 1.0}


def obs_phase(dev, report):
    """Phase 21: the obs and fault planes wired into ``fmtorch train`` and
    ``fmtorch serve`` at config 3's full width."""
    import gc
    import importlib
    import tempfile

    import torch

    from fm_spark_tpu_torch.ops import KERNEL_COUNTERS, kernel_launches

    root = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(root, exist_ok=True)
    base = tempfile.mkdtemp(prefix="obs.", dir=root)
    out = {"card": report["card"], "host_cpu": _host_cpu()}
    t_phase = time.perf_counter()
    try:
        # Counts start at 0 just before the main path and are read after.
        for _, mod, attr in KERNEL_COUNTERS:
            setattr(importlib.import_module(f"fm_spark_tpu_torch.ops.{mod}"),
                    attr, 0)
        ck = _obs_train_leg(base, out)
        gc.collect()
        torch.cuda.empty_cache()
        _obs_serve_leg(dev, base, ck, out)
        gc.collect()
        torch.cuda.empty_cache()
        _obs_fault_leg(base, out)
        _obs_cost_leg(base, out)
        launches = kernel_launches()
        out["launches"] = launches
        for k in ("fm_bwd_segment_totals", "sr_bits", "fm_fused_scores"):
            _check(launches[k] > 0, f"phase 21: {k} never launched: "
                   f"{launches}")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print("obs", json.dumps(out), flush=True)
    d = out["leg_d"]["median"]
    print(f"phase 21 ({report['card']}): leg A {out['leg_a_s']:.1f} s, "
          f"leg B {out['leg_b_s']:.1f} s ({out['leg_b']['qps']} req/s, "
          f"request p50 {out['leg_b']['request_ms']['p50']} ms); captured "
          f"step wall ms off/on {d['wall_ms']['off']:.3f}/"
          f"{d['wall_ms']['on']:.3f}, CUDA-event ms off/on "
          f"{d['event_ms']['off']:.3f}/{d['event_ms']['on']:.3f}; phase "
          f"{out['phase_s']:.1f} s", flush=True)
    report["obs"] = out
    return launches



# ------------------------------------------------------------------ phase 22

#: Phase 22: training over torch.distributed at world 1 (one card, an
#: NCCL group of one rank), the field families' dense step, bf16 tiers.
PAR_STEPS, PAR_PROFILED = 3, 2
PAR_SMALL_BUCKET, PAR_SMALL_B = 1 << 12, 8192     # the reduced legs
PAR_TIER_STEPS = 24                     # the 48-bucket hot tier churns past 16


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _same_tables(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def _par_fm_leg(dev, mesh, out):
    """The field-sharded FieldFM step (bf16, dedup_sr, the device compact
    aux at ``CAP``, gfull + kernel A), captured, against the single-card
    fused step from the same params and bench batches at config 3's full
    width: losses and tables the same bits after every step."""
    import torch

    from fm_spark_tpu_torch import models, parallel, sparse
    from fm_spark_tpu_torch.train import TrainConfig

    spec = models.FieldFMSpec(
        num_features=F * BUCKET, rank=RANK, num_fields=F, bucket=BUCKET,
        init_std=0.01, param_dtype="bfloat16", compute_dtype="bfloat16")
    cfg = TrainConfig(batch_size=TRAIN_B, learning_rate=0.05,
                      reg_factors=1e-6, sparse_update="dedup_sr",
                      compact_device=True, compact_cap=CAP,
                      gfull_fused=True, segtotal_pallas=True)
    p1 = spec.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    stacked = parallel.stack_field_params(spec, p1, mesh.shape["feat"])
    p2 = parallel.shard_field_params(stacked, mesh)
    del stacked
    torch.cuda.empty_cache()
    single = sparse.make_field_sparse_sgd_step(spec, cfg)
    shard = parallel.make_field_sharded_sgd_step(spec, cfg, mesh)
    stream = BenchStream(0, batch=TRAIN_B, fields=F, bucket=BUCKET)
    on_dev = [[torch.from_numpy(a).to(dev) for a in stream.next_batch()]
              for _ in range(PAR_STEPS + PAR_PROFILED)]
    losses = []
    for i in range(PAR_STEPS):
        _, l1 = single(p1, i, *on_dev[i])
        # One rank: its rows are the whole batch, its fields all 39.
        _, l2 = shard(p2, i, *on_dev[i])
        _check(torch.equal(l1, l2), f"phase 22 fm step {i}: sharded loss "
               f"{float(l2)!r} != single-card {float(l1)!r}")
        _check(_same_tables(p1["vw"], p2["vw"])
               and torch.equal(p1["w0"], p2["w0"]),
               f"phase 22 fm step {i}: sharded tables differ from the "
               "single card's")
        losses.append(float(l2))
    _check(losses[-1] < losses[0], f"phase 22 fm: loss did not fall: {losses}")
    n = PAR_STEPS
    prof_1 = _profile_calls(lambda j: single(p1, n + j, *on_dev[n + j]),
                            range(PAR_PROFILED))
    prof_2 = _profile_calls(lambda j: shard(p2, n + j, *on_dev[n + j]),
                            range(PAR_PROFILED))
    _check(_same_tables(p1["vw"], p2["vw"]),
           "phase 22 fm: tables differ after the profiled steps")
    runs = prof_2.get("kernel_runs_per_step")
    _check(runs is None or (runs["segment_totals"] >= 1
                            and runs["sr_bits"] >= 1),
           f"phase 22 fm: kernel A or sr_bits in no replayed step: {runs}")
    out["fm"] = {"spec": "config 3, 39 x 262,144 x 65 bf16, B = 131,072",
                 "losses": losses, "bitwise": True,
                 "capture_s": {"single": single.captured.capture_s,
                               "sharded": shard.captured.capture_s},
                 "single": prof_1, "sharded": prof_2}
    del p1, p2, on_dev, single, shard
    torch.cuda.empty_cache()


def _par_small_legs(dev, mesh, out):
    """FieldFFM and FieldDeepFM's sharded steps against the single-card
    steps at reduced depth (``PAR_SMALL_BUCKET`` rows a field, B =
    ``PAR_SMALL_B``), and config 2 under ``dp`` (the NCCL mesh) against
    ``train.make_train_step`` at full width."""
    import numpy as np
    import torch

    from fm_spark_tpu_torch import configs, models, parallel, sparse
    from fm_spark_tpu_torch.parallel import deepfm_step
    from fm_spark_tpu_torch.train import (TrainConfig, make_optimizer,
                                          make_train_step)

    def batches(fields, n, b=PAR_SMALL_B, bucket=PAR_SMALL_BUCKET):
        s = BenchStream(3, batch=b, fields=fields, bucket=bucket)
        return [[torch.from_numpy(a).to(dev) for a in s.next_batch()]
                for _ in range(n)]

    def err(a, b):
        return max(float((x.float() - y.float()).abs().max())
                   for x, y in zip(a, b))

    # FieldFFM (config 4's fields and rank, fp32): the sharded sel
    # exchange against the single card's sel form.
    ffm = models.FieldFFMSpec(num_features=FFM_F * PAR_SMALL_BUCKET,
                              rank=FFM_RANK, num_fields=FFM_F,
                              bucket=PAR_SMALL_BUCKET, init_std=0.01)
    cfg = TrainConfig(learning_rate=0.05, sparse_update="dedup",
                      compact_device=True, compact_cap=PAR_SMALL_B)
    p1 = ffm.init(torch.Generator(device=dev).manual_seed(1), device=dev)
    p2 = parallel.shard_field_params(
        parallel.stack_field_params(ffm, p1, mesh.shape["feat"]), mesh)
    s1 = sparse.make_field_ffm_sparse_sgd_step(ffm, cfg)
    s2 = parallel.make_field_ffm_sharded_step(ffm, cfg, mesh)
    bs = batches(FFM_F, 3)
    l1 = [float(s1(p1, i, *b)[1]) for i, b in enumerate(bs)]
    l2 = [float(s2(p2, i, *b)[1]) for i, b in enumerate(bs)]
    e = err(p1["vw"], p2["vw"])
    _check(np.allclose(l1, l2, rtol=1e-5) and e < 1e-5,
           f"phase 22 ffm: sharded {l2} vs single {l1}, table err {e}")
    out["ffm"] = {"losses": l2, "single_losses": l1, "max_table_err": e,
                  "tolerance": "losses rtol 1e-5, tables 1e-5 abs (fp32: "
                               "the sel exchange sums in its own order)"}
    # FieldDeepFM (config 5's head, Adam), replicated and deep-sharded.
    c5 = configs.get_config("criteo1tb_deepfm", bucket=PAR_SMALL_BUCKET)
    deep = c5.spec()
    out["deepfm"] = {}
    for head in ("replicated", "deep_sharded"):
        cfg = TrainConfig(learning_rate=0.05, optimizer="adam",
                          sparse_update="dedup", compact_device=True,
                          compact_cap=PAR_SMALL_B,
                          deep_sharded=head == "deep_sharded")
        single_cfg = TrainConfig(learning_rate=0.05, optimizer="adam",
                                 sparse_update="dedup", compact_device=True,
                                 compact_cap=PAR_SMALL_B)
        p1 = deep.init(torch.Generator(device=dev).manual_seed(2),
                       device=dev)
        p2 = deepfm_step.shard_field_deepfm_params(
            deepfm_step.stack_field_deepfm_params(deep, p1,
                                                  mesh.shape["feat"]), mesh)
        s1 = sparse.make_field_deepfm_sparse_step(deep, single_cfg)
        s2 = deepfm_step.make_field_deepfm_sharded_step(deep, cfg, mesh)
        o1, o2 = s1.init_opt_state(p1), s2.init_opt_state(p2)
        bs = batches(deep.num_fields, 3)
        l1 = [float(s1(p1, o1, i, *b)[2]) for i, b in enumerate(bs)]
        l2 = [float(s2(p2, o2, i, *b)[2]) for i, b in enumerate(bs)]
        e = max(err(p1["vw"], p2["vw"]),
                err([l[k] for l in p1["mlp"] for k in l],
                    [l[k] for l in p2["mlp"] for k in l]))
        _check(np.allclose(l1, l2, rtol=1e-4) and e < 1e-4,
               f"phase 22 deepfm {head}: sharded {l2} vs single {l1}, "
               f"err {e}")
        out["deepfm"][head] = {"losses": l2, "single_losses": l1,
                               "max_param_err": e, "bitwise": l1 == l2
                               and e == 0.0}
    # Config 2 under dp at world 1 against the single-device dense step.
    c2 = configs.get_config("criteo_kaggle_fm_r32")
    spec2 = c2.spec()
    tc = c2.train_config()
    p1 = spec2.init(torch.Generator(device=dev).manual_seed(3), device=dev)
    dmesh = parallel.make_mesh(1, 1, device=dev)
    p2 = parallel.shard_params(p1, dmesh, spec2, "dp")
    opt = make_optimizer(tc)
    o1, o2 = opt.init(p1), opt.init(p2)
    s1 = make_train_step(spec2, tc, opt)
    s2 = parallel.make_parallel_train_step(spec2, tc, dmesh, "dp", opt)
    stream = _FlatConfig2Stream(5)
    bs = [[torch.from_numpy(a).to(dev) for a in stream.next_batch()]
          for _ in range(3 + PAR_PROFILED)]
    l1, l2 = [], []
    for b in bs[:3]:
        l1.append(float(s1(p1, o1, *b)[2]["loss"]))
        l2.append(float(s2(p2, o2, *b)[2]["loss"]))
    _check(l1 == l2 and all(torch.equal(p1[k], p2[k]) for k in p1),
           f"phase 22 dp config 2: {l2} vs single {l1}")
    prof = _profile_calls(lambda j: s2(p2, o2, *bs[3 + j]),
                          range(PAR_PROFILED))
    out["dp_config2"] = {"losses": l2, "bitwise": True, "profile": prof,
                         "capture_s": s2.captured.capture_s}
    del p1, p2, o1, o2, s1, s2
    torch.cuda.empty_cache()


def _par_dense_field_legs(dev, out):
    """One generic dense step per field family (the reference's
    ``--strategy single`` on a field config), captured against its eager
    body on a copy of the params, bit for bit, at reduced depth."""
    import torch

    from fm_spark_tpu_torch import configs, graphs
    from fm_spark_tpu_torch.train import TrainConfig, make_optimizer
    from fm_spark_tpu_torch.train import make_train_step

    out["dense_field"] = {}
    for name in ("criteo1tb_fm_r64", "avazu_ffm_r16", "criteo1tb_deepfm"):
        spec = configs.get_config(name, bucket=PAR_SMALL_BUCKET).spec()
        tc = TrainConfig(learning_rate=0.05, optimizer="adam")
        opt = make_optimizer(tc)
        p1 = spec.init(torch.Generator(device=dev).manual_seed(4),
                       device=dev)
        p2 = graphs._clone(p1)
        o1, o2 = opt.init(p1), opt.init(p2)
        step = make_train_step(spec, tc, opt)
        s = BenchStream(6, batch=PAR_SMALL_B, fields=spec.num_fields,
                        bucket=PAR_SMALL_BUCKET)
        bs = [[torch.from_numpy(a).to(dev) for a in s.next_batch()]
              for _ in range(3 + PAR_PROFILED)]
        for b in bs[:3]:
            m = step(p1, o1, *b)[2]
            loss, _ = step.body(p2, o2, *b)
            _check(torch.equal(m["loss"], loss) and _same_tree(p1, p2),
                   f"phase 22 dense {name}: captured differs from eager")
        prof = _profile_calls(lambda j: step(p1, o1, *bs[3 + j]),
                              range(PAR_PROFILED))
        out["dense_field"][name] = {
            "bucket": PAR_SMALL_BUCKET, "B": PAR_SMALL_B, "bitwise": True,
            "capture_s": step.captured.capture_s, "profile": prof}
        del p1, p2, o1, o2, step
        torch.cuda.empty_cache()


def _par_tier_leg(dev, out):
    """The tier's bf16 planes against the untiered bf16 step at
    10,000,384 features (config 2's widths, SGD), bit for bit."""
    import dataclasses

    import numpy as np

    n_features = -(-TIER_RUNGS[0] // TIER_BUCKET) * TIER_BUCKET
    batches = _tier_stream(n_features, PAR_TIER_STEPS + TIER_PROFILED)
    main, extra = batches[:PAR_TIER_STEPS], batches[PAR_TIER_STEPS:]
    spec, cfg = _tier_config("sgd", n_features)
    spec = dataclasses.replace(spec, param_dtype="bfloat16")
    trainer, losses, merged, tiered = _tiered_run(dev, spec, cfg, main, extra)
    del trainer
    want_losses, want, untiered = _untiered_run(dev, spec, cfg, main, extra)
    _check(losses == want_losses, f"phase 22 bf16 tier: losses differ: "
           f"{losses[:4]} vs {want_losses[:4]}")
    same = sorted(merged) == sorted(want) and all(
        np.array_equal(merged[k], want[k]) for k in want)
    _check(same, "phase 22 bf16 tier: a merged plane differs from the "
           "untiered step's")
    _check(tiered["evictions"] > 0, f"phase 22 bf16 tier: no churn {tiered}")
    out["tier_bf16"] = {"num_features": n_features, "steps": PAR_TIER_STEPS,
                        "bitwise": True, "tiered": tiered,
                        "untiered": untiered}


def _par_cli_leg(base, out):
    """``fmtorch train --distributed`` at config 3's full width, world 1
    from a torchrun-style environment (the group is the command's own: it
    joins one and leaves it), with ``--ckpt-sharded``, run in this process
    (``cli.main``, no interpreter start-up) as the script's last training;
    then the chain restored into ``fmtorch eval --checkpoint-dir``."""
    import torch.distributed as dist

    ck = os.path.join(base, "ck")
    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE="1", RANK="0", LOCAL_RANK="0")
    argv = ["train", "--config", "criteo1tb_fm_r64", "--synthetic", TRAIN_B,
            "--batch-size", TRAIN_B, "--steps", 2, "--param-dtype",
            "bfloat16", "--compute-dtype", "bfloat16", "--sparse-update",
            "dedup_sr", "--compact-device", "--compact-cap", CAP,
            "--gfull-fused", "--segtotal-pallas", "--test-fraction", 0,
            "--log-every", 1, "--checkpoint-dir", ck, "--checkpoint-every",
            2, "--distributed", "--ckpt-sharded", "--prefetch", 0]
    t0 = time.perf_counter()
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        lines, summary = _cli(*argv)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    losses = _losses(lines)
    _check(sorted(losses) == [1, 2], f"phase 22 cli: losses {losses}")
    _check(not dist.is_initialized(),
           "phase 22 cli: the command's group outlived it")
    state = json.load(open(os.path.join(ck, "2", "state.json")))
    _check(state["layout"] == "sharded" and summary["world"] == 1,
           f"phase 22 cli: layout {state['layout']}, world {summary}")
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ev, _ = _cli("eval", "--checkpoint-dir", ck, "--config",
                 "criteo1tb_fm_r64", "--compute-dtype", "bfloat16",
                 "--synthetic", 65536, "--batch-size", 65536)
    _check(ev[0] == {"checkpoint_step": 2} and ev[1]["count"] > 0,
           f"phase 22 cli: eval of the chain {ev}")
    out["cli"] = {"losses": losses, "summary": summary, "train_s": train_s,
                  "eval": ev[1], "eval_s": time.perf_counter() - t0,
                  "arrays": len(state["arrays"])}


def parallel_phase(dev, report):
    """Phase 22: training over torch.distributed at world 1 on the card
    (an NCCL group of one rank made here), the field families' generic
    dense step, and the tier's bf16 planes."""
    import importlib
    import tempfile

    import torch
    import torch.distributed as dist

    from fm_spark_tpu_torch import parallel
    from fm_spark_tpu_torch.ops import KERNEL_COUNTERS, kernel_launches

    root = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(root, exist_ok=True)
    base = tempfile.mkdtemp(prefix="par.", dir=root)
    out = {"card": report["card"]}
    t_phase = time.perf_counter()
    parallel.init_distributed(dev, coordinator=f"127.0.0.1:{_free_port()}",
                              num_processes=1, process_id=0, timeout_s=300)
    out["world"] = dist.get_world_size()
    out["backend"] = dist.get_backend()
    print(f"phase 22: world {out['world']} ({out['backend']})", flush=True)
    seconds = out["seconds"] = {}
    try:
        mesh = parallel.make_field_mesh(device=dev)
        for _, mod, attr in KERNEL_COUNTERS:
            setattr(importlib.import_module(f"fm_spark_tpu_torch.ops.{mod}"),
                    attr, 0)
        for name, leg in (("fm", lambda: _par_fm_leg(dev, mesh, out)),
                          ("small", lambda: _par_small_legs(dev, mesh, out)),
                          ("dense", lambda: _par_dense_field_legs(dev, out)),
                          ("tier", lambda: _par_tier_leg(dev, out)),
                          ("cli", lambda: _par_cli_leg(base, out))):
            t0 = time.perf_counter()
            if name == "cli":
                # The command joins a group of its own.
                dist.destroy_process_group()
            leg()
            seconds[name] = time.perf_counter() - t0
            print(f"phase 22 leg {name}: {seconds[name]:.1f} s", flush=True)
        launches = kernel_launches()
        out["launches"] = launches
        _check(launches["segment_totals"] > 0 and launches["sr_bits"] > 0,
               f"phase 22: kernel A or sr_bits never launched: {launches}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(base, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print("parallel", json.dumps(out), flush=True)
    card = report["card"]
    for leg, prof in (("single", out["fm"]["single"]),
                      ("sharded", out["fm"]["sharded"])):
        runs = prof.get("kernel_runs_per_step", {})
        print(f"phase 22 ({card}) fm {leg} captured: wall "
              f"{prof['wall_ms_per_step']:.2f} ms, busy "
              f"{prof['device_ms_per_step']} ms per step; kernel A "
              f"{runs.get('segment_totals')} and sr_bits "
              f"{runs.get('sr_bits')} runs per replayed step", flush=True)
    p = out["dp_config2"]["profile"]
    print(f"phase 22 ({card}) dp config 2 captured: wall "
          f"{p['wall_ms_per_step']:.2f} ms, busy {p['device_ms_per_step']} "
          f"ms per step; kernel A "
          f"{p.get('kernel_runs_per_step', {}).get('segment_totals')} runs "
          "per replayed step", flush=True)
    for name, r in out["dense_field"].items():
        p = r["profile"]
        print(f"phase 22 ({card}) dense {name} @ bucket {r['bucket']}: wall "
              f"{p['wall_ms_per_step']:.2f} ms, busy "
              f"{p['device_ms_per_step']} ms per step; kernel A "
              f"{p.get('kernel_runs_per_step', {}).get('segment_totals')} "
              "runs per replayed step", flush=True)
    t = out["tier_bf16"]["tiered"]
    print(f"phase 22 ({card}) bf16 tier @ {out['tier_bf16']['num_features']:,}"
          f": {t['examples_per_s']:.0f} ex/s, busy "
          f"{t['profile']['device_ms_per_step']} ms/step, evictions "
          f"{t['evictions']}, bitwise", flush=True)
    c = out["cli"]
    print(f"phase 22 ({card}) fmtorch train --distributed --ckpt-sharded: "
          f"losses {c['losses']}, {c['train_s']:.1f} s; eval of the chain "
          f"{c['eval_s']:.1f} s; phase {out['phase_s']:.1f} s", flush=True)
    report["parallel"] = out
    return launches


def repeat_phase_17(dev, report, seconds: float) -> int:
    """``chip_smoke.py --repeat-phase-17 SECONDS``: phases 3-16 once, as
    the full run runs them, then phase 17 again and again until
    ``SECONDS`` have passed (run it under ``CUDA_LAUNCH_BLOCKING=1`` to
    pin an asynchronous CUDA error to its launch). Each pass prints its
    line; the first failure propagates with its traceback. Prints
    ``{"phase17_loop": {"runs", "passed", "seconds"}}``."""
    t0 = time.perf_counter()
    kernel_phase(dev, report)
    eval_phase(dev, report)
    serve_phase(dev, report)
    cli_phase(dev, report)
    training_kernels_phase(dev, report)
    train_phase(dev, report)
    ffm_kernel_phase(dev, report)
    ffm_serve_phase(dev, report)
    ffm_train_phase(dev, report)
    row_kernel_phase(dev, report)
    pallas_train_phase(dev, report)
    sr_bits_phase(dev, report)
    capture_phase(dev, report)
    ingest_phase(dev, report)
    deepfm_phase(dev, report)
    serve_chain_phase(dev, report)
    t1 = time.perf_counter()
    print(f"phases 3-16: {t1 - t0:.1f} s", flush=True)
    runs = 0
    while runs == 0 or time.perf_counter() - t1 < seconds:
        runs += 1
        t = time.perf_counter()
        flat_fm_phase(dev, report)
        print(f"phase 17 pass {runs}: {time.perf_counter() - t:.1f} s",
              flush=True)
    print(json.dumps({"phase17_loop": {
        "runs": runs, "passed": runs, "seconds": time.perf_counter() - t1,
        "launch_blocking": os.environ.get("CUDA_LAUNCH_BLOCKING")}}),
        flush=True)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from fm_spark_tpu_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # The telemetry plane is on by default in fmtorch train and serve;
    # phases 1-20 run their CLI calls (and subprocesses) with it off, as
    # they were written; phase 21 names its run dirs.
    os.environ["FM_SPARK_OBS_DIR"] = "none"
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}

    t0 = time.perf_counter()
    build.build_all()
    report["build_s"] = time.perf_counter() - t0
    print(f"kernel build {report['build_s']:.2f} s", flush=True)
    for name, log in build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
    if sys.argv[1:2] == ["--repeat-phase-17"]:
        return repeat_phase_17(dev, report, float(sys.argv[2]))

    seconds = report["phase_seconds"] = {}

    def timed(name, phase):
        """One phase, its seconds printed and kept in the report."""
        t = time.perf_counter()
        out = phase(dev, report)
        seconds[name] = time.perf_counter() - t
        print(f"phase {name}: {seconds[name]:.1f} s", flush=True)
        return out

    rows = timed("3 kernel", kernel_phase)
    timed("3 eval", eval_phase)
    launches = timed("4 serve", serve_phase)
    timed("5 cli", cli_phase)
    a_rows, b_rows = timed("6 training kernels", training_kernels_phase)
    train_launches = timed("7 train", train_phase)
    ffm_rows = timed("8 ffm kernels", ffm_kernel_phase)
    ffm_serve_launches = timed("9 ffm serve", ffm_serve_phase)
    ffm_launches = timed("10 ffm train", ffm_train_phase)
    row_rows = timed("11 row kernels", row_kernel_phase)
    pallas_launches = timed("12 pallas train", pallas_train_phase)
    sr_rows = timed("13 sr bits", sr_bits_phase)
    capture_launches = timed("13 capture", capture_phase)
    ingest_launches = timed("14 ingest", ingest_phase)
    deepfm_launches, w17 = timed("15 deepfm", deepfm_phase)
    serve_runs = timed("16 serve chain", serve_chain_phase)
    flat_launches, flat = timed("17 flat fm", flat_fm_phase)
    fam_launches, fam = timed("18 families", families_phase)
    stream_launches = timed("19 stream", stream_phase)
    tier_launches = timed("20 tier", tier_phase)
    obs_launches = timed("21 obs", obs_phase)
    par_launches = timed("22 parallel", parallel_phase)

    def fwd_row(dtype, ids, b, compute="float32"):
        return next(r for r in rows if (r["dtype"], r["ids"], r["B"],
                                        r["compute"], r["width"])
                    == (dtype, ids, b, compute, WIDTH))

    main_row = fwd_row("float32", "uniform", 512)
    # The eval batch in bf16 storage, both compute modes, and in fp32,
    # beside the serving bucket.
    fwd_cases = {
        f"{d} B={TRAIN_B}{' cd-bf16' if c == 'bfloat16' else ''}":
            fwd_row(d, "uniform", TRAIN_B, c)
        for d, c in (("bfloat16", "float32"), ("bfloat16", "bfloat16"),
                     ("float32", "float32"))}
    kernels = {"kernels": [{
        "name": "fm_fused_scores", "route": "cuda",
        "source": "fm_spark_tpu_torch/csrc/fm_fused_fwd.cu",
        "replaces": "fm_spark_tpu/ops/pallas_fused.py:258",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "max_rel_err": max(r["max_rel_err"] for r in rows),
        "ms": main_row["ms"], "call_ms": main_row["call_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "shape": "fp32 B=512 (largest serving bucket)",
        **{name: {**{k: r[k] for k in ("ms", "call_ms", "plain_ms",
                                       "bound_ms")},
                  "bound_by": "bytes", "library_ms": None,
                  "shape": f"{F} fields, w={WIDTH}, uniform ids"}
           for name, r in fwd_cases.items()},
        "eval_launches": report["eval"]["launches"],
    }, {
        "name": "segment_totals", "route": "cuda",
        "source": "fm_spark_tpu_torch/csrc/segment_totals.cu",
        "replaces": "fm_spark_tpu/ops/pallas_segsum.py:81",
        "launches": train_launches["segment_totals"],
        "use_pallas_launches": pallas_launches["segment_totals"],
        "max_abs_err": max(r["max_abs_err"] for r in a_rows),
        "max_rel_err": max(r["max_rel_err"] for r in a_rows),
        **{k: a_rows[0][k] for k in ("ms", "call_ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")},
        "shape": f"compact: one field, B={TRAIN_B}, cap={CAP}, w={WIDTH}",
        **{r["case"]: {**{k: r[k] for k in (
            "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")}, "shape": f"one field, B={TRAIN_B}, cap=B, "
            f"w={r['width']}, {r['segments']} segments"}
           for r in a_rows[1:]},
    }, {
        "name": "fm_bwd_segment_totals", "route": "cuda",
        "source": "fm_spark_tpu_torch/csrc/fm_fused_bwd.cu",
        "replaces": "fm_spark_tpu/ops/pallas_fused.py:355",
        "launches": train_launches["fm_bwd_segment_totals"],
        "max_abs_err": max(r["max_abs_err"] for r in b_rows),
        "max_rel_err": max(r["max_rel_err"] for r in b_rows),
        "ms": b_rows[-1]["ms"], "plain_ms": b_rows[-1]["plain_ms"],
        "bound_ms": b_rows[-1]["bound_ms"], "bound_by": b_rows[-1]["bound_by"],
        "library_ms": None,
        "shape": f"{F} fields, B={TRAIN_B}, cap={CAP}, bf16 store+compute",
    }]}
    # The FFM kernels at the training batch in bf16 (the selblk-pallas
    # leg's shape); launches from phase 10's run, the forward's serving
    # launches from phase 9 beside them.
    ffm_main = next(r for r in ffm_rows
                    if r["dtype"] == "bfloat16" and r["B"] == TRAIN_B)
    for name, key, line in (
            ("ffm_sel_scores", "scores", 490), ("ffm_sel_bwd", "bwd", 521)):
        m = ffm_main[key]
        entry = {
            "name": name, "route": "cuda",
            "source": "fm_spark_tpu_torch/csrc/ffm_sel.cu",
            "replaces": f"fm_spark_tpu/ops/pallas_fused.py:{line}",
            "launches": ffm_launches[name],
            "max_abs_err": max(r[key]["max_abs_err"] for r in ffm_rows),
            "max_rel_err": max(r[key]["max_rel_err"] for r in ffm_rows),
            "ms": m["ms"], "call_ms": m["call_ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": None,
            "shape": f"{FFM_F} fields, rank {FFM_RANK}, B={TRAIN_B}, bf16",
        }
        if name == "ffm_sel_scores":
            entry["serve_launches"] = ffm_serve_launches
        entry["use_pallas_launches"] = pallas_launches[name]
        kernels["kernels"].append(entry)
    # The row kernels on config 3's fp32 tables at the field with the most
    # distinct ids; launches from phase 12's two legs.
    row_main = row_rows[0]
    for name, key, line in (("gather_rows", "gather", 97),
                            ("update_rows_add", "update", 178)):
        m = row_main[key]
        entry = {
            "name": name, "route": "cuda",
            "source": "fm_spark_tpu_torch/csrc/rows.cu",
            "replaces": f"fm_spark_tpu/ops/pallas_fm.py:{line}",
            "launches": pallas_launches[name],
            "max_abs_err": max(r[key]["max_abs_err"] for r in row_rows),
            "ms": m["ms"], "call_ms": m["call_ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"],
            "shape": (f"one field of {F}, B={TRAIN_B}, "
                      f"{row_main['unique_max']} distinct ids, "
                      f"w={WIDTH}, fp32"),
        }
        # Phase 11's other two cases: config 3 in bf16 and config 4's
        # 369-column rows.
        for r in row_rows[1:]:
            entry[r["case"]] = {
                **{k: r[key][k] for k in ("ms", "call_ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms")},
                "shape": (f"one field of {r['fields']}, B={TRAIN_B}, "
                          f"{r['unique_max']} distinct ids, w={r['width']}, "
                          f"{r['dtype']}")}
        kernels["kernels"].append(entry)
    # The SR bits at the compact update's shape; launches from phase 13's
    # captured legs.
    kernels["kernels"].append({
        "name": "sr_bits", "route": "cuda",
        "source": "fm_spark_tpu_torch/csrc/sr_bits.cu",
        "replaces": "fm_spark_tpu/ops/scatter.py:67",
        "note": "jax.random.bits of the dedup_sr write; no Pallas kernel",
        "launches": train_launches["sr_bits"],
        "max_abs_err": 0,
        **{k: sr_rows[0][k] for k in ("ms", "call_ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms")},
        "shape": f"[{CAP}, {WIDTH}] int32",
        "ffm_width": {k: sr_rows[1][k] for k in (
            "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
    })
    # Each kernel's runs per replayed step of phase 13's captured legs, as
    # the profiler counts them by kernel symbol.
    for entry in kernels["kernels"]:
        entry["runs_per_captured_step"] = capture_launches.get(entry["name"],
                                                               {})
        # Phase 14's legs (ingest, train, resume, eval, predict).
        entry["ingest_launches"] = ingest_launches[entry["name"]]
        # Phase 15's legs (config 5: eager and captured, fmtorch).
        entry["deepfm_launches"] = deepfm_launches[entry["name"]]
        # Serving's kernel runs by symbol in the graphs' replays: phases 4
        # and 9 (4 threads) and phase 16's leg C (5 profiled replays per
        # bucket); 0 off the serving path.
        entry["serve_launches"] = serve_runs.get(entry["name"], 0) + {
            "fm_fused_scores": launches,
            "ffm_sel_scores": ffm_serve_launches}.get(entry["name"], 0)
    # The kernels at config 5's row width (17 columns), phase 15.
    w17_shape = f"config 5, w={DEEPFM_W}, B={DEEPFM_B}"
    for entry in kernels["kernels"]:
        name = entry["name"]
        if name in ("gather_rows", "update_rows_add"):
            key = "gather" if name == "gather_rows" else "update"
            entry["deepfm_w17"] = {
                r["dtype"]: {**{k: r[key][k] for k in (
                    "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}, "shape": (
                    f"{w17_shape}, one field of {F}, "
                    f"{r['unique_max']} distinct ids, {r['dtype']}")}
                for r in w17["rows"]}
        elif name == "segment_totals":
            entry["deepfm_w17"] = {r["case"]: {**{k: r[k] for k in (
                "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "max_abs_err")}, "shape": (
                f"{w17_shape}, cap={r['cap']}, {r['segments']} segments, "
                "fp32 deltas")} for r in w17["segment_totals"]}
        elif name == "sr_bits":
            entry["deepfm_w17"] = {**{k: w17["sr_bits"][k] for k in (
                "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")}, "shape": f"[{DEEPFM_CAP}, {DEEPFM_W}] int32"}
    # Phase 17, the flat FM's dense steps: kernel A at their shape and its
    # launches (eager steps and capture warm-ups; replays run it uncounted,
    # counted by symbol per replayed step).
    for entry in kernels["kernels"]:
        entry["flat_launches"] = flat_launches[entry["name"]]
        if entry["name"] == "segment_totals":
            for cfg in ("config2", "config1"):
                r = flat["kernel_a"][cfg]
                entry[f"flat_{cfg}"] = {**{k: r[k] for k in (
                    "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "max_abs_err")}, "shape": (
                    f"{cfg} dense step: B*nnz={r['B']} lanes, w={r['width']}, "
                    f"cap=B*nnz, {r['segments']} segments, fp32"),
                    "runs_per_replayed_step": flat[cfg][
                        "kernel_a_runs_per_replay"]}
    # Phase 18, the other families and optimizers: each kernel's launches
    # (eager steps and capture warm-ups), kernel A at the flat FFM step's
    # width and the sel kernels at its shape.
    for entry in kernels["kernels"]:
        entry["families_launches"] = fam_launches[entry["name"]]
        if entry["name"] == "segment_totals":
            r = fam["C_ffm_kernel_a"]
            entry["families_flat_ffm"] = {**{k: r[k] for k in (
                "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "max_abs_err")}, "shape": (
                f"flat FFM dense step: B*nnz={r['B']} lanes, "
                f"w={r['width']}, cap=B*nnz, {r['segments']} segments, "
                "fp32"), "runs_per_replayed_step": fam["C_ffm_step"][
                    "kernel_a_runs_per_replay"]}
        elif entry["name"] in ("ffm_sel_scores", "ffm_sel_bwd"):
            key = "scores" if entry["name"] == "ffm_sel_scores" else "bwd"
            entry["families_flat_ffm"] = {
                **fam["C_ffm_kernels"][key],
                "shape": f"flat FFM step: B={FAM_B}, {FFM_F} fields, "
                         f"rank {FFM_RANK}, fp32"}
    # Phase 19, the raw-text stream and FieldFM's col and unfused forms:
    # each kernel's launches (the eager steps and capture warm-ups of its
    # legs; the replays' runs of kernel B and sr_bits by symbol in
    # report["stream"]).
    for entry in kernels["kernels"]:
        entry["stream_launches"] = stream_launches[entry["name"]]
    # Phase 20, the tiered store and continuous learning: each kernel's
    # launches (the captures' warm-ups); kernel A at the tiered step's
    # shape and its runs per replayed tiered and online step by symbol.
    tier = report["tier"]
    for entry in kernels["kernels"]:
        entry["tier_launches"] = tier_launches[entry["name"]]
        if entry["name"] == "segment_totals":
            r = tier["kernel_a"]
            entry["tier_step"] = {**{k: r[k] for k in (
                "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "max_abs_err")}, "shape": (
                f"tiered step: B*nnz={r['B']} lanes by global id, "
                f"w={r['width']}, cap=B*nnz, {r['segments']} segments, "
                "fp32"), "runs_per_replayed_step": {
                    opt: tier["leg_a"][opt]["tiered"]["profile"].get(
                        "kernel_runs_per_step", {}).get("segment_totals")
                    for opt in ("sgd", "ftrl", "adagrad")},
                "online_runs_per_replayed_step":
                    tier["leg_d"]["profiled"]["runs_per_replayed_step"]}
    # Phase 21, the obs and fault planes: each kernel's launches (the
    # capture warm-ups of its training legs, the serving warm-up).
    for entry in kernels["kernels"]:
        entry["obs_launches"] = obs_launches[entry["name"]]
    # Phase 22, training over torch.distributed at world 1, the field
    # families' dense step and the bf16 tier: each kernel's launches (the
    # eager steps and the captures' warm-ups); kernel A's and sr_bits'
    # runs per replayed step of the sharded FieldFM step by symbol.
    par = report["parallel"]
    for entry in kernels["kernels"]:
        entry["parallel_launches"] = par_launches[entry["name"]]
        runs = par["fm"]["sharded"].get("kernel_runs_per_step")
        if runs is not None and entry["name"] in ("segment_totals",
                                                  "sr_bits"):
            entry["parallel_runs_per_replayed_step"] = runs[entry["name"]]
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({**report, **kernels}, f, indent=2)
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
