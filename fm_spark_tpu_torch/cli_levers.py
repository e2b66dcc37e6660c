"""The CLI lever registry of ``fmtorch train`` (the port of
``fm_spark_tpu/cli_levers.py``): one row per TrainConfig lever.

Parser setup (:func:`_add_lever_args`), train-config threading
(:func:`_lever_overrides`), the per-lever capability guards (the rows'
``validate``, run by ``cli._validate_field_caps``; their
strategy-independent ``validate_any``, run by :func:`check_levers_any`)
and the levers the flat family's dense step refuses
(:func:`field_only_levers`) all iterate ONE table — adding a lever to
the CLI is one :class:`_Lever` row here (+ its TrainConfig field and step
support). Multi-flag interplay (the compact-aux family) stays in
``cli._validate_field_caps``' own block: those guards couple several
flags at once and would not be clearer as rows. Every message is the
reference's.
"""

from __future__ import annotations

import dataclasses
import types


@dataclasses.dataclass(frozen=True)
class _Lever:
    flag: str            # CLI flag, e.g. "--score-sharded"
    field: str           # TrainConfig field name (= argparse dest)
    kind: str            # 'flag' | 'int' | 'choice'
    help: str
    choices: tuple = ()
    # Optional guard: (tconfig, ctx) -> error message | None, where ctx
    # has spec/cap/n/pc/sharded/row_shards. Raised as SystemExit by
    # cli._validate_field_caps (strategy field_sparse only — the other
    # strategies' step factories carry the per-flag rejects).
    validate: object = None
    # Optional strategy-INDEPENDENT guard: (tconfig) -> error message |
    # None, run by cli._cmd_train for EVERY strategy right after the
    # TrainConfig is built — for flags whose misuse the non-field
    # factories cannot see (a policy flag that is a silent no-op without
    # its companion cap).
    validate_any: object = None


def check_levers_any(tconfig):
    """Run every registry row's strategy-independent guard; returns the
    first error message or None."""
    for lv in _LEVERS:
        if lv.validate_any is not None:
            msg = lv.validate_any(tconfig)
            if msg:
                return msg
    return None


def field_caps(spec):
    """The sharded-step capabilities the lever guards read (the
    reference's ``_FIELD_CAPS`` columns): FieldFM's field-sharded step
    takes ``score_sharded``, FieldDeepFM's ``deep_sharded``."""
    name = type(spec).__name__
    return types.SimpleNamespace(sharded_score=name == "FieldFMSpec",
                                 sharded_deep=name == "FieldDeepFMSpec")


def _v_overflow_needs_cap(tc):
    if tc.compact_overflow != "error" and tc.compact_cap <= 0:
        # The fused factories refuse this too; the dense strategies never
        # consult compact flags, so without this guard the CLI would
        # accept a policy that does nothing (no silent fallback).
        return (
            f"--compact-overflow {tc.compact_overflow} has no effect "
            "without --compact-cap"
        )


def _v_collective_dtype(tc, ctx):
    if tc.collective_dtype != "float32" and not ctx["sharded"]:
        return (
            f"--collective-dtype {tc.collective_dtype} is a wire-"
            f"precision knob for multi-device runs (found {ctx['n']} "
            "device(s))"
        )


def _v_score_sharded(tc, ctx):
    if tc.score_sharded and not (ctx["sharded"]
                                 and ctx["cap"].sharded_score):
        return (
            f"--score-sharded needs multiple devices and a model family "
            f"with the example-sharded score path "
            f"(found {ctx['n']} device(s), {type(ctx['spec']).__name__})"
        )


def _v_deep_sharded(tc, ctx):
    if tc.deep_sharded and not (ctx["sharded"]
                                and ctx["cap"].sharded_deep):
        return (
            f"--deep-sharded needs multiple devices and a model family "
            f"with an example-sharded deep head "
            f"(found {ctx['n']} device(s), {type(ctx['spec']).__name__})"
        )


def _v_sel_blocked(tc, ctx):
    from fm_spark_tpu_torch.models import FieldFFMSpec

    if tc.sel_blocked and (ctx["sharded"]
                           or type(ctx["spec"]) is not FieldFFMSpec):
        return (
            f"--sel-blocked is the single-chip FieldFFM body's lever "
            f"(it blocks the [B, F, F, k] sel tensor; found "
            f"{ctx['n']} device(s), {type(ctx['spec']).__name__})"
        )


def _v_hot_rows_need_tier(tc):
    if tc.hot_rows > 0 and tc.embed_tier == "off":
        # Capacity without the lever would be a silent no-op: the
        # in-memory trainers never consult hot_rows.
        return "--hot-rows has no effect without --embed-tier auto|require"
    if tc.embed_tier != "off" and tc.hot_rows > 0 and \
            tc.hot_rows % tc.embed_bucket_rows:
        return (
            f"--hot-rows {tc.hot_rows} must be a multiple of "
            f"--embed-bucket-rows {tc.embed_bucket_rows} (the hot tier "
            "is managed in whole buckets)"
        )


def _v_embed_tier(tc, ctx):
    # 'require' on a sharded run would die later with a less situated
    # message (the residency protocol is single-device); 'auto' is always
    # legal — queryable fallback.
    if tc.embed_tier == "require" and ctx["sharded"]:
        return (
            f"--embed-tier require is served by the SINGLE-CHIP tiered "
            f"flat-FM trainer (found {ctx['n']} devices); use 'auto' "
            "for fallback-to-in-HBM semantics on a sharded run"
        )


def _v_fused_embed(tc, ctx):
    # 'require' on a sharded run dies later in the factory with a less
    # situated message; 'auto' is always legal.
    if tc.fused_embed == "require" and ctx["sharded"]:
        return (
            f"--fused-embed require is served by the SINGLE-CHIP fused "
            f"Pallas bodies (found {ctx['n']} devices); use 'auto' for "
            "fallback-to-XLA semantics on a sharded run"
        )


_LEVERS = (
    _Lever("--host-dedup", "host_dedup", "flag",
           "build the dedup aux on the host (the compact aux with "
           "--compact-cap)"),
    _Lever("--compact-cap", "compact_cap", "int",
           "COMPACT aux: the static per-field unique-id capacity — the "
           "step touches the big tables with this many lanes instead of "
           "the batch size. Must bound every field's per-batch unique-id "
           "count. Needs --host-dedup or --compact-device"),
    _Lever("--compact-device", "compact_device", "flag",
           "build the compact aux on the card inside the step (no host "
           "aux). Needs --compact-cap and a dedup --sparse-update; "
           "exclusive with --host-dedup"),
    _Lever("--compact-overflow", "compact_overflow", "choice",
           "when a field's unique ids exceed --compact-cap: error "
           "(default; the device aux poisons the loss to -inf), drop "
           "(device aux: overflow ids behave as absent features), split "
           "(host aux: the batch is halved until every field fits)",
           choices=("error", "drop", "split"),
           validate_any=_v_overflow_needs_cap),
    _Lever("--collective-dtype", "collective_dtype", "choice",
           "wire dtype of the field-sharded steps' activation "
           "collectives (score sums, DeepFM h, FFM sel all_to_all); "
           "bfloat16 halves their bytes. field_sparse under "
           "--distributed only",
           choices=("float32", "bfloat16"),
           validate=_v_collective_dtype),
    _Lever("--score-sharded", "score_sharded", "flag",
           "shard the [B, k] score/dscores math over examples on the "
           "field-sharded FieldFM step (exact; one [B] dscores "
           "all_gather). field_sparse under --distributed only",
           validate=_v_score_sharded),
    _Lever("--deep-sharded", "deep_sharded", "flag",
           "example-shard the FieldDeepFM head on the field-sharded step "
           "(one all_to_all of h, the MLP on B/n examples a rank). "
           "field_sparse under --distributed only",
           validate=_v_deep_sharded),
    _Lever("--gfull-fused", "gfull_fused", "flag",
           "build each field's backward g_full buffer directly in place "
           "of concatenating its two halves (FieldFM/DeepFM fused "
           "bodies)"),
    _Lever("--sel-blocked", "sel_blocked", "flag",
           "FieldFFM: the per-owner-field interaction loop in place of "
           "the [B, F, F, k] sel tensor",
           validate=_v_sel_blocked),
    _Lever("--segtotal-pallas", "segtotal_pallas", "flag",
           "segment sums by the segment-totals kernel"),
    _Lever("--fused-embed", "fused_embed", "choice",
           "the fused kernels: FieldFM's backward, FieldFFM's ffm_sel "
           "pair (with --sel-blocked)",
           choices=("off", "auto", "require"),
           validate=_v_fused_embed),
    _Lever("--embed-tier", "embed_tier", "choice",
           "tiered embedding store (flat FM, sgd/ftrl/adagrad): a "
           "card-resident cache of --hot-rows rows in buckets over host "
           "cold storage, bit-identical to the in-memory path; 'auto' "
           "falls back with a stderr notice, 'require' fails instead",
           choices=("off", "auto", "require"),
           validate=_v_embed_tier),
    _Lever("--hot-rows", "hot_rows", "int",
           "hot-tier capacity in rows for --embed-tier (a multiple of "
           "--embed-bucket-rows, covering one batch's buckets, below the "
           "feature count)",
           validate_any=_v_hot_rows_need_tier),
    _Lever("--embed-bucket-rows", "embed_bucket_rows", "int",
           "rows per hot-tier bucket (the residency unit; default 512)"),
)

#: train's flags of the fused field steps (strategy field_sparse), which
#: the flat family's dense step refuses, in the order ``cli._train_flat``
#: checks them: lever rows, and two flags outside the table.
_FIELD_ONLY = ("host_dedup", "compact_device", "compact_cap",
               "segtotal_pallas", "gfull_fused", "sel_blocked", "use_pallas",
               "sparse_update", "compact_overflow")


def field_only_levers() -> tuple:
    """``(dest, flag)`` of every flag the dense step refuses, in
    :data:`_FIELD_ONLY`'s order."""
    flags = {lv.field: lv.flag for lv in _LEVERS}
    return tuple((d, flags.get(d, "--" + d.replace("_", "-")))
                 for d in _FIELD_ONLY)


def _add_lever_args(parser):
    """Registry-driven argparse rows (one per _Lever). Every lever
    defaults to None: an unset flag leaves the config's value."""
    for lv in _LEVERS:
        if lv.kind == "flag":
            parser.add_argument(lv.flag, action="store_true", default=None,
                                dest=lv.field, help=lv.help)
        elif lv.kind == "int":
            parser.add_argument(lv.flag, type=int, default=None,
                                dest=lv.field, help=lv.help)
        elif lv.kind == "choice":
            parser.add_argument(lv.flag, default=None,
                                choices=list(lv.choices),
                                dest=lv.field, help=lv.help)
        else:
            raise ValueError(f"unknown lever kind {lv.kind!r}")


def _lever_overrides(args) -> dict:
    """The registry's train_config(**overrides) slice: store_true flags
    map False/None -> None (no override) so config defaults survive."""
    out = {}
    for lv in _LEVERS:
        v = getattr(args, lv.field)
        if lv.kind == "flag":
            v = True if v else None
        out[lv.field] = v
    return out
