"""Faults planted under the timed path, for the checks that ``correct``
comes out false when the step is broken: ``state``, a step that returns
its state unchanged (no table write, no bias update); ``half``, half of
the batch left out and the mean taken over the rest; ``misplace``, each
field's right updates written to the wrong ids (every id's total or
lane's gradient moved to the next one), which keeps each table's norm
of change. Used by the
benchmark's tests on the CPU and by ``benchmark.calibrate`` on the card;
never by a timed run."""

from __future__ import annotations

import contextlib

KINDS = ("state", "half", "misplace")


@contextlib.contextmanager
def planted(kind: str):
    """Break the program's field-sparse step in ``kind``'s way while the
    block runs (the step must be built inside it)."""
    from fm_spark_tpu_torch import sparse

    saved = {}

    def swap(name, fn):
        saved[name] = getattr(sparse, name)
        setattr(sparse, name, fn)

    if kind == "state":
        def nothing(*a, **k):
            return None

        for name in ("_apply_updates", "_fused_compact_updates",
                     "_update_bias"):
            swap(name, nothing)
    elif kind == "half":
        make = sparse._loss_and_grad_fn

        def half_batch(loss_name):
            inner = make(loss_name)

            def loss_and_grad(scores, labels, weights, wsum=None):
                kept = weights.clone()
                kept[kept.shape[0] // 2:] = 0
                return inner(scores, labels, kept)

            return loss_and_grad

        swap("_loss_and_grad_fn", half_batch)
    elif kind == "misplace":
        fused = sparse.fused_bwd_lib
        totals = fused.fm_bwd_segment_totals
        apply = sparse._apply_updates

        def moved_totals(*a, **k):
            return totals(*a, **k).roll(1, dims=1)

        def moved_lanes(compact, tables, ids, g_fulls, *a, **k):
            return apply(compact, tables, ids,
                         [g.roll(1, dims=0) for g in g_fulls], *a, **k)

        saved["fused_bwd_lib.fm_bwd_segment_totals"] = totals
        fused.fm_bwd_segment_totals = moved_totals
        swap("_apply_updates", moved_lanes)
    else:
        raise ValueError(f"unknown fault {kind!r}; expected one of {KINDS}")
    try:
        yield
    finally:
        for name, fn in saved.items():
            owner, _, attr = name.rpartition(".")
            setattr(getattr(sparse, owner) if owner else sparse, attr, fn)
