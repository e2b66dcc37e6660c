"""Per-rank work and collective byte counts of the field-sharded steps
(the port of ``fm_spark_tpu/parallel/projection.py``).

:func:`field_sharded_costs` counts, exactly, from each sharded program's
construction (``parallel/field_step.py``, ``ffm_step.py``,
``deepfm_step.py``): the index-op lanes each rank performs against its
big tables and the bytes each of its collectives moves per step. The
port's collectives are the reference's (the batch all_to_all, the
label/weight gathers, the score all_reduce, FFM's sel all_to_all,
DeepFM's ``h`` gather), so the counts are the same; the keys keep the
reference's names (``ici`` is the interconnect, NVLink between cards).

:func:`project_aggregate` combines the counts with a measured single-card
rate into a projected n-card aggregate. Its time inputs (per-step
dispatch, the replicated score math per 128k examples, the link
bandwidth) are arguments WITHOUT defaults: the reference's defaults are
figures of its TPU, which say nothing of a card, and no time enters this
module that a chip run of the port did not measure. Until such a run
measures them, the port gives counts, not times.
"""

from __future__ import annotations

_WIRE_BYTES = {"float32": 4, "bfloat16": 2}


def _base_counts(B: int, F: int, k: int, n: int, cap: int,
                 device_aux: bool, n_total: int | None = None) -> dict:
    """Work + batch-reshard link counts shared by all three models.

    ``n_total`` (2-D meshes): the batch enters example-sharded over
    EVERY mesh axis (field_step.field_batch_specs), so the batch
    a2a / labels all_gather cross ``n_total`` chips while the
    feat-axis activation collectives cross only ``n`` — the two recv
    fractions differ."""
    f_pad = -(-F // n) * n
    f_local = f_pad // n
    lanes = cap if cap else B
    ring = 2 * (n - 1) / n  # ring all-reduce traffic factor
    recv = (n - 1) / n      # fraction of an all_to_all/all_gather that
    #                         crosses a link (the rest is already local)
    nt = n_total if n_total is not None else n
    recv_batch = (nt - 1) / nt  # batch-reshard fraction (total chips)
    a2a_cols = f_local * (8 if device_aux or not cap else 4)
    # host-compact skips the ids all_to_all (field_step._field_forward);
    # its aux arrives host->device, not over a link.
    return dict(
        f_pad=f_pad, f_local=f_local, lanes=lanes, ring=ring, recv=recv,
        per_chip={
            # Index ops against the BIG tables: the n-fold reduction
            # scale-out buys.
            "big_table_gather_lanes": lanes * f_local,
            "big_table_scatter_lanes": lanes * f_local,
            # [B]-lane work per owned field against SMALL (cap- or
            # B-sized) operands: compact expand + delta reorder + cumsum.
            "small_operand_lanes": (3 * B * f_local) if cap else 0,
            # Device-built aux only: one [B] stable sort per owned field.
            "aux_sort_lanes": (B * f_local) if (cap and device_aux) else 0,
        },
        ici={
            "a2a_batch": int(B * a2a_cols * recv_batch),
            "allgather_labels_weights": int(8 * B * recv_batch),
        },
    )


def field_sharded_costs(B: int, F: int, k: int, n: int, cap: int = 0,
                        device_aux: bool = False,
                        psum_dtype: str = "float32",
                        model: str = "fm", n_row: int = 1,
                        deep_sharded: bool = False) -> dict:
    """Exact per-rank work + link traffic counts for one step of the
    field-sharded fused step of ``model`` ('fm' | 'ffm' | 'deepfm').
    ``cap=0`` = plain (non-compact) path. ``psum_dtype`` is the wire
    dtype of the ACTIVATION collectives (TrainConfig.collective_dtype);
    ids stay int32 and the batch re-shard fp32. ``n_row`` > 1 models
    the 2-D (feat, row) mesh's EXTRA activation collective for FFM (the
    sel psum over ``row`` that completes the ownership-masked partials;
    ``n`` is then the feat extent, total chips = n·n_row). Byte counts
    per activation collective, by construction (field_step.py):

    - fm:     psum of (s[B,k], sq[B], lin[B])             → ring·w·B·(k+2)
    - ffm:    + sel all_to_all [B, f_local, F_pad, k]     → w·B·f_local·f_pad·k·recv
              (+ 2-D: sel psum over row                   → 2(r−1)/r·w·B·f_local·f_pad·k)
              (score psums are 2·[B] — pair, lin)
    - deepfm: fm's psum group + h all_gather [B, f_pad·k] → w·B·f_pad·k·recv
    """
    c = _base_counts(B, F, k, n, cap, device_aux,
                     n_total=n * n_row if n_row > 1 else None)
    w = _WIRE_BYTES[psum_dtype]
    ici = c["ici"]
    if n_row > 1 and model == "fm":
        raise ValueError(
            "n_row adds no FM activation collective to model (the "
            "score psums widen their axis set at the same [B, k+2] "
            "bytes — a ring-factor nuance, not a new term); pass the "
            "TOTAL chip count as n for a 2-D FM estimate"
        )
    row_ring = 2 * (n_row - 1) / n_row if n_row > 1 else 0.0
    if model == "fm":
        ici["psum_scores"] = int(c["ring"] * w * B * (k + 2))
    elif model == "ffm":
        # The all_to_all ships exactly the consumed target blocks, each
        # ordered pair block once; the bf16 wire halves it.
        sel_bytes = w * B * c["f_local"] * c["f_pad"] * k
        ici["a2a_sel"] = int(sel_bytes * c["recv"])
        if n_row > 1:
            ici["psum_sel_row"] = int(row_ring * sel_bytes)
        ici["psum_scores"] = int(c["ring"] * w * B * 2)
    elif model == "deepfm":
        ici["psum_scores"] = int(c["ring"] * w * B * (k + 2))
        if deep_sharded:
            # Example-sharded deep head (TrainConfig.deep_sharded): the
            # h all_gather becomes one forward a2a (each chip ships its
            # [B, f_local·k] columns, receives its [B/n, f_pad·k]
            # example rows — ≈ B·f_local·k bytes either direction), one
            # reverse a2a of the same size for the pullback, and a
            # [B]-scalar deep-score all_gather. The MLP-grad psum is
            # EXCLUDED: its bytes are the (fixed) MLP parameter count ·
            # ring, independent of B — and the model carries no MLP-size
            # input.
            a2a_h = int(w * B * c["f_local"] * k * c["recv"])
            ici["a2a_h_fwd"] = a2a_h
            ici["a2a_dh_bwd"] = a2a_h
            ici["allgather_deep_scores"] = int(w * B * c["recv"])
        else:
            ici["allgather_h"] = int(w * B * c["f_pad"] * k * c["recv"])
        if n_row > 1:
            # The h completion psum runs BEFORE the feat all_gather /
            # a2a, on each chip's [B, f_local·k] block (deepfm_step.py)
            # — first-order, comparable to allgather_h.
            ici["psum_h_row"] = int(row_ring * w * B * c["f_local"] * k)
    else:
        raise ValueError(f"unknown model {model!r}")
    ici["total"] = sum(v for kk, v in ici.items() if kk != "total")
    per_chip = c["per_chip"]
    per_chip["ici_bytes_per_step"] = ici
    per_chip["f_local"] = c["f_local"]
    return per_chip


def project_aggregate(single_chip_rate: float, B: int, F: int, k: int,
                      n: int, *, dispatch_ms: float,
                      replicated_score_ms_per_128k: float, link_gbps: float,
                      cap: int = 0, device_aux: bool = False,
                      psum_dtype: str = "float32", model: str = "fm",
                      score_sharded: bool = False, n_row: int = 1,
                      deep_sharded: bool = False,
                      measured_B: int = 131072) -> dict:
    """Projected n-card aggregate throughput from a MEASURED single-card
    rate, by the reference's model ``t(n) = t_fixed + t_rep(B) + (T1 −
    t_fixed − t_rep)/n + bytes/bw``. Every time input is required and
    echoed: ``dispatch_ms`` (per-step launch overhead), ``replicated_
    score_ms_per_128k`` (the [B, k] score math every rank repeats, at
    ``measured_B`` examples, scaled linearly in B) and ``link_gbps`` (the
    effective per-card link bandwidth). ``score_sharded`` (FM) moves the
    replicated term into the divided one and adds the ``[B]`` dscores
    gather."""
    if deep_sharded and model != "deepfm":
        raise ValueError("deep_sharded is the DeepFM step's lever")
    costs = field_sharded_costs(B, F, k, n, cap, device_aux,
                                psum_dtype=psum_dtype, model=model,
                                n_row=n_row, deep_sharded=deep_sharded)
    t1 = B / single_chip_rate
    t_fixed = dispatch_ms / 1e3
    t_rep = replicated_score_ms_per_128k / 1e3 * (B / measured_B)
    t_sharded = max(t1 - t_fixed - t_rep, 0.0)
    if score_sharded:
        if model != "fm":
            raise ValueError("score_sharded is the FM step's lever")
        ici = costs["ici_bytes_per_step"]
        ici["allgather_dscores"] = int(4 * B * (n - 1) / n)
        ici["total"] += ici["allgather_dscores"]
        t_sharded = t_sharded + t_rep
        t_rep = 0.0
    t_link = costs["ici_bytes_per_step"]["total"] / (link_gbps * 1e9)
    t_n = t_fixed + t_rep + t_sharded / n + t_link
    return {
        "model": "t(n) = t_fixed + t_rep(B) + (T1 - t_fixed - t_rep)/n"
                 " + bytes/bw",
        "inputs": {
            "single_chip_rate": round(single_chip_rate),
            "B": B, "F": F, "k": k, "n": n, "cap": cap,
            "device_aux": device_aux, "psum_dtype": psum_dtype,
            "step_model": model, "score_sharded": score_sharded,
            "deep_sharded": deep_sharded, "n_row": n_row,
            "dispatch_ms": dispatch_ms,
            "replicated_score_ms_per_128k": replicated_score_ms_per_128k,
            "link_gbps": link_gbps,
        },
        "per_chip": costs,
        "t_single_chip_ms": round(t1 * 1e3, 2),
        "t_projected_ms": round(t_n * 1e3, 2),
        "projected_aggregate_samples_per_sec": round(B / t_n),
        "projected_per_chip_samples_per_sec": round(
            B / t_n / (n * n_row)),
    }
