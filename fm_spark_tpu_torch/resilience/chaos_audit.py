"""The chaos campaign's standalone auditors (the port's copy of
``fm_spark_tpu/resilience/chaos_audit.py``): serving, storage and fleet
invariants, judged from artifacts alone — standalone and import-free.

Split out of :mod:`fm_spark_tpu_torch.resilience.chaos` (which
re-exports it) so a light tool can load this file BY PATH without
importing the package (or torch): a run report audits every serve run it
renders, as the ledger and sentinel load standalone too. The invariants
and violation texts are the reference's, word for word.
"""

from __future__ import annotations

__all__ = ["audit_disk", "audit_fleet", "audit_serve_events"]


def _violation(invariant: str, detail: str) -> dict:
    return {"invariant": invariant, "detail": detail}


def audit_serve_events(events: list[dict], *,
                       final_staleness: int | None = None,
                       staleness_bound: int = 0,
                       rc: int | None = None,
                       allowed_rcs=(0,),
                       tombstoned_steps=()) -> list[dict]:
    """Serving invariants over a run's event stream —
    flight-ring records (``kind``) and journal records (``event``)
    both read. Empty list = green. The contracts:

    - **no_torn_swap** — every observed ``serve_swap`` advances the
      generation monotonically (step strictly up, ``gen_id`` by
      exactly one): a regressed or duplicated generation means a
      request could have seen a mixture of model states;
    - **no_tombstoned_generation** — no swap ever installed
      a DEMOTED generation: pass the chain's tombstoned step set and
      any ``serve_swap`` to one of them is a violation — the
      continuous-learning guarantee that a drift-judged-bad model was
      never scored with, asserted from artifacts alone;
    - **staleness_bounded** — after recovery the served generation is
      within ``staleness_bound`` steps of the chain's published tip
      (``final_staleness`` from the ``serve/staleness_steps`` gauge);
    - **rc_discipline** — a drilled serving process ends with an
      expected rc (0, the watchdog's HANG_EXIT_RC, or the injected
      exit code — never an unexplained death).

    Degraded mode is additionally held to its journaling contract:
    every ``reload_failed`` names the step it kept serving.
    """
    v: list[dict] = []
    stones = {int(s) for s in tombstoned_steps}
    last_step: int | None = None
    last_gen: int | None = None
    seen_swaps: set = set()
    for e in events:
        kind = e.get("kind") or e.get("event")
        if kind == "serve_swap":
            step, gid = e.get("step"), e.get("gen_id")
            if step is None:
                v.append(_violation(
                    "no_torn_swap",
                    "serve_swap event missing its generation step"))
                continue
            # One swap can reach the stream via two transports (the
            # journal AND its flight-ring mirror): an event identical
            # in (step, gen_id, from_step) is the same swap observed
            # twice, not a duplicated swap. A REAL duplicate (same
            # gen_id, different step — or vice versa) still trips the
            # monotonicity checks below.
            key = (step, gid, e.get("from_step"))
            if key in seen_swaps:
                continue
            seen_swaps.add(key)
            if step in stones:
                v.append(_violation(
                    "no_tombstoned_generation",
                    f"swap installed step {step}, which carries a "
                    "demotion tombstone — a drift-judged-bad "
                    "generation was served"))
            if last_step is not None and step <= last_step:
                v.append(_violation(
                    "no_torn_swap",
                    f"swap to step {step} after step {last_step} — "
                    "generations must advance monotonically"))
            if (gid is not None and last_gen is not None
                    and gid != last_gen + 1):
                v.append(_violation(
                    "no_torn_swap",
                    f"gen_id jumped {last_gen} -> {gid} — a swap was "
                    "lost or duplicated"))
            last_step = step
            last_gen = gid if gid is not None else last_gen
        elif kind == "reload_failed":
            if e.get("served_step") is None and "poll loop" not in str(
                    e.get("error", "")):
                v.append(_violation(
                    "degraded_journaled",
                    "reload_failed event does not name the generation "
                    "it kept serving"))
    if final_staleness is not None and final_staleness > staleness_bound:
        v.append(_violation(
            "staleness_bounded",
            f"served generation {final_staleness} step(s) behind the "
            f"published chain tip (bound {staleness_bound}) after "
            "recovery"))
    if rc is not None and rc not in tuple(allowed_rcs):
        v.append(_violation(
            "rc_discipline",
            f"serving process exited rc={rc}; expected one of "
            f"{tuple(allowed_rcs)}"))
    return v


def audit_disk(*, committed_steps=(), tombstoned_steps=(),
               last_good_step: "int | None" = None,
               restored_step: "int | None" = None,
               expected_surviving=None,
               io_failures: "dict | None" = None,
               degraded_gauge: "float | None" = None,
               params_match: "bool | None" = None,
               spool_seqs=None,
               events: "list[dict] | None" = None) -> list[dict]:
    """Storage-fault invariants, graded from artifacts
    alone: the chain reader's view (``committed_steps`` = manifest-
    verified, ``tombstoned_steps``, ``last_good_step``, and
    ``restored_step`` = where a FRESH reader actually landed after the
    plan cleared), the durable seam's failure accounting
    (``io_failures`` = :func:`fm_spark_tpu_torch.utils.durable.
    io_failure_counts` or the ``io.write_failed*`` counters,
    ``degraded_gauge`` = ``obs/io_degraded``), the golden-vs-drilled
    params fingerprint comparison (``params_match``), and the flight
    spool's ``seq`` column. Empty list = green. The contracts:

    - **last_good_loadable** — whenever any committed, non-demoted
      generation exists, ``last_good_step`` names one of them: never
      None, never a tombstoned step, never a step without a verified
      manifest. Disk faults may stall the pointer, never corrupt it.
    - **chain_never_broken** — after the fault plan clears, a fresh
      reader walks the chain to the NEWEST committed non-demoted step
      (torn/short reads walk back, they never crash-loop and never
      land past a demotion).
    - **demotion_atomic** — when the drill demoted (``expected_
      surviving`` = steps that must outlive it), the tombstone set is
      exactly the complement: no expected survivor demoted, no
      condemned step left standing — a torn rename mid-demotion is
      all-or-nothing.
    - **degradation_signaled** — best-effort (obs-tier) write failures
      leave a trail: the failure counts are nonzero AND the
      ``obs/io_degraded`` gauge is raised. Silent telemetry loss is
      the one degradation this plane forbids.
    - **obs_degraded_harmless** — the drilled run's final params are
      byte-identical to the golden run's (``params_match``): no obs
      write failure ever leaked into training bytes.
    - **spool_seq_continuous** — flight ``seq`` values on disk are
      strictly increasing (gaps are legal — a failed best-effort
      append loses that record from DISK, not from the ring — but a
      regressed or duplicated seq means a restart forked the stream).
    """
    v: list[dict] = []
    committed = {int(s) for s in committed_steps}
    stones = {int(s) for s in tombstoned_steps}
    good = committed - stones
    if good:
        if last_good_step is None:
            v.append(_violation(
                "last_good_loadable",
                f"no last_good pointer while committed non-demoted "
                f"steps {sorted(good)} exist"))
        elif int(last_good_step) in stones:
            v.append(_violation(
                "last_good_loadable",
                f"last_good names step {last_good_step}, which "
                "carries a demotion tombstone"))
        elif int(last_good_step) not in committed:
            v.append(_violation(
                "last_good_loadable",
                f"last_good names step {last_good_step}, which has "
                f"no verified manifest (committed: {sorted(committed)})"))
        if restored_step is not None and int(restored_step) != max(good):
            v.append(_violation(
                "chain_never_broken",
                f"fresh reader landed on step {restored_step} after "
                f"the plan cleared; the newest committed non-demoted "
                f"step is {max(good)}"))
    elif restored_step is not None:
        v.append(_violation(
            "chain_never_broken",
            f"fresh reader restored step {restored_step} but no "
            "committed non-demoted step exists"))
    if expected_surviving is not None:
        keep = {int(s) for s in expected_surviving}
        wrongly_demoted = sorted(keep & stones)
        left_standing = sorted((committed - keep) - stones)
        if wrongly_demoted:
            v.append(_violation(
                "demotion_atomic",
                f"steps {wrongly_demoted} were expected to survive "
                "the demotion but carry tombstones"))
        if left_standing:
            v.append(_violation(
                "demotion_atomic",
                f"condemned steps {left_standing} have no tombstone — "
                "the demotion tore"))
    fails = dict(io_failures or {})
    # The gauge contract binds the BEST-EFFORT tier (swallowed
    # failures); fail-loud failures surface to a caller who owns them
    # and need no ambient flag.
    n_fail = int(fails.get("best_effort") or 0)
    if n_fail and (degraded_gauge is None or degraded_gauge < 1.0):
        v.append(_violation(
            "degradation_signaled",
            f"{n_fail} best-effort write failure(s) swallowed but the "
            f"obs/io_degraded gauge reads {degraded_gauge!r} — "
            "telemetry loss must leave a visible mark"))
    if params_match is False:
        v.append(_violation(
            "obs_degraded_harmless",
            "drilled final params differ from the golden run's — an "
            "obs-tier disk fault leaked into training bytes"))
    if spool_seqs is not None:
        seqs = [int(s) for s in spool_seqs]
        for a, b in zip(seqs, seqs[1:]):
            if b <= a:
                v.append(_violation(
                    "spool_seq_continuous",
                    f"flight spool seq regressed {a} -> {b} — a "
                    "restart forked the event stream"))
                break
    return v


def audit_fleet(tap_events: list[dict], counters: dict, *,
                expected_requests: int | None = None,
                tombstoned_steps=(),
                replica_events: "dict[int, list[dict]] | None" = None,
                staleness_bound: int = 0,
                fleet_events: "list[dict] | None" = None,
                partition_victim: "int | None" = None,
                max_autoscale_decisions: "int | None" = None,
                max_direction_changes: int = 1) -> list[dict]:
    """Fleet/traffic invariants over a load-replay run,
    graded from artifacts alone: the loadgen **tap** (one record per
    attempt: ``req_id``/``attempt``/``outcome``/``gen_step``), the
    front door's counter snapshot (its ``frontdoor_summary`` journal
    event / ``FrontDoor.stats()``), and — optionally — each replica's
    serve journal (re-audited via :func:`audit_serve_events`).
    Empty list = green. The contracts:

    - **exactly_once_responses** — every scheduled request reached a
      terminal outcome at least once, no (req_id, attempt) was
      answered twice, and no req_id got more than one ``ok`` (a
      client only retries failures, so a double-ok means a dead
      replica's in-flight request was BOTH replayed and delivered);
    - **accepted_accounting** — the door's books close:
      ``accepted == answered + timeout + failed`` (an admitted
      request that vanished from the counters was silently dropped);
    - **shed_accounting** — the tap's observed ``shed`` outcomes
      equal the admission controller's ``shed`` counter, and
      ``shed == shed_queue + shed_deadline`` (the backpressure the
      clients experienced IS the backpressure the door accounted);
    - **no_tombstoned_generation** — no attempt was ever answered by
      a demoted generation (the tap carries the scoring generation);
      replica journals are additionally held to the full serve
      invariants (torn swaps, staleness after recovery).

    Partition-chaos extensions, graded from the fleet's
    own ``fleet_health.jsonl`` slice (``fleet_events``):

    - **partition_not_a_crash** — a replica partitioned away from the
      parent (``partition_victim``) was suspected -> drained ->
      readmitted through the normal green-poll gate, and NEVER
      respawn-killed: after its first ``replica_drained`` there is a
      ``replica_ready`` with no ``replica_spawn``/``replica_down``
      in between (the process stayed alive; only the LINK failed);
    - **autoscale_converged** — the autoscaler's journaled
      ``autoscale_decision`` events are bounded
      (``max_autoscale_decisions``) and do not flap: at most
      ``max_direction_changes`` grow<->shrink direction reversals.
    """
    v: list[dict] = []
    stones = {int(s) for s in tombstoned_steps}
    attempts = [e for e in tap_events
                if (e.get("event") or e.get("kind")) == "attempt"]
    seen: dict = {}
    ok_by_req: dict = {}
    n_shed = 0
    for e in attempts:
        rid, att = e.get("req_id"), e.get("attempt")
        out = e.get("outcome")
        key = (rid, att)
        if key in seen:
            v.append(_violation(
                "exactly_once_responses",
                f"request {rid} attempt {att} recorded twice — an "
                "in-flight request was answered more than once"))
        seen[key] = out
        if out == "ok":
            ok_by_req[rid] = ok_by_req.get(rid, 0) + 1
        elif out == "shed":
            n_shed += 1
        gs = e.get("gen_step")
        if gs is not None and int(gs) in stones:
            v.append(_violation(
                "no_tombstoned_generation",
                f"request {rid} was scored by demoted generation "
                f"{gs}"))
    for rid, n_ok in ok_by_req.items():
        if n_ok > 1:
            v.append(_violation(
                "exactly_once_responses",
                f"request {rid} answered ok {n_ok} times — retried "
                "after a success (double-scored to the client)"))
    if expected_requests is not None:
        got = len({rid for rid, _ in seen})
        if got != int(expected_requests):
            v.append(_violation(
                "exactly_once_responses",
                f"{got} of {expected_requests} scheduled requests "
                "reached a terminal outcome — the rest were "
                "silently dropped"))
    acc = int(counters.get("accepted") or 0)
    closed = (int(counters.get("answered") or 0)
              + int(counters.get("timeout") or 0)
              + int(counters.get("failed") or 0))
    if acc != closed:
        v.append(_violation(
            "accepted_accounting",
            f"accepted={acc} but answered+timeout+failed={closed} — "
            f"{acc - closed} admitted request(s) have no terminal "
            "outcome on the door's books"))
    shed = int(counters.get("shed") or 0)
    shed_split = (int(counters.get("shed_queue") or 0)
                  + int(counters.get("shed_deadline") or 0))
    if shed != shed_split:
        v.append(_violation(
            "shed_accounting",
            f"shed={shed} != shed_queue+shed_deadline={shed_split}"))
    if n_shed != shed:
        v.append(_violation(
            "shed_accounting",
            f"clients observed {n_shed} shed response(s) but the "
            f"admission controller counted {shed}"))
    for idx, events in (replica_events or {}).items():
        staleness = None
        for e in events:
            if (e.get("event") or e.get("kind")) == "replica_state":
                staleness = e.get("staleness_steps", staleness)
        # A SIGKILLed replica's respawn restarts the generation
        # sequence from the base model, so the monotonic-swap audit
        # holds WITHIN an incarnation, not across the journal: split
        # at each ``replica_start``. Tombstone/degraded contracts hold
        # for every segment regardless.
        segments: list[list[dict]] = [[]]
        for e in events:
            if (e.get("event") or e.get("kind")) == "replica_start":
                segments.append([])
            segments[-1].append(e)
        live = [s for s in segments if s]
        for inc, seg in enumerate(live):
            for viol in audit_serve_events(
                    seg, tombstoned_steps=stones,
                    final_staleness=(staleness
                                     if inc == len(live) - 1 else None),
                    staleness_bound=staleness_bound):
                viol = dict(viol)
                viol["detail"] = (f"replica {idx} incarnation {inc}: "
                                  f"{viol['detail']}")
                v.append(viol)
    fev = fleet_events or []
    if partition_victim is not None:
        vic = int(partition_victim)
        timeline = [(e.get("event") or e.get("kind")) for e in fev
                    if e.get("replica") == vic]
        try:
            first_drain = timeline.index("replica_drained")
        except ValueError:
            first_drain = None
        if first_drain is None:
            v.append(_violation(
                "partition_not_a_crash",
                f"replica {vic} was the partition victim but was "
                "never drained — the fault plane did not reach the "
                "health poller"))
        else:
            after = timeline[first_drain + 1:]
            if "replica_ready" not in after:
                v.append(_violation(
                    "partition_not_a_crash",
                    f"replica {vic} was drained but never readmitted "
                    "after the partition healed"))
            else:
                upto = after[:after.index("replica_ready")]
                bad = [k for k in upto
                       if k in ("replica_spawn", "replica_down")]
                if bad:
                    v.append(_violation(
                        "partition_not_a_crash",
                        f"replica {vic} saw {bad} between drain and "
                        "readmission — a partitioned-but-alive "
                        "replica was treated as a crash"))
    if max_autoscale_decisions is not None:
        actions = [e.get("action") for e in fev
                   if (e.get("event") or e.get("kind"))
                   == "autoscale_decision"]
        if len(actions) > int(max_autoscale_decisions):
            v.append(_violation(
                "autoscale_converged",
                f"{len(actions)} autoscale decisions "
                f"(bound {max_autoscale_decisions}) — the policy did "
                "not converge"))
        flips = sum(1 for a, b in zip(actions, actions[1:])
                    if a != b)
        if flips > int(max_direction_changes):
            v.append(_violation(
                "autoscale_converged",
                f"autoscaler flapped: {flips} grow<->shrink "
                f"reversals (bound {max_direction_changes}) in "
                f"{actions}"))
    return v
