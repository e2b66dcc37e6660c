"""Quality and perf provenance ledger: append-only JSONL of measurements
(the port's copy of ``fm_spark_tpu/obs/ledger.py``).

Every record carries ``kind``, ``leg``, ``run_id`` and a measurement
``fingerprint`` (:func:`measurement_fingerprint`): the lever-config hash,
the card's name and count, the torch and CUDA versions, the degraded /
fused_fallback stamps, and the attachment-health verdict. Records whose
fingerprints share a ``key`` (:func:`fingerprint_key`) were measured
under comparable conditions: the cohort the regression
:mod:`~fm_spark_tpu_torch.obs.sentinel` judges over. The port's online
loop appends one ``quality_eval`` record per eval day (eval AUC as the
higher-is-better ``value``), under its own ``quality/<config>/<optimizer>``
leg namespace.

Where the reference fingerprints ``jax_version`` and ``libtpu_version``
(and the TPU's kind), the port fingerprints ``torch_version``,
``cuda_version`` and the card's name: the port's ledger is its own file,
never mixed with the JAX package's, and a cohort never spans the two.

Contracts, as the reference's: append-only; importable without a device
(the versions come from an already-imported torch); torn-tail tolerant
(:meth:`PerfLedger.records` skips a line that does not parse); and
schema'd (:meth:`PerfLedger.append` refuses a record without the
required provenance fields).
"""

from __future__ import annotations

import hashlib
import json
import os
import time

from fm_spark_tpu_torch.utils import durable

__all__ = [
    "LEDGER_FILE",
    "PerfLedger",
    "default_ledger_path",
    "fingerprint_key",
    "measurement_fingerprint",
]

#: One history file across runs: ``artifacts/obs/ledger_torch.jsonl``
#: (the JAX package's is ``ledger.jsonl``: the two never mix).
LEDGER_FILE = "ledger_torch.jsonl"

_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))

#: Fields every record must carry (the lint-enforced minimum).
REQUIRED_FIELDS = ("kind", "leg", "run_id", "fingerprint")

#: Fingerprint fields that define a comparability cohort. Everything
#: else in the fingerprint (attachment_health above all) is evidence
#: attached to one measurement, not a cohort splitter.
_KEY_FIELDS = ("config_hash", "device_kind", "n_chips", "torch_version",
               "cuda_version", "degraded", "fused_fallback")


def default_ledger_path(art_dir: str | None = None) -> str:
    """``<artifacts>/obs/ledger_torch.jsonl`` (default: the repo's
    ``artifacts/``)."""
    art_dir = art_dir or os.path.join(_REPO_ROOT, "artifacts")
    return os.path.join(art_dir, "obs", LEDGER_FILE)


def _stable_hash(obj) -> str:
    return hashlib.sha256(
        json.dumps(obj, sort_keys=True, default=str).encode()
    ).hexdigest()[:12]


def fingerprint_key(fp: dict) -> str:
    """The cohort key: a stable hash over the comparability-defining
    fingerprint fields (see :data:`_KEY_FIELDS`).

    ``chaos`` splits the cohort ONLY when set: a leg
    measured under an active fault schedule ran a different program in
    everything but name, so chaos-drill legs form their own cohort and
    can never join — or poison the trailing band of — a real perf
    cohort. Folded in asymmetrically (absent/falsy contributes nothing
    to the hash) so every pre-chaos historical key stays byte-stable.
    """
    src = {k: fp.get(k) for k in _KEY_FIELDS}
    if fp.get("chaos"):
        src["chaos"] = True
    return _stable_hash(src)


def measurement_fingerprint(*, variant: str, model: str | None = None,
                            batch: int | None = None,
                            steps: int | None = None,
                            rank: int | None = None,
                            extra: dict | None = None,
                            device_kind: str | None = None,
                            n_chips: int | None = None,
                            torch_version: str | None = None,
                            cuda_version: str | None = None,
                            degraded: bool = False,
                            fused_fallback: bool = False,
                            chaos: bool = False,
                            attachment_health: str = "healthy") -> dict:
    """Build one measurement fingerprint.

    ``config_hash`` digests the program identity (variant label +
    model/batch/steps/rank — the same fields the bench's provenance
    stamps protect — plus any caller-supplied ``extra`` shape/dtype
    fields: bench_kernels prices the SAME kernel at different
    width/cap/dtype, and those must be distinct cohorts); the
    environment fields ride alongside, and ``key`` is the cohort key.
    ``attachment_health`` is the supervisor-journal verdict for THIS
    measurement (``healthy | flaky | degraded | down``). ``chaos``
    marks a fault-drill measurement — its own cohort, never
    keep-best eligible.
    """
    ident = {"variant": variant, "model": model, "batch": batch,
             "steps": steps, "rank": rank}
    if extra:
        ident["extra"] = extra
    fp = {
        "config_hash": _stable_hash(ident),
        "variant": variant,
        "device_kind": device_kind,
        "n_chips": n_chips,
        "torch_version": torch_version,
        "cuda_version": cuda_version,
        "degraded": bool(degraded),
        "fused_fallback": bool(fused_fallback),
        "chaos": bool(chaos),
        "attachment_health": attachment_health,
    }
    fp["key"] = fingerprint_key(fp)
    return fp


def runtime_versions() -> dict:
    """``{"torch_version", "cuda_version", "device_kind"}`` from an
    already-imported torch (never imports it; ``device_kind`` is the
    card's name, None without one)."""
    import sys

    out = {"torch_version": None, "cuda_version": None,
           "device_kind": None}
    torch = sys.modules.get("torch")
    if torch is None:
        return out
    out["torch_version"] = getattr(torch, "__version__", None)
    try:
        out["cuda_version"] = torch.version.cuda
        if torch.cuda.is_available():
            out["device_kind"] = torch.cuda.get_device_name(0)
    except Exception:           # noqa: BLE001 — provenance is best-effort
        pass
    return out


class PerfLedger:
    """Append-only JSONL measurement history (see module docstring)."""

    def __init__(self, path: str | None = None):
        self.path = path or default_ledger_path()

    # ------------------------------------------------------------ write

    def append(self, record: dict) -> dict:
        """Append one record (returns it, ``ts``-stamped). Raises
        ``ValueError`` on a record missing the required provenance
        fields — an unattributable number must fail loudly at the
        call site, not surface as a hole in the history."""
        missing = [k for k in REQUIRED_FIELDS if not record.get(k)]
        if missing:
            raise ValueError(
                f"ledger record missing required field(s) {missing}; "
                f"every measurement needs {REQUIRED_FIELDS}"
            )
        fp = record["fingerprint"]
        if not isinstance(fp, dict) or not fp.get("key"):
            raise ValueError(
                "ledger record fingerprint must be a "
                "measurement_fingerprint() dict (with its cohort 'key')"
            )
        record = dict(record)
        record.setdefault("ts", round(time.time(), 3))
        try:
            os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                        exist_ok=True)
        except OSError:
            pass
        # Best-effort through the durable seam: a failing disk degrades
        # the history (counted: io.write_failed_total), never the run it
        # narrates.
        durable.append_line_path(self.path, json.dumps(record),
                                 path_class="obs", best_effort=True)
        return record

    # ------------------------------------------------------------- read

    def records(self, kind: str | None = None, leg: str | None = None,
                run_id: str | None = None,
                fingerprint_key: str | None = None) -> list[dict]:
        """All records in APPEND ORDER (the sentinel's history axis),
        optionally filtered. Missing file = empty history; torn or
        malformed lines are skipped."""
        out = []
        try:
            with open(self.path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if not isinstance(rec, dict):
                        continue
                    if kind is not None and rec.get("kind") != kind:
                        continue
                    if leg is not None and rec.get("leg") != leg:
                        continue
                    if run_id is not None and rec.get("run_id") != run_id:
                        continue
                    if fingerprint_key is not None and (
                            (rec.get("fingerprint") or {}).get("key")
                            != fingerprint_key):
                        continue
                    out.append(rec)
        except OSError:
            pass
        return out

    def cohort(self, leg: str, fingerprint_key: str) -> list[dict]:
        """The exact comparability cohort: same leg, same fingerprint
        key, append-ordered."""
        return self.records(leg=leg, fingerprint_key=fingerprint_key)
