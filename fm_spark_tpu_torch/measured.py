"""Single source of truth for MEASURED card rates (the port of
``fm_spark_tpu/measured.py``).

Every projection that starts from a measured single-card rate must load
the rate from the repo-root ``MEASURED_torch.json`` via
:func:`load_measured` instead of hard-coding it. The port's benchmark
REWRITES an entry whenever a run lands a real number
(:func:`update_entry`), so a stale projection constant cannot survive a
new measurement; the provenance fields (``source``, ``date``,
``attachment`` — the card's name) travel with the number so downstream
artifacts can name where their input came from. The file is the port's
own: the repo's ``MEASURED.json`` holds the JAX package's TPU rates and
is never read here.

Schema (the reference's: two required entries, each with provenance)::

    {"headline":  {"rate_samples_per_sec_per_chip": float, "vs_baseline":
                   float|None, "variant": str, "source": str,
                   "attachment": str, "date": "YYYY-MM-DD"},
     "ffm_avazu": {"rate_samples_per_sec_per_chip": float, "source": str,
                   "date": "YYYY-MM-DD"}}
"""

from __future__ import annotations

import json
import os

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEASURED_FILE = "MEASURED_torch.json"
MEASURED_PATH = os.path.join(_REPO_ROOT, MEASURED_FILE)

_FIELDS = ("rate_samples_per_sec_per_chip", "source", "date")
# Entries that must exist in a valid file: config 3's training headline
# and config 4's (FieldFFM on Avazu) rate.
_REQUIRED = {"headline": _FIELDS, "ffm_avazu": _FIELDS}
# Entries a benchmark MAY write once measured (their absence is valid):
# config 5's and config 2's training rates, and "serving" (scored
# rows/s/card through the bucketed request path).
_OPTIONAL = {"deepfm_criteo": _FIELDS, "fm_kaggle": _FIELDS,
             "serving": _FIELDS}
_KNOWN = {**_REQUIRED, **_OPTIONAL}


def load_measured(path: str | None = None) -> dict:
    """Load and validate the file. Fails loudly — no silent default:
    a missing/invalid file means the provenance chain is broken and any
    projection made from a guessed rate would be exactly the stale-constant
    failure mode this module exists to kill."""
    p = path or MEASURED_PATH
    with open(p) as f:
        data = json.load(f)
    for key in _REQUIRED:
        if key not in data:
            raise ValueError(f"{MEASURED_FILE} missing entry {key!r}")
    for key, entry in data.items():
        fields = _KNOWN.get(key)
        if fields is None:
            raise ValueError(f"{MEASURED_FILE} unknown entry {key!r}")
        for field in fields:
            if field not in entry:
                raise ValueError(
                    f"{MEASURED_FILE} entry {key!r} missing field {field!r}")
        rate = entry["rate_samples_per_sec_per_chip"]
        if not (isinstance(rate, (int, float)) and rate > 0):
            raise ValueError(
                f"{MEASURED_FILE} {key}: bad rate {rate!r}")
    return data


def update_entry(key: str, rate: float, variant: str, source: str,
                 attachment: str, date: str,
                 vs_baseline: float | None = None,
                 path: str | None = None) -> None:
    """Rewrite one entry (called by a benchmark on a successful run),
    preserving the other entries and their provenance."""
    if key not in _KNOWN:
        raise ValueError(f"unknown {MEASURED_FILE} entry {key!r}")
    p = path or MEASURED_PATH
    try:
        with open(p) as f:
            data = json.load(f)
    except FileNotFoundError:
        data = {}  # first-ever measurement: start a fresh file
    # Any other read/parse failure propagates: silently rewriting a
    # corrupt file would discard the other entries and their
    # provenance — the destructive version of the stale-constant bug.
    entry = {
        "rate_samples_per_sec_per_chip": float(rate),
        "variant": variant,
        "source": source,
        "attachment": attachment,
        "date": date,
    }
    if key == "headline":
        entry["vs_baseline"] = vs_baseline
    data[key] = entry
    tmp = p + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=2)
        f.write("\n")
    os.replace(tmp, p)


def update_headline(rate: float, vs_baseline: float | None,
                    variant: str, source: str, attachment: str,
                    date: str, path: str | None = None) -> None:
    update_entry("headline", rate, variant, source, attachment, date,
                 vs_baseline=vs_baseline, path=path)
