"""Final-model save/load in the JAX package's model-dir format (the port
of ``fm_spark_tpu/models/io.py``).

A model dir holds ``spec.json`` (``{"family", "spec", "param_dtypes"}``)
and ``params.npz`` (flat arrays named by their path in the parameter
tree, JAX's keypath join: ``w0``, ``w`` and ``v`` for the flat FM and
FFM (``v`` ``[n, F, k]``), with ``mlp/{i}/kernel`` and ``mlp/{i}/bias``
for DeepFM,
``w0``, ``vw/0`` … ``vw/{F-1}`` for the field families, and for
FieldDeepFM ``mlp/{i}/kernel`` and ``mlp/{i}/bias``). bf16 arrays are
widened to float32 on disk and restored from ``param_dtypes`` on load, so
a dir written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os

import numpy as np
import torch

from fm_spark_tpu_torch import resolve_device
from fm_spark_tpu_torch.models.base import torch_dtype
from fm_spark_tpu_torch.models.deepfm import DeepFMSpec
from fm_spark_tpu_torch.models.ffm import FFMSpec
from fm_spark_tpu_torch.models.field_deepfm import FieldDeepFMSpec
from fm_spark_tpu_torch.models.field_ffm import FieldFFMSpec
from fm_spark_tpu_torch.models.field_fm import FieldFMSpec
from fm_spark_tpu_torch.models.fm import FMSpec

_FAMILIES = {"FMSpec": FMSpec, "FFMSpec": FFMSpec, "DeepFMSpec": DeepFMSpec,
             "FieldFMSpec": FieldFMSpec, "FieldFFMSpec": FieldFFMSpec,
             "FieldDeepFMSpec": FieldDeepFMSpec}


def _table_names(spec) -> list[str]:
    if type(spec) in (FMSpec, FFMSpec, DeepFMSpec):
        return ["w", "v"]
    groups = ("vw",) if spec.fused_linear else ("v", "w")
    return [f"{g}/{f}" for g in groups for f in range(spec.num_fields)]


def _mlp_names(spec) -> list[str]:
    if not hasattr(spec, "mlp_dims"):
        return []
    return [f"mlp/{i}/{leaf}" for i in range(len(spec.mlp_dims) + 1)
            for leaf in ("kernel", "bias")]


def param_names(spec) -> list[str]:
    """The keypath names of a spec's parameters, in the model dir's order."""
    return ["w0", *_table_names(spec), *_mlp_names(spec)]


def flatten(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """The leaves of a nested dict/list tree under their keypath names
    (``w0``, ``vw/0``, ``mlp/0/kernel`` …), JAX's keypath join."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    flat = {}
    for key, leaf in items:
        flat.update(flatten(leaf, f"{prefix}/{key}" if prefix else str(key)))
    return flat


def unflatten(flat: dict, names) -> dict:
    """The nested tree of ``flat``'s entries under ``names`` (keypaths; a
    level whose keys are all digits is a list)."""
    groups: dict[str, list[str]] = {}
    for name in names:
        head, _, rest = name.partition("/")
        groups.setdefault(head, []).append(rest)
    tree = {}
    for head, rests in groups.items():
        if rests == [""]:
            tree[head] = flat[head]
            continue
        sub = unflatten({r: flat[f"{head}/{r}"] for r in rests}, rests)
        tree[head] = ([sub[str(i)] for i in range(len(sub))]
                      if all(k.isdigit() for k in sub) else sub)
    return tree


def params_from_numpy(spec, flat: dict, device=None,
                      dtypes: dict | None = None) -> dict:
    """Parameters for ``spec`` on ``device`` from numpy arrays under the
    npz names (``w0``, ``w``, ``v``, ``vw/0`` …, ``mlp/0/kernel`` …) — the carrier that
    moves JAX parameters into the port. ``dtypes`` maps names to dtype
    names ('float32' | 'bfloat16'); by default tables take the spec's
    ``param_dtype``, ``w0`` and the MLP float32."""
    dev = resolve_device(device)
    dtypes = dtypes or {}
    tables = _table_names(spec)
    names = param_names(spec)
    missing = [n for n in names if n not in flat]
    if missing:
        raise KeyError(f"parameters missing for {type(spec).__name__}: {missing}")
    out = {}
    for name in names:
        arr = np.asarray(flat[name])
        if arr.dtype.name == "bfloat16":      # ml_dtypes arrays from JAX
            arr = arr.astype(np.float32)
        default = spec.param_dtype if name in tables else "float32"
        want = torch_dtype(dtypes.get(name, default))
        out[name] = torch.from_numpy(np.require(arr, requirements=["C", "W"])).to(
            device=dev, dtype=want)
    out["w0"] = out["w0"].reshape(())
    return unflatten(out, names)


def save_model(path: str, spec, params: dict) -> None:
    """Write spec.json + params.npz under ``path`` (a directory)."""
    os.makedirs(path, exist_ok=True)
    meta = {"family": type(spec).__name__, "spec": dataclasses.asdict(spec)}
    # JSON can't hold inf; the regression clip defaults are ±inf.
    for key in ("min_target", "max_target"):
        if not math.isfinite(meta["spec"][key]):
            meta["spec"][key] = None
    flat, dtypes = {}, {}
    for name, t in flatten(params).items():
        dtypes[name] = str(t.dtype).removeprefix("torch.")
        flat[name] = t.detach().to("cpu", torch.float32).numpy()
    meta["param_dtypes"] = dtypes
    with open(os.path.join(path, "spec.json"), "w") as f:
        json.dump(meta, f, indent=2)
    np.savez(os.path.join(path, "params.npz"), **flat)


def load_model(path: str, device=None):
    """Read back ``(spec, params)`` with the params on ``device``."""
    dev = resolve_device(device)
    with open(os.path.join(path, "spec.json")) as f:
        meta = json.load(f)
    family = _FAMILIES.get(meta["family"])
    if family is None:
        raise ValueError(f"model family {meta['family']!r} is not ported yet "
                         f"(ported: {sorted(_FAMILIES)})")
    kwargs = dict(meta["spec"])
    if kwargs.get("min_target") is None:
        kwargs["min_target"] = -math.inf
    if kwargs.get("max_target") is None:
        kwargs["max_target"] = math.inf
    if "mlp_dims" in kwargs:
        kwargs["mlp_dims"] = tuple(kwargs["mlp_dims"])
    spec = family(**kwargs)
    with np.load(os.path.join(path, "params.npz")) as npz:
        flat = {k: npz[k] for k in npz.files}
    return spec, params_from_numpy(spec, flat, dev, meta.get("param_dtypes"))
