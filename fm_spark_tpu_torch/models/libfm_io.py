"""libFM text model format, import and export (the port of
``fm_spark_tpu/models/libfm_io.py``).

Rendle's libFM ``--save_model`` text format is the interchange format of
FM weights in the spark-libFM lineage. Its sections are present iff the
dim flags ``k0``/``k1``/``k2`` enable them::

    #global bias W0
    <w0>
    #unary interactions Wj
    <one weight per line, feature-major>
    #pairwise interactions Vj,f
    <k space-separated factors per line, feature-major>

Export flattens a FieldFM to the plain ``[n, k]`` table first and writes
each value with ``%.17g`` of its float64 widening, so the same params
give the same bytes as the reference's file. Import always yields a flat
:class:`~fm_spark_tpu_torch.models.fm.FMSpec` and tensors on the
requested device. The tables are formatted a chunk of rows at a time by
one ``%`` of a repeated line template and read back by ``np.loadtxt``,
which checks that every line of a section has the same count of values.
"""

from __future__ import annotations

import io

import numpy as np
import torch

_BIAS_HDR = "#global bias W0"
_UNARY_HDR = "#unary interactions Wj"
_PAIR_HDR = "#pairwise interactions Vj,f"
_CHUNK_ROWS = 4096


def _host32(t) -> np.ndarray:
    """A tensor (or array) as float32 numpy: bf16 and float32 widen to
    float64 through it exactly, as the reference's ``np.asarray(...,
    np.float64)`` widens them."""
    if isinstance(t, torch.Tensor):
        t = t.detach().to("cpu", torch.float32).numpy()
    return np.asarray(t, np.float32)


def _write_rows(f, rows: np.ndarray) -> None:
    """``rows`` (``[n, cols]``) one line each, every value ``%.17g`` of its
    float64 widening, joined by ``' '``: the reference's bytes."""
    rows = np.asarray(rows, np.float64)
    line = " ".join(["%.17g"] * rows.shape[1]) + "\n"
    for start in range(0, rows.shape[0], _CHUNK_ROWS):
        chunk = rows[start:start + _CHUNK_ROWS]
        f.write((line * chunk.shape[0]) % tuple(chunk.ravel().tolist()))


def save_libfm(path: str, spec, params: dict) -> None:
    """Write ``params`` in libFM text format (sections by the dim flags).
    A FieldFM is flattened first; FFM and DeepFM raise (their ``[n, F,
    k]`` factors and MLP have no libFM form)."""
    from fm_spark_tpu_torch.models.field_fm import FieldFMSpec
    from fm_spark_tpu_torch.models.fm import FMSpec

    if isinstance(spec, FieldFMSpec):
        params = spec.to_flat_params(params)
    elif not isinstance(spec, FMSpec):
        raise ValueError(
            f"libFM format holds plain FM models only, not "
            f"{type(spec).__name__}")
    w0 = float(_host32(params["w0"]))
    v = _host32(params["v"])
    with open(path, "w") as f:
        if spec.use_bias:
            f.write(f"{_BIAS_HDR}\n{w0:.17g}\n")
        if spec.use_linear:
            f.write(_UNARY_HDR + "\n")
            _write_rows(f, _host32(params["w"]).reshape(-1, 1))
        f.write(_PAIR_HDR + "\n")
        _write_rows(f, v.reshape(v.shape[0], -1))


def _sections(path: str) -> dict:
    """Each ``#``-line of the file → the bytes of its body, up to the next
    ``#``-line (the last of two equal headers wins, text before the first
    is ignored), as the reference's line loop reads them."""
    with open(path, "rb") as f:
        data = f.read()
    starts = [0] if data.startswith(b"#") else []
    at = data.find(b"\n#")
    while at >= 0:
        starts.append(at + 1)
        at = data.find(b"\n#", at + 1)
    out = {}
    for i, start in enumerate(starts):
        eol = data.find(b"\n", start)
        eol = len(data) if eol < 0 else eol
        end = starts[i + 1] if i + 1 < len(starts) else len(data)
        out[data[start:eol].decode()] = data[eol + 1:end]
    return out


def _read_rows(body: bytes, what: str) -> np.ndarray:
    """A section's non-blank lines as float32 ``[rows, cols]``, each value
    read as float64 and rounded once, as the reference's ``float()``
    then ``np.float32``. No line, or lines of unequal counts, raise."""
    if not body.strip():
        raise ValueError(f"{what}: no rows")
    with io.StringIO(body.decode()) as text:
        rows = np.loadtxt(text, dtype=np.float64, ndmin=2, comments=None)
    return rows.astype(np.float32)


def load_libfm(path: str, task: str = "classification", device=None,
               **spec_kwargs):
    """Read a libFM text model → ``(FMSpec, params)``, the params on
    ``device`` (the card unless ``device="cpu"``). ``spec_kwargs`` pass
    through to :class:`FMSpec` (e.g. a regression clip); a missing section
    turns its dim flag off."""
    from fm_spark_tpu_torch import resolve_device
    from fm_spark_tpu_torch.models.fm import FMSpec

    dev = resolve_device(device)
    sections = _sections(path)
    if _PAIR_HDR not in sections:
        raise ValueError(f"{path}: missing {_PAIR_HDR!r} section")
    v = _read_rows(sections[_PAIR_HDR], f"{path}: {_PAIR_HDR!r}")
    n, rank = v.shape
    use_bias = _BIAS_HDR in sections
    use_linear = _UNARY_HDR in sections
    w0 = (float(next(ln for ln in sections[_BIAS_HDR].split(b"\n")
                     if ln.strip())) if use_bias else 0.0)
    if use_linear:
        w = _read_rows(sections[_UNARY_HDR], f"{path}: {_UNARY_HDR!r}")
        if w.shape[1] != 1:
            raise ValueError(f"{path}: {w.shape[1]} values on a line of "
                             f"{_UNARY_HDR!r}, want one")
        w = w.reshape(-1)
        if w.shape[0] != n:
            raise ValueError(
                f"{path}: {w.shape[0]} unary weights but {n} factor rows")
    else:
        w = np.zeros((n,), np.float32)
    spec = FMSpec(num_features=n, rank=rank, task=task, use_bias=use_bias,
                  use_linear=use_linear, **spec_kwargs)
    params = {
        "w0": torch.tensor(np.float32(w0), device=dev),
        "w": torch.from_numpy(w).to(dev, spec.pdtype),
        "v": torch.from_numpy(v).to(dev, spec.pdtype),
    }
    return spec, params
