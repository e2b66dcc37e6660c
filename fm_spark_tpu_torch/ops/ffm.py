"""Field-aware factorization machine (FFM) interaction math over one flat
table (the port of ``fm_spark_tpu/ops/ffm.py``).

Each feature ``i`` carries one latent vector per field, ``V ∈ R^{n × F ×
k}``, and the pairwise term uses the opposite slot's field::

    ŷ_ffm = Σ_{i<j} <v[i, field(j)], v[j, field(i)]> x_i x_j

With the CTR fixed-slot encoding (one feature per field per example,
``field(slot j) = j``) the gathered rows ``v[ids]`` reshaped to ``[B, F,
F·k]`` are exactly the layout of the sel-blocked FFM kernels
(``ops.ffm_sel``): row ``b``, owner slot ``i``, columns ``j·k:(j+1)·k``
the vector toward field ``j``. On CUDA that layout goes through
``ffm_sel_scores``; an explicit ``fields`` vector (slots in other fields)
runs the reference's formula in plain PyTorch on any device, the library
path. On the CPU the reference's formula runs either way.
"""

from __future__ import annotations

import torch

from fm_spark_tpu_torch.ops import ffm_sel
from fm_spark_tpu_torch.ops.fm import gather_index, sum_upcast


def _pairwise(rows, fields, vals_c):
    """The reference's pairwise term from ``rows [B, nnz, F, k]`` (compute
    dtype): ``sel[b, i, j] = v[id_i, field(j)]·x_i`` (field ids clipped
    into range, as ``jnp.take(mode='clip')``), ``a = Σ_k sel·selᵀ`` and
    ``½·(Σ a − trace a)``, every sum ``jnp.sum``'s (bf16 accumulated in
    float32, rounded once)."""
    fields = fields.long().clamp(0, rows.shape[2] - 1)
    sel = rows.index_select(2, fields) * vals_c[:, :, None, None]
    a = sum_upcast(sel * sel.transpose(1, 2), -1)              # [B, i, j]
    diag = sum_upcast(torch.diagonal(a, dim1=1, dim2=2), -1)
    return 0.5 * (sum_upcast(a, (1, 2)) - diag)


def ffm_scores(w0: torch.Tensor, w: torch.Tensor, v: torch.Tensor,
               ids: torch.Tensor, vals: torch.Tensor, fields=None,
               compute_dtype=torch.float32) -> torch.Tensor:
    """Batched FFM raw scores ``w0 + Σ_i w_i x_i + ŷ_ffm`` (``[B]``, the
    compute dtype).

    ``w0`` a scalar, ``w`` ``[n]``, ``v`` ``[n, F, k]``, ``ids`` ``[B,
    nnz]`` (JAX's index rules: an id in ``[-n, 0)`` counts from the end,
    any other clamps into the table), ``vals`` ``[B, nnz]`` (0 ⇒ a padded
    slot). ``fields`` is the ``[nnz]`` field id of each slot; by default
    ``arange(nnz)``, which needs ``nnz == F``. Field ids outside ``[0, F)``
    raise (checked on the host, as the reference checks a concrete
    vector)."""
    nnz = ids.shape[1]
    num_fields = v.shape[1]
    cd = compute_dtype
    if fields is None:
        if nnz != num_fields:
            raise ValueError(
                f"default slot==field layout needs nnz ({nnz}) == F "
                f"({num_fields}); pass an explicit `fields` vector otherwise")
    else:
        fields = torch.as_tensor(fields, dtype=torch.int32, device=v.device)
        if tuple(fields.shape) != (nnz,):
            raise ValueError(f"fields must have shape ({nnz},), got "
                             f"{tuple(fields.shape)}")
        lo, hi = int(fields.min()), int(fields.max())
        if hi >= num_fields or lo < 0:
            raise ValueError(f"field ids must be in [0, {num_fields}); got "
                             f"range [{lo}, {hi}]")
    vals_c = vals.to(cd)
    gidx = gather_index(ids, v.shape[0])
    linear = sum_upcast(w[gidx].to(cd) * vals_c, 1)
    if fields is None and v.device.type == "cuda":
        rows = v[gidx].to(cd).reshape(ids.shape[0], nnz, -1)
        pairwise = 0.5 * ffm_sel.ffm_sel_scores(rows, vals_c)
    else:
        if fields is None:
            fields = torch.arange(nnz, device=v.device)
        pairwise = _pairwise(v[gidx].to(cd), fields, vals_c)
    return w0.to(cd) + linear + pairwise


def ffm_scores_dense(w0, w, v, ids, vals, fields=None):
    """Explicit per-pair FFM, the test oracle of :func:`ffm_scores`: a
    Python double loop over slot pairs, the literal FFM definition (tiny
    nnz only), in numpy on the arrays as given, accumulated in a Python
    float, as the reference's oracle. Returns float32 ``[B]``."""
    import numpy as np

    ids = np.asarray(ids)
    vals = np.asarray(vals)
    w0 = float(np.asarray(w0))
    w = np.asarray(w)
    v = np.asarray(v)
    b, nnz = ids.shape
    if fields is None:
        fields = np.arange(nnz)
    out = np.zeros((b,), dtype=np.float64)
    for bi in range(b):
        y = w0
        for i in range(nnz):
            y += w[ids[bi, i]] * vals[bi, i]
        for i in range(nnz):
            for j in range(i + 1, nnz):
                vi = v[ids[bi, i], fields[j]]
                vj = v[ids[bi, j], fields[i]]
                y += float(vi @ vj) * vals[bi, i] * vals[bi, j]
        out[bi] = y
    return out.astype(np.float32)
