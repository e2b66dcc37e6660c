"""The port's FieldDeepFM hybrid step (tables by the fused sparse rule with
the MLP's pullback, the MLP and ``w0`` by Adam) against the JAX package's
``make_field_deepfm_sparse_step``, at a small size: 4 fields, 32 buckets,
rank 4, ``mlp_dims`` (16, 16, 16), B = 64.

Parameters are drawn by JAX and carried across by ``params_from_numpy``;
batches are numpy from a seed, with duplicate (Zipf) ids and zero-weight
rows. JAX's step is compiled with ``xla_allow_excess_precision`` off, so
XLA rounds every bf16 operation as the program writes it. The SR bits of
``dedup_sr`` are JAX's own key schedule on both sides.

Tolerances, and why:

- float32 compute and tables: the loss within ``rtol=1e-6``, every
  table and Adam moment within ``rtol=1e-5, atol=1e-7`` after three
  steps: the two sides' matrix products and batch sums add in different
  orders (a few float32 ulps). ``w0`` and the MLP, which Adam updates,
  within ``rtol=1e-5`` and ``atol=1e-7 + 1e-3·lr``: Adam's update
  ``lr·m̂/(√v̂ + ε)`` is scale-free, so where a gradient's batch sum
  cancels to a few ulps of its terms the summation order reaches
  ``m̂/√v̂`` itself (measured up to 3.7e-4·lr beyond ``rtol`` over eight
  seeds of batches, one of them the roll's).
- bf16 compute (the registered recipe: bf16 tables, ``dedup_sr``, the
  host's compact aux): the MLP's bf16 products round the same float32
  sums to bf16, but the sums add in another order, and XLA's CPU sums a
  bf16 bias gradient in bf16 in an order of its own where the port sums
  in float32 and rounds once. Adam's scale-free update turns an ulp of a
  small gradient into a different step, so single elements are not held:
  the tables, and the dense side (``w0`` and the MLP), each differ from
  JAX's by at most 20 % (L2) of how far JAX's moved from the initial
  params; Adam's moments by at most 25 % of their norm; the loss by
  1e-3. Measured over eight seeds of batches: tables ≤ 9 %, dense side
  ≤ 4.3 %, moments ≤ 12 %, loss ≤ 3e-4; the variant without the deep
  pullback moves the tables 41-72 % off, the one without Adam's bias
  correction the dense side ≥ 270 %.

Each tolerance is shown to catch a wrong formula: the step without the
deep head's pullback in the table gradient, and Adam without its bias
correction, both fail it (``test_the_tolerance_catches_*``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_spark_tpu import sparse as jsparse
from fm_spark_tpu import train as jtrain
from fm_spark_tpu.models.field_deepfm import FieldDeepFMSpec as JSpec
from fm_spark_tpu_torch import models, sparse
from fm_spark_tpu_torch import train as ptrain
from fm_spark_tpu_torch.models.io import flatten
from fm_spark_tpu_torch.ops import scatter
from fm_spark_tpu_torch.train import TrainConfig

from test_torch_capture import NoHostSync, _jit_exact

B, F, BUCKET, K, CAP = 64, 4, 32, 4, 32
MLP = (16, 16, 16)
STEPS = 3
LR = 0.05


def _specs(pd, cd):
    kw = dict(num_features=F * BUCKET, num_fields=F, bucket=BUCKET, rank=K,
              mlp_dims=MLP, param_dtype=pd, compute_dtype=cd, init_std=0.1)
    return JSpec(**kw), models.FieldDeepFMSpec(**kw)


def _jflat(tree) -> dict:
    """A JAX tree as numpy float32 copies under its keypath names."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        out[name] = np.array(jnp.asarray(leaf).astype(jnp.float32)
                             if jnp.issubdtype(jnp.asarray(leaf).dtype,
                                               jnp.floating)
                             else leaf)
    return out


def _params(jspec, pspec, seed=0):
    """JAX-initialised params with a random linear column and bias, and
    the port's copy of them."""
    jp = jspec.init(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    flat = _jflat(jp)
    flat["w0"] = np.float32(0.1)
    for f in range(F):
        flat[f"vw/{f}"][:, -1] = rng.normal(size=BUCKET) * 0.2
    jp = {"w0": jnp.float32(0.1),
          "vw": [jnp.asarray(flat[f"vw/{f}"].copy()).astype(jspec.pdtype)
                 for f in range(F)],
          "mlp": jp["mlp"]}
    return jp, models.params_from_numpy(pspec, flat, "cpu")


def _batches(n, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = (rng.zipf(1.3, (B, F)) % BUCKET).astype(np.int32)
        vals = rng.uniform(0.5, 1.5, (B, F)).astype(np.float32)
        labels = rng.integers(0, 2, B).astype(np.float32)
        weights = np.ones(B, np.float32)
        weights[-5:] = 0.0                      # padded tail lanes
        out.append((ids, vals, labels, weights))
    return out


def _aux(lever, ids):
    if not lever.get("host_dedup"):
        return None
    return (scatter.compact_aux(ids, CAP) if lever.get("compact_cap")
            else scatter.dedup_aux(ids))


def _state_flat(jopt) -> dict:
    """JAX's Adam state as the port's flat names (``count``, ``mu/...``,
    ``nu/...``)."""
    adam = jopt[0]
    out = {"count": np.asarray(adam.count)}
    out.update({f"mu/{k}": v for k, v in _jflat(adam.mu).items()})
    out.update({f"nu/{k}": v for k, v in _jflat(adam.nu).items()})
    return out


def _np(t):
    return t.float().numpy() if t.is_floating_point() else t.numpy()


# The forms of the step, with the dtypes each runs in.
COMPACT = dict(host_dedup=True, compact_cap=CAP)
FORMS = {
    "scatter_add-fp32": ("float32", dict(sparse_update="scatter_add")),
    "dedup-fp32": ("float32", dict(sparse_update="dedup")),
    "gfull-fp32": ("float32", dict(sparse_update="dedup", gfull_fused=True)),
    "compact_device-fp32": ("float32", dict(
        sparse_update="dedup", compact_device=True, compact_cap=CAP)),
    "segtotal-fp32": ("float32", dict(sparse_update="dedup", **COMPACT,
                                      gfull_fused=True,
                                      segtotal_pallas=True)),
    "use_pallas-fp32": ("float32", dict(sparse_update="scatter_add",
                                        use_pallas=True)),
    "recipe-bf16": ("bfloat16", dict(sparse_update="dedup_sr", **COMPACT)),
    "gfull-bf16": ("bfloat16", dict(sparse_update="dedup_sr", **COMPACT,
                                    gfull_fused=True)),
}


def _cfg(lever, **kw):
    return dict(learning_rate=LR, lr_schedule="constant", optimizer="adam",
                reg_factors=1e-4, reg_linear=1e-5, reg_bias=1e-6, seed=3,
                **lever, **kw)


def _run_both(form, steps=STEPS):
    """``steps`` steps of JAX's jitted step and of the port's body from the
    same params and batches: ``(jax losses, port losses, jax params flat,
    port params flat, jax Adam flat, port Adam flat)``."""
    dt, lever = FORMS[form]
    jspec, pspec = _specs(dt, dt)
    cfg = _cfg(lever)
    jbody, jinit = jsparse.make_field_deepfm_sparse_body(
        jspec, jtrain.TrainConfig(**cfg))
    jstep = _jit_exact(jbody)
    pstep = sparse.make_field_deepfm_sparse_step(pspec, TrainConfig(**cfg))
    jp, pp = _params(jspec, pspec)
    jo, po = jinit(jp), pstep.init_opt_state(pp)
    jl, pl = [], []
    for i, batch in enumerate(_batches(steps)):
        aux = _aux(lever, batch[0])
        jp, jo, jloss = jstep(jp, jo, jnp.int32(i), *map(jnp.asarray, batch),
                              None if aux is None
                              else tuple(map(jnp.asarray, aux)))
        pp, po, ploss = pstep(pp, po, i, *map(torch.from_numpy, batch),
                              None if aux is None
                              else tuple(map(torch.from_numpy, aux)))
        jl.append(float(jloss))
        pl.append(float(ploss))
    pflat = {k: _np(v) for k, v in flatten(pp).items()}
    oflat = {k: _np(v) for k, v in flatten(po).items()}
    return jl, pl, _jflat(jp), pflat, _state_flat(jo), oflat, dt


def _compare(jl, pl, jp, pp, jo, po, dt):
    """The stated tolerance (module docstring); raises AssertionError."""
    assert sorted(jp) == sorted(pp) and sorted(jo) == sorted(po)
    assert int(po["count"]) == int(jo["count"])
    if dt == "float32":
        np.testing.assert_allclose(pl, jl, rtol=1e-6)
        for name in jp:
            adam = not name.startswith("vw/")
            np.testing.assert_allclose(pp[name], jp[name], rtol=1e-5,
                                       atol=1e-7 + (1e-3 * LR if adam else 0),
                                       err_msg=name)
        for name in jo:
            np.testing.assert_allclose(po[name], jo[name], rtol=1e-5,
                                       atol=1e-7, err_msg=name)
        return
    np.testing.assert_allclose(pl, jl, rtol=0, atol=1e-3)
    j0 = _jflat(_params(*_specs(dt, dt))[0])

    def norm(tree, names, minus=None):
        return np.sqrt(sum(np.sum((tree[n] - (0 if minus is None
                                              else minus[n])) ** 2)
                           for n in names))

    tables = [n for n in jp if n.startswith("vw/")]
    dense = [n for n in jp if n not in tables]
    for names in (tables, dense):
        assert norm(pp, names, jp) <= 0.2 * norm(jp, names, j0), names
    for moment in ("mu/", "nu/"):
        names = [n for n in jo if n.startswith(moment)]
        assert norm(po, names, jo) <= 0.25 * norm(jo, names), moment


@pytest.mark.parametrize("form", list(FORMS))
def test_step_matches_jax_over_three_steps(form):
    got = _run_both(form)
    assert int(got[5]["count"]) == STEPS
    _compare(*got)


@pytest.mark.parametrize("form", ["dedup-fp32", "recipe-bf16"])
def test_the_tolerance_catches_a_step_without_the_deep_pullback(
        form, monkeypatch):
    real = sparse._mlp_backward

    def no_pullback(*args):
        grads, g_h = real(*args)
        return grads, torch.zeros_like(g_h)

    monkeypatch.setattr(sparse, "_mlp_backward", no_pullback)
    with pytest.raises(AssertionError):
        _compare(*_run_both(form))


@pytest.mark.parametrize("form", ["dedup-fp32", "recipe-bf16"])
def test_the_tolerance_catches_adam_without_its_bias_correction(
        form, monkeypatch):
    monkeypatch.setattr(ptrain, "_bias_correction", lambda m, d, c: m)
    with pytest.raises(AssertionError):
        _compare(*_run_both(form))


# ------------------------------------------------------------ the roll


@pytest.mark.parametrize("form", ["dedup-fp32", "recipe-bf16"])
def test_roll_of_two_matches_jax_and_the_single_steps(form):
    """The n = 2 roll over three steps (a full call and a tail of one)
    against JAX's roll, and bit for bit against three single steps of the
    port."""
    dt, lever = FORMS[form]
    jspec, pspec = _specs(dt, dt)
    cfg = _cfg(lever)
    batches = _batches(STEPS, seed=5)
    auxes = [_aux(lever, b[0]) for b in batches]
    jm = jsparse.make_field_deepfm_multistep(jspec, jtrain.TrainConfig(**cfg),
                                             2)
    pm = sparse.make_field_deepfm_multistep(pspec, TrainConfig(**cfg), 2)
    body, init = sparse.make_field_deepfm_sparse_body(pspec,
                                                      TrainConfig(**cfg))
    jp, pp = _params(jspec, pspec)
    _, ps = _params(jspec, pspec)
    jo, po, so = jm.init_opt_state(jp), pm.init_opt_state(pp), init(ps)
    jl, pl, sl = [], [], []
    for lo, hi in ((0, 2), (2, STEPS)):
        # JAX's roll takes [n, ...] batches and runs the first m.
        group = batches[lo:hi] + batches[lo:lo + 2 - (hi - lo)]
        stacked = [np.stack(a) for a in zip(*group)]
        aux = (None if auxes[0] is None else [np.stack(a) for a in zip(
            *[_aux(lever, g[0]) for g in group])])
        jp, jo, loss = jm(jp, jo, jnp.int32(lo), jnp.int32(hi - lo),
                          *map(jnp.asarray, stacked),
                          None if aux is None else tuple(map(jnp.asarray,
                                                             aux)))
        jl.append(float(loss))
        pp, po, loss = pm(pp, po, lo, hi - lo,
                          *map(torch.from_numpy, stacked),
                          None if aux is None else
                          tuple(map(torch.from_numpy, aux)))
        pl.append(float(loss))
    for i, b in enumerate(batches):
        aux = auxes[i]
        ps, so, loss = body(ps, so, i, *map(torch.from_numpy, b),
                            None if aux is None
                            else tuple(map(torch.from_numpy, aux)))
        sl.append(float(loss))
    assert pl == [sl[1], sl[2]] and int(po["count"]) == STEPS
    for a, c in zip(flatten({"p": pp, "o": po}).values(),
                    flatten({"p": ps, "o": so}).values()):
        assert torch.equal(a, c)
    _compare(jl, pl, _jflat(jp),
             {k: _np(v) for k, v in flatten(pp).items()}, _state_flat(jo),
             {k: _np(v) for k, v in flatten(po).items()}, dt)


# ------------------------------------------------- the capturable forms


@pytest.mark.parametrize("form", list(FORMS) + ["devaux-drop-bf16",
                                                "inv_sqrt-bf16"])
def test_capturable_forms_make_no_host_sync(form):
    """The body and the roll as a graph runs them (the step a 0-dim int32
    tensor) under the guard."""
    if form == "devaux-drop-bf16":
        dt, lever = "bfloat16", dict(sparse_update="dedup_sr",
                                     compact_device=True, compact_cap=8,
                                     compact_overflow="drop")
    elif form == "inv_sqrt-bf16":
        dt, lever = FORMS["recipe-bf16"]
    else:
        dt, lever = FORMS[form]
    _, pspec = _specs(dt, dt)
    cfg = TrainConfig(**{**_cfg(lever), **(
        {"lr_schedule": "inv_sqrt"} if form == "inv_sqrt-bf16" else {})})
    body, init = sparse.make_field_deepfm_sparse_body(pspec, cfg)
    params = pspec.init(torch.Generator().manual_seed(1), device="cpu")
    opt = init(params)
    batches = _batches(2, seed=6)
    auxes = [_aux(lever, b[0]) for b in batches]
    step = torch.tensor(3, dtype=torch.int32)
    aux = None if auxes[0] is None else tuple(map(torch.from_numpy, auxes[0]))
    batch = [torch.from_numpy(a) for a in batches[0]]
    with NoHostSync():
        params, opt, loss = body(params, opt, step, *batch, aux)
    assert loss.shape == () and int(opt["count"]) == 1
    stacked = [torch.from_numpy(np.stack(a)) for a in zip(*batches)]
    aux = None if auxes[0] is None else tuple(
        torch.from_numpy(np.stack(a)) for a in zip(*auxes))
    with NoHostSync():
        loss = sparse._deepfm_roll(body, params, opt, step, 2, *stacked, aux)
    assert loss.shape == () and int(opt["count"]) == 3


# --------------------------------------------------- guards and entry points


def test_guards_keep_the_reference_messages():
    _, pspec = _specs("float32", "float32")
    with pytest.raises(ValueError, match="fused_embed='require' is served"):
        sparse.make_field_deepfm_sparse_body(
            pspec, TrainConfig(fused_embed="require"))
    with pytest.raises(ValueError, match="sel_blocked is the FieldFFM"):
        sparse.make_field_deepfm_sparse_body(pspec,
                                             TrainConfig(sel_blocked=True))
    with pytest.raises(ValueError, match="deep_sharded is implemented"):
        sparse.make_field_deepfm_sparse_body(pspec,
                                             TrainConfig(deep_sharded=True))
    with pytest.raises(ValueError, match="expected a FieldDeepFMSpec"):
        sparse.make_field_deepfm_sparse_step(
            models.FieldFMSpec(num_features=F * BUCKET, rank=K, num_fields=F,
                               bucket=BUCKET), TrainConfig())
    with pytest.raises(ValueError, match="unknown optimizer"):
        sparse.make_field_deepfm_sparse_body(pspec,
                                             TrainConfig(optimizer="lion"))
    family, reason = sparse.fused_embed_plan(pspec,
                                             TrainConfig(fused_embed="auto"))
    assert family is None and reason == ("no fused kernel family for "
                                         "FieldDeepFMSpec")


@pytest.mark.parametrize("form", ["dedup-fp32", "scatter_add-fp32"])
def test_ftrl_dense_head_matches_jax(form):
    """FieldDeepFM's hybrid step with ``optimizer='ftrl'`` on ``w0`` and the
    MLP (z seeded from the params, n = 0), three steps against JAX's. The
    reference folds ``reg_bias``/``reg_factors`` into the dense gradients
    and FTRL applies them again as its proximal l2; the port does the
    same. Float32 throughout: the tables, the loss, and FTRL's params and
    ``z``/``n`` within ``rtol=1e-5, atol=1e-7`` (FTRL is not scale-free
    like Adam, so summation order moves it by a few ulps only)."""
    dt, lever = FORMS[form]
    jspec, pspec = _specs(dt, dt)
    cfg = dict(_cfg(lever), optimizer="ftrl")
    jbody, jinit = jsparse.make_field_deepfm_sparse_body(
        jspec, jtrain.TrainConfig(**cfg))
    jstep = _jit_exact(jbody)
    pstep = sparse.make_field_deepfm_sparse_step(pspec, TrainConfig(**cfg))
    jp, pp = _params(jspec, pspec)
    jo, po = jinit(jp), pstep.init_opt_state(pp)
    assert sorted(po) == ["n", "z"]
    for i, batch in enumerate(_batches(STEPS)):
        jp, jo, jloss = jstep(jp, jo, jnp.int32(i), *map(jnp.asarray, batch),
                              None)
        pp, po, ploss = pstep(pp, po, i, *map(torch.from_numpy, batch))
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-6)
    jflat, pflat = _jflat(jp), {k: _np(v) for k, v in flatten(pp).items()}
    for name in jflat:
        np.testing.assert_allclose(pflat[name], jflat[name], rtol=1e-5,
                                   atol=1e-7, err_msg=name)
    jstate = {**{f"z/{k}": v for k, v in _jflat(jo.z).items()},
              **{f"n/{k}": v for k, v in _jflat(jo.n).items()}}
    pstate = {k: _np(v) for k, v in flatten(po).items()}
    assert sorted(jstate) == sorted(pstate)
    for name in jstate:
        np.testing.assert_allclose(pstate[name], jstate[name], rtol=1e-5,
                                   atol=1e-7, err_msg=name)


@pytest.mark.parametrize("steps_per_call", [1, 2])
def test_precompile_returns_the_step_without_stepping_anything(
        steps_per_call):
    _, pspec = _specs("bfloat16", "bfloat16")
    cfg = TrainConfig(**_cfg(FORMS["recipe-bf16"][1]))
    params = pspec.init(torch.Generator().manual_seed(1), device="cpu")
    with pytest.raises(ValueError, match="binds its optimizer state"):
        sparse.precompile_field_sparse_step(pspec, cfg, B, steps_per_call,
                                            params=params)
    before = {k: v.clone() for k, v in flatten(params).items()}
    step = sparse.precompile_field_sparse_step(
        pspec, cfg, B, steps_per_call, params=params,
        opt_state=sparse.make_field_deepfm_sparse_step(
            pspec, cfg).init_opt_state(params))
    assert all(torch.equal(before[k], v) for k, v in flatten(params).items())
    opt = step.init_opt_state(params)
    b = _batches(1)[0]
    aux = tuple(map(torch.from_numpy, _aux(COMPACT, b[0])))
    args = [torch.from_numpy(a) for a in b]
    if steps_per_call == 1:
        _, _, loss = step(params, opt, 0, *args, aux)
    else:
        _, _, loss = step(params, opt, 0, 1, *(a[None] for a in args),
                          tuple(a[None] for a in aux))
    assert np.isfinite(float(loss)) and int(opt["count"]) == 1


# ------------------------------------------------------ fit and resume


def _fit(pspec, cfg, ids, vals, labels, ckdir, steps, steps_per_call=1):
    from fm_spark_tpu_torch import data
    from fm_spark_tpu_torch.checkpoint import Checkpointer

    cfg = TrainConfig(**{**cfg.__dict__, "num_steps": steps})
    batches = data.Batches(ids, vals, labels, B, seed=cfg.seed)
    stats = {}
    ck = Checkpointer(str(ckdir), save_every=2)
    params = ptrain.fit_field_sparse(pspec, cfg, batches, device="cpu",
                                     stats=stats, checkpointer=ck,
                                     steps_per_call=steps_per_call)
    ck.close()
    return params, stats


@pytest.mark.parametrize("steps_per_call", [1, 2])
def test_fit_stopped_and_resumed_equals_the_uninterrupted_run(
        tmp_path, steps_per_call):
    """fit 4 steps in one run, and 2 then 2 more (a resume from the chain):
    the params, Adam's moments and count, and the losses bit for bit."""
    _, pspec = _specs("bfloat16", "bfloat16")
    rng = np.random.default_rng(7)
    ids = (rng.zipf(1.3, (4 * B, F)) % BUCKET).astype(np.int32)
    vals = np.ones((4 * B, F), np.float32)
    labels = rng.integers(0, 2, 4 * B).astype(np.float32)
    cfg = TrainConfig(**_cfg(FORMS["recipe-bf16"][1]), batch_size=B)
    full, sf = _fit(pspec, cfg, ids, vals, labels, tmp_path / "a", 4,
                    steps_per_call)
    _fit(pspec, cfg, ids, vals, labels, tmp_path / "b", 2, steps_per_call)
    rest, sr = _fit(pspec, cfg, ids, vals, labels, tmp_path / "b", 4,
                    steps_per_call)
    assert sr["resumed"]["step"] == 2 and sr["start"] == 2
    assert sr["loss"] == sf["loss"][-len(sr["loss"]):]
    for a, c in zip(flatten({"p": full, "o": sf["opt_state"]}).values(),
                    flatten({"p": rest, "o": sr["opt_state"]}).values()):
        assert torch.equal(a, c)
    assert int(sr["opt_state"]["count"]) == 4
    # The chains' last steps hold the same arrays, Adam's under opt/.
    ca = (tmp_path / "a" / "4" / "opt" / "mu" / "mlp" / "0" / "kernel.npy")
    cb = (tmp_path / "b" / "4" / "opt" / "mu" / "mlp" / "0" / "kernel.npy")
    np.testing.assert_array_equal(np.load(ca), np.load(cb))
