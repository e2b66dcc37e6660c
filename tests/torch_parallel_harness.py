"""Shared pieces of the port's sharded-step tests: the small cases (specs,
configs, batches and JAX-initialised params, all from numpy seeds), the
spawn of a gloo process group running them (``torch_parallel_worker.py``)
under a timeout of its own, and the references each case is held to: the
JAX package's sharded step on a mesh of the conftest's host devices, and
the port's single-card step.

Shapes: 5 fields of 16 buckets (so a 2-rank ``feat`` axis pads to 6
fields, one of them padding), rank 4, B = 32 with repeated ids and
zero-weight lanes, a (8, 8) head for FieldDeepFM; the flat FM of the
dense strategies 64 features, 5 ids a row; 3 steps.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np

F, BUCKET, K, B, STEPS, CAP = 5, 16, 4, 32, 3, 32
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_parallel_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FIELD_SPEC = dict(num_features=F * BUCKET, num_fields=F, bucket=BUCKET,
                  rank=K, init_std=0.1)
FLAT_SPEC = dict(kind="FMSpec", num_features=64, rank=K, init_std=0.1)
REG = dict(reg_factors=1e-3, reg_linear=1e-3, reg_bias=1e-3,
           learning_rate=0.1)


def field(kind, **kw):
    return dict(kind=kind, **FIELD_SPEC, **kw)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def batches(case, seed=7):
    """The case's global batches (numpy)."""
    rng = np.random.default_rng(seed)
    out = []
    flat = case["spec"]["kind"] == "FMSpec"
    for _ in range(STEPS):
        if flat:
            n = case["spec"]["num_features"]
            ids = (rng.zipf(1.3, (B, 5)) % n).astype(np.int32)
            ids[0, 0] = -3                      # out of range: dropped
            vals = rng.uniform(0.5, 1.5, (B, 5)).astype(np.float32)
        else:
            ids = (rng.zipf(1.3, (B, F)) % BUCKET).astype(np.int32)
            vals = rng.uniform(0.5, 1.5, (B, F)).astype(np.float32)
        labels = rng.integers(0, 2, B).astype(np.float32)
        weights = np.ones(B, np.float32)
        weights[::7] = 0.0
        out.append((ids, vals, labels, weights))
    return out


def jax_spec(case):
    from fm_spark_tpu import models as jmodels

    kw = dict(case["spec"])
    return getattr(jmodels, kw.pop("kind"))(**kw)


def port_spec(case):
    from fm_spark_tpu_torch import models

    kw = dict(case["spec"])
    return getattr(models, kw.pop("kind"))(**kw)


def jax_params(case, seed=0):
    """JAX-initialised params (a random linear column and bias, so those
    terms move) and their float32 numpy copies by canonical name."""
    import jax
    import jax.numpy as jnp

    spec = jax_spec(case)
    jp = spec.init(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    flat = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        flat[name] = np.array(jnp.asarray(leaf, jnp.float32))
    flat["w0"] = np.float32(0.1)
    for name in list(flat):
        if name.startswith("vw/"):
            flat[name][:, -1] = rng.normal(size=flat[name].shape[0]) * 0.1
        if name == "w":
            flat[name] = (rng.normal(size=flat[name].shape) * 0.1
                          ).astype(np.float32)
    return flat


def to_jax_tree(case, flat):
    import jax.numpy as jnp

    spec = jax_spec(case)
    pd = spec.pdtype
    names = list(flat)
    tree = {}
    for name in names:
        parts = name.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        dtype = (pd if name in ("w", "v") or name.startswith("vw/")
                 else jnp.float32)
        node[parts[-1]] = jnp.asarray(flat[name]).astype(dtype)

    def lists(t):
        if isinstance(t, dict):
            if t and all(k.isdigit() for k in t):
                return [lists(t[str(i)]) for i in range(len(t))]
            return {k: lists(v) for k, v in t.items()}
        return t
    return lists(tree)


def write_cases(directory, cases) -> dict:
    """Each case's inputs as ``<case>.npz`` and the case list as
    ``cases.json``; returns ``{case: (params flat, batches)}``."""
    inputs = {}
    for name, case in cases.items():
        flat = jax_params(case)
        bs = batches(case)
        arrays = {f"param/{k}": v for k, v in flat.items()}
        for i, b in enumerate(bs):
            for key, a in zip(("ids", "vals", "labels", "weights"), b):
                arrays[f"b{i}/{key}"] = a
        np.savez(os.path.join(directory, f"{name}.npz"), steps=STEPS,
                 **arrays)
        inputs[name] = (flat, bs)
    with open(os.path.join(directory, "cases.json"), "w") as f:
        json.dump(cases, f)
    return inputs


def spawn(directory, world: int, timeout_s: float = 60.0):
    """Run the worker on ``world`` ranks; every process is killed if the
    group has not finished within ``timeout_s`` (a hung rendezvous fails
    the test, never the suite). Returns ``{case: (losses, params)}``."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(world),
                               str(port), str(directory)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout_s)
            outs.append(out.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        raise AssertionError(f"the {world}-rank group did not finish within "
                             f"{timeout_s} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, o[-3000:]) for r, (p, o) in
           enumerate(zip(procs, outs)) if p.returncode]
    assert not bad, bad
    cases = json.load(open(os.path.join(directory, "cases.json")))
    results = {}
    for name in cases:
        out = np.load(os.path.join(directory, f"{name}.out.npz"))
        params = {k[len("param/"):]: out[k] for k in out.files
                  if k.startswith("param/")}
        results[name] = (list(out["losses"]), params)
    return results


# -------------------------------------------------------------- references


def port_single(case, flat, bs):
    """The port's single-card run of the case: the fused body (field
    families) or the dense step (``dp``/``row``), from the same params."""
    import torch

    from fm_spark_tpu_torch import models, sparse
    from fm_spark_tpu_torch.models.io import flatten
    from fm_spark_tpu_torch.ops import scatter
    from fm_spark_tpu_torch.train import (TrainConfig, make_optimizer,
                                          make_train_step)

    spec = port_spec(case)
    cfg = dict(case["config"])
    for key in ("score_sharded", "collective_dtype", "deep_sharded"):
        cfg.pop(key, None)
    config = TrainConfig(**cfg)
    params = models.params_from_numpy(spec, {k: np.array(v) for k, v in
                                             flat.items()}, "cpu")
    losses = []
    if case.get("strategy"):
        step = make_train_step(spec, config)
        opt = make_optimizer(config).init(params)
        for b in bs:
            params, opt, m = step(params, opt, *(torch.from_numpy(a.copy())
                                                 for a in b))
            losses.append(float(m["loss"]))
    elif case["spec"]["kind"] == "FieldDeepFMSpec":
        step = sparse.make_field_deepfm_sparse_step(spec, config)
        opt = step.init_opt_state(params)
        for i, b in enumerate(bs):
            params, opt, loss = step(params, opt, i,
                                     *(torch.from_numpy(a.copy()) for a in b))
            losses.append(float(loss))
    else:
        step = sparse.make_sgd_step(spec, config)
        for i, b in enumerate(bs):
            aux = None
            if config.host_dedup:
                aux = tuple(torch.from_numpy(a) for a in
                            scatter.compact_aux(b[0], config.compact_cap))
            params, loss = step(params, i, *(torch.from_numpy(a.copy())
                                             for a in b), aux)
            losses.append(float(loss))
    return losses, {k: v.float().numpy() for k, v in
                    flatten(params).items()}


def jax_sharded(case, flat, bs):
    """The JAX package's sharded run of the case on a mesh of the
    conftest's host devices."""
    import jax
    import jax.numpy as jnp

    from fm_spark_tpu import parallel as jpar
    from fm_spark_tpu import train as jtrain
    from fm_spark_tpu.ops import scatter as jscatter
    from fm_spark_tpu.parallel import field_step as jfs

    spec = jax_spec(case)
    config = jtrain.TrainConfig(**case["config"])
    tree = to_jax_tree(case, flat)
    kind, *shape = case["mesh"]
    losses = []
    if kind == "dense":
        nd, nf = shape
        mesh = jpar.make_mesh(nd, nf, devices=jax.devices()[:nd * nf])
        params = jpar.shard_params(tree, mesh, spec, case["strategy"])
        step = jpar.make_parallel_train_step(spec, config, mesh,
                                             case["strategy"])
        opt = jtrain.make_optimizer(config).init(params)
        for b in bs:
            params, opt, m = step(params, opt, *jpar.shard_batch(b, mesh))
            losses.append(float(m["loss"]))
        out = jax.device_get(params)
    else:
        n_row = shape[0]
        world = case["world"]
        mesh = jfs.make_field_mesh(world, devices=jax.devices()[:world],
                                   n_row=n_row)
        n_feat = world // n_row
        deep = case["spec"]["kind"] == "FieldDeepFMSpec"
        if deep:
            step = jfs.make_field_deepfm_sharded_step(spec, config, mesh)
            params = jfs.shard_field_deepfm_params(
                jfs.stack_field_deepfm_params(spec, tree, n_feat), mesh)
            opt = step.init_opt_state(params)
        else:
            make = (jfs.make_field_ffm_sharded_step
                    if case["spec"]["kind"] == "FieldFFMSpec"
                    else jfs.make_field_sharded_sgd_step)
            step = make(spec, config, mesh)
            params = jfs.shard_field_params(
                jfs.stack_field_params(spec, tree, n_feat), mesh)
        for i, b in enumerate(bs):
            sb = jfs.shard_field_batch(jfs.pad_field_batch(b, F, n_feat),
                                       mesh)
            if deep:
                params, opt, loss = step(params, opt, jnp.int32(i), *sb)
            elif config.host_dedup:
                caux = jfs.shard_compact_aux(
                    jscatter.compact_aux(b[0], config.compact_cap), mesh,
                    n_feat)
                params, loss = step(params, jnp.int32(i), *sb, caux)
            else:
                params, loss = step(params, jnp.int32(i), *sb)
            losses.append(float(loss))
        unstack = (jfs.unstack_field_deepfm_params if deep
                   else jfs.unstack_field_params)
        out = unstack(spec, jax.device_get(params))
    flat_out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(out):
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        flat_out[name] = np.asarray(jnp.asarray(leaf, jnp.float32))
    return losses, flat_out


def assert_close(got, want, rtol, atol, what=""):
    losses_g, params_g = got
    losses_w, params_w = want
    np.testing.assert_allclose(losses_g, losses_w, rtol=rtol, atol=atol,
                               err_msg=f"{what} losses")
    assert sorted(params_g) == sorted(params_w), (sorted(params_g),
                                                  sorted(params_w))
    for k in params_w:
        np.testing.assert_allclose(params_g[k], params_w[k], rtol=rtol,
                                   atol=atol, err_msg=f"{what} {k}")
