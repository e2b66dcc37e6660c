"""One rank of the port's sharded-step tests: joins a gloo process group
on the CPU (the explicit triple), runs every case of a case file over
its mesh, and has rank 0 write each case's losses and gathered canonical
params. Imports the port only (never JAX).

Usage: ``python torch_parallel_worker.py RANK WORLD PORT CASE_DIR``; the
case directory holds ``cases.json`` and one ``<case>.npz`` of inputs per
case, and receives ``<case>.out.npz`` (or ``error.txt``).
"""

import json
import os
import sys
import traceback

import numpy as np
import torch


def _spec(models, case):
    kw = dict(case["spec"])
    kind = kw.pop("kind")
    return getattr(models, kind)(**kw)


def _params(models, spec, arrays):
    flat = {k[len("param/"):]: arrays[k].copy() for k in arrays.files
            if k.startswith("param/")}
    return models.params_from_numpy(spec, flat, "cpu")


def _batches(arrays):
    n = int(arrays["steps"])
    return [tuple(arrays[f"b{i}/{x}"] for x in ("ids", "vals", "labels",
                                                 "weights"))
            for i in range(n)]


def run_field(case, arrays, mesh):
    from fm_spark_tpu_torch import models, parallel
    from fm_spark_tpu_torch.models.field_deepfm import FieldDeepFMSpec
    from fm_spark_tpu_torch.ops import scatter
    from fm_spark_tpu_torch.parallel import deepfm_step, field_step
    from fm_spark_tpu_torch.train import TrainConfig

    spec = _spec(models, case)
    config = TrainConfig(**case["config"])
    canonical = _params(models, spec, arrays)
    n_feat = mesh.shape["feat"]
    deep = isinstance(spec, FieldDeepFMSpec)
    if deep:
        step = deepfm_step.make_field_deepfm_sharded_step(spec, config, mesh)
        params = deepfm_step.shard_field_deepfm_params(
            deepfm_step.stack_field_deepfm_params(spec, canonical, n_feat),
            mesh)
        opt = step.init_opt_state(params)
    else:
        make = (parallel.make_field_ffm_sharded_step
                if type(spec).__name__ == "FieldFFMSpec"
                else parallel.make_field_sharded_sgd_step)
        step = make(spec, config, mesh)
        params = parallel.shard_field_params(
            parallel.stack_field_params(spec, canonical, n_feat), mesh)
    losses = []
    for i, batch in enumerate(_batches(arrays)):
        caux = None
        if config.host_dedup:
            caux = parallel.shard_compact_aux(
                scatter.compact_aux(batch[0], config.compact_cap), mesh)
        local = parallel.shard_field_batch(
            parallel.pad_field_batch(batch, spec.num_fields, n_feat), mesh)
        if deep:
            params, opt, loss = step(params, opt, i, *local)
        else:
            params, loss = step(params, i, *local, caux)
        losses.append(float(loss))
    gather = (deepfm_step.gather_field_deepfm_params if deep
              else field_step.gather_field_params)
    return losses, gather(spec, params, mesh)


def run_dense(case, arrays, mesh):
    from fm_spark_tpu_torch import models, parallel
    from fm_spark_tpu_torch.train import TrainConfig, make_optimizer

    spec = _spec(models, case)
    config = TrainConfig(**case["config"])
    strategy = case["strategy"]
    params = parallel.shard_params(_params(models, spec, arrays), mesh, spec,
                                   strategy)
    step = parallel.make_parallel_train_step(spec, config, mesh, strategy)
    opt = make_optimizer(config).init(params)
    losses = []
    for batch in _batches(arrays):
        params, opt, m = step(params, opt, *parallel.shard_batch(batch,
                                                                 mesh))
        losses.append(float(m["loss"]))
    return losses, parallel.gather_tree(params, mesh, spec, strategy)


def main():
    rank, world, port = (int(x) for x in sys.argv[1:4])
    case_dir = sys.argv[4]
    try:
        from fm_spark_tpu_torch import parallel
        from fm_spark_tpu_torch.models.io import flatten

        parallel.init_distributed("cpu", coordinator=f"127.0.0.1:{port}",
                                  num_processes=world, process_id=rank,
                                  timeout_s=45)
        torch.set_num_threads(1)
        cases = json.load(open(os.path.join(case_dir, "cases.json")))
        for name, case in cases.items():
            arrays = np.load(os.path.join(case_dir, f"{name}.npz"))
            kind, *shape = case["mesh"]
            if kind == "field":
                mesh = parallel.make_field_mesh(n_row=shape[0],
                                                device="cpu")
                losses, params = run_field(case, arrays, mesh)
            else:
                mesh = parallel.make_mesh(shape[0], shape[1], device="cpu")
                losses, params = run_dense(case, arrays, mesh)
            if rank == 0:
                out = {f"param/{k}": v.float().numpy()
                       for k, v in flatten(params).items()}
                np.savez(os.path.join(case_dir, f"{name}.out.npz"),
                         losses=np.asarray(losses, np.float64), **out)
        torch.distributed.destroy_process_group()
    except BaseException:
        with open(os.path.join(case_dir, f"error.{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


if __name__ == "__main__":
    main()
