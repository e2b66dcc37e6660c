"""Distributed training over ``torch.distributed`` (the port of
``fm_spark_tpu/parallel/``): meshes of ranks, the dense strategies (``dp``
for every family, ``row`` for the flat FM) and the field-sharded fused
steps of FieldFM, FieldFFM and FieldDeepFM on a 1-D ``(feat,)`` or 2-D
``(feat, row)`` mesh. NCCL on the card (one rank per card), gloo on the
CPU. The reference's ``lower_*`` entries (JAX lowering against abstract
shapes) have no counterpart: ``precompile_*`` captures the steps.
"""

from fm_spark_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    init_distributed,
    make_field_mesh,
    make_mesh,
)
from fm_spark_tpu_torch.parallel.step import (  # noqa: F401
    evaluate_parallel,
    fit_parallel,
    gather_tree,
    make_parallel_eval_step,
    make_parallel_train_step,
    param_specs,
    precompile_parallel_train_step,
    shard_batch,
    shard_params,
)
from fm_spark_tpu_torch.parallel.field_step import (  # noqa: F401
    evaluate_field_sharded,
    fit_field_sharded,
    gather_field_params,
    make_field_sharded_eval_step,
    make_field_sharded_multistep,
    make_field_sharded_sgd_body,
    make_field_sharded_sgd_step,
    pad_field_batch,
    precompile_field_sharded_step,
    shard_compact_aux,
    shard_field_batch,
    shard_field_batch_local,
    shard_field_params,
    stack_compact_aux,
    stack_field_params,
    unstack_field_params,
)
from fm_spark_tpu_torch.parallel.ffm_step import (  # noqa: F401
    make_field_ffm_sharded_body,
    make_field_ffm_sharded_eval_step,
    make_field_ffm_sharded_step,
)
from fm_spark_tpu_torch.parallel.deepfm_step import (  # noqa: F401
    gather_field_deepfm_params,
    make_field_deepfm_sharded_eval_step,
    make_field_deepfm_sharded_multistep,
    make_field_deepfm_sharded_step,
    shard_field_deepfm_params,
    stack_field_deepfm_params,
    unstack_field_deepfm_params,
)
