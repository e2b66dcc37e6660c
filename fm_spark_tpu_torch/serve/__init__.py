"""Online serving runtime of the port: the micro-batched predict engine
(a CUDA graph per bucket on the card) and hot reload from the checkpoint
chain."""

from fm_spark_tpu_torch.serve.engine import (  # noqa: F401
    DEFAULT_BUCKETS,
    Generation,
    PredictEngine,
    ServeFuture,
)
from fm_spark_tpu_torch.serve.reload import ReloadFollower  # noqa: F401

__all__ = ["DEFAULT_BUCKETS", "Generation", "PredictEngine",
           "ReloadFollower", "ServeFuture"]
