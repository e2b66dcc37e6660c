"""Online serving runtime of the port: the micro-batched predict engine."""

from fm_spark_tpu_torch.serve.engine import (  # noqa: F401
    DEFAULT_BUCKETS,
    Generation,
    PredictEngine,
    ServeFuture,
)

__all__ = ["DEFAULT_BUCKETS", "Generation", "PredictEngine", "ServeFuture"]
