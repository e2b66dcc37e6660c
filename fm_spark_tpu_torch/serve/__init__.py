"""Online serving runtime of the port: the micro-batched predict engine
(a CUDA graph per bucket on the card), hot reload from the checkpoint
chain, the HTTP front door with admission control, the multi-process
replica fleet behind it (:mod:`.fleet`), its autoscaler
(:mod:`.autoscale`) and the seeded load generator (:mod:`.loadgen`)."""

from fm_spark_tpu_torch.serve.engine import (  # noqa: F401
    DEFAULT_BUCKETS,
    Generation,
    PredictEngine,
    ServeFuture,
)
from fm_spark_tpu_torch.serve.frontdoor import (  # noqa: F401
    AdmissionController,
    BackendError,
    FrontDoor,
    LocalBackend,
    parse_classes,
)
from fm_spark_tpu_torch.serve.reload import ReloadFollower  # noqa: F401

__all__ = ["DEFAULT_BUCKETS", "AdmissionController", "BackendError",
           "FrontDoor", "Generation", "LocalBackend", "PredictEngine",
           "ReloadFollower", "ServeFuture", "parse_classes"]
