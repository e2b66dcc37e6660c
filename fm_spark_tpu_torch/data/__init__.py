"""Host data of the port: seeded synthetic CTR data, the Criteo and Avazu
parsers and the packed dataset format, batching, the compact-aux wrapper
and the prefetcher."""

from fm_spark_tpu_torch.data.packed import (  # noqa: F401
    PackedBatches,
    PackedDataset,
    PackedWriter,
    iter_packed_once,
    shuffle_packed,
)
from fm_spark_tpu_torch.data.pipeline import (  # noqa: F401
    Batches,
    DedupAuxBatches,
    Prefetcher,
    iterate_once,
    train_test_split,
)
from fm_spark_tpu_torch.data.synthetic import field_local, synthetic_ctr  # noqa: F401
