"""Host data of the port: seeded synthetic CTR data, the MovieLens, libSVM,
Criteo and Avazu readers and the packed dataset format, the raw-text stream
(``data/stream.py``, ``data/native_stream.py``), batching (epoch batches
and the reference's Bernoulli sample), the compact-aux, mapping and
stacking wrappers and the prefetcher."""

from fm_spark_tpu_torch.data.libsvm import load_libsvm, save_libsvm  # noqa: F401
from fm_spark_tpu_torch.data.packed import (  # noqa: F401
    PackedBatches,
    PackedDataset,
    PackedWriter,
    iter_packed_once,
    shuffle_packed,
)
from fm_spark_tpu_torch.data.pipeline import (  # noqa: F401
    Batches,
    BernoulliBatches,
    DedupAuxBatches,
    MappedBatches,
    Prefetcher,
    StackedBatches,
    iterate_once,
    train_test_split,
    wrap_prefetch,
)
from fm_spark_tpu_torch.data.synthetic import field_local, synthetic_ctr  # noqa: F401
