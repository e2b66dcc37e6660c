"""Host data for the serving slice: seeded synthetic CTR batches."""

from fm_spark_tpu_torch.data.pipeline import iterate_once  # noqa: F401
from fm_spark_tpu_torch.data.synthetic import field_local, synthetic_ctr  # noqa: F401
