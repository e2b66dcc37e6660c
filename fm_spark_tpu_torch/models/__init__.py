"""Model families of the port: the flat FM (configs 1 and 2), FFM and
DeepFM, and the field-partitioned FieldFM (config 3's model), FieldFFM
(config 4's) and FieldDeepFM (config 5's)."""

from fm_spark_tpu_torch.models.base import ModelSpec, predict_from_scores  # noqa: F401
from fm_spark_tpu_torch.models.deepfm import DeepFMSpec  # noqa: F401
from fm_spark_tpu_torch.models.ffm import FFMSpec  # noqa: F401
from fm_spark_tpu_torch.models.field_deepfm import FieldDeepFMSpec  # noqa: F401
from fm_spark_tpu_torch.models.field_ffm import FieldFFMSpec  # noqa: F401
from fm_spark_tpu_torch.models.field_fm import FieldFMSpec  # noqa: F401
from fm_spark_tpu_torch.models.fm import FMSpec  # noqa: F401
from fm_spark_tpu_torch.models.io import (  # noqa: F401
    load_model,
    params_from_numpy,
    save_model,
)
