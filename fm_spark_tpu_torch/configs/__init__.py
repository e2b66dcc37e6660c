"""The benchmark run configs as dataclasses (the port of
``fm_spark_tpu/configs/__init__.py``): the same names, fields and
recipes, so a config reads the same in both packages.

Only the ``field_fm`` family (config 3, ``criteo1tb_fm_r64``) is ported;
``RunConfig.spec`` raises for the others. The descriptions name each
config's model and data; speed figures of the JAX package were measured
on a TPU and are not repeated here.
"""

from __future__ import annotations

import dataclasses

from fm_spark_tpu_torch import models
from fm_spark_tpu_torch.train import TrainConfig

_TRAIN_FIELDS = {f.name for f in dataclasses.fields(TrainConfig)}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """One benchmark run: model family + shapes + data + training recipe."""

    name: str
    description: str
    model: str                      # 'fm' | 'field_fm' | 'ffm' | 'deepfm'
    dataset: str                    # 'movielens' | 'criteo' | 'avazu' | 'synthetic'
    rank: int
    num_fields: int                 # fixed nnz slot count
    bucket: int = 0                 # per-field hash buckets; 0 ⇒ dense ids
    strategy: str = "single"        # 'single' | 'dp' | 'row' | 'field_sparse'
    task: str = "classification"
    loss: str | None = None
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    table_layout: str = "row"
    mlp_dims: tuple = (400, 400, 400)
    # Training recipe (TrainConfig subset).
    num_steps: int = 1000
    batch_size: int = 8192
    learning_rate: float = 0.1
    lr_schedule: str = "inv_sqrt"
    optimizer: str = "sgd"
    reg_bias: float = 0.0
    reg_linear: float = 0.0
    reg_factors: float = 1e-6
    seed: int = 0
    sparse_update: str = "scatter_add"
    use_pallas: bool = False

    @property
    def field_local_ids(self) -> bool:
        """True for field-partitioned models (ids in [0, bucket) per field)."""
        return self.model in ("field_fm", "field_ffm", "field_deepfm")

    @property
    def num_features(self) -> int:
        if self.bucket <= 0:
            raise ValueError(
                f"config {self.name!r} takes num_features from the data; "
                "pass it to spec(num_features=...)"
            )
        return self.num_fields * self.bucket

    def spec(self, num_features: int | None = None):
        """The model spec; only ``field_fm`` is ported."""
        if self.model != "field_fm":
            raise ValueError(
                f"model family {self.model!r} (config {self.name!r}) is not "
                "ported yet (ROADMAP)")
        if num_features is not None and num_features != self.num_features:
            raise ValueError("field_fm shapes are fixed by num_fields*bucket")
        return models.FieldFMSpec(
            num_features=self.num_features, rank=self.rank, task=self.task,
            loss=self.loss, init_std=0.01, param_dtype=self.param_dtype,
            compute_dtype=self.compute_dtype, num_fields=self.num_fields,
            bucket=self.bucket, table_layout=self.table_layout,
        )

    def train_config(self, **overrides) -> TrainConfig:
        base = {k: getattr(self, k) for k in _TRAIN_FIELDS if hasattr(self, k)}
        base.update({k: v for k, v in overrides.items() if v is not None})
        return TrainConfig(**base)


CONFIGS = {
    c.name: c
    for c in [
        RunConfig(
            name="movielens_fm_r8",
            description="Config 1: FM rank-8, MovieLens-100K, logistic loss.",
            model="fm", dataset="movielens", rank=8, num_fields=2,
            strategy="single", num_steps=2000, batch_size=4096,
            learning_rate=0.05, reg_factors=1e-4, reg_linear=1e-5,
        ),
        RunConfig(
            name="criteo_kaggle_fm_r32",
            description="Config 2: FM rank-32, Criteo-Kaggle 45M, 39×32768"
            " per-field hashed features, data-parallel.",
            model="fm", dataset="criteo", rank=32, num_fields=39,
            bucket=1 << 15, strategy="dp", num_steps=100_000,
            batch_size=16384, learning_rate=0.05, lr_schedule="constant",
        ),
        RunConfig(
            name="criteo1tb_fm_r64",
            description="Config 3: FM rank-64, Criteo-1TB, 39×262144 hashed"
            " features; field-partitioned tables trained by the fused"
            " sparse-SGD step. The JAX package's best single-chip recipe:"
            " --param-dtype bfloat16 --compute-dtype bfloat16"
            " --sparse-update dedup_sr --host-dedup --compact-cap 12288"
            " (the cap must bound the batch's per-field unique ids)"
            " --gfull-fused --segtotal-pallas, or --fused-embed require in"
            " place of the last two.",
            model="field_fm", dataset="criteo", rank=64, num_fields=39,
            bucket=1 << 18, strategy="field_sparse", num_steps=1_000_000,
            batch_size=1 << 17, learning_rate=0.05, lr_schedule="constant",
        ),
        RunConfig(
            name="avazu_ffm_r16",
            description="Config 4: FFM rank-16, Avazu CTR, 23 fields,"
            " field-partitioned tables.",
            model="field_ffm", dataset="avazu", rank=16, num_fields=23,
            bucket=1 << 14, strategy="field_sparse", num_steps=100_000,
            batch_size=8192, learning_rate=0.05, lr_schedule="constant",
        ),
        RunConfig(
            name="criteo1tb_deepfm",
            description="Config 5: DeepFM, FM rank-16 + 3-layer 400-wide"
            " MLP on Criteo shapes.",
            model="field_deepfm", dataset="criteo", rank=16, num_fields=39,
            bucket=1 << 18, strategy="field_sparse", num_steps=1_000_000,
            batch_size=16384, learning_rate=1e-3, lr_schedule="constant",
            optimizer="adam",
        ),
    ]
}


def get_config(name: str, **overrides) -> RunConfig:
    """Look up a registered config, optionally overriding fields."""
    if name not in CONFIGS:
        raise KeyError(
            f"unknown config {name!r}; available: {sorted(CONFIGS)}"
        )
    cfg = CONFIGS[name]
    overrides = {k: v for k, v in overrides.items() if v is not None}
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
