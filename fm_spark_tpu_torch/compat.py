"""Reference-API compatibility: ``FMWithSGD``, ``FMWithLBFGS`` and
``FFMWithSGD`` with ``FMModel`` (the port of ``fm_spark_tpu/compat.py``).

Argument for argument the reference's entry point (``FMWithSGD.train(
input, task, numIterations, stepSize, miniBatchFraction, dim, regParam,
initStd)`` and instance ``run(input)``): ``input`` is the fixed-nnz
triple ``(ids, vals, labels)``, ``dim=(k0, k1, k2)`` → (use bias, use
linear, rank), ``regParam=(r0, r1, r2)`` per-group L2, ``initStd`` the
factor init, 1-based ``stepSize/√iter`` SGD, and regression targets
clipped to the [min, max] learned from the data. Training runs on the
card unless ``device="cpu"`` is given (the port's one addition).
"""

from __future__ import annotations

import numpy as np
import torch

from fm_spark_tpu_torch import models
from fm_spark_tpu_torch.data.pipeline import (Batches, BernoulliBatches,
                                              iterate_once)
from fm_spark_tpu_torch.train import FMTrainer, TrainConfig


class FMModel:
    """Trained model handle: predict / save / load, like the reference's."""

    def __init__(self, spec, params):
        self.spec = spec
        self.params = params

    def predict(self, ids, vals) -> np.ndarray:
        """Predictions for a batch: sigmoid probability or clipped value."""
        dev = self.params["w0"].device
        with torch.no_grad():
            out = self.spec.predict(
                self.params, torch.as_tensor(np.asarray(ids), device=dev),
                torch.as_tensor(np.asarray(vals, np.float32), device=dev))
        return out.float().cpu().numpy()

    def save(self, path: str) -> None:
        models.save_model(path, self.spec, self.params)

    @classmethod
    def load(cls, path: str, device=None) -> "FMModel":
        spec, params = models.load_model(path, device=device)
        return cls(spec, params)


def _coerce_input(input, task):
    """(ids, vals, labels) arrays + the spec kwargs every entry point
    shares: ``num_features = max(id) + 1`` and, for regression, the
    target range the predictions are clipped to."""
    ids, vals, labels = input
    ids = np.asarray(ids, np.int32)
    vals = np.asarray(vals, np.float32)
    labels = np.asarray(labels, np.float32)
    spec_kwargs = dict(num_features=int(ids.max()) + 1, task=task)
    if task == "regression":
        spec_kwargs["min_target"] = float(labels.min())
        spec_kwargs["max_target"] = float(labels.max())
    return ids, vals, labels, spec_kwargs


class _SGDEntryPoint:
    """The minibatch-SGD loop of the reference-named entry points; a
    subclass gives the model family (:meth:`_build_spec`).

    Each iteration Bernoulli-samples the dataset at ``miniBatchFraction``
    (:class:`~fm_spark_tpu_torch.data.BernoulliBatches`: the whole
    dataset with a fresh weight mask per step, the reference's
    ``data.sample`` per iteration, O(N) per step as the reference's); at
    1.0 every step is the full batch."""

    def __init__(self, task: str = "classification",
                 numIterations: int = 100, stepSize: float = 0.1,
                 miniBatchFraction: float = 1.0,
                 dim: tuple = (True, True, 8),
                 regParam: tuple = (0.0, 0.0, 0.0), initStd: float = 0.01,
                 seed: int = 0, device=None):
        self.task = task
        self.numIterations = numIterations
        self.stepSize = stepSize
        self.miniBatchFraction = miniBatchFraction
        self.dim = dim
        self.regParam = regParam
        self.initStd = initStd
        self.seed = seed
        self.device = device

    def _build_spec(self, spec_kwargs, ids):
        raise NotImplementedError

    def run(self, input) -> FMModel:
        """Train on ``input = (ids, vals, labels)`` and return the model."""
        ids, vals, labels, spec_kwargs = _coerce_input(input, self.task)
        k0, k1, k2 = self.dim
        r0, r1, r2 = self.regParam
        spec_kwargs.update(
            rank=int(k2),
            loss="logistic" if self.task == "classification" else "squared",
            use_bias=bool(k0), use_linear=bool(k1), init_std=self.initStd)
        spec = self._build_spec(spec_kwargs, ids)
        batch_size = ids.shape[0]
        if self.miniBatchFraction < 1.0:
            batches = BernoulliBatches(ids, vals, labels,
                                       self.miniBatchFraction, seed=self.seed)
        else:
            batches = Batches(ids, vals, labels, batch_size, seed=self.seed)
        config = TrainConfig(
            num_steps=self.numIterations, batch_size=batch_size,
            learning_rate=self.stepSize, lr_schedule="inv_sqrt",
            optimizer="sgd", reg_bias=r0, reg_linear=r1, reg_factors=r2,
            seed=self.seed, log_every=max(self.numIterations // 10, 1))
        trainer = FMTrainer(spec, config, device=self.device)
        trainer.fit(batches)
        return FMModel(spec, trainer.params)


class FMWithSGD(_SGDEntryPoint):
    """Minibatch-SGD FM training, the reference's entry-point class."""

    def _build_spec(self, spec_kwargs, ids):
        return models.FMSpec(**spec_kwargs)

    @staticmethod
    def train(input, task: str = "classification", numIterations: int = 100,
              stepSize: float = 0.1, miniBatchFraction: float = 1.0,
              dim: tuple = (True, True, 8),
              regParam: tuple = (0.0, 0.0, 0.0), initStd: float = 0.01,
              seed: int = 0, device=None) -> FMModel:
        """Static overload matching the reference object's ``train``."""
        return FMWithSGD(task, numIterations, stepSize, miniBatchFraction,
                         dim, regParam, initStd, seed, device).run(input)


class FMWithLBFGS:
    """Full-batch L-BFGS FM training, the reference's second optimizer:
    MLlib's ``numCorrections`` history and ``convergenceTol``
    relative-decrease stop over the same model (:func:`~fm_spark_tpu_torch
    .lbfgs.fit_lbfgs`), on the card unless ``device="cpu"``."""

    def __init__(self, task: str = "classification",
                 numIterations: int = 100, numCorrections: int = 10,
                 convergenceTol: float = 1e-6, dim: tuple = (True, True, 8),
                 regParam: tuple = (0.0, 0.0, 0.0), initStd: float = 0.01,
                 seed: int = 0, device=None):
        self.task = task
        self.numIterations = numIterations
        self.numCorrections = numCorrections
        self.convergenceTol = convergenceTol
        self.dim = dim
        self.regParam = regParam
        self.initStd = initStd
        self.seed = seed
        self.device = device
        self.info: dict | None = None      # the last run's fit_lbfgs info

    def run(self, input) -> FMModel:
        """Train on ``input = (ids, vals, labels)`` and return the model."""
        from fm_spark_tpu_torch import resolve_device
        from fm_spark_tpu_torch.lbfgs import fit_lbfgs

        ids, vals, labels, spec_kwargs = _coerce_input(input, self.task)
        k0, k1, k2 = self.dim
        r0, r1, r2 = self.regParam
        spec_kwargs.update(rank=int(k2), use_bias=bool(k0),
                           use_linear=bool(k1), init_std=self.initStd)
        spec = models.FMSpec(**spec_kwargs)
        config = TrainConfig(reg_bias=r0, reg_linear=r1, reg_factors=r2)
        dev = resolve_device(self.device)
        params = spec.init(torch.Generator(device=dev).manual_seed(self.seed),
                           device=dev)
        params, self.info = fit_lbfgs(
            spec, params, ids, vals, labels, config=config,
            num_iterations=self.numIterations,
            num_corrections=self.numCorrections,
            convergence_tol=self.convergenceTol)
        return FMModel(spec, params)

    @staticmethod
    def train(input, task: str = "classification", numIterations: int = 100,
              numCorrections: int = 10, convergenceTol: float = 1e-6,
              dim: tuple = (True, True, 8),
              regParam: tuple = (0.0, 0.0, 0.0), initStd: float = 0.01,
              seed: int = 0, device=None) -> FMModel:
        """Static overload matching the reference object's ``train``."""
        return FMWithLBFGS(task, numIterations, numCorrections,
                           convergenceTol, dim, regParam, initStd, seed,
                           device).run(input)


class FFMWithSGD(_SGDEntryPoint):
    """Field-aware FM training entry point (config 4's model over one flat
    table, ``FFMSpec`` with one field per input slot); the argument
    surface of :class:`FMWithSGD`."""

    def _build_spec(self, spec_kwargs, ids):
        return models.FFMSpec(num_fields=int(ids.shape[1]), **spec_kwargs)

    @staticmethod
    def train(input, task: str = "classification", numIterations: int = 100,
              stepSize: float = 0.1, miniBatchFraction: float = 1.0,
              dim: tuple = (True, True, 4),
              regParam: tuple = (0.0, 0.0, 0.0), initStd: float = 0.01,
              seed: int = 0, device=None) -> FMModel:
        """Static overload matching the reference object's ``train``."""
        return FFMWithSGD(task, numIterations, stepSize, miniBatchFraction,
                          dim, regParam, initStd, seed, device).run(input)


def evaluate(model: FMModel, input, batch_size: int = 8192) -> dict:
    """AUC/logloss/RMSE of a model on ``(ids, vals, labels)``."""
    from fm_spark_tpu_torch.train import evaluate_params

    ids, vals, labels = input
    return evaluate_params(
        model.spec, model.params,
        iterate_once(np.asarray(ids, np.int32), np.asarray(vals, np.float32),
                     np.asarray(labels, np.float32), batch_size))
