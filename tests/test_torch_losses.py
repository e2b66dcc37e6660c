"""The port's loss gradients (``sparse._loss_and_grad_fn``) against
``jax.value_and_grad`` of the JAX step's own batch loss
(``fm_spark_tpu/sparse.py``: ``jnp.sum(per_example_loss(sc, labels) *
weights) / max(Σw, 1)``).

Scores in the compute dtype (float32 or bfloat16), labels and weights in
float32, as the steps hand them over. The scores include the hinge kink
(``t·s = 1`` exactly: s = 1 with y = 1, s = -1 with y = 0), zero, ±30 and
a wide random draw; some weights are 0, as the padded tail lanes.

Tolerances of the dscores: bf16 bit for bit; float32 hinge and squared
bit for bit. float32 logistic within ``rtol=1e-6``
plus ``atol=2e-7 / N``: the port computes ``logaddexp`` and its
derivative with JAX's formulas, but XLA's ``exp`` and ``log1p`` on the CPU
differ from torch's by an ulp in about 10 % of float32 inputs, which no
formula removes; where ``exp(s - out)`` is near ``y`` the two cancel and
that ulp (1.2e-7 near 1, divided by the batch's weight) is all that is
left. Loss values within the value test's ``rtol=1e-6``: a float32 sum
over the batch in another order. The squared
loss had no fault to repair; its cases pin it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_spark_tpu.ops import losses as jlosses
from fm_spark_tpu_torch import sparse

N = 4096


def _batch():
    rng = np.random.default_rng(7)
    s = (rng.normal(size=N) * 6).astype(np.float32)
    y = rng.integers(0, 2, N).astype(np.float32)
    fixed = [(1.0, 1.0), (-1.0, 0.0), (1.0, 0.0), (-1.0, 1.0), (0.0, 0.0),
             (0.0, 1.0), (30.0, 0.0), (30.0, 1.0), (-30.0, 0.0),
             (-30.0, 1.0)]
    for i, (sv, yv) in enumerate(fixed * 8):
        s[i], y[i] = sv, yv
    w = np.ones(N, np.float32)
    w[-300:] = 0.0
    w[100:200] = 0.5
    return s, y, w


def _jax(name, s, y, w, dtype):
    per_example = jlosses.loss_fn(name)
    labels, weights = jnp.asarray(y), jnp.asarray(w)
    wsum = jnp.maximum(jnp.sum(weights), 1.0)

    def batch_loss(sc):
        return jnp.sum(per_example(sc, labels) * weights) / wsum

    loss, ds = jax.value_and_grad(batch_loss)(jnp.asarray(s).astype(dtype))
    return float(loss), np.asarray(ds.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["logistic", "squared", "hinge"])
def test_loss_gradients_match_jax(name, dtype):
    s, y, w = _batch()
    jloss, jds = _jax(name, s, y, w, dtype)
    loss, ds = sparse._loss_and_grad_fn(name)(
        torch.from_numpy(s).to(getattr(torch, dtype)), torch.from_numpy(y),
        torch.from_numpy(w))
    assert ds.dtype == getattr(torch, dtype)
    got = ds.float().numpy()
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-6)
    if name == "logistic" and dtype == "float32":
        np.testing.assert_allclose(got, jds, rtol=1e-6, atol=2e-7 / N)
    else:
        np.testing.assert_array_equal(got, jds)
