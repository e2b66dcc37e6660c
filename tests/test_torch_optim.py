"""The port's dense optimizers (``train.make_optimizer``) against optax's
on a float32 tree shaped like FieldDeepFM's dense side (``w0`` and a
two-layer MLP): sgd, adam and adagrad, each with the ``constant`` and
``inv_sqrt`` schedules, over 5 steps of seeded gradients that span seven
decades, with the state carried to fresh tensors after step 2 (what a
resume does). Tolerance ``rtol=1e-6``: both sides compute each update in
float32 in optax's order; the one operation that may round differently
is float32's ``decay**count`` (the port takes the correctly rounded
power), a part in 1e7 of Adam's bias correction.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fm_spark_tpu import train as jtrain
from fm_spark_tpu_torch import train as ptrain
from fm_spark_tpu_torch.checkpoint import copy_into
from fm_spark_tpu_torch.models.io import flatten

SHAPES = {"w0": (), "mlp": [{"kernel": (6, 4), "bias": (4,)},
                            {"kernel": (4, 1), "bias": (1,)}]}


def _tree(fn):
    return jax.tree_util.tree_map(fn, SHAPES,
                                  is_leaf=lambda x: isinstance(x, tuple))


def _torch(tree):
    return ptrain._tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _named(tree) -> dict:
    """A JAX tree's leaves by keypath name (``w0``, ``mlp/0/kernel`` …)."""
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _close(port_tree, jax_tree, msg=""):
    got = {k: v.numpy() for k, v in flatten(port_tree).items()}
    want = _named(jax_tree)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                   err_msg=f"{msg} {k}")


@pytest.mark.parametrize("schedule", ["constant", "inv_sqrt"])
@pytest.mark.parametrize("name", ["sgd", "adam", "adagrad"])
def test_optimizer_matches_optax_over_five_steps(name, schedule):
    rng = np.random.default_rng(0)
    kw = dict(optimizer=name, lr_schedule=schedule, learning_rate=1e-2)
    jopt = jtrain.make_optimizer(jtrain.TrainConfig(**kw))
    popt = ptrain.make_optimizer(ptrain.TrainConfig(**kw))
    start = _tree(lambda s: rng.normal(size=s).astype(np.float32))
    jp = jax.tree_util.tree_map(jnp.asarray, start)
    pp = _torch(start)
    js, ps = jopt.init(jp), popt.init(pp)
    for t in range(5):
        g = _tree(lambda s: (rng.normal(size=s)
                             * 10.0 ** rng.integers(-6, 1)).astype(np.float32))
        updates, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                  js, jp)
        jp = optax.apply_updates(jp, updates)
        ptrain.apply_updates(pp, popt.update(_torch(g), ps, pp))
        _close(pp, jp, f"step {t}")
        if t == 1:
            # A resume: the state and params copied into fresh tensors.
            fresh_p, fresh_s = _torch(start), popt.init(_torch(start))
            copy_into(fresh_p, pp)
            copy_into(fresh_s, ps)
            pp, ps = fresh_p, fresh_s
    if name == "adam":
        assert int(ps["count"]) == int(js[0].count) == 5
        _close(ps["mu"], js[0].mu, "mu")
        _close(ps["nu"], js[0].nu, "nu")
    if schedule == "inv_sqrt":
        assert int(ps["schedule_count"]) == 5


def test_state_lives_on_the_params_device_with_int32_counts():
    popt = ptrain.make_optimizer(ptrain.TrainConfig(optimizer="adam",
                                                    lr_schedule="inv_sqrt"))
    state = popt.init(_torch(_tree(lambda s: np.zeros(s, np.float32))))
    assert state["count"].dtype == state["schedule_count"].dtype == torch.int32
    assert state["count"].shape == ()
    assert sorted(state) == ["count", "mu", "nu", "schedule_count"]


def test_the_count_saturates_at_the_int32_maximum():
    count = torch.tensor(2**31 - 2, dtype=torch.int32)
    ptrain._advance(count)
    ptrain._advance(count)
    assert int(count) == 2**31 - 1


def test_ftrl_and_unknown_optimizers_raise():
    """FTRL builds (its state z and n, no schedule: an lr_schedule beside
    it is ignored, as the reference's); unknown optimizers and schedules
    still raise."""
    popt = ptrain.make_optimizer(ptrain.TrainConfig(optimizer="ftrl",
                                                    lr_schedule="cosine"))
    state = popt.init(_torch(_tree(lambda s: np.ones(s, np.float32))))
    assert sorted(state) == ["n", "z"]
    with pytest.raises(ValueError, match="needs params"):
        popt.update(_torch(_tree(lambda s: np.ones(s, np.float32))), state)
    with pytest.raises(ValueError, match="unknown optimizer"):
        ptrain.make_optimizer(ptrain.TrainConfig(optimizer="lion"))
    with pytest.raises(ValueError, match="unknown lr_schedule"):
        ptrain.make_optimizer(ptrain.TrainConfig(optimizer="adam",
                                                 lr_schedule="cosine"))
