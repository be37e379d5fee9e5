"""The port's optimizer (``repro_torch.optim``) against the JAX one
(``repro.optim``) on the same numpy-seeded trees, float32 on the CPU:
AdamW over 3 steps with global-norm clipping active (grads scaled so
their norm is ~40x ``clip_norm``), with and without weight decay and
with a cosine schedule; ``global_norm``; ``cosine_schedule`` over its
warmup, decay and floor; the noise-scale estimator and its EMA.
Tolerance 1e-6 relative plus 1e-7 absolute: the same float32 arithmetic,
summed in another order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.adamw import AdamW as JaxAdamW
from repro.optim.adamw import cosine_schedule as jax_cosine
from repro.optim.adamw import global_norm as jax_global_norm
from repro.optim.grad_noise import NoiseScaleEMA as JaxEMA
from repro.optim.grad_noise import \
    noise_scale_from_microbatches as jax_noise
from repro_torch.optim import (
    AdamW, NoiseScaleEMA, cosine_schedule, global_norm,
    noise_scale_from_microbatches,
)

TOL = dict(rtol=1e-6, atol=1e-7)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"q": {"a": (rng.standard_normal((2, 16, 4)) * scale)
                  .astype(np.float32),
                  "b": (rng.standard_normal((2, 4, 16)) * scale)
                  .astype(np.float32)},
            "o": {"a": (rng.standard_normal((2, 16, 4)) * scale)
                  .astype(np.float32),
                  "b": np.zeros((2, 4, 16), np.float32)}}


def _torch(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _close(t_tree, j_tree):
    for t, j in zip(jax.tree.leaves(jax.tree.map(lambda x: x.numpy(),
                                                 t_tree)),
                    jax.tree.leaves(j_tree)):
        np.testing.assert_allclose(t, np.asarray(j), **TOL)


@pytest.mark.parametrize("kind", ["plain", "decay", "cosine"])
def test_adamw_matches_jax_over_three_steps(kind):
    kw = {"plain": dict(lr=1e-2), "decay": dict(lr=1e-2, weight_decay=0.1),
          "cosine": dict(weight_decay=0.01)}[kind]
    params = _tree(0)
    jopt = JaxAdamW(**kw, **({"lr": jax_cosine(1e-2, 2, 6)}
                             if kind == "cosine" else {}))
    topt = AdamW(**kw, **({"lr": cosine_schedule(1e-2, 2, 6)}
                          if kind == "cosine" else {}))
    jp, tp = jax.tree.map(jnp.asarray, params), _torch(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(3):
        grads = _tree(10 + step, scale=5.0)
        assert float(jax_global_norm(grads)) > 10 * jopt.clip_norm
        jp, js, jm = jopt.update(jax.tree.map(jnp.asarray, grads), js, jp)
        tp_new, ts, tm = topt.update(_torch(grads), ts, tp)
        # functional: the old tree is untouched
        assert tp_new["q"]["a"] is not tp["q"]["a"]
        tp = tp_new
        _close(tp, jp)
        _close(ts.m, js.m)
        _close(ts.v, js.v)
        assert int(ts.step) == int(js.step) == step + 1
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL)


def test_init_is_zero_state():
    st = AdamW().init(_torch(_tree(1)))
    assert int(st.step) == 0 and st.step.dtype == torch.int32
    assert all(not t.any() for t in jax.tree.leaves(
        jax.tree.map(lambda x: x.numpy(), st.m)))


def test_global_norm_matches_jax():
    tree = _tree(2, scale=3.0)
    np.testing.assert_allclose(float(global_norm(_torch(tree))),
                               float(jax_global_norm(tree)), **TOL)
    assert float(global_norm({})) == 0.0


def test_cosine_schedule_matches_jax():
    jf, tf = jax_cosine(3e-3, 4, 20, 0.2), cosine_schedule(3e-3, 4, 20, 0.2)
    for step in range(0, 26):
        np.testing.assert_allclose(
            float(tf(torch.tensor(step, dtype=torch.int32))),
            float(jf(jnp.int32(step))), **TOL)


@pytest.mark.parametrize("micro,big,mb,n", [
    (4.0, 1.0, 2, 4), (2.5, 2.4, 8, 2), (1.0, 2.0, 4, 4)])
def test_noise_scale_matches_jax(micro, big, mb, n):
    t = noise_scale_from_microbatches(torch.tensor(micro), torch.tensor(big),
                                      mb, n)
    j = jax_noise(jnp.float32(micro), jnp.float32(big), mb, n)
    np.testing.assert_allclose(float(t), float(j), **TOL)


def test_noise_scale_ema_matches_jax():
    te, je = NoiseScaleEMA(0.8), JaxEMA(0.8)
    assert not te.initialized
    for v in (3.0, 1.0, 7.5, 2.0):
        assert te.update(v) == pytest.approx(je.update(v), rel=1e-12)
    assert te.initialized
