"""The PyTorch package's Stage-A losses against the JAX package's: values
and gradients within 1e-6 on the same numpy inputs.

Two cases follow the JAX package where its eager arithmetic is not the
whole story:

  * an all-zero row in ``info_nce``: the L2 norm's gradient there is NaN in
    JAX (``jnp.linalg.norm``), and the port's sqrt-of-sum norm gives NaN in
    the same places (``torch.linalg.norm`` would give a finite value);
  * a padded batch in ``info_nce``: a pad slot's diagonal is ``-inf``, and
    JAX's eager masked mean multiplies it by 0 (NaN).  The port selects
    valid anchors instead, which equals ``jax.jit(info_nce)`` and the numpy
    mean over valid anchors and columns.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.models import losses as JL
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.models import losses as TL

TOL = 1e-6


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


def _grads(fn, *xs):
    ts = [_t(x, True) for x in xs]
    v = fn(*ts)
    v.backward()
    return v.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("case", ["masked", "empty", "all", "padded"])
def test_masked_bce(case):
    rng = np.random.default_rng(0)
    B = 12
    pred = rng.uniform(0, 1, B).astype(np.float32)
    pred[0], pred[1] = 0.0, 1.0                      # the clip's ends
    labels = rng.integers(0, 2, B).astype(np.float32)
    mask = {"masked": rng.random(B) < 0.6, "empty": np.zeros(B, bool),
            "all": np.ones(B, bool),
            "padded": np.arange(B) < 9}[case]
    jv, jg = jax.value_and_grad(JL.masked_bce)(pred, labels, mask)
    tv, (tg,) = _grads(lambda p: TL.masked_bce(p, _t(labels), _t(mask)),
                       pred)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=TOL)
    np.testing.assert_allclose(tg, jg, rtol=0, atol=TOL)
    if case == "empty":
        assert tv == 0.0 and not tg.any()


@pytest.mark.parametrize("case", ["some_zero_w", "none_kept", "min_w"])
def test_smoothness_loss(case):
    rng = np.random.default_rng(1)
    U, I, E, H = 9, 7, 40, 5
    hs = rng.normal(size=(U, H)).astype(np.float32)
    hd = rng.normal(size=(I, H)).astype(np.float32)
    src = rng.integers(0, U, E)
    dst = rng.integers(0, I, E)
    w = np.where(rng.random(E) < 0.3, 0.0, rng.uniform(0, 1, E)).astype(
        np.float32)
    min_w = 0.0
    if case == "none_kept":
        w[:] = 0.0
    elif case == "min_w":
        min_w = 0.5

    def jf(a, b):
        return JL.smoothness_loss(a, b, jnp.asarray(src), jnp.asarray(dst),
                                  jnp.asarray(w), min_w=min_w)

    jv, jg = jax.value_and_grad(jf, argnums=(0, 1))(hs, hd)
    tv, tg = _grads(lambda a, b: TL.smoothness_loss(
        a, b, _t(src), _t(dst), _t(w), min_w=min_w), hs, hd)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=TOL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    if case == "none_kept":
        assert tv == 0.0


@pytest.mark.parametrize("B", [1, 6])
def test_info_nce_unmasked(B):
    rng = np.random.default_rng(B)
    z1 = rng.normal(size=(B, 8)).astype(np.float32)
    z2 = rng.normal(size=(B, 8)).astype(np.float32)
    jv, jg = jax.value_and_grad(JL.info_nce, argnums=(0, 1))(z1, z2, 0.2)
    tv, tg = _grads(lambda a, b: TL.info_nce(a, b, tau=0.2), z1, z2)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=TOL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


def _numpy_masked_info_nce(z1, z2, tau, mask):
    """Mean over valid anchors of -log softmax over valid columns, float64."""
    z1 = z1 / (np.linalg.norm(z1, axis=-1, keepdims=True) + 1e-12)
    z2 = z2 / (np.linalg.norm(z2, axis=-1, keepdims=True) + 1e-12)
    logits = (z1.astype(np.float64) @ z2.T.astype(np.float64)) / tau
    v = np.nonzero(mask)[0]
    sub = logits[np.ix_(v, v)]
    lse = np.log(np.exp(sub - sub.max(1, keepdims=True)).sum(1)) \
        + sub.max(1)
    return float(-(np.diag(sub) - lse).mean())


@pytest.mark.parametrize("n_valid", [3, 7, 8])
def test_info_nce_padded_batch_is_finite_and_equals_jitted_jax(n_valid):
    rng = np.random.default_rng(10 + n_valid)
    B = 8
    z1 = rng.normal(size=(B, 6)).astype(np.float32)
    z2 = rng.normal(size=(B, 6)).astype(np.float32)
    mask = np.arange(B) < n_valid
    tv, tg = _grads(lambda a, b: TL.info_nce(a, b, 0.2, _t(mask)), z1, z2)
    assert np.isfinite(tv)
    jit_v = float(jax.jit(JL.info_nce)(z1, z2, 0.2, mask))
    np.testing.assert_allclose(tv, jit_v, rtol=0, atol=TOL)
    np.testing.assert_allclose(tv, _numpy_masked_info_nce(z1, z2, 0.2, mask),
                               rtol=0, atol=TOL)
    if n_valid < B:
        # the eager JAX formula multiplies a pad slot's -inf by 0
        assert np.isnan(float(JL.info_nce(z1, z2, 0.2, mask)))
    # the gradient is finite either way, and equal
    jg = jax.grad(JL.info_nce, argnums=(0, 1))(z1, z2, 0.2, mask)
    for a, b in zip(tg, jg):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    assert not tg[0][n_valid:].any()                 # pad rows get no gradient


@pytest.mark.parametrize("which", [0, 1])
def test_info_nce_zero_row_gradient_is_nan_like_jax(which):
    rng = np.random.default_rng(3)
    z = [rng.normal(size=(5, 8)).astype(np.float32) for _ in range(2)]
    z[which][2] = 0.0                                # a dead-ReLU row
    jv, jg = jax.value_and_grad(JL.info_nce, argnums=(0, 1))(z[0], z[1], 0.2)
    tv, tg = _grads(lambda a, b: TL.info_nce(a, b, tau=0.2), *z)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=TOL)
    for a, b in zip(tg, jg):
        assert np.array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    assert np.isnan(tg[which][2]).all()
    # torch.linalg.norm would have hidden it
    zz = _t(z[which], True)
    (zz / (torch.linalg.norm(zz, dim=-1, keepdim=True) + 1e-12)).sum() \
        .backward()
    assert np.isfinite(zz.grad.numpy()).all()
