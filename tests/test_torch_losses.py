"""The PyTorch package's Stage-B losses against the JAX package's.

Values and gradients (w.r.t. every float input) of ``bpr_loss``,
``ego_l2`` and ``fairness_loss`` on the same numpy inputs, with a random,
an all-ones and an all-zero mask and with no mask: within 1e-6 (fp32,
the same ops in another summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu.models import losses as j_losses
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.models import losses as t_losses

B, D = 37, 8
MASKS = ["random", "ones", "zeros", "none"]


def _mask(kind, rng):
    if kind == "none":
        return None
    return {"random": rng.random(B) < 0.6, "ones": np.ones(B, bool),
            "zeros": np.zeros(B, bool)}[kind]


def _inputs(name, rng):
    if name == "bpr_loss":
        return [rng.normal(0, 3, B).astype(np.float32),
                rng.normal(0, 3, B).astype(np.float32)]
    if name == "ego_l2":
        return [rng.normal(size=(B, D)).astype(np.float32) for _ in range(3)]
    return [rng.uniform(0, 1, B).astype(np.float32),
            rng.normal(size=B).astype(np.float32)]


@pytest.mark.parametrize("name", ["bpr_loss", "ego_l2", "fairness_loss"])
@pytest.mark.parametrize("mask_kind", MASKS)
def test_value_and_grads_match_jax(name, mask_kind):
    rng = np.random.default_rng(0)
    xs = _inputs(name, rng)
    mask = _mask(mask_kind, rng)
    jf, tf = getattr(j_losses, name), getattr(t_losses, name)
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.as_tensor(mask)

    argnums = tuple(range(len(xs)))
    jv, jg = jax.value_and_grad(lambda *a: jf(*a, jm), argnums=argnums)(
        *[jnp.asarray(x) for x in xs])
    tx = [torch.as_tensor(x).requires_grad_() for x in xs]
    tv = tf(*tx, tm)
    tg = torch.autograd.grad(tv, tx)
    assert tv.dtype == torch.float32 and tv.dim() == 0
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6, atol=1e-6)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    if mask_kind == "zeros":
        assert float(tv.detach()) == 0.0   # the max(sum(m), 1) guard


def test_bpr_keeps_the_log_guard():
    """-log(sigmoid(d) + 1e-12) stays finite where sigmoid underflows."""
    pos, neg = torch.tensor([-200.0]), torch.tensor([200.0])
    v = t_losses.bpr_loss(pos, neg)
    assert np.isclose(float(v), -np.log(1e-12), rtol=1e-6)
    jv = j_losses.bpr_loss(jnp.asarray([-200.0]), jnp.asarray([200.0]))
    assert float(v) == pytest.approx(float(jv), rel=1e-6)
