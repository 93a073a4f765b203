"""The PyTorch package's Adam (the fused kernel's plain version) against
optax.

``adam_step`` runs ``ops/adam_cuda.fused_adam_reference`` on CPU tensors.
Over 10 steps on random leaves from zero moments it is held to
``optax.adam(1e-3)`` + ``optax.apply_updates`` within rtol 1e-6 /
atol 1e-7: the folded form ``a*m/(sqrt(v)*b + eps)`` equals optax's
``lr*m_hat/(sqrt(v_hat) + eps)`` in exact arithmetic and differs by a few
fp32 roundings of the update (~1e-3), far below atol.  The first moment
is the same fp32 ops as optax's and is held to equality; the second moment
follows the probe kernel's ``(1-b2)*g*g`` where optax squares ``g`` first,
so it differs by a rounding of each step: rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops import adam as t_adam
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops import adam_cuda

SHAPES = {"user_emb": (53, 8), "item_emb": (31, 8), "odd": (7, 3)}
LR = 1e-3


def _leaves(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}


def test_ten_steps_match_optax():
    params = _leaves(0)
    grads = [{k: (v * 1e-2).astype(np.float32) for k, v in _leaves(s).items()}
             for s in range(1, 11)]
    grads[3]["odd"][:] = 0.0                    # an all-zero gradient step

    opt = optax.adam(LR)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = opt.init(jp)
    tp = {k: torch.as_tensor(v.copy()) for k, v in params.items()}
    ts = t_adam.adam_init(tp)
    assert ts.count == 0
    for g in grads:
        upd, js = opt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        t_adam.adam_step(tp, {k: torch.as_tensor(v) for k, v in g.items()},
                         ts, LR)
    assert ts.count == 10 == int(js[0].count)
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
        assert np.array_equal(ts.m[k].numpy(), np.asarray(js[0].mu[k]))
        np.testing.assert_allclose(ts.v[k].numpy(), np.asarray(js[0].nu[k]),
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("t", [1, 2, 10, 1000, 100000])
def test_scalars_follow_the_probe_formula(t):
    """a = lr/(1-b1^t), b = 1/sqrt(1-b2^t) in fp32, as
    scripts/probe_fused_adam.py:91-94 computes them (jnp, float32 t)."""
    a, b = t_adam.adam_scalars(t, LR)
    tj = jnp.float32(t)
    ja = LR / (1 - 0.9 ** tj)
    jb = 1.0 / jnp.sqrt(1 - 0.999 ** tj)
    assert ja.dtype == jb.dtype == jnp.float32
    assert a == float(ja) and b == float(jb)


def test_constants_are_jax_fp32_roundings():
    """The kernel's constants 0.1f and 0.001f are the fp32 roundings of
    the Python doubles 1-0.9 and 1-0.999 that JAX multiplies by."""
    assert adam_cuda.OMB1 == float(np.float32(0.1))
    assert adam_cuda.OMB2 == float(np.float32(0.001))
    src = adam_cuda.SOURCE.read_text()
    for const in ("kB1 = 0.9f", "kB2 = 0.999f", "kOneMinusB1 = 0.1f",
                  "kOneMinusB2 = 0.001f", "kEps = 1e-8f"):
        assert const in src, const


def test_reference_is_one_rounded_op_at_a_time():
    """The plain version equals a numpy evaluation of the kernel's
    arithmetic in fp32, op by op (no fused multiply-add, a correctly rounded
    square root), at a size that the CPU splits over threads."""
    rng = np.random.default_rng(3)
    f = np.float32
    p, g, m, v = (rng.normal(size=(300, 200)).astype(np.float32)
                  for _ in range(4))
    v = np.abs(v)
    a, b = t_adam.adam_scalars(3, LR)
    m2 = f(0.9) * m + f(0.1) * g
    v2 = f(0.999) * v + (f(0.001) * g) * g
    p2 = p - (f(a) * m2) / (np.sqrt(v2) * f(b) + f(1e-8))
    tp, tg, tm, tv = (torch.as_tensor(x.copy()) for x in (p, g, m, v))
    adam_cuda.fused_adam_reference(tp, tg, tm, tv, a, b)
    assert np.array_equal(tm.numpy(), m2)
    assert np.array_equal(tv.numpy(), v2)
    assert np.array_equal(tp.numpy(), p2)


def test_cpu_tensors_take_the_plain_version():
    p, g, m, v = (torch.randn(4, 3) for _ in range(4))
    before = adam_cuda.KERNEL.launches
    adam_cuda.fused_adam(p, g, m, v.abs(), 0.01, 1.0)
    assert adam_cuda.KERNEL.launches == before
    with pytest.raises(ValueError):
        adam_cuda.fused_adam(p, g, m, v, 0.01, 1.0, backend="optax")
    with pytest.raises(ValueError):
        adam_cuda.KERNEL(p, g, m, v, 0.01, 1.0)   # no kernel for the CPU


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1), (1001, 3), (4096, 64)])
def test_kernel_bit_equal_to_plain_on_card(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py phase 2b runs this "
                    "comparison at full size)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    p, g, m, v = (torch.randn(shape, device="cuda", generator=gen)
                  for _ in range(4))
    v = v.abs()
    ref = [x.clone() for x in (p, g, m, v)]
    adam_cuda.KERNEL(p, g, m, v, *t_adam.adam_scalars(7, LR))
    adam_cuda.fused_adam_reference(*ref, *t_adam.adam_scalars(7, LR))
    for x, y in zip((p, m, v), (ref[0], ref[2], ref[3])):
        assert torch.equal(x, y)
