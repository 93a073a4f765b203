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

A step's leaves go to the kernel as one list (one launch per 32 leaves);
the list's plain version is a loop over the one-leaf plain version, and the
wrapper's checks, table reuse and the split of long lists into launches
are held here on the CPU (a counting stub stands in for the compiled entry
point); the kernel itself is compared on the card.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops import adam as t_adam
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.models import cred_model
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
        adam_cuda.KERNEL([(p, g, m, v)], 0.01, 1.0)   # no kernel for the CPU


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
    adam_cuda.KERNEL([(p, g, m, v)], *t_adam.adam_scalars(7, LR))
    adam_cuda.fused_adam_reference(*ref, *t_adam.adam_scalars(7, LR))
    for x, y in zip((p, m, v), (ref[0], ref[2], ref[3])):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the multi-leaf launch: one kernel launch over a list of leaves
# ---------------------------------------------------------------------------

def _stage_a_shapes():
    """The ten Stage-A leaves (``models/cred_model.init_cred_params``: 7
    user features, 2 item features, hidden 64)."""
    p = cred_model.init_cred_params(torch.Generator().manual_seed(0), 7, 2, 64)
    return {k: tuple(v.shape) for k, v in p.items()}


def _misaligned(shape, rng):
    """A float32 tensor of ``shape`` one float off 16-byte alignment."""
    n = int(np.prod(shape))
    flat = torch.as_tensor(rng.normal(size=n + 1).astype(np.float32))
    return flat[1:].view(shape)


def _leaf_list(rng, device="cpu"):
    """Stage A's ten leaves, a 1-element leaf, a 1-D leaf and a view one
    float off 16-byte alignment, with moments as after a few steps."""
    shapes = list(_stage_a_shapes().values()) + [(1,), (1001,)]
    leaves = []
    for s in shapes:
        p, g, m, v = (torch.as_tensor(rng.normal(size=s).astype(np.float32))
                      for _ in range(4))
        leaves.append((p, g * 1e-2, m * 1e-2, v.abs() * 1e-4))
    leaves.append(tuple(_misaligned((257, 3), rng) for _ in range(4)))
    p, g, m, v = leaves[-1]
    g.mul_(1e-2), m.mul_(1e-2), v.abs_().mul_(1e-4)
    return [tuple(x.to(device) for x in leaf) for leaf in leaves]


def test_stage_a_has_ten_leaves():
    shapes = _stage_a_shapes()
    assert len(shapes) == 10
    assert shapes["user_proj_w"] == (7, 64) and shapes["out_b"] == (1,)


@pytest.mark.parametrize("t", [1, 1000])
def test_list_plain_version_equals_per_leaf_loop(t):
    """The list form (the multi-leaf launch's plain version, as the wrapper
    takes it on the CPU) equals one ``fused_adam_reference`` a leaf, bit
    for bit."""
    rng = np.random.default_rng(t)
    leaves = _leaf_list(rng)
    assert leaves[-1][0].data_ptr() % 16 != 0
    ref = [tuple(x.clone() for x in leaf) for leaf in leaves]
    a, b = t_adam.adam_scalars(t, LR)
    adam_cuda.fused_adam_leaves(leaves, a, b)
    for leaf in ref:
        adam_cuda.fused_adam_reference(*leaf, a, b)
    for got, want in zip(leaves, ref):
        for x, y in zip(got, want):
            assert torch.equal(x, y)
    # the one-leaf call is the one-entry list
    again = [tuple(x.clone() for x in leaf) for leaf in ref]
    adam_cuda.fused_adam(*again[3], a, b)
    adam_cuda.fused_adam_leaves_reference(ref[3:4], a, b)
    assert all(torch.equal(x, y) for x, y in zip(again[3], ref[3]))


def test_stage_a_leaves_ten_steps_match_optax():
    """``adam_step`` over the ten Stage-A leaves (one call a step) against
    ``optax.adam(1e-3)`` + ``optax.apply_updates``, the optimizer of
    ``train/cred_trainer.py:83`` in the JAX package; tolerances as in
    :func:`test_ten_steps_match_optax`."""
    rng = np.random.default_rng(5)
    shapes = _stage_a_shapes()
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * 1e-2).astype(np.float32)
              for k, s in shapes.items()} for _ in range(10)]
    opt = optax.adam(LR)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = opt.init(jp)
    tp = {k: torch.as_tensor(v.copy()) for k, v in params.items()}
    ts = t_adam.adam_init(tp)
    before = adam_cuda.KERNEL.launches
    for g in grads:
        upd, js = opt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        t_adam.adam_step(tp, {k: torch.as_tensor(v) for k, v in g.items()},
                         ts, LR)
    assert adam_cuda.KERNEL.launches == before      # a CPU step launches nothing
    assert ts.count == 10 == int(js[0].count)
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
        assert np.array_equal(ts.m[k].numpy(), np.asarray(js[0].mu[k]))
        np.testing.assert_allclose(ts.v[k].numpy(), np.asarray(js[0].nu[k]),
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("fault", ["shape", "dtype", "device", "g_shape"])
def test_mismatched_leaf_list_raises(fault):
    rng = np.random.default_rng(0)
    leaves = [list(leaf) for leaf in _leaf_list(rng)[:4]]
    if fault == "shape":
        leaves[2][2] = torch.zeros(3, 3)
    elif fault == "dtype":
        leaves[1][3] = leaves[1][3].double()
    elif fault == "device":
        leaves[3][0] = torch.empty(leaves[3][0].shape, device="meta")
    else:
        leaves[0][1] = leaves[0][1].reshape(-1)
    before = [x.clone() for x in leaves[0]]
    with pytest.raises(ValueError, match="leaf"):
        adam_cuda.fused_adam_leaves([tuple(leaf) for leaf in leaves], 0.01, 1.0)
    assert all(torch.equal(x, y) for x, y in zip(leaves[0], before))
    with pytest.raises(ValueError, match="leaf"):
        adam_cuda.LeafTable([tuple(leaf) for leaf in leaves])


class _CountingStub:
    """Stands in for the compiled entry point: records each launch's leaf
    table and returns 0 (launched)."""

    def __init__(self):
        self.calls = []

    def __call__(self, arr, num, a, b, device, stream):
        self.calls.append([(e.p, e.g, e.m, e.v, e.n) for e in arr[:num]])
        return 0


@pytest.mark.parametrize("num,empty,launches", [(1, 0, 1), (10, 0, 1),
                                                 (32, 0, 1), (33, 0, 2),
                                                 (70, 5, 3), (33, 1, 1)])
def test_long_lists_split_into_launches(monkeypatch, num, empty, launches):
    """More than MAX_LEAVES (32) leaves take one launch per 32 (empty
    leaves left out), each counted once, every leaf's pointers and length
    in order."""
    assert adam_cuda.MAX_LEAVES == 32
    stub = _CountingStub()
    monkeypatch.setattr(adam_cuda.KERNEL, "_function", lambda: stub)
    leaves = []
    for i in range(num):
        n = 0 if i < empty else 1 + i % 7
        leaves.append(tuple(torch.zeros(n) for _ in range(4)))
    table = adam_cuda.LeafTable(leaves)
    before = adam_cuda.KERNEL.launches
    adam_cuda.KERNEL.launch_table(table, 0.1, 1.0, 0)
    assert adam_cuda.KERNEL.launches - before == launches == len(stub.calls)
    assert all(len(c) <= 32 for c in stub.calls)
    want = [(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel())
            for p, g, m, v in leaves if p.numel()]
    assert [e for c in stub.calls for e in c] == want


def test_table_reused_while_leaves_stay(monkeypatch):
    """A later step with the same p, m and v reuses the table and writes
    only the new gradients' pointers; other leaves build a new table."""
    monkeypatch.setattr(adam_cuda.KERNEL, "_table", None)
    rng = np.random.default_rng(1)
    leaves = _leaf_list(rng)
    t1 = adam_cuda.KERNEL.table(leaves)
    step2 = [(p, g.clone(), m, v) for p, g, m, v in leaves]
    assert adam_cuda.KERNEL.table(step2) is t1
    assert [e.g for e in t1.groups[0]] == [g.data_ptr() for _, g, _, _ in step2]
    other = [tuple(x.clone() for x in leaf) for leaf in leaves]
    assert adam_cuda.KERNEL.table(other) is not t1
    bad = [(p, g.double(), m, v) for p, g, m, v in other]
    with pytest.raises(ValueError, match="g must be"):
        adam_cuda.KERNEL.table(bad)


def _cuda_leaves():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py phase 2b runs this "
                    "comparison at full size)")
    rng = np.random.default_rng(2)
    leaves = _leaf_list(rng)
    leaves += [tuple(torch.as_tensor(rng.normal(size=(4096, 64))
                                     .astype(np.float32)).abs()
                     for _ in range(4))]
    return [tuple(x.cuda() if x.data_ptr() % 16 == 0 else
                  torch.empty(x.numel() + 1, device="cuda")[1:].view(x.shape)
                  .copy_(x) for x in leaf) for leaf in leaves]


@pytest.mark.cuda
def test_multi_leaf_launch_bit_equal_to_plain_on_card():
    leaves = _cuda_leaves()
    assert leaves[-2][0].data_ptr() % 16 != 0         # the misaligned view
    ref = [tuple(x.clone() for x in leaf) for leaf in leaves]
    a, b = t_adam.adam_scalars(3, LR)
    before = adam_cuda.KERNEL.launches
    adam_cuda.KERNEL(leaves, a, b)
    assert adam_cuda.KERNEL.launches - before == 1
    adam_cuda.fused_adam_leaves_reference(ref, a, b)
    for got, want in zip(leaves, ref):
        for x, y in zip(got, want):
            assert torch.equal(x, y)


@pytest.mark.cuda
def test_multi_leaf_launches_bit_identical_on_card():
    leaves = _cuda_leaves()
    again = [tuple(x.clone() for x in leaf) for leaf in leaves]
    a, b = t_adam.adam_scalars(1000, LR)
    adam_cuda.KERNEL(leaves, a, b)
    adam_cuda.KERNEL(again, a, b)
    for got, want in zip(leaves, again):
        for x, y in zip(got, want):
            assert torch.equal(x, y)
