"""The PyTorch package's slab row gather (probe kernel P4).

The plain version must equal ``np.asarray(x)[idx]`` bit for bit, the check
``scripts/probe_vmem_gather.py`` makes of the Pallas kernel.  The routes
(L2 by default, shared memory on request for slabs up to 192 KiB, in
clusters of 1, 2, 4 or 8 CTAs, the slab brought in by multicast bulk copies
when it is 16-byte aligned and by each CTA's threads otherwise) and the
wrapper's contract are checked here; the kernel itself is compared on the
card.
"""

import inspect

import numpy as np
import pytest
import torch

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops import row_gather as rg
from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.ops import row_gather_cuda


def _slab(S, D, steps, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((S, D)).astype(np.float32)
    return x, rng.integers(0, S, steps * S).astype(np.int32)


@pytest.mark.parametrize("S", [1, 16, 512, 2048])
@pytest.mark.parametrize("D", [3, 64])
def test_plain_equals_numpy_bit_for_bit(S, D):
    x, idx = _slab(S, D, 4)
    out = rg.row_gather(torch.as_tensor(x), torch.as_tensor(idx))
    assert out.shape == (idx.size, D) and out.dtype == torch.float32
    assert np.array_equal(out.numpy(), x[idx])


@pytest.mark.parametrize("S,D,route", [(512, 64, "smem"), (768, 64, "smem"),
                                       (769, 64, "l2"), (2048, 64, "l2"),
                                       (16384, 64, "l2"), (3000, 16, "smem")])
def test_route_by_slab_bytes(S, D, route):
    # "smem": the slab fits the shared-memory route (up to 192 KiB)
    assert row_gather_cuda.smem_fits(S, D) == (route == "smem")


def _default(fn, name):
    return inspect.signature(fn).parameters[name].default


def test_wrapper_routes():
    x, idx = _slab(769, 64, 1)
    xt, it = torch.as_tensor(x), torch.as_tensor(idx)
    # the L2 route is the default; shared memory only when asked for and
    # only for a slab that fits, in clusters of 1, 2, 4 or 8 CTAs
    assert _default(rg.row_gather, "route") == "l2"
    assert _default(row_gather_cuda.KERNEL.__call__, "route") == "l2"
    assert row_gather_cuda.CLUSTERS == (1, 2, 4, 8)
    assert _default(rg.row_gather, "cluster") \
        == _default(row_gather_cuda.KERNEL.__call__, "cluster") \
        == row_gather_cuda.DEFAULT_CLUSTER in row_gather_cuda.CLUSTERS
    with pytest.raises(ValueError, match="shared-memory"):
        row_gather_cuda.KERNEL(xt, it, "smem")
    with pytest.raises(ValueError, match="route"):
        row_gather_cuda.KERNEL(xt, it, "auto")
    with pytest.raises(ValueError, match="cluster"):
        row_gather_cuda.KERNEL(xt[:512], it, "smem", cluster=3)


def _misaligned(S, D):
    """An (S, D) fp32 slab one float off 16-byte alignment."""
    return torch.arange(S * D + 1, dtype=torch.float32)[1:].view(S, D)


@pytest.mark.parametrize("S,D,load", [(512, 64, "bulk"), (768, 64, "bulk"),
                                      (3, 4, "bulk"), (1, 3, "threads"),
                                      (5, 3, "threads"),
                                      ("misaligned", 64, "threads")])
def test_smem_load_by_alignment(S, D, load):
    """The shared-memory route brings a slab in by multicast bulk copies
    only when its address and byte size are 16-byte aligned; otherwise
    each CTA's threads load it (the kernel refuses a bulk load of a
    misaligned slab)."""
    x = _misaligned(512, D) if S == "misaligned" else torch.zeros(S, D)
    assert row_gather_cuda.smem_load(x) == load


def test_cpu_tensors_take_the_plain_version():
    x, idx = _slab(40, 8, 2)
    xt, it = torch.as_tensor(x), torch.as_tensor(idx)
    before = row_gather_cuda.KERNEL.launches
    assert torch.equal(rg.row_gather(xt, it), rg.row_gather(xt, it, "torch"))
    assert row_gather_cuda.KERNEL.launches == before
    with pytest.raises(ValueError, match="backend"):
        rg.row_gather(xt, it, backend="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        row_gather_cuda.KERNEL(xt, it)
    with pytest.raises(IndexError):
        rg.row_gather(xt, torch.tensor([40], dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [512, 768])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("aligned", [True, False])
def test_cluster_route_equals_plain_on_card(S, cluster, aligned):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py phase 9 runs this "
                    "comparison at every probe size)")
    x, idx = _slab(S, 64, 8)
    xt = torch.as_tensor(x, device="cuda") if aligned else \
        torch.empty(S * 64 + 1, device="cuda")[1:].view(S, 64).copy_(
            torch.as_tensor(x))
    assert row_gather_cuda.smem_load(xt) == ("bulk" if aligned else "threads")
    out = rg.row_gather(xt, torch.as_tensor(idx, device="cuda"), route="smem",
                        cluster=cluster)
    assert np.array_equal(out.cpu().numpy(), x[idx])


@pytest.mark.cuda
@pytest.mark.parametrize("S", [512, 2048])
@pytest.mark.parametrize("route", ["default", "smem", "l2"])
def test_kernel_equals_plain_on_card(S, route):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py phase 9 runs this "
                    "comparison at every probe size)")
    if route == "smem" and not row_gather_cuda.smem_fits(S, 64):
        pytest.skip("slab larger than the shared-memory route takes")
    x, idx = _slab(S, 64, 8)
    kw = {} if route == "default" else {"route": route}
    out = rg.row_gather(torch.as_tensor(x, device="cuda"),
                        torch.as_tensor(idx, device="cuda"), **kw)
    assert np.array_equal(out.cpu().numpy(), x[idx])
