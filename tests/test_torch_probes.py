"""The port's probes run end to end on the CPU at a tiny size.

Each probe's ``main`` builds its graph or slabs, runs every variant through
the plain versions (the CPU path of each wrapper), checks the results and
prints one line per variant.  Without a card the default ``--device cuda``
raises rather than falling back to the CPU.
"""

import pytest
import torch

from beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch.probes import kernel_grid, vmem_gather, window_kernel

TINY = ["--device", "cpu", "--users", "300", "--items", "900",
        "--edges-per-user", "6", "--dim", "8", "--iters", "1"]


def test_window_kernel_probe(capsys):
    res = window_kernel.main(TINY)
    out = capsys.readouterr().out
    variants = ["csr", "base R=512 T=256", "i16 R=512 T=256", "win W=64",
                "win W=128", "win W=256"]
    assert [r["variant"] for r in res["rows"]] == variants * 2
    assert all(r["ok"] for r in res["rows"])
    assert res["clock"] == "host clock, cpu"
    for d in ("items<-users", "users<-items"):
        for v in variants:
            assert f"{d} {v}" in out
    assert "FAIL" not in out


def test_kernel_grid_probe(capsys):
    res = kernel_grid.main(TINY)
    out = capsys.readouterr().out
    assert len(res["grid"]) == 2 * 3 * 4
    assert all(r["ok"] for r in res["grid"])
    assert res["chain_ok"]
    assert set(res["chain"]) == {"current", "truncated", "padded"}
    assert "items<-users BEST:" in out and "users<-items BEST:" in out
    assert "chain sums: current=" in out and "FAIL" not in out


def test_vmem_gather_probe(capsys):
    res = vmem_gather.main(["--device", "cpu", "--sizes", "16,40",
                            "--steps", "4", "--dim", "8", "--iters", "1"])
    out = capsys.readouterr().out
    assert [r["S"] for r in res["rows"]] == [16, 40]
    assert all(r["exact"] and r["route"] == "plain" for r in res["rows"])
    assert out.count("correct") == 2 and "WRONG" not in out


@pytest.mark.parametrize("probe", [window_kernel, kernel_grid, vmem_gather])
def test_probe_defaults_to_cuda(probe):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default run is the full probe")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.main([])
