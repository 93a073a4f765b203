"""Probes of the SpMM layouts and the slab gather, ported from the JAX
package's ``scripts/probe_window_kernel.py``, ``scripts/probe_kernel_grid.py``
and ``scripts/probe_vmem_gather.py``.  Each runs as
``python -m <package>.probes.<name> [--device cuda|cpu] [sizes]`` and, by
default, at the JAX probe's reference scale on the CUDA card."""
