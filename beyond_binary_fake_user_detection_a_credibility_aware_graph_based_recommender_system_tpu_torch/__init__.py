"""PyTorch/CUDA port of the credibility-aware graph recommender.

The JAX package beside it
(``beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu``)
is the reference; this package keeps its sub-package and module names so
each module's counterpart is easy to find, imports ``torch`` and never
``jax``, and runs its entry points on the CUDA device unless the caller asks
for the CPU.  Its hand-written kernels are the weighted segment-sum SpMM
(``ops/spmm_cuda.py``, ``csrc/segment_spmm.cu``), which is also its own
backward, and the fused Adam update (``ops/adam_cuda.py``,
``csrc/fused_adam.cu``).  The probes (``probes/``) run the edge-chunked
SpMM layout (``ops/segment_plan.py``, ``ops/chunk_spmm.py``,
``csrc/chunk_spmm.cu``) and a slab row gather (``ops/row_gather.py``,
``csrc/row_gather.cu``) against the main path's kernel.

Both stages are ported.  Stage A: ``train-cred`` / ``CredTrainer.fit``
(ingest through the native C++ reader ``data/native/`` or the Python one,
labels, features, the heterograph, and the credibility model in its SLAS
and full-graph modes).  Stage B: ``train-rec`` / ``RecTrainer.fit`` (BPR
training with checkpoints), ``evaluate`` on saved parameters, the
full-catalog and sampled rankings, and ``eval.retrieval.topk_for_users``.
The training steps' row gathers (``ops/gather.py``) take the SpMM kernel as
their backward, a segment-sum of the gradient rows in a fixed order.
Serving also runs on a device mesh (``parallel/``, ``torch.distributed``):
the edge-sharded SpMM operator, whose local sums are the same kernel, and
the row-sharded top-k, behind ``evaluate --mesh``.  The JAX system's
performance surface and north-star pipeline are ``bench.py`` (``python -m
<package>.bench``) and ``scripts/two_stage_10m.py``.

    import beyond_binary_fake_user_detection_a_credibility_aware_graph_based_recommender_system_tpu_torch as bbt
"""

__version__ = "0.1.0"
