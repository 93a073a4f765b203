"""Serving over a device mesh: the mesh runtime on ``torch.distributed``,
the edge-sharded SpMM operator and the row-sharded top-k."""
