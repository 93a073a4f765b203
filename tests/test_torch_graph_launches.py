"""``chip_smoke.graph_node_counts``: the CUDA launches of one call, read
from the DOT dump (``cuGraphDebugDotPrint``, verbose) of a CUDA graph
captured from the call.  ``chip_smoke.py`` phases 5 and 10 hold the SpMM
kernels' launches per application to these counts.

The two dumps below are the driver's output for one application of the
chunk kernel (the counters' memset, then ``chunk_staged_kernel``) and of
the segment kernel with long rows (``rows_kernel``, then
``long_rows_kernel``) on an NVIDIA H100 80GB HBM3 under CUDA 12.8, with
their handles and addresses shortened.
"""

import pytest

import chip_smoke

CHUNK_DOT = r'''digraph dot {
subgraph cluster_1 {
label="graph_1" graph[style="dashed"];
"graph_1_node_0"[style="solid" style="solid" shape="record" label="{MEMSET
| {{ID | node handle | dptr | pitch | value | elementSize | width | height} | {0 (topoId: 1) | 0x01 | 0x02 | 0 | 0 | 1 | 6804 | 1}}}"];

"graph_1_node_1"[style="bold" shape="record" label="{KERNEL
| {ID | 1 (topoId: 0) | _ZN46_GLOBAL__N__eb76e861_13_chunk_spmm_cu_ad69ae7a19chunk_staged_kernelILb0ELb1EifEEvNS_4PlanIT1_EEPKT2_PfS7_Piiiiiiii\<\<\<396,256,72772\>\>\>}
| {{node handle | func handle} | {0x03 | 0x04}}
| {cooperative | 0}
| {priority | 0}
}"];

"graph_1_node_0" -> "graph_1_node_1" [headlabel=0];
}
}
'''

SEGMENT_DOT = r'''digraph dot {
subgraph cluster_2 {
label="graph_2" graph[style="dashed"];
"graph_2_node_0"[style="bold" shape="record" label="{KERNEL
| {ID | 0 (topoId: 1) | _ZN48_GLOBAL__N__2bb0e799_15_segment_spmm_cu_30cc376c11rows_kernelIffLi4ELi4EEEvPKlPKiPKfPKT_PT0_PfS2_S4_lliii\<\<\<4137,256,0\>\>\>}
| {{node handle | func handle} | {0x05 | 0x06}}
| {cooperative | 0}
| {priority | 0}
}"];

"graph_2_node_1"[style="bold" shape="record" label="{KERNEL
| {ID | 1 (topoId: 0) | _ZN48_GLOBAL__N__2bb0e799_15_segment_spmm_cu_30cc376c16long_rows_kernelIfEEvPKfPKiS4_PT_i\<\<\<446,256,0\>\>\>}
| {{node handle | func handle} | {0x07 | 0x08}}
| {cooperative | 0}
| {priority | 0}
}"];

"graph_2_node_0" -> "graph_2_node_1" [headlabel=0];
}
}
'''

CHUNK_KINDS = {"staged": "chunk_staged_kernel"}


@pytest.mark.parametrize("dot, kinds, want", [
    (CHUNK_DOT, CHUNK_KINDS, {"memset": 1, "staged": 1}),
    # long_rows_kernel holds "rows_kernel": the first fragment that
    # matches labels a kernel, and SEGMENT_KINDS names long_rows first
    (SEGMENT_DOT, chip_smoke.SEGMENT_KINDS, {"rows": 1, "long_rows": 1}),
    # a kernel no fragment names counts as "other"
    (SEGMENT_DOT, CHUNK_KINDS, {"other": 2}),
], ids=["chunk", "segment", "unnamed"])
def test_graph_node_counts(dot, kinds, want):
    assert chip_smoke.graph_node_counts(dot, kinds) == want


def test_graph_node_counts_sees_every_node():
    """Two applications in one graph count twice; an empty graph counts
    nothing; a node whose label names no type is refused."""
    body = CHUNK_DOT.split("digraph dot {")[1]
    twice = "digraph dot {" + body.replace("graph_1", "graph_9") + body
    assert chip_smoke.graph_node_counts(twice, CHUNK_KINDS) == {
        "memset": 2, "staged": 2}
    assert chip_smoke.graph_node_counts("digraph dot {\n}\n",
                                        CHUNK_KINDS) == {}
    with pytest.raises(AssertionError, match="without a type"):
        chip_smoke.graph_node_counts(
            'digraph dot {\n"graph_1_node_0"[shape="record"];\n}\n',
            CHUNK_KINDS)
