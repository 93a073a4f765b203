"""The check that nothing the run loaded is JAX or the JAX package.

The port's package name begins with the JAX package's, so modules are
compared by their whole top-level name, the part before the first dot."""

from __future__ import annotations

import sys
from typing import Iterable, List

JAX_PACKAGE = ("beyond_binary_fake_user_detection_a_credibility_aware_graph_"
               "based_recommender_system_tpu")
PORT_PACKAGE = JAX_PACKAGE + "_torch"
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", JAX_PACKAGE})


def forbidden_loaded(modules: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among ``modules`` (default: the
    names in ``sys.modules``), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
