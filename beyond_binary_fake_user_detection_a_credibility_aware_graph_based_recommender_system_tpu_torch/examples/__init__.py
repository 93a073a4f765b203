"""Walk-throughs of the public API, ported from the JAX package's
``examples/``, each run as ``python -m <package>.examples.<name>``."""
