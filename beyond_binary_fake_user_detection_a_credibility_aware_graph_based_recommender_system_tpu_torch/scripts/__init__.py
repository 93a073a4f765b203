"""Pipelines ported from the JAX package's ``scripts/``, each run as
``python -m <package>.scripts.<name>`` on the CUDA card by default."""
