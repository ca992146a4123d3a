"""repro_torch — the Camel system ported to PyTorch and CUDA for an NVIDIA
H100, beside the JAX reference package `repro`.

The layout mirrors `repro` module for module.  This package imports
`torch` and never `jax` or `repro`: what it needs from the reference's
framework-free modules it keeps as its own copy.  Entry points run on the
card (`device="cuda"`) unless the caller passes `device="cpu"`, which runs
every kernel's plain PyTorch version instead.  Run it from the repository
root with ``PYTHONPATH=src python -m repro_torch...``: started from inside
this directory, its `platform` subpackage would shadow the standard
library's.
"""
