"""Hand-written Hopper kernels of the port, one package per TPU kernel of
`repro.kernels` on the engine path.  Each package holds the plain PyTorch
version (`ref.py`, the CPU path and the on-card oracle) and `ops.py`, the
entry point: a CPU tensor goes to the plain version, a CUDA tensor to the
CUDA kernel under `repro_torch/csrc/` (built by `_build`), never the other
way round.  Each `ops` module counts its kernel launches in `launches`."""
