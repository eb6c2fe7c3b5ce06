"""PyTorch port of the `repro` package for NVIDIA Hopper (H100).

Same layout as `repro`: `core/`, `models/`, `kernels/<family>/`, `api/`,
`data/`; `csrc/` holds the hand-written CUDA kernels. Imports torch and
numpy, never jax and nothing of `repro`. Entry points run on "cuda"
unless asked for "cpu", where every kernel wrapper takes its plain
PyTorch version. `bridge.py` loads JAX parameter trees (as numpy) into
the port's modules.
"""
