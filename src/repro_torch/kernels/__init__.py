"""Hand-written CUDA kernels (``csrc/``), their wrappers and their plain
PyTorch versions. Nothing here builds or loads a kernel at import: the
build runs at the first launch on a CUDA tensor."""
