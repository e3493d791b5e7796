"""The port's kernels: hand-written CUDA (``csrc/``) behind Python
wrappers, each with its plain PyTorch version beside it.  Nothing here
builds or loads a kernel at import time."""
