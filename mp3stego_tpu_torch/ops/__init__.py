"""Numeric planes in torch, and the hand-written CUDA kernels they launch.

Nothing here imports ``triton`` or builds a kernel at import time: kernels
are compiled at their first launch (``ops._cuda``)."""
