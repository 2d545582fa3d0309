import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    # several test workers on one host: a few intra-op threads each, or
    # their thread pools oversubscribe the cores and stall
    if os.environ.get("PYTEST_XDIST_WORKER"):
        import torch
        torch.set_num_threads(2)
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")
