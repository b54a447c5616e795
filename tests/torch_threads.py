"""One intra-op thread per test process for the port's CPU tests.

The suite runs under pytest-xdist, several workers side by side on one
host. Left alone, every worker's torch starts one OpenMP thread per core
for each op on a large enough tensor, so the workers' threads outnumber
the cores many times over and spin against each other: a port test took
four times as long in the full suite as alone. The port's tests work on
small tensors, where one thread per process loses nothing. Every
`tests/test_torch_*.py` imports this module, so the cap holds in each
worker whatever file it collects first; nothing of what a test checks
depends on it.
"""

import torch

torch.set_num_threads(1)
