"""One intra-op thread for PyTorch in every test process of the port.

Every ``tests/test_torch_*.py`` imports this module first.  The port's
parity tests run many small eager tensor ops.  At PyTorch's default of
one intra-op thread per core, each pytest-xdist worker's thread pool
spins against the other workers' for the same cores, and a test that
takes seconds alone takes a minute or more beside them.  So this module
pins PyTorch to one intra-op thread in the importing process, and sets
``OMP_NUM_THREADS=1`` for the processes the tests start (the command-line
entry points, the reference's subprocess harnesses), which read it when
they start.  JAX's CPU thread pool reads neither setting.
"""
import os

os.environ["OMP_NUM_THREADS"] = "1"

import torch  # noqa: E402

torch.set_num_threads(1)
