"""The port's tagged-DFA scan against the JAX package's kernel (the
Pallas kernel in interpret mode on the CPU mesh, as its own tests run
it): the cases of tests/test_torch_tdfa.py's KERNEL_CASES with random
tables at the 4-bit edge and with 16-bit codes, and the 8-bit-class
pattern past the CPU budget.  Each compiles its own interpret-mode JAX
program, so they run in a file of their own to balance the test
workers.  On identical seeded inputs tdfa_scan_ref gives the JAX
kernel's phi, swarm, bank and regs planes and the same device summary;
every quantity is an integer, so the tolerance is exact equality.
"""

import pytest
import torch

from test_torch_tdfa import KERNEL_CASES_EDGES_FILE
from test_torch_tdfa import planes_and_summary_match_jax

# The tier-1 run puts several test workers on the machine's cores; torch's
# own intra-op threads would spin against them and make these small ops
# many times slower.
torch.set_num_threads(1)


@pytest.mark.parametrize("name", sorted(KERNEL_CASES_EDGES_FILE))
def test_planes_and_summary_match_jax(name, monkeypatch):
    planes_and_summary_match_jax(name, monkeypatch)
