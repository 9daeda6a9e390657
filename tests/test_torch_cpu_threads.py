"""Torch's intra-op threads in the CPU tests.

The suite runs in several worker processes at once (pytest-xdist), and
every worker imports every test module. Torch's default of one OpenMP
thread per core in each worker oversubscribes the cores, and the port's
many small ops then wait on each other's threads: the tiny LM's train CLI
test took 3 s alone and 218 s beside five other workers. Importing this
module caps torch at `THREADS` intra-op threads per process, which leaves
each test's arithmetic and tolerances as they are."""

import torch

THREADS = 2
torch.set_num_threads(min(THREADS, torch.get_num_threads()))


def test_torch_runs_with_few_intra_op_threads():
    assert 1 <= torch.get_num_threads() <= THREADS
