"""A reproducible CPU route for the port's float64 parity tests.

torch's CPU ``sqrt`` (float32 and float64) is computed by its vector math
library, not by the IEEE square-root instruction: it rounds 1 ulp below
the correctly rounded root for about 0.85% of arguments, the same in
every run, at any thread count and on every CPU capability path
(``ATEN_CPU_CAPABILITY`` default, avx2, avx512), strided or contiguous.
That is deterministic. What is not: at 8 intra-op threads, one thread's
chunk of a float64 call has been seen to come back up to 4.9e5 ulps off
in a few processes of a parallel test run, and never at one intra-op
thread. So the parity tests that pass float64 through ``sqrt`` run at
one intra-op thread, through the ``one_thread`` fixture, and the thread
count is restored after each test.
"""

import contextlib

import pytest
import torch


@contextlib.contextmanager
def one_intra_op_thread():
    """torch's intra-op thread count set to 1 inside the block, restored
    after it."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(old)


@pytest.fixture
def one_thread():
    """The test runs at one intra-op thread (``one_intra_op_thread``)."""
    with one_intra_op_thread():
        yield
