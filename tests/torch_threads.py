"""One thread for torch and the BLAS while a port test module runs.

Every ``test_torch_*.py`` imports ``one_thread``, an autouse fixture of
module scope. The pytest-xdist workers already share the machine's cores,
and at the libraries' default of one thread a core each worker asked for
all of them: the port's test files then took several times as long, the
more so the busier the machine. The counts in force before the module are
put back after it, so the JAX package's own test files run as they would
without it.

The BLAS is pinned too, through ``threadpoolctl`` where it is installed
(``test_torch_parity.py`` checks that it is wherever the JAX package's
tests run): numpy builds most of the tests' inputs and references. The
results stored in ``tests/torch_refs`` hold at any thread count: their
inputs move only in their last bits with it.

No module of the JAX package is imported here, so that the JAX-free test
files, which also run on the card, can take the fixture.
"""

import contextlib

import pytest


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch's intra-op pool, OpenMP and the BLAS at one thread each."""
    import torch

    try:
        from threadpoolctl import threadpool_limits
    except ImportError:  # the card's machine has none, and no xdist workers
        limits = contextlib.nullcontext()
    else:
        limits = threadpool_limits(1)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with limits:
        yield
    torch.set_num_threads(threads)
