"""Thread pins shared by the port's test files (``test_torch_*.py``).

The suite runs in several xdist workers at once, and each port test file
also starts JAX reference runs in subprocesses.  Left alone, each worker's
torch takes one intra-op thread per core and each JAX subprocess runs
XLA's own pool on every core, so the workers oversubscribe the cores many
times over and spend their time waiting on each other.  A test file
imports the two fixtures below::

    from torch_threads import pin_threads, subproc  # noqa: F401

``pin_threads`` (module-scoped, autouse) runs the module's torch on one
intra-op thread and sets ``OMP_NUM_THREADS=1`` for the processes it
starts (the train CLI, the JAX references); both are restored when the
module ends.  ``subproc`` replaces the conftest fixture of that name for
the module: the same ``run_subprocess``, with XLA's CPU runtime capped to
one thread per op (``--xla_cpu_multi_thread_eigen=false`` appended to
``XLA_FLAGS`` before the snippet imports jax) and at most
``MAX_SUBPROCS`` reference runs of the worker at a time (``bounded``).
A bitwise gate between two port runs still compares runs made under the
same thread count in one process.  Single-threaded Eigen sums a
reference run's matmuls in another order than XLA's default pool: a
module whose bounds were set against the default pool's results keeps
the conftest's ``subproc`` and wraps it in ``bounded`` itself
(``test_torch_train_step.py``: its int8 runs sit one quantization step
from a bound).
"""

import os
import textwrap
import threading

import pytest
import torch

#: appended to the snippet's ``XLA_FLAGS`` before it imports jax
XLA_ONE_THREAD = " --xla_cpu_multi_thread_eigen=false"

#: reference subprocesses one test module runs at once
MAX_SUBPROCS = 2

_PRELUDE = ("import os\n"
            "os.environ['XLA_FLAGS'] = os.environ.get('XLA_FLAGS', '') + "
            f"{XLA_ONE_THREAD!r}\n")

_SLOTS = threading.BoundedSemaphore(MAX_SUBPROCS)


@pytest.fixture(scope="module", autouse=True)
def pin_threads():
    n = torch.get_num_threads()
    omp = os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(n)
    if omp is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = omp


def bounded(run):
    """``run`` (a ``subproc``) that waits while ``MAX_SUBPROCS`` reference
    runs of this worker are live."""
    def call(*args, **kwargs):
        with _SLOTS:
            return run(*args, **kwargs)
    return call


@pytest.fixture(scope="module")
def subproc(subproc):
    """The conftest's ``subproc`` with XLA on one thread per op, at most
    ``MAX_SUBPROCS`` at a time."""
    def run(code: str, devices: int = 8, timeout: int = 900) -> str:
        return subproc(_PRELUDE + textwrap.dedent(code), devices, timeout)
    return bounded(run)
