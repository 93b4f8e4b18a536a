"""Host-compute placement.

The positioning epoch loops are host-side f64 math (Kepler, Klobuchar,
4×4 WLS solves, coordinate transforms) running between device scans as
many tiny eager operations.  On a GPU each of them would cost a kernel
launch and a device round trip, more than its arithmetic, so
`host_epoch_device()` pins this math to the local CPU backend; on a
CPU-default process it is a no-op.
"""

from __future__ import annotations

import contextlib
import functools
import os


def host_epoch_device():
    """Context manager placing uncommitted computations on the CPU."""
    import jax

    if jax.default_backend() == "cpu":
        return contextlib.nullcontext()
    try:
        cpu = jax.devices("cpu")[0]
    except RuntimeError as e:
        raise RuntimeError(
            "the receiver's epoch math runs on JAX's CPU backend, which "
            "this process hides (JAX_PLATFORMS="
            f"{os.environ.get('JAX_PLATFORMS')!r}); allow it, e.g. "
            "JAX_PLATFORMS=cuda,cpu, or leave JAX_PLATFORMS unset") from e
    return jax.default_device(cpu)


def on_host_cpu(fn):
    """Decorator: run `fn` under host_epoch_device()."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with host_epoch_device():
            return fn(*args, **kwargs)

    return wrapped
