"""Mesh-sharded acquisition: the search grid is data parallel
(SURVEY.md §2.9; reference hot loop acquisition.m:47-61).

Each device owns P/D code replicas and computes its slice of the
(P, F, S) power grid of :func:`acquisition_power_grid`, the circular
complex grid.  The per-block carrier-mix FFTs are replicated work (every
device computes the same (F, S) spectra), a ≤ 1/(P/D+1) fraction of the
total FFT work.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from gps_sdr_tpu.acquisition import acquisition_power_grid
from gps_sdr_tpu.parallel.mesh import AXIS


def sharded_acquisition_power(mesh: Mesh, prn_chunk: int = 8):
    """Returns power_fn(blocks, carriers, code_fft) → (P, F, S) float32,
    the circular grid with its PRN axis sharded over `mesh` (P is padded
    to a multiple of the mesh size and the padding sliced off); drop-in
    for ``run_acquisition(power_fn=…)``."""
    ndev = mesh.shape[AXIS]
    inner = functools.partial(acquisition_power_grid, prn_chunk=prn_chunk)
    shard_fn = jax.jit(jax.shard_map(
        inner, mesh=mesh,
        in_specs=(P(None, None), P(None, None), P(AXIS, None)),
        out_specs=P(AXIS, None, None), check_vma=False))

    def fn(blocks, carriers, code_fft):
        p = code_fft.shape[0]
        pad = (-p) % ndev
        code_fft = jnp.pad(code_fft, ((0, pad), (0, 0)))
        return shard_fn(blocks, carriers, code_fft)[:p]

    return fn
