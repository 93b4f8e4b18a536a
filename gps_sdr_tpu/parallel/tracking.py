"""Mesh-sharded conventional tracking: channels are independent between
measurement epochs (SURVEY.md §2.9), so the channel batch axis shards
cleanly over devices — each device scans its channels against a replicated
raw chunk; no collectives until the positioning epoch.

`tracking.run_tracking(..., mesh=...)` is the production entry: it pads
the channel axis to a multiple of the mesh size (duplicating channel 0 —
the padded channels track real signal and are simply dropped from the
returned records) and dispatches every chunk scan through
`sharded_track_scan`.  Per-channel arithmetic is identical to the
unsharded scan, so results are bit-identical at any device count
(tests/test_parallel.py, tests/test_mesh_pipeline.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from gps_sdr_tpu.parallel.mesh import AXIS
from gps_sdr_tpu.tracking import TrackParams, TrackState, track_scan


@functools.lru_cache(maxsize=64)
def sharded_track_scan(mesh: Mesh, params: TrackParams, n_steps: int,
                       fs: float, blk: int, code_freq_basis: float,
                       margin: int = 0):
    """Returns fn(raw, chunk_start, state, chip_tables) with the channel
    axis of `state`/`chip_tables` sharded over the mesh.  Channel count
    must be a multiple of the mesh size (see `pad_channels`).

    lru_cached on the full static signature (Mesh and the frozen
    TrackParams are hashable) so repeated `run_tracking` calls in one
    pipeline run — eph tracking, the 3-phase schedule, positioning —
    reuse one jitted program per (params, chunk shape) instead of
    re-jitting the scan every stage."""

    def inner(raw, chunk_start, state, chip_tables):
        return track_scan(raw, chunk_start, state, chip_tables, params,
                          n_steps, fs, blk, code_freq_basis, margin)

    chan = P(AXIS)
    state_spec = TrackState(*([chan] * len(TrackState._fields)))
    rec_spec = dict(corr=P(None, AXIS, None, None), code_err=P(None, AXIS),
                    carr_err=P(None, AXIS), code_freq=P(None, AXIS),
                    carr_freq=P(None, AXIS), num_sample=P(None, AXIS),
                    rem_chip=P(None, AXIS), rem_phase=P(None, AXIS),
                    absolute_sample=P(None, AXIS))
    fn = jax.shard_map(
        inner, mesh=mesh,
        in_specs=(P(), P(), state_spec, P(AXIS, None)),
        out_specs=(state_spec, rec_spec), check_vma=False)
    return jax.jit(fn)


def pad_channels(state: TrackState, chip_tables: jnp.ndarray, mult: int):
    """Pad the channel axis of (state, chip_tables) to a multiple of
    `mult` by duplicating channel 0.  Returns (state, tables, n_pad)."""
    n = state.ptr.shape[0]
    pad = (-n) % mult
    if pad == 0:
        return state, chip_tables, 0
    state = TrackState(*[
        jnp.concatenate([f, jnp.repeat(f[:1], pad, axis=0)])
        for f in state])
    chip_tables = jnp.concatenate(
        [chip_tables, jnp.repeat(chip_tables[:1], pad, axis=0)])
    return state, chip_tables, pad


