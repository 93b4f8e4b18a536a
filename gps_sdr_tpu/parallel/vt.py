"""Mesh-sharded vector tracking (VDFLL) — the flagship stage distributed.

The VT loop couples all channels every ms through the 8-state EKF
(trackingVT_POS_updated.m:388-404), but the coupling is tiny: each
channel contributes one unit line-of-sight row (at the Kepler group
head) and two scalar measurements + a validity bit per ms.  Everything
else — the correlator banks (the bulk of the FLOPs at 58 Msps/channel),
code/carrier NCOs, scalar PLLs, Kepler solves, atmosphere — is
per-channel and shards cleanly over devices.

`receiver/vt.run_vector_tracking(..., mesh=...)` is the production
entry: the channel axis of the scan state / chip tables / ephemeris is
padded to a multiple of the mesh size and the whole `vt_scan` runs
inside `shard_map`.  Per step each device `all_gather`s the per-channel
measurement contributions (~10 f32 per channel, at the
receiver's natural 1 ms sync point) and applies the IDENTICAL
replicated Joseph-form EKF update — so the sharded run is
**bit-identical** to the single-device scan at any device count
(tests/test_mesh_pipeline.py), the same guarantee the sharded CT
tracking and WLS epoch paths give.  (An information-form psum —
HᵀR⁻¹H (8×8), HᵀR⁻¹z (8,) — would move marginally fewer bytes but
compute a numerically DIFFERENT f32 update per device count; with ≤32
channels the gather payload is ≲1 KB/ms either way, so collective
latency, not bandwidth, sets its cost and the bit-stable formulation
wins.)
"""

from __future__ import annotations

import functools

import jax
from jax.sharding import Mesh, PartitionSpec as P

from gps_sdr_tpu.parallel.mesh import AXIS
from gps_sdr_tpu.receiver.vt import (_VT_REC_GLOBAL, _VT_STATE_REPLICATED,
                                     VTParams, VTState, vt_scan)

# VTState fields replicated across the mesh (the EKF layer); every other
# field is per-channel and shards along its leading axis.  Single
# source: receiver/vt._VT_STATE_REPLICATED (also drives the unpad).
_REPLICATED = _VT_STATE_REPLICATED

_STATE_SPEC = VTState(**{
    f: (P() if f in _REPLICATED else P(AXIS))
    for f in VTState._fields})

# scan records: per-channel series shard on axis 1 (axis 0 is time);
# EKF-layer series (_VT_REC_GLOBAL) are replicated
_REC_KEYS = ("corr", "carr_err", "code_err", "code_freq", "carr_freq",
             "delta_pr", "num_sample", "absolute_sample", "rem_chip",
             "rem_phase", "carr_nco", "sv_pos", "predicted_z",
             "total_state", "state_cov_diag", "kalman_gain", "innovation",
             "r_diag", "loop_bw_hz", "el", "az", "sv_vel", "local_time",
             "transmit_time", "cn0", "valid")


def _rec_spec(keys):
    return {k: (P() if k in _VT_REC_GLOBAL else P(None, AXIS))
            for k in keys}


@functools.lru_cache(maxsize=64)
def sharded_vt_scan(mesh: Mesh, params: VTParams, n_steps: int, fs: float,
                    blk: int, f_if: float, fc: float,
                    code_freq_basis: float, doy: int, n_real: int):
    """Returns fn(raw, chunk_start, state, chip_tables, eph, alpha, beta)
    with the channel axis sharded over `mesh` (channel count must be a
    multiple of mesh.size — see `pad_vt_state`; `n_real` is the real
    channel count before padding).  lru_cached on the full static
    signature so the chunked host driver reuses one jitted program per
    chunk length."""

    def inner(raw, chunk_start, state, chip_tables, eph, alpha, beta):
        return vt_scan(raw, chunk_start, state, chip_tables, eph, alpha,
                       beta, params, n_steps, fs, blk, f_if, fc,
                       code_freq_basis, doy, axis_name=AXIS,
                       n_real=n_real)

    from gps_sdr_tpu.geo.ephemeris import Ephemeris
    eph_spec = Ephemeris(*([P(AXIS)] * len(Ephemeris._fields)))
    fn = jax.shard_map(
        inner, mesh=mesh,
        in_specs=(P(), P(), _STATE_SPEC, P(AXIS, None), eph_spec, P(),
                  P()),
        out_specs=(_STATE_SPEC, _rec_spec(_REC_KEYS)), check_vma=False)
    return jax.jit(fn)


def pad_vt_state(state: VTState, chip_tables, eph, mult: int):
    """Pad the channel axis of (state, chip_tables, eph) to a multiple
    of `mult` by duplicating channel 0 (appended LAST, so the scan's
    gather-slice [:n_real] never sees them).  Replicated EKF fields are
    left untouched.  Returns (state, tables, eph, n_pad)."""
    import jax.numpy as jnp

    n = state.ptr.shape[0]
    pad = (-n) % mult
    if pad == 0:
        return state, chip_tables, eph, 0

    def pad_arr(a):
        return jnp.concatenate([a, jnp.repeat(a[:1], pad, axis=0)])

    state = VTState(**{
        f: (getattr(state, f) if f in _REPLICATED
            else pad_arr(getattr(state, f)))
        for f in VTState._fields})
    chip_tables = pad_arr(chip_tables)
    eph = type(eph)(*[pad_arr(jnp.asarray(f)) for f in eph])
    return state, chip_tables, eph, pad
