"""Conventional-tracking positioning: measurement epochs + WLS PVT.

The reference fuses tracking and WLS in one MATLAB loop
(`trackingCT_POS_updated.m`), but the coupling is one-directional — the
WLS result never feeds back into the DLL/PLL (only into the bookkeeping
`localTime`).  This build therefore runs the whole tracking
segment as one device scan (tracking.py) and forms the measurement epochs
from the recorded per-block state afterwards, host-side in float64:

- measurement epoch grid anchored at the first common subframe sample
  (trackingCT_POS_updated.m:151-164),
- per-channel code-phase interpolation to the common measurement sample
  → transmit times (…:437-458),
- pseudoranges from a receiver local clock initialized at
  max(transmitTime)+75 ms, corrected by the estimated bias each epoch
  (…:462-466,550-554),
- SV positions/clocks at transmit time, Sagnac, Klobuchar, UNB3
  corrections (…:472-505),
- iterated LS position + DOP, Doppler velocity LS (…:512-514).

All index conventions (1-based `nav1`, `sfb`) follow SURVEY.md §4 so the
reference's golden artifacts remain comparable.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from gps_sdr_tpu.config import C_LIGHT, L1_WAVELENGTH, ReceiverConfig
from gps_sdr_tpu.geo.atmosphere import klobuchar_delay, tropo_unb3_delay
from gps_sdr_tpu.geo.coords import elevation_azimuth, xyz2enu, xyz2llh
from gps_sdr_tpu.geo.earth import earth_rotation_correction
from gps_sdr_tpu.geo.ephemeris import Ephemeris, sv_pos_vel_clock
from gps_sdr_tpu.navdecode import EphemerisRecord
from gps_sdr_tpu.positioning.wls import (doppler_velocity_ls,
                                         iterated_ls_position)
from gps_sdr_tpu.tracking import TrackRecords
from gps_sdr_tpu.utils.device import on_host_cpu


@dataclasses.dataclass
class NavSolutions:
    """WLS navigation solutions, one row per epoch — the reference's
    `navSolutionsWLS` record (trackingCT_POS_updated.m:509-554)."""

    usr_pos: np.ndarray        # (E,3) ECEF
    usr_vel: np.ndarray        # (E,3) ECEF
    usr_pos_enu: np.ndarray    # (E,3) vs initial/truth position
    usr_pos_llh: np.ndarray    # (E,3) lat/lon deg, height m
    clk_bias_m: np.ndarray     # (E,)
    usr_vel_enu: np.ndarray
    clk_drift_ms: np.ndarray
    dop: np.ndarray            # (E,4)
    sat_el_deg: np.ndarray     # (E,N)
    sat_az_deg: np.ndarray
    transmit_time: np.ndarray  # (E,N)
    raw_pseudorange: np.ndarray
    code_phase_meas: np.ndarray
    local_time: np.ndarray     # (E,)
    cn0_dbhz: np.ndarray = None       # (E,N) moment-method C/N0
    valid: np.ndarray = None          # (E,N) channels in the solution


def cn0_series(records: TrackRecords, pdi: np.ndarray, k: int = 20):
    """Per-row (cn0_dbhz, gate_snr_db) from the prompt correlator powers
    — thin adapter over the single implementation in
    :func:`gps_sdr_tpu.utils.metrics.cn0_series` (gated mode), with the
    pdi²-normalization that keeps windows straddling the reference's
    per-channel 1 ms → 10 ms switch from spuriously tripping the gate."""
    from gps_sdr_tpu.utils.metrics import cn0_series as _cn0

    return _cn0(records.p_i, records.p_q, t_coh_s=pdi * 1e-3, window=k,
                gated=True)


def first_subframe_sample(records: TrackRecords, ch: int, nav1_ms: int,
                          sfb1: int) -> float:
    """Absolute sample of the first decoded subframe start
    (trackingCT_POS_updated.m:156): abs_sample[nav1 + sfb·20] (1-based)."""
    return float(records.absolute_sample[nav1_ms + sfb1 * 20 - 1, ch])


@on_host_cpu
def run_ct_positioning(records: TrackRecords, cfg: ReceiverConfig,
                       prns: Sequence[int],
                       eph: Dict[int, EphemerisRecord],
                       sbf: Dict[str, Dict[int, int]],
                       init_pos_ecef: np.ndarray,
                       pdi_ms_per_block: np.ndarray | int = 1,
                       max_epochs: int | None = None,
                       meas_start_sample: float | None = None,
                       local_time_advance_s: float | None = None,
                       doppler_at_fire_row: bool = False,
                       mesh=None) -> NavSolutions:
    """Form WLS solutions from a tracked segment.

    `records` must come from a tracking run whose state was initialized
    with the same origin as the eph-decoding run (both start at
    skip·S + S − codedelay + 1).

    `pdi_ms_per_block` is the coherent length of each record row: a
    scalar, a (T,) vector, or a (T, N) matrix when channels switch pdi
    at different rows (the reference's per-channel 1 ms → 10 ms switch
    at msToProcessCT_1ms + countinx, trackingCT_POS_updated.m:183,294).
    The transmit-time term uses each channel's own elapsed-ms cumsum
    (…:458: (index − switch)·pdi + switch).

    `meas_start_sample` overrides the first measurement sample (the
    reference anchors it at the first common subframe sample of its
    40 s eph-tracking record, …:151-164; replaying the reference's own
    shipped POS records needs the anchor passed in explicitly because
    that eph record predates the POS record's rows).

    `local_time_advance_s` overrides the per-epoch local-clock advance.
    The reference advances localTime by measSampleStep/Fs where
    measSampleStep is scaled by file.dataType — a BYTE count
    (…:164,554) — so its localTime steps 2× the true epoch interval on
    IQ data; the feedback loop re-removes the overshoot each epoch, so
    only the recorded clkBias (a constant +20 ms·c) and localTime are
    affected, not the position fix.  Default (None) uses the physically
    correct sample count; golden-artifact comparisons pass the
    reference's byte-scaled value.

    `doppler_at_fire_row=True` feeds the velocity LS the carrier
    frequency of the first row at which every channel has passed the
    measurement sample — one common row, the reference's live loop
    variable (…:513-514) — instead of each channel's interpolation row.
    Default keeps the epoch-aligned row.

    `mesh` (jax.sharding.Mesh) solves every epoch with the channel axis
    sharded over devices — psum-reduced normal equations for the
    iterated LS / DOP / velocity LS with validity weights
    (parallel/epoch.sharded_wls_epoch); results match the host solver
    to float round-off.
    """
    sig, cmn, solu = cfg.signal, cfg.cmn, cfg.solu
    fs = sig.fs
    n_ch = len(prns)
    T = records.absolute_sample.shape[0]
    pdi = (np.full((T, n_ch), pdi_ms_per_block)
           if np.isscalar(pdi_ms_per_block)
           else np.asarray(pdi_ms_per_block))
    if pdi.ndim == 1:
        pdi = np.broadcast_to(pdi[:, None], (T, n_ch))
    ms_elapsed = np.cumsum(pdi, axis=0)              # (T, N): ms at block end

    eph_struct = Ephemeris.stack(
        [_eph_to_struct(eph[p]) for p in prns])
    tow1 = np.array([eph[p].tow[0] for p in prns])
    nav1 = np.array([sbf["nav1"][p] for p in prns])
    sfb1 = np.array([eph[p].sfb[0] for p in prns])

    if meas_start_sample is None:
        anchor_rows = nav1 + sfb1 * 20 - 1
        if anchor_rows.max() >= T:
            raise ValueError(
                f"CT record ({T} rows) does not reach the first-subframe "
                f"anchor at row {int(anchor_rows.max())} (decoded "
                "nav1 + sfb1·20; trackingCT_POS_updated.m:151-161) — "
                "track more ms (n_ms) or decode with a smaller "
                "start_offset_ms so an earlier subframe anchors the "
                "measurement epoch")
        sample_start = np.array([
            first_subframe_sample(records, ch, int(nav1[ch]), int(sfb1[ch]))
            for ch in range(n_ch)])
        meas_start = sample_start.max() + 1
    else:
        meas_start = float(meas_start_sample)
    sample_end = records.absolute_sample[-1].min() - 1
    meas_step = int(fs * solu.nav_sol_period_ms / 1000)
    lt_advance = (meas_step / fs if local_time_advance_s is None
                  else float(local_time_advance_s))

    abs_s = records.absolute_sample            # (T, N)
    out: Dict[str, List] = {k: [] for k in (
        "usr_pos", "usr_vel", "enu", "llh", "clk_bias", "vel_enu",
        "clk_drift", "dop", "el", "az", "tt", "pr", "cpm", "lt",
        "cn0", "valid")}

    # measurement-validity gate: per-row post-correlation SNR against
    # solu.mask_snr_db (SURVEY.md §5 — channels drop in/out of the WLS
    # epochs; the reference computes CN0_CT but feeds every channel
    # unconditionally)
    cn0_rows, gate_rows = cn0_series(records, pdi)
    mask_thresh = float(getattr(solu, "mask_snr_db", 0.0))
    if mask_thresh > 0:
        from gps_sdr_tpu.utils.metrics import gate_mask
        valid_rows = gate_mask(gate_rows, mask_thresh)
    else:
        valid_rows = np.ones_like(gate_rows, bool)

    epoch_solver = None
    if mesh is not None and getattr(mesh, "size", 1) > 1:
        from gps_sdr_tpu.parallel.epoch import make_epoch_solver
        epoch_solver = make_epoch_solver(mesh, L1_WAVELENGTH)

    est = np.concatenate([np.asarray(init_pos_ecef, np.float64), [0.0]])
    local_time = np.inf
    epoch = 0
    while True:
        if max_epochs is not None and epoch >= max_epochs:
            break
        cur = meas_start + meas_step * epoch
        if cur > sample_end:
            break
        # last block whose end sample ≤ current measurement sample
        idx = np.array([np.searchsorted(abs_s[:, ch], cur, side="right") - 1
                        for ch in range(n_ch)])
        if np.any(idx < 0) or np.any(idx >= T - 1):
            break
        step_chips = records.code_freq[idx, np.arange(n_ch)] / fs
        code_phase = (records.rem_chip[idx, np.arange(n_ch)]
                      + step_chips * (cur - abs_s[idx, np.arange(n_ch)]))
        transmit_time = (code_phase / sig.code_length / 1000.0
                         + (ms_elapsed[idx, np.arange(n_ch)]
                            - (nav1 + sfb1 * 20)) / 1000.0
                         + tow1)

        if np.isinf(local_time):
            local_time = transmit_time.max() + 75e-3  # assumed travel time
        pseudorange = (local_time - transmit_time) * C_LIGHT

        sv = sv_pos_vel_clock(eph_struct, transmit_time)
        sv_pos = np.asarray(sv["pos"])
        sv_vel = np.asarray(sv["vel"])
        sv_clk = np.asarray(sv["clk_m"])
        sv_clk_rate = np.asarray(sv["clk_rate_ms"])
        tgd = np.asarray(sv["tgd_s"])

        prvec = pseudorange + sv_clk - tgd * C_LIGHT
        sv_pos_rot = np.asarray(earth_rotation_correction(sv_pos, prvec))

        el, az = elevation_azimuth(sv_pos_rot, est[:3])
        el, az = np.asarray(el), np.asarray(az)
        llh = np.asarray(xyz2llh(est[:3]))
        iono = np.asarray(klobuchar_delay(
            transmit_time, sv_pos_rot, est[:3],
            cmn.iono_alpha, cmn.iono_beta))
        tropo = np.abs(np.asarray(tropo_unb3_delay(
            cmn.day_of_year, np.rad2deg(llh[0]), llh[2], np.rad2deg(el))))
        prvec = prvec - iono - tropo

        cn0_now = cn0_rows[idx, np.arange(n_ch)]
        m = valid_rows[idx, np.arange(n_ch)]
        if m.sum() < 4:
            # not enough healthy channels to gate — degrade gracefully
            # to the ungated solution rather than losing the fix
            m = np.ones(n_ch, bool)
        # Doppler observable (carrFreq − IF), as the reference passes it
        # (trackingCT_POS_updated.m:514).  NB the fitted clock drift then
        # equals −c·(receiver fractional clock drift): a fast receiver
        # clock lowers every measured carrier frequency.
        dop_rows = (np.full(n_ch, min(int(idx.max()) + 1, T - 1))
                    if doppler_at_fire_row else idx)
        doppler = records.carr_freq[dop_rows, np.arange(n_ch)] - sig.f_if
        if epoch_solver is not None:
            est, dop, vel, clk_drift = epoch_solver(
                prvec, sv_pos_rot, sv_vel, doppler, sv_clk_rate, m, est)
        else:
            est, dop = iterated_ls_position(prvec[m], sv_pos_rot[m], est)
            est = np.asarray(est)
            vel, clk_drift, _ = doppler_velocity_ls(
                est[:3], sv_pos_rot[m], sv_vel[m], doppler[m],
                L1_WAVELENGTH, sv_clk_rate[m])
            vel = np.asarray(vel)

        enu = np.asarray(xyz2enu(est[:3], init_pos_ecef))
        vel_enu = np.asarray(xyz2enu(est[:3] + vel, est[:3]))
        llh_out = np.asarray(xyz2llh(est[:3]))
        llh_out = np.array([np.rad2deg(llh_out[0]), np.rad2deg(llh_out[1]),
                            llh_out[2]])

        out["usr_pos"].append(est[:3].copy())
        out["usr_vel"].append(vel)
        out["enu"].append(enu)
        out["llh"].append(llh_out)
        out["clk_bias"].append(est[3])
        out["vel_enu"].append(vel_enu)
        out["clk_drift"].append(float(clk_drift))
        out["dop"].append(np.asarray(dop))
        out["el"].append(np.rad2deg(el))
        out["az"].append(np.rad2deg(az))
        out["tt"].append(transmit_time)
        out["pr"].append(pseudorange)
        out["cpm"].append(code_phase)
        out["cn0"].append(cn0_now)
        out["valid"].append(m)
        # local clock feedback (trackingCT_POS_updated.m:550-554)
        local_time = local_time - est[3] / C_LIGHT
        out["lt"].append(local_time)
        local_time = local_time + lt_advance
        epoch += 1

    return NavSolutions(
        usr_pos=np.asarray(out["usr_pos"]), usr_vel=np.asarray(out["usr_vel"]),
        usr_pos_enu=np.asarray(out["enu"]), usr_pos_llh=np.asarray(out["llh"]),
        clk_bias_m=np.asarray(out["clk_bias"]),
        usr_vel_enu=np.asarray(out["vel_enu"]),
        clk_drift_ms=np.asarray(out["clk_drift"]), dop=np.asarray(out["dop"]),
        sat_el_deg=np.asarray(out["el"]), sat_az_deg=np.asarray(out["az"]),
        transmit_time=np.asarray(out["tt"]),
        raw_pseudorange=np.asarray(out["pr"]),
        code_phase_meas=np.asarray(out["cpm"]),
        local_time=np.asarray(out["lt"]),
        cn0_dbhz=np.asarray(out["cn0"]),
        valid=np.asarray(out["valid"]))


def _eph_to_struct(rec: EphemerisRecord):
    """EphemerisRecord (first decode) → Ephemeris field namespace."""
    d = rec.latest(0)

    class _E:
        pass

    e = _E()
    for k, v in d.items():
        setattr(e, k, v)
    return e
