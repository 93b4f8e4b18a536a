"""End-to-end vector-tracking (VDFLL + EKF) test on the geometry scenario,
warm-started from the CT stage like the reference (SDR_main.m:77-99)."""

import numpy as np
import pytest

from gps_sdr_tpu.geo.coords import llh2xyz
from gps_sdr_tpu.pipeline import Receiver

from tests import scenario


@pytest.fixture(scope="module")
def vt_result():
    src = scenario.build_scenario_source()
    rx = Receiver(scenario.CFG, src, artifact_dir=scenario.CACHE_DIR)
    truth = np.asarray(llh2xyz(np.asarray(scenario.TRUTH_LLH)))
    init = truth + np.array([3000.0, -2000.0, 1500.0])
    trk, sol = rx.vt_position(n_ms=3000, ct_n_ms=4000, init_pos_ecef=init)
    return trk, sol, truth


def test_vt_position_accuracy(vt_result):
    _, sol, truth = vt_result
    err = np.linalg.norm(sol.usr_pos - truth, axis=1)
    tail = err[500:]
    # same Gold-code cross-correlation floor as the WLS scenario
    # (test_e2e_ct.py), with tighter scatter from the EKF smoothing
    assert np.median(tail) < 35.0, f"median VT error {np.median(tail):.2f} m"
    assert np.max(tail) < 60.0, f"max VT error {np.max(tail):.2f} m"


def test_vt_scatter_tighter_than_wls(vt_result):
    _, sol, truth = vt_result
    spread = np.std(sol.usr_pos[500:] - sol.usr_pos[500:].mean(0), axis=0)
    assert np.all(spread < 8.0), spread


def test_vt_velocity_static(vt_result):
    _, sol, _ = vt_result
    v = np.linalg.norm(sol.usr_vel[500:], axis=1)
    assert np.median(v) < 1.0, f"median VT velocity {np.median(v):.2f} m/s"


def test_vt_innovations_bounded(vt_result):
    _, sol, _ = vt_result
    n2 = sol.innovation.shape[1]
    pr_inno = sol.innovation[500:, :n2 // 2]
    assert np.median(np.abs(pr_inno)) < 10.0
    assert np.all(np.isfinite(sol.innovation))


def test_vt_code_loop_closed_by_nav(vt_result):
    trk, _, _ = vt_result
    # the vector loop drives codeFreq from the nav solution: mean deltaPr
    # per channel sits at the geometric range rate (±1 km/s); the per-ms
    # scatter reflects EKF position jitter differenced at 1 kHz
    means = trk.delta_pr[500:].mean(axis=0)
    assert np.all(np.abs(means) < 1200.0), means
    assert np.std(trk.delta_pr[500:], axis=0).max() < 600.0


def test_vt_diagnostics_recorded(vt_result):
    trk, sol, _ = vt_result
    T = sol.usr_pos.shape[0]
    n_ch = trk.code_freq.shape[1]
    assert sol.kalman_gain.shape == (T, 8, 2 * n_ch)
    assert sol.state_cov_diag.shape == (T, 8)
    assert np.all(sol.state_cov_diag > 0)
    # equivalent loop bandwidth diag(H·K)/4/293/0.001 — the 2021 VT
    # variant's diagnostic (trackingVT_POS_updated_by_20210621.m:384);
    # steady-state VDLL bandwidths are positive and O(0.1-100) Hz
    assert sol.loop_bw_hz.shape == (T, 2 * n_ch)
    bw = sol.loop_bw_hz[500:]
    assert np.all(np.isfinite(bw))
    assert np.median(bw) > 0.0
    assert np.all(np.abs(bw) < 1000.0)


def test_vt_legacy_params():
    """trackingVT_POS.m's noise model as a VTParams preset: fixed R
    (adaptive machinery disabled), the 1e1-scaled process noise."""
    from gps_sdr_tpu.receiver.vt import VTParams

    p = VTParams.legacy()
    assert (p.r_pr0, p.r_prr0) == (1e-1, 1e-2)
    assert (p.q_pos, p.q_vel, p.q_clk, p.q_clkd) == (1.0, 0.1, 100.0, 10.0)
    assert p.r_update_ms > 1_000_000  # never fires within a run
    assert p.taps == (0.5, 0.0, -0.5)


def test_vt_atmosphere_cadence_any_chunking():
    """Regression: the iono/tropo/el/az refresh must keep its
    ~corr_update_ms cadence for ANY chunk length / kepler_update_ms,
    including combinations where Kepler group heads never land exactly
    on a multiple of corr_update_ms (the group-head refresh condition
    tests for a due multiple WITHIN the group)."""
    import dataclasses as dc

    import numpy as np

    from gps_sdr_tpu.geo.ephemeris import Ephemeris
    from gps_sdr_tpu.pipeline import Receiver
    from gps_sdr_tpu.receiver.vt import (VTParams, init_vt_state,
                                         run_vector_tracking)

    src = scenario.build_scenario_source()
    rx = Receiver(scenario.CFG, src, artifact_dir=scenario.CACHE_DIR)
    cfg = scenario.CFG
    eph, sbf = rx.decode()
    pos_svs = rx.usable_svs()
    truth = np.asarray(llh2xyz(np.asarray(scenario.TRUTH_LLH)))
    init = truth + np.array([3000.0, -2000.0, 1500.0])
    ct_rec, ct_nav = rx.ct_position(n_ms=4000, init_pos_ecef=init)
    epoch0 = cfg.file.skiptime_vt_ms // cfg.solu.nav_sol_period_ms - 1
    # kepler_update_ms=30 does NOT divide corr_update_ms=100, and
    # chunk_ms=133 shifts every chunk's group phase
    params = VTParams(kepler_update_ms=30)
    start_slot, tt0 = {}, np.empty(len(pos_svs))
    for ch, p in enumerate(pos_svs):
        first_sf_ms = sbf["nav1"][p] + eph[p].sfb[0] * 20
        slot = first_sf_ms + cfg.file.skiptime_vt_ms - 1
        start_slot[ch] = slot
        tt0[ch] = (eph[p].tow[0] + (slot + 1 - first_sf_ms) / 1000.0
                   + ct_rec.rem_chip[slot, ch] / cfg.signal.code_freq_basis)
    state = init_vt_state(cfg, ct_rec, list(range(len(pos_svs))),
                          start_slot, tt0, ct_nav.usr_pos[epoch0],
                          ct_nav.usr_vel[epoch0],
                          float(ct_nav.clk_bias_m[epoch0]),
                          float(ct_nav.clk_drift_ms[epoch0]), params)
    eph_struct = Ephemeris(**{
        k: np.asarray([eph[p].latest(0)[k] for p in pos_svs])
        for k in Ephemeris._fields})
    _, sol, _ = run_vector_tracking(rx.source, cfg, pos_svs, eph_struct,
                                    state, params, 450, init, chunk_ms=133)
    el = sol.sat_el_deg[:, 0]
    # refresh fired repeatedly (satellite motion changes el each time);
    # with the frozen-refresh bug there is exactly one distinct value
    assert len(np.unique(el)) >= 3, np.unique(el)
    # and never a gap longer than corr_update_ms + kepler_update_ms
    change = np.flatnonzero(np.diff(el) != 0)
    assert change.size >= 2
    assert np.max(np.diff(change)) <= 130 + 1, np.max(np.diff(change))


def test_vt_mat_export_roundtrip(vt_result, tmp_path):
    """The VT `.mat` interop (trackingVT_POS_updated.m:532-533): records
    and solutions written in the reference's 21-field TckResultVT /
    navSolutionsVT schemas round-trip through the loaders — a MATLAB
    user of the reference can consume this build's VT outputs."""
    from gps_sdr_tpu.io import matref
    from gps_sdr_tpu.receiver.vt import VTParams
    from tests.scenario import CFG

    trk, sol, _ = vt_result
    n_ch = trk.code_freq.shape[1]
    prns = [3, 16, 22, 26, 31][:n_ch]

    p = str(tmp_path / "tckRstVT_test_updated.mat")
    w = 20
    cn0 = sol.cn0_dbhz[w - 1::w]
    matref.save_vt_records_mat(
        p, trk, prns, bytes_per_sample=CFG.file.bytes_per_sample,
        samples_per_ms=CFG.signal.samples_per_ms, cn0_vt=cn0)
    trk2, cn0_2 = matref.load_vt_records(
        p, prns, bytes_per_sample=CFG.file.bytes_per_sample)
    np.testing.assert_array_equal(trk2.absolute_sample,
                                  trk.absolute_sample)
    np.testing.assert_array_equal(trk2.rem_chip, trk.rem_chip)
    np.testing.assert_array_equal(trk2.rem_phase, trk.rem_phase)
    np.testing.assert_array_equal(trk2.code_freq, trk.code_freq)
    np.testing.assert_array_equal(trk2.carr_freq, trk.carr_freq)
    np.testing.assert_array_equal(trk2.carr_nco, trk.carr_nco)
    np.testing.assert_array_equal(trk2.delta_pr, trk.delta_pr)
    np.testing.assert_allclose(trk2.corr, trk.corr, rtol=1e-6)
    np.testing.assert_allclose(trk2.sv_vel, trk.sv_vel, rtol=1e-6)
    # numSample is not a schema field; rows 1: are reconstructed exactly
    # from the absoluteSample diffs (row 0 is estimated — docstring)
    np.testing.assert_array_equal(trk2.num_sample[1:], trk.num_sample[1:])
    np.testing.assert_array_equal(cn0_2, cn0)

    # the schema's internal laws hold on OUR export exactly as they hold
    # on the reference's shipped artifact (test_golden_mat VT laws):
    import scipy.io as sio
    raw = sio.loadmat(p, squeeze_me=True)["TckResultVT"]
    ch0 = raw[prns[0] - 1]
    ab = np.asarray(ch0["absoluteSample"], np.float64)
    cd = np.asarray(ch0["codedelay"], np.float64)
    np.testing.assert_array_equal(
        cd, np.mod(ab / CFG.file.bytes_per_sample,
                   CFG.signal.samples_per_ms))
    assert np.all(np.asarray(ch0["prRate"], np.float64) == 0.0)
    assert np.all(np.asarray(ch0["amplitude"], np.float64) == 0.0)

    pn = str(tmp_path / "navSolVT_test_updated.mat")
    matref.save_navsol_vt_mat(pn, sol, trk=trk,
                              r_update_ms=VTParams().r_update_ms)
    g = matref.load_navsol_vt(pn)
    np.testing.assert_array_equal(g["usrPos"], sol.usr_pos)
    np.testing.assert_array_equal(g["usrVel"], sol.usr_vel)
    np.testing.assert_array_equal(g["clkBias"].reshape(-1),
                                  sol.clk_bias_m)
    np.testing.assert_array_equal(g["localTime"].reshape(-1),
                                  sol.local_time)
    np.testing.assert_array_equal(g["newZ"], sol.innovation)
    np.testing.assert_array_equal(g["predicted_z"], sol.predicted_z)
    np.testing.assert_array_equal(
        g["meas_inno"], sol.innovation - sol.predicted_z)
    np.testing.assert_array_equal(g["state_cov"], sol.state_cov_diag)
    # kalman_gain stored in the reference's (8, 2N, T) layout
    np.testing.assert_array_equal(
        np.transpose(g["kalman_gain"], (2, 0, 1)), sol.kalman_gain)
    np.testing.assert_array_equal(
        np.transpose(g["svxyz_pos"], (2, 0, 1)), sol.sv_pos)
    # error_state = K·z (…:398)
    np.testing.assert_allclose(
        g["state"],
        np.einsum("tij,tj->ti", sol.kalman_gain, sol.innovation),
        rtol=1e-6, atol=1e-12)
    # the U row is down-positive in the file (reference convention)
    np.testing.assert_array_equal(g["usrVelENU"][:, 2],
                                  -sol.usr_vel_enu[:, 2])
    # satePos/sateVel: the reference's last-channel loop leak; satePos
    # is the earth-rotation-corrected svxyzr (trackingVT_POS_updated.m:
    # 372,426) — rotated through |sv − usr| + clkBias (writer docstring)
    from gps_sdr_tpu.geo.earth import earth_rotation_correction
    sv_last = sol.sv_pos[:, -1, :]
    travel = (np.linalg.norm(sv_last - sol.usr_pos, axis=-1)
              + sol.clk_bias_m)
    np.testing.assert_allclose(
        g["satePos"],
        np.asarray(earth_rotation_correction(sv_last, travel)),
        rtol=0, atol=1e-9)
    # the rotation moves satePos O(40 m) off the raw sv_pos — assert the
    # correction is actually applied, not a no-op
    assert np.max(np.abs(g["satePos"] - sv_last)) > 1.0
    np.testing.assert_allclose(g["sateVel"], trk.sv_vel[:, -1, :],
                               rtol=1e-6)
    # exactly one R row per adaptive-R fire (every 200 ms)
    T = sol.usr_pos.shape[0]
    assert g["R"].shape == (T // 200, sol.innovation.shape[1])
    np.testing.assert_array_equal(g["R"], sol.r_diag[199::200])
