"""Multi-device execution through the production driver (SURVEY.md §2.9,
round-2 VERDICT missing #3): `Receiver` on the virtual 8-device CPU mesh
must produce artifacts equivalent to the single-device run — tracking
records bit-identical (per-channel arithmetic is unchanged by channel
sharding), acquisition results identical, WLS solutions equal to float
round-off (psum normal equations vs host lstsq)."""

import shutil

import jax
import numpy as np
import pytest

from gps_sdr_tpu.pipeline import _REC_FIELDS, Receiver
from gps_sdr_tpu.parallel.mesh import make_mesh

from tests import scenario

pytestmark = pytest.mark.skipif(len(jax.devices()) < 2,
                                reason="needs a multi-device mesh")


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """Single-device receiver over the shared artifact cache."""
    src = scenario.build_scenario_source()
    rx = Receiver(scenario.CFG, src, artifact_dir=scenario.CACHE_DIR,
                  mesh=None)
    rx.track_for_eph(n_ms=scenario.DURATION_MS - 200)
    rx.decode(start_offset_ms=200)
    return rx


@pytest.fixture(scope="module")
def meshed(single, tmp_path_factory):
    """Mesh receiver in a fresh artifact dir; the expensive decode-stage
    artifacts are copied over so only acquisition + CT tracking +
    positioning re-run (sharded)."""
    mdir = tmp_path_factory.mktemp("mesh_artifacts")
    for stem in (f"tckeph_{single.key}.npz", f"eph_{single.key}.pkl",
                 f"countinx_{single.key}.npz",
                 f"nacquired_{single.key}_0.npz"):
        p = single._path(stem)
        if p is not None and shutil.os.path.exists(p):
            shutil.copy(p, mdir / stem)
    rx = Receiver(scenario.CFG, single.source, artifact_dir=str(mdir),
                  mesh=make_mesh())
    assert rx.mesh is not None and rx.mesh.size >= 2
    return rx


def test_auto_mesh_resolution(single):
    rx = Receiver(scenario.CFG, single.source)   # mesh="auto"
    assert rx.mesh is not None
    assert rx.mesh.size == len(jax.devices())


def test_sharded_acquisition_identical(single, meshed):
    a0 = single.acquisition()
    am = meshed.acquisition()
    np.testing.assert_array_equal(a0.sv, am.sv)
    np.testing.assert_array_equal(a0.code_delay, am.code_delay)
    np.testing.assert_allclose(a0.snr_db, am.snr_db, atol=1e-4)
    np.testing.assert_allclose(a0.fine_freq_hz, am.fine_freq_hz, atol=1e-6)


def test_sharded_ct_records_bit_identical(single, meshed):
    rec0, nav0 = single.ct_position(n_ms=1600)
    recm, navm = meshed.ct_position(n_ms=1600)
    for f in _REC_FIELDS:
        np.testing.assert_array_equal(
            getattr(rec0, f), getattr(recm, f), err_msg=f)
    # WLS epochs: psum normal-equation solver vs host lstsq
    assert len(nav0.local_time) == len(navm.local_time) > 10
    np.testing.assert_allclose(navm.usr_pos, nav0.usr_pos, atol=1e-5)
    np.testing.assert_allclose(navm.clk_bias_m, nav0.clk_bias_m, atol=1e-5)
    np.testing.assert_allclose(navm.usr_vel, nav0.usr_vel, atol=1e-6)
    np.testing.assert_allclose(navm.dop, nav0.dop, atol=1e-9)
    np.testing.assert_array_equal(navm.valid, nav0.valid)


def test_sharded_epoch_masks_channels(single, meshed):
    """The sharded epoch honors validity weights: zero-weight rows are
    exact no-ops (same fix as dropping the rows host-side)."""
    from gps_sdr_tpu.parallel.epoch import make_epoch_solver
    from gps_sdr_tpu.positioning.wls import (doppler_velocity_ls,
                                             iterated_ls_position)
    from gps_sdr_tpu.config import L1_WAVELENGTH

    rng = np.random.default_rng(5)
    n = 6
    usr = np.array([-2.418e6, 5.386e6, 2.404e6])
    sv = usr + rng.normal(size=(n, 3)) * 5e6 + np.array([0, 0, 2.0e7])
    rngs = np.linalg.norm(sv - usr, axis=1)
    pr = rngs + 1234.5 + rng.normal(size=n)
    sv_vel = rng.normal(size=(n, 3)) * 3e3
    clk_rate = rng.normal(size=n) * 1e-2
    doppler = rng.normal(size=n) * 1e3
    valid = np.array([1, 1, 0, 1, 1, 1], bool)
    init = np.concatenate([usr + 1000.0, [0.0]])

    solver = make_epoch_solver(make_mesh(), L1_WAVELENGTH)
    est_s, dop_s, vel_s, drift_s = solver(pr, sv, sv_vel, doppler,
                                          clk_rate, valid, init)
    est_h, dop_h = iterated_ls_position(pr[valid], sv[valid], init)
    vel_h, drift_h, _ = doppler_velocity_ls(
        np.asarray(est_h)[:3], sv[valid], sv_vel[valid], doppler[valid],
        L1_WAVELENGTH, clk_rate[valid])
    np.testing.assert_allclose(est_s, np.asarray(est_h), atol=1e-6)
    np.testing.assert_allclose(dop_s, np.asarray(dop_h), atol=1e-9)
    np.testing.assert_allclose(vel_s, np.asarray(vel_h), atol=1e-8)
    np.testing.assert_allclose(drift_s, float(drift_h), atol=1e-8)


@pytest.fixture(scope="module")
def vt_state(single):
    """A CT-warm-started VT state + ephemeris struct built once from the
    shared scenario artifacts (the same handoff construction as
    pipeline.vt_position)."""
    from gps_sdr_tpu.geo.coords import llh2xyz
    from gps_sdr_tpu.geo.ephemeris import Ephemeris
    from gps_sdr_tpu.receiver.vt import VTParams, init_vt_state

    cfg = scenario.CFG
    eph, sbf = single.decode()
    pos_svs = single.usable_svs()
    truth = np.asarray(llh2xyz(np.asarray(scenario.TRUTH_LLH)))
    init = truth + np.array([3000.0, -2000.0, 1500.0])
    ct_rec, ct_nav = single.ct_position(n_ms=4000, init_pos_ecef=init)
    epoch0 = cfg.file.skiptime_vt_ms // cfg.solu.nav_sol_period_ms - 1
    params = VTParams()
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
    return state, eph_struct, params, pos_svs, init, truth


def test_sharded_vt_bit_identical(single, vt_state):
    """Vector tracking with the channel axis sharded over the 8-device
    mesh (5 channels → 3 padding duplicates; chunked into several scan
    programs) matches the single-device scan (parallel/vt.py; the
    round-3 VERDICT's 'last §2.9 axis'):

    - the ENTIRE measurement→EKF→navigation chain is BIT-identical —
      correlator outputs, the sample-pointer/block-length integers,
      innovations, gains, covariances, positions, clock states — because
      the per-ms coupling is an all-gather of measurement rows and every
      device applies the identical replicated update, and the f32 casts
      at the measurement boundary (z_pr uses codeFreq as f32) absorb any
      f64 ulp wobble below;
    - the per-channel f64 GEOMETRY series (codeFreq/deltaPr/remChip from
      the predicted-pseudorange chain) are allowed ≤ ~2 ulp relative
      difference: reducing a (1,3) shard vs a (5,3) batch changes the
      SIMD summation order of the f64 norms (same class of wobble as the
      C/N0 mean/var below)."""
    import dataclasses as _dc

    from gps_sdr_tpu.receiver.vt import run_vector_tracking

    state, eph_struct, params, pos_svs, init, _ = vt_state
    kw = dict(n_ms=450, chunk_ms=133)
    trk0, sol0, st0 = run_vector_tracking(
        single.source, scenario.CFG, pos_svs, eph_struct, state, params,
        init_pos_ecef=init, **kw)
    trkm, solm, stm = run_vector_tracking(
        single.source, scenario.CFG, pos_svs, eph_struct, state, params,
        init_pos_ecef=init, mesh=make_mesh(), **kw)
    exact = ("corr", "carr_err", "code_err", "num_sample",
             "absolute_sample", "rem_phase")
    for f in _dc.fields(type(trk0)):
        a, b = getattr(trk0, f.name), getattr(trkm, f.name)
        if a is None:
            continue
        if f.name in exact:
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            # atol covers delta_pr: the /dt=1e3 differencing of the
            # ~2e7 m predicted pseudorange amplifies its f64 ulp wobble
            # to ~1e-5 m/s — still 9 orders below physical significance
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-4,
                                       err_msg=f.name)
    np.testing.assert_array_equal(sol0.usr_pos, solm.usr_pos)
    np.testing.assert_array_equal(sol0.usr_vel, solm.usr_vel)
    np.testing.assert_array_equal(sol0.clk_bias_m, solm.clk_bias_m)
    np.testing.assert_array_equal(sol0.kalman_gain, solm.kalman_gain)
    np.testing.assert_array_equal(sol0.innovation, solm.innovation)
    np.testing.assert_array_equal(sol0.r_diag, solm.r_diag)
    np.testing.assert_array_equal(sol0.valid, solm.valid)
    np.testing.assert_allclose(sol0.local_time, solm.local_time,
                               rtol=0, atol=1e-12)
    # cn0: the moment estimator's mean/var reductions vectorize
    # differently over a 1-channel shard than the 5-channel batch
    np.testing.assert_allclose(sol0.cn0_dbhz, solm.cn0_dbhz,
                               rtol=0, atol=1e-9)
    # final carry: nav/EKF state identical → any continuation identical
    np.testing.assert_array_equal(np.asarray(st0.total_state),
                                  np.asarray(stm.total_state))
    np.testing.assert_array_equal(np.asarray(st0.ptr),
                                  np.asarray(stm.ptr))
    np.testing.assert_array_equal(np.asarray(st0.state_cov),
                                  np.asarray(stm.state_cov))


def test_sharded_vt_through_receiver(meshed):
    """The production pipeline path: Receiver(mesh=...).vt_position runs
    the sharded VT stage end-to-end (warm start from the sharded CT
    stage) and holds a physical fix."""
    from gps_sdr_tpu.geo.coords import llh2xyz

    truth = np.asarray(llh2xyz(np.asarray(scenario.TRUTH_LLH)))
    init = truth + np.array([3000.0, -2000.0, 1500.0])
    trk, sol = meshed.vt_position(n_ms=800, ct_n_ms=4000,
                                  init_pos_ecef=init)
    assert sol.usr_pos.shape == (800, 3)
    assert np.all(np.isfinite(sol.innovation))
    err = np.linalg.norm(sol.usr_pos[300:] - truth, axis=1)
    assert np.median(err) < 45.0, np.median(err)


def test_sharded_vt_multicorr_bank(single, vt_state):
    """The 29-tap multicorrelator VT bank
    (trackingVT_POS_updated_multicorrelator.m) through the sharded
    path: full tap records and the nav chain match the single-device
    run (the EKF still closes on the ±0.5/P taps)."""
    from gps_sdr_tpu.receiver.vt import VTParams, run_vector_tracking

    state, eph_struct, _, pos_svs, init, _ = vt_state
    params = VTParams.multicorr()
    kw = dict(n_ms=120, chunk_ms=60)
    trk0, sol0, _ = run_vector_tracking(
        single.source, scenario.CFG, pos_svs, eph_struct, state, params,
        init_pos_ecef=init, **kw)
    trkm, solm, _ = run_vector_tracking(
        single.source, scenario.CFG, pos_svs, eph_struct, state, params,
        init_pos_ecef=init, mesh=make_mesh(), **kw)
    assert trk0.corr.shape == (120, len(pos_svs), 29, 2)
    np.testing.assert_array_equal(trk0.corr, trkm.corr)
    np.testing.assert_array_equal(sol0.usr_pos, solm.usr_pos)
    np.testing.assert_array_equal(sol0.innovation, solm.innovation)
