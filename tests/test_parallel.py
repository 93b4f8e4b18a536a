"""Multi-device sharding tests on the virtual 8-device CPU mesh.

Key property (SURVEY.md §5 "race detection" analog): device count must not
change results — sharded and single-device paths must agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gps_sdr_tpu.acquisition import acquisition_power_grid
from gps_sdr_tpu.config import FileConfig, ReceiverConfig, SignalConfig
from gps_sdr_tpu.ops.cacode import ca_code_table
from gps_sdr_tpu.parallel import (make_mesh, sharded_acquisition_power,
                                  sharded_track_scan,
                                  sharded_wls_normal_equations)
from gps_sdr_tpu.tracking import TrackParams, init_track_state, track_scan

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

CFG = ReceiverConfig(file=FileConfig(skip_ms=0),
                     signal=SignalConfig(f_if=2.5e5, fs=1.023e6))


def test_sharded_acquisition_matches_single_device():
    rng = np.random.default_rng(0)
    S = CFG.signal.samples_per_ms
    B, F, P = 3, 7, 16
    blocks = jnp.asarray((rng.normal(size=(B, S)) + 1j * rng.normal(
        size=(B, S))).astype(np.complex64))
    carriers = jnp.asarray(np.exp(
        2j * np.pi * rng.uniform(size=(F, S))).astype(np.complex64))
    code_fft = jnp.asarray(np.fft.fft(
        rng.choice([-1.0, 1.0], size=(P, S))).astype(np.complex64))
    ref = np.asarray(acquisition_power_grid(blocks, carriers, code_fft,
                                            prn_chunk=2))
    mesh = make_mesh(8)
    fn = sharded_acquisition_power(mesh, prn_chunk=2)
    out = np.asarray(fn(blocks, carriers, code_fft))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-2)


def test_run_acquisition_composes_with_sharded_grid():
    """run_acquisition(power_fn=…) with the PRN-sharded circular grid
    must find the same SVs/delays as the unsharded search."""
    from gps_sdr_tpu.acquisition import run_acquisition
    from gps_sdr_tpu.io.ifdata import IFSampleSource
    from gps_sdr_tpu.io.synthetic import SyntheticSV, generate_if_samples

    cfg = ReceiverConfig(file=FileConfig(name="synthetic", skip_ms=2),
                         signal=SignalConfig(f_if=1.023e6, fs=4.092e6))
    svs = [SyntheticSV(prn=3, amplitude=2.5, doppler_hz=1500.0,
                       code_delay_samples=1234.0),
           SyntheticSV(prn=16, amplitude=2.0, doppler_hz=-3000.0,
                       code_delay_samples=0.0)]
    iq = generate_if_samples(cfg, svs, duration_ms=40, noise_std=8.0, seed=1)
    vals = np.empty(2 * iq.size)
    vals[0::2] = iq.real
    vals[1::2] = iq.imag
    source = IFSampleSource.from_array(
        np.clip(np.round(vals), -127, 127).astype(np.int8), cfg.file)

    ref = run_acquisition(source, cfg)
    mesh = make_mesh(8)
    fn = sharded_acquisition_power(mesh)
    got = run_acquisition(source, cfg, power_fn=fn)
    assert set(got.sv) == set(ref.sv) == {3, 16}
    for p in (3, 16):
        ir, ig = ref.channel_index(p), got.channel_index(p)
        assert int(ref.code_delay[ir]) == int(got.code_delay[ig])
        assert ref.doppler_hz[ir] == got.doppler_hz[ig]
        assert abs(ref.snr_db[ir] - got.snr_db[ig]) < 0.1
        assert ref.fine_freq_hz[ir] == got.fine_freq_hz[ig]


def test_sharded_tracking_matches_single_device():
    rng = np.random.default_rng(1)
    S = CFG.signal.samples_per_ms
    n_ch, n_steps = 8, 6
    blk = -(-(S + 256) // 128) * 128
    params = TrackParams.epl(CFG)
    state = init_track_state(CFG, np.arange(n_ch, dtype=np.int64) * 10,
                             np.full(n_ch, CFG.signal.f_if + 500.0))
    chip_tables = jnp.asarray(np.stack(
        [ca_code_table()[p] for p in range(n_ch)]), jnp.float32)
    raw = jnp.asarray(rng.normal(
        size=((n_steps + 2) * S + blk, 2)).astype(np.float32))
    ref_state, ref_rec = track_scan(
        raw, jnp.int64(0), state, chip_tables, params, n_steps,
        float(CFG.signal.fs), blk, float(CFG.signal.code_freq_basis))
    mesh = make_mesh(8)
    fn = sharded_track_scan(mesh, params, n_steps, float(CFG.signal.fs),
                            blk, float(CFG.signal.code_freq_basis))
    sh_state, sh_rec = fn(raw, jnp.int64(0), state, chip_tables)
    np.testing.assert_allclose(np.asarray(sh_rec["corr"]),
                               np.asarray(ref_rec["corr"]), rtol=2e-5,
                               atol=1e-2)
    np.testing.assert_array_equal(np.asarray(sh_state.ptr),
                                  np.asarray(ref_state.ptr))
    np.testing.assert_allclose(np.asarray(sh_state.carr_freq),
                               np.asarray(ref_state.carr_freq), rtol=1e-9)


def test_sharded_wls_epoch_matches_direct():
    rng = np.random.default_rng(2)
    n_sv = 8
    usr = np.array([-2.4e6, 5.38e6, 2.41e6])
    sv_pos = rng.normal(size=(n_sv, 3)) * 5e6 + np.array([0, 0, 2.6e7])
    resid = rng.normal(size=n_sv) * 30.0
    diff = usr[None, :] - sv_pos
    h = np.concatenate([diff / np.linalg.norm(diff, axis=1, keepdims=True),
                        np.ones((n_sv, 1))], axis=1)
    expect = np.linalg.solve(h.T @ h, h.T @ resid)
    mesh = make_mesh(8)
    fn = sharded_wls_normal_equations(mesh)
    got = np.asarray(fn(jnp.asarray(sv_pos), jnp.asarray(resid),
                        jnp.asarray(usr)))
    np.testing.assert_allclose(got, expect, rtol=1e-8)


def test_dryrun_multichip():
    import __graft_entry__
    __graft_entry__.dryrun_multichip(8)


def test_entry_compiles():
    import __graft_entry__
    fn, args = __graft_entry__.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert out.shape[0] == args[2].shape[0]
