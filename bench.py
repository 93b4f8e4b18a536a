"""Benchmark: Opensky-shaped workload (58 MHz int8 IQ) on one device.

Primary metric: continuous tracking throughput — IF samples/s through
the 8-channel E/P/L correlator engine (the receiver's steady-state work)
with the engine `tracking.resolve_replica("auto")` picks.  Detail covers
the vector-tracking scan and its per-phase breakdown, a 32-channel run,
the 25-tap multicorrelator bank, the full acquisition search (32 PRN ×
41 Doppler × 20 ms non-coherent grid + the per-SV fine-Doppler long FFT,
i.e. the whole cold-start latency), 8-way time-segmented tracking, and
the end-to-end pipeline on a 41 s capture.

Every stage prints its own JSON line {"metric", "value", "unit",
"vs_baseline"} the moment it is measured; the LAST line printed — the
flagship tracking line with the full detail dict — is the canonical
one.  A stage that raises makes the run exit non-zero.  `vs_baseline`
is the real-time factor (value / 58e6): the reference MATLAB receiver
publishes no throughput numbers (BASELINE.md), so 1.0x real-time is the
reference point.

Every timed run ends in `jax.block_until_ready`.  `--profile DIR` wraps
the measured runs in a jax.profiler trace (SURVEY.md §5 tracing row).
"""

import argparse
import contextlib
import json
import os
import shutil
import sys
import time

import numpy as np


def bench_acquisition(reps: int = 3):
    """Full-grid search latency + the fine-Doppler host FFTs for the 8
    golden Opensky SVs (round-1 bench excluded the fine stage — on 8
    acquired SVs it is real seconds of host work)."""
    import jax
    import jax.numpy as jnp

    from gps_sdr_tpu.acquisition import (acquisition_power_grid,
                                         doppler_carriers,
                                         fine_doppler_batch, sampled_codes)
    from gps_sdr_tpu.config import ReceiverConfig

    cfg = ReceiverConfig()  # Opensky shape: S=58000, F=41, B=20
    S = cfg.signal.samples_per_ms
    B = cfg.acq.n_noncoherent_ms
    F = cfg.acq.n_freq_bins
    rng = np.random.default_rng(0)
    blocks = jnp.asarray((rng.integers(-64, 64, size=(B, S))
                          + 1j * rng.integers(-64, 64, size=(B, S))
                          ).astype(np.complex64))
    carriers = jnp.asarray(doppler_carriers(cfg))
    code_fft = jnp.asarray(np.fft.fft(
        sampled_codes(cfg, range(1, 33))).astype(np.complex64))

    def run():
        return acquisition_power_grid(blocks, carriers, code_fft)

    jax.block_until_ready(run())  # compile + warm-up
    t0 = time.perf_counter()
    for _ in range(reps):
        out = run()
    jax.block_until_ready(out)
    grid_dt = (time.perf_counter() - t0) / reps

    # fine Doppler: one 11 ms host segment, 8 SVs (the Opensky count)
    long_raw = (rng.integers(-64, 64, size=(cfg.acq.fine_fft_ms + 1) * S)
                + 1j * rng.integers(-64, 64,
                                    size=(cfg.acq.fine_fft_ms + 1) * S)
                ).astype(np.complex64)
    golden = ((3, 4, 16, 22, 26, 27, 31, 32),
              (3683, 12701, 26051, 2610, 57908, 49778, 39064, 20170))
    t0 = time.perf_counter()
    fine_doppler_batch(long_raw, golden[0], golden[1], cfg)
    fine_dt = time.perf_counter() - t0       # cold: includes compile
    t0 = time.perf_counter()
    fine_doppler_batch(long_raw, golden[0], golden[1], cfg)
    fine_warm = time.perf_counter() - t0     # steady-state (cached jit)
    return dict(acq_grid_wall_s=grid_dt,
                acq_fine_doppler_8sv_wall_s=fine_dt,
                acq_fine_doppler_8sv_warm_s=fine_warm,
                acq_total_wall_s=grid_dt + fine_dt,
                acq_total_warm_s=grid_dt + fine_warm,
                acq_grid_cells_per_s=32 * F * B * S / grid_dt)


def bench_tracking(n_ch: int = 8, n_steps: int = 1000, reps: int = 3,
                   replica: str = "auto", multicorr: bool = False):
    """One `n_steps` × 1 ms tracking chunk (track_scan) on device-resident
    random IQ at the Opensky shape.  Returns (samples/s, s per chunk)."""
    import jax
    import jax.numpy as jnp

    from gps_sdr_tpu.config import ReceiverConfig
    from gps_sdr_tpu.ops.cacode import ca_code_table
    from gps_sdr_tpu.tracking import (TrackParams, build_shift_tables,
                                      init_track_state, track_scan)

    cfg = ReceiverConfig()
    S = cfg.signal.samples_per_ms
    blk = -(-(S + 256) // 128) * 128
    mk = TrackParams.pos_multicorr if multicorr else TrackParams.epl
    params = mk(cfg, replica=replica)
    rng = np.random.default_rng(1)
    state = init_track_state(
        cfg, np.zeros(n_ch, np.int64),
        np.full(n_ch, cfg.signal.f_if + 1234.0))
    state = state._replace(ptr=jnp.zeros(n_ch, jnp.int64))
    prns = list(range(1, n_ch + 1))
    margin = 0
    if params.replica == "shift":
        tables, margin = build_shift_tables(cfg, prns, blk)
    else:
        tables = np.stack([ca_code_table()[p - 1] for p in prns])
    chip_tables = jnp.asarray(tables, jnp.float32)
    raw = jnp.asarray(rng.integers(-64, 64, size=((n_steps + 2) * S + blk, 2)
                                   ).astype(np.float32))

    def run():
        return track_scan(raw, jnp.int64(0), state, chip_tables, params,
                          n_steps, float(cfg.signal.fs), blk,
                          float(cfg.signal.code_freq_basis), margin)

    jax.block_until_ready(run())  # compile + warm-up
    t0 = time.perf_counter()
    for _ in range(reps):
        out = run()
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps
    return n_steps * S / dt, dt


def bench_vt(n_ch: int = 8, n_steps: int = 1000, reps: int = 3,
             ablate: str = ""):
    """The vector-tracking hot loop: correlators + Kepler + atmosphere +
    EKF as one scan (receiver/vt.py), on synthetic-but-plausible state
    (a real constellation geometry is irrelevant to throughput)."""
    import jax
    import jax.numpy as jnp

    from gps_sdr_tpu.config import ReceiverConfig
    from gps_sdr_tpu.geo.ephemeris import Ephemeris
    from gps_sdr_tpu.ops.cacode import ca_code_table
    from gps_sdr_tpu.receiver.vt import VTParams, VTState, vt_scan

    cfg = ReceiverConfig()
    S = cfg.signal.samples_per_ms
    blk = -(-(S + 256) // 128) * 128
    params = VTParams(remove_dc=cfg.file.data_precision == 2)
    rng = np.random.default_rng(3)
    base = dict(sqrta=5153.6413, ecc=0.0012, i0=0.9668, w=-0.8925,
                deltan=4.3e-09, omegadot=-7.2e-09, idot=-4.2e-10,
                cuc=1.5e-07, cus=2.4e-07, crc=287.5, crs=-2.6,
                cic=-7.5e-09, cis=1.3e-08, toe=388800.0, toc=388800.0,
                af0=1.8e-04, af1=2.0e-12, af2=0.0, tgd=-7.5e-09)
    eph = Ephemeris(**{
        k: jnp.asarray(np.full(n_ch, v, np.float64)) for k, v in base.items()
    } | {"m0": jnp.asarray(rng.uniform(0, 2 * np.pi, n_ch)),
         "omega0": jnp.asarray(rng.uniform(0, 2 * np.pi, n_ch))})
    usr = np.array([-2.4e6, 5.38e6, 2.41e6])
    n2 = 2 * n_ch
    state = VTState(
        ptr=jnp.zeros(n_ch, jnp.int64),
        rem_chip=jnp.zeros(n_ch, jnp.float64),
        code_freq=jnp.full(n_ch, cfg.signal.code_freq_basis, jnp.float64),
        carr_freq=jnp.full(n_ch, cfg.signal.f_if + 1234.0, jnp.float64),
        carr_freq_basis=jnp.full(n_ch, cfg.signal.f_if + 1234.0,
                                 jnp.float64),
        phase_fp=jnp.zeros(n_ch, jnp.int32),
        pll_nco=jnp.zeros(n_ch, jnp.float64),
        pll_last=jnp.zeros(n_ch, jnp.float64),
        transmit_time=jnp.asarray(388800.0
                                  + rng.uniform(0, 1e-3, n_ch) - 0.075),
        predicted_pr_last=jnp.zeros(n_ch, jnp.float64),
        iono_m=jnp.zeros(n_ch, jnp.float64),
        tropo_m=jnp.zeros(n_ch, jnp.float64),
        el_rad=jnp.full(n_ch, np.pi / 4), az_rad=jnp.zeros(n_ch),
        total_state=jnp.asarray(np.concatenate([usr, np.zeros(3),
                                                [0.0, 0.0]])),
        state_cov=jnp.asarray(1e5 * np.diag([0.1] * 6 + [1.0, 1.0])),
        r_diag=jnp.asarray(np.concatenate([np.full(n_ch, 0.3),
                                           np.full(n_ch, 0.1)])),
        innov_sq_sum=jnp.zeros(n2, jnp.float64),
        step_count=jnp.asarray(0, jnp.int32),
        zk=jnp.zeros((n_ch, params.cn0_window), jnp.float64),
        snr_hist=jnp.full((n_ch, 5), 99.0, jnp.float64),
        cn0=jnp.full(n_ch, 99.0, jnp.float64),
        valid=jnp.ones(n_ch, bool))
    chip_tables = jnp.asarray(np.stack(
        [ca_code_table()[p] for p in range(n_ch)]), jnp.float32)
    raw = jnp.asarray(rng.integers(
        -64, 64, size=((n_steps + 2) * S + blk, 2)).astype(np.float32))
    alpha = jnp.asarray(cfg.cmn.iono_alpha, jnp.float64)
    beta = jnp.asarray(cfg.cmn.iono_beta, jnp.float64)

    def run():
        _, rec = vt_scan(raw, jnp.int64(0), state, chip_tables, eph,
                         alpha, beta, params, n_steps,
                         float(cfg.signal.fs), blk, float(cfg.signal.f_if),
                         float(cfg.signal.fc),
                         float(cfg.signal.code_freq_basis),
                         int(cfg.cmn.day_of_year), ablate=ablate)
        return rec

    jax.block_until_ready(run())
    t0 = time.perf_counter()
    for _ in range(reps):
        out = run()
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps
    return n_steps * S / dt, dt


def bench_segmented(n_ch: int = 2, n_segments: int = 8, n_ms: int = 8000,
                    halo_ms: int = 400, fs: float = 5e6):
    """Overlap-save time parallelism (parallel/time_segments.py): the
    scan shrinks by D while the batch grows by D.  Measured compute-only
    (device-resident raw, direct track_scan) at a small front-end shape
    — the regime where the serial scan's per-step work underfills the
    device (e.g. many-capture reprocessing at low fs).  Returns
    (serial_sps, segmented_sps) for the same n_ch×n_ms workload."""
    import jax
    import jax.numpy as jnp

    from gps_sdr_tpu.config import FileConfig, ReceiverConfig, SignalConfig
    from gps_sdr_tpu.parallel.time_segments import segmented_initial_state
    from gps_sdr_tpu.tracking import (TrackParams, build_shift_tables,
                                      init_track_state, track_scan)

    cfg = ReceiverConfig(file=FileConfig(skip_ms=0),
                         signal=SignalConfig(f_if=1.25e6, fs=fs))
    S = cfg.signal.samples_per_ms
    blk = -(-(S + 256) // 128) * 128
    params = TrackParams.epl(cfg, replica="shift")
    rng = np.random.default_rng(2)
    prns = list(range(1, n_ch + 1))
    delays = np.zeros(n_ch, np.int64)
    fines = np.full(n_ch, cfg.signal.f_if + 1234.0)
    seg_ms = -(-n_ms // n_segments)
    dur_samples = (n_ms + halo_ms + seg_ms + 4) * S + blk + 64
    raw = jnp.asarray(rng.integers(-64, 64, size=(dur_samples, 2)
                                   ).astype(np.float32))
    tables, margin = build_shift_tables(cfg, prns, blk)

    def timed(state, chip_tables, n_steps):
        def run():
            _, rec = track_scan(raw, jnp.int64(0), state, chip_tables,
                                params, n_steps, float(cfg.signal.fs), blk,
                                float(cfg.signal.code_freq_basis), margin)
            return rec
        jax.block_until_ready(run())
        t0 = time.perf_counter()
        for _ in range(3):
            out = run()
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / 3

    st = init_track_state(cfg, delays, fines)
    st = st._replace(ptr=jnp.zeros(n_ch, jnp.int64))
    t_serial = timed(st, jnp.asarray(tables), n_ms)

    st_seg = segmented_initial_state(cfg, delays, fines, n_segments,
                                     seg_ms, halo_ms)
    tables_seg = np.concatenate([tables] * n_segments)
    t_seg = timed(st_seg, jnp.asarray(tables_seg), seg_ms + halo_ms)
    work = n_ms * S
    return work / t_serial, work / t_seg


E2E_CAPTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           ".cache", "e2e58_scn_v3.bin")
E2E_MS = 41000
# the shared scenario constellation's surveyed antenna (tests/scenario.py)
E2E_TRUTH_LLH = (0.3897057693107332, 1.9926489077944098, 4.0)
# Realism of the constellation (both found by running the pipeline on
# earlier capture versions):
# - the 5 MHz scenario amplitudes (2.4-3.0 vs noise 8) would give ~66
#   dB-Hz at 58 MHz — strong enough that Gold cross-correlation
#   sidelobes cross the 12 dB acquisition threshold as false alarms;
#   C/N0 = 10log10(A²/(2σ²)·fs) puts 0.09·(2.0..3.2) at ~41.5-46 dB-Hz,
#   the operating band of the reference's real captures;
# - equal powers maximize the C/A cross-correlation DLL-lock
#   displacement (measured ±0.27 chip per SV on a 5-equal-power
#   capture; the single-SV lock bias at this exact shape is 0.0015
#   chips — tests/test_absolute_code_phase.py class), so the e2e
#   constellation uses 8 SVs with spread powers and azimuths, which is
#   also what a real sky looks like.
E2E_AMP_SCALE = 0.09
E2E_PRNS = (3, 7, 16, 22, 27, 1, 8, 30)
E2E_AMPS = (3.0, 2.6, 2.8, 2.4, 2.7, 2.2, 3.2, 2.0)


E2E_CAPTURE_BYTES = E2E_MS * 58000 * 2


def make_e2e_capture(path: str = None) -> str:
    """Generate the 41 s, 58 MHz, 8-SV end-to-end capture (~4.8 GB) with
    the jitted synthesis writer, on the default device, unless a complete
    copy is already there."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    from gps_sdr_tpu.geo.coords import llh2xyz
    from gps_sdr_tpu.io.synthetic import GeometrySignal, GeometrySV
    from gps_sdr_tpu.utils.atomic import file_lock
    from tests import scenario

    path = path or E2E_CAPTURE
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with file_lock(path):
        if (os.path.exists(path)
                and os.path.getsize(path) == E2E_CAPTURE_BYTES):
            return path
        free = shutil.disk_usage(os.path.dirname(path)).free
        if free < E2E_CAPTURE_BYTES + (1 << 30):
            raise RuntimeError(
                f"the e2e capture needs {E2E_CAPTURE_BYTES / 1e9:.1f} GB "
                f"(+1 GB margin) in {os.path.dirname(path)}; "
                f"{free / 1e9:.1f} GB free")
        cfg = e2e_cfg(path)
        ephs = scenario.visible_constellation(len(E2E_PRNS))
        svs = [GeometrySV(prn=p, eph=e, amplitude=E2E_AMP_SCALE * a)
               for p, e, a in zip(E2E_PRNS, ephs, E2E_AMPS)]
        usr = np.asarray(llh2xyz(np.asarray(scenario.TRUTH_LLH)))
        gs = GeometrySignal(cfg, svs, usr, scenario.TOW0,
                            clk_bias_s=scenario.CLK_BIAS_S,
                            clk_drift_sps=scenario.CLK_DRIFT_SPS,
                            atmosphere=True, iono_alpha=cfg.cmn.iono_alpha,
                            iono_beta=cfg.cmn.iono_beta,
                            doy=cfg.cmn.day_of_year)
        gs.write_file_fast(path, E2E_MS, noise_std=scenario.NOISE_STD,
                           seed=11)
    return path


def e2e_cfg(path: str):
    from gps_sdr_tpu.config import (CommonConfig, FileConfig,
                                    ReceiverConfig, SignalConfig,
                                    SolutionConfig)

    return ReceiverConfig(
        file=FileConfig(path=path, name="e2e58", skip_ms=0),
        signal=SignalConfig(f_if=4.58e6, fs=58e6),
        solu=SolutionConfig(truth_llh=E2E_TRUTH_LLH),
        cmn=CommonConfig(multicorr_ct=False, multicorr_vt=False))


def run_e2e_stages(rx, ct_ms: int = 3000, vt_ms: int = 1000,
                   eph_ms: int = E2E_MS - 1200, decode_offset_ms: int = 1000):
    """The staged driver on the e2e capture, in user order: acquisition →
    eph tracking → decode → usable SVs → WLS → VT/EKF.  Returns
    (per-stage wall seconds, acquisition, usable SVs, WLS nav, VT sol);
    each stage's time ends when its results are on the host."""
    stages = {}
    t0 = time.perf_counter()
    acq = rx.acquisition()
    stages["acquisition_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rx.track_for_eph(n_ms=eph_ms)
    stages["eph_tracking_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rx.decode(start_offset_ms=decode_offset_ms)
    svs = rx.usable_svs()
    stages["decode_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, nav = rx.ct_position(n_ms=ct_ms)
    stages["ct_wls_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, sol = rx.vt_position(n_ms=vt_ms, ct_n_ms=ct_ms)
    stages["vt_ekf_s"] = time.perf_counter() - t0
    return stages, acq, svs, nav, sol


def bench_pipeline_e2e(ct_ms: int = 3000, vt_ms: int = 1000):
    """The end-to-end number — a 41 s 58 MHz Opensky-shaped capture
    through the full driver (acquisition → eph tracking → decode → WLS →
    VT/EKF) on one device, per-stage split, cold and warm.  Cold = fresh
    artifact directory, first compiles (the persistent compilation
    cache may hold them from an earlier run); warm = a second fresh
    artifact directory in the same process — the steady-state recompute
    cost.  Fix quality is asserted so the number certifies a WORKING
    pipeline, not just completed dispatches."""
    import tempfile

    from gps_sdr_tpu.geo.coords import llh2xyz
    from gps_sdr_tpu.io.ifdata import IFSampleSource
    from gps_sdr_tpu.pipeline import Receiver

    cfg = e2e_cfg(E2E_CAPTURE)
    truth = np.asarray(llh2xyz(np.asarray(cfg.solu.truth_llh)))

    def one_pass():
        with tempfile.TemporaryDirectory() as td:
            src = IFSampleSource(E2E_CAPTURE, cfg.file)
            rx = Receiver(cfg, src, artifact_dir=td, mesh=None)
            stages, _, svs, nav, sol = run_e2e_stages(rx, ct_ms, vt_ms)
        total = sum(stages.values())
        err = np.linalg.norm(nav.usr_pos - truth, axis=1)
        verr = np.linalg.norm(sol.usr_pos - truth, axis=1)
        assert len(svs) >= 4, f"e2e decode found only {svs}"
        # the error floor of this synthetic sky is C/A cross-correlation
        # DLL-lock displacement (single-SV code bias at this shape is
        # 0.0015 chip ≈ 0.5 m), bounded here as a working-receiver gate
        assert np.median(err) < 120.0, np.median(err)
        assert np.all(np.isfinite(sol.usr_pos))
        return dict(total_wall_s=total, capture_s=E2E_MS / 1000,
                    x_realtime=E2E_MS / 1000 / total,
                    stages=stages, n_usable_svs=len(svs),
                    wls_median_err_m=float(np.median(err)),
                    vt_median_err_m=float(np.median(verr)))

    return {"cold": one_pass(), "warm": one_pass()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", default=None,
                    help="write a jax.profiler trace to this directory")
    ap.add_argument("--full", action="store_true",
                    help="also run the secondary suite (the shift "
                         "replica and segmented tracking); the default "
                         "suite measures the flagship tracking, VT, "
                         "25-tap multicorrelator, 32-channel tracking, "
                         "the full acquisition search and the e2e "
                         "pipeline")
    ap.add_argument("--make-e2e-capture", action="store_true",
                    help=f"generate the 41 s 58 MHz e2e capture "
                         f"({os.path.relpath(E2E_CAPTURE)}) and exit")
    ap.add_argument("--budget-s", type=float, default=1500.0,
                    help="soft wall budget: each stage after the "
                         "flagship is skipped once the elapsed wall time "
                         "exceeds this (every completed stage has "
                         "already printed its own JSON line)")
    args = ap.parse_args()
    if args.make_e2e_capture:
        print(make_e2e_capture())
        return
    t_start = time.perf_counter()
    from gps_sdr_tpu.utils.jit_cache import enable_compilation_cache
    enable_compilation_cache()

    import jax

    from gps_sdr_tpu.tracking import resolve_replica

    if args.profile:
        prof = jax.profiler.trace(args.profile)
    else:
        prof = contextlib.nullcontext()

    flagship_replica = resolve_replica("auto")
    dev = jax.devices()[0]
    detail = {"tracking_replica": flagship_replica,
              "device": {"platform": dev.platform,
                         "kind": dev.device_kind,
                         "count": len(jax.devices())}}
    errors = {}

    def flagship_line(extra_detail):
        return json.dumps({
            "metric": "tracking IF samples/s (8-channel E/P/L engine, "
                      "58 MHz Opensky shape, one device)",
            "value": trk_sps,
            "unit": "samples/s",
            "vs_baseline": trk_sps / 58e6,
            "detail": extra_detail,
        })

    def stage_line(metric, value, unit, vs_baseline):
        print(json.dumps({"metric": metric, "value": value, "unit": unit,
                          "vs_baseline": vs_baseline}), flush=True)

    def left():
        return args.budget_s - (time.perf_counter() - t_start)

    # each stage measures, UPDATES the detail dict, and prints its own
    # JSON line immediately; the LAST line printed (the flagship line
    # with the full detail dict) is the canonical one
    def stage_vt():
        vt_sps, _ = bench_vt()
        detail.update(vt_ekf_sps=vt_sps,
                      vt_ekf_realtime_factor=vt_sps / 58e6)
        stage_line("vector tracking IF samples/s (8-channel VDFLL: "
                   "correlators + Kepler + atmosphere + 8-state EKF)",
                   vt_sps, "samples/s", vt_sps / 58e6)

    def stage_vt_phases():
        """WHERE the VT step spends its time — DCE-ablated variants of
        the same scan (vt_scan's `ablate` diagnostic), so each phase's
        cost is a wall-clock difference of real runs, not a model."""
        _, t_full = bench_vt()
        _, t_noekf = bench_vt(ablate="no_ekf")
        _, t_nogeom = bench_vt(ablate="no_geom")
        _, t_corr = bench_vt(ablate="corr_only")
        detail["vt_phase_breakdown_ms_per_1000ms"] = dict(
            total=t_full * 1e3,
            ekf_gain_chain=(t_full - t_noekf) * 1e3,
            predicted_pr_chain=(t_noekf - t_nogeom) * 1e3,
            cn0_gate_and_measurements=(t_nogeom - t_corr) * 1e3,
            correlator_and_pll=t_corr * 1e3)
        stage_line("VT per-phase wall (1000 ms, 8 ch): correlator+PLL "
                   "core of the full step", t_corr * 1e3, "ms",
                   t_corr / t_full)

    def stage_multicorr():
        sps, _ = bench_tracking(n_steps=300, multicorr=True)
        detail["tracking_multicorr25_sps"] = sps
        stage_line("tracking IF samples/s (25-tap multicorrelator "
                   "bank, 8 channels)", sps, "samples/s", sps / 58e6)

    def stage_32ch():
        sps, _ = bench_tracking(n_ch=32)
        detail["tracking_32ch_sps_per_ch_stream"] = sps
        detail["tracking_32ch_channel_samples_per_s"] = 32 * sps
        stage_line("tracking channel-samples/s (32 channels x "
                   "per-channel stream rate)", 32 * sps,
                   "channel-samples/s", sps / 58e6)

    def stage_acquisition():
        d = bench_acquisition()
        detail.update(d)
        stage_line("acquisition latency, warm programs (32 PRN x 41 "
                   "Doppler x 20 ms grid + 8-SV fine Doppler)",
                   d["acq_total_warm_s"], "s",
                   0.02 / max(d["acq_grid_wall_s"], 1e-9))

    def stage_shift():
        detail["tracking_shift_replica_sps"] = bench_tracking(
            replica="shift")[0]

    def stage_vt32():
        sps, _ = bench_vt(n_ch=32, n_steps=500)
        detail["vt_32ch_sps_per_ch_stream"] = sps
        detail["vt_32ch_channel_samples_per_s"] = 32 * sps
        stage_line("vector tracking channel-samples/s (32-channel "
                   "VDFLL: 64-row measurement vector, 8x64 gain)",
                   32 * sps, "channel-samples/s", sps / 58e6)

    def stage_segmented():
        s, g = bench_segmented()
        detail.update(segmented_small_shape_serial_sps=s,
                      segmented_small_shape_8seg_sps=g,
                      segmented_small_shape_speedup=g / s)

    def stage_e2e():
        make_e2e_capture()
        d = bench_pipeline_e2e()
        detail["pipeline_e2e"] = d
        stage_line("end-to-end pipeline wall, warm (41 s 58 MHz capture: "
                   "acquisition -> eph tracking -> decode -> WLS -> "
                   "1000 ms VT/EKF, one device)",
                   d["warm"]["total_wall_s"], "s",
                   d["warm"]["x_realtime"])

    with prof:
        trk_sps, trk_dt = bench_tracking()
        detail.update(tracking_wall_s_1000ms_8ch=trk_dt,
                      tracking_realtime_factor=trk_sps / 58e6)
        print(flagship_line(dict(detail)), flush=True)

        stages = [("vt", stage_vt), ("vt_phases", stage_vt_phases),
                  ("acquisition", stage_acquisition),
                  ("multicorr", stage_multicorr), ("32ch", stage_32ch),
                  ("vt32", stage_vt32), ("e2e", stage_e2e)]
        if args.full:
            stages += [("shift", stage_shift),
                       ("segmented", stage_segmented)]
        for name, fn in stages:
            if left() <= 0:
                detail[f"skipped_{name}"] = "budget exhausted"
                continue
            try:
                fn()
            except Exception as e:
                errors[name] = f"{type(e).__name__}: {e}"
                detail[f"error_{name}"] = errors[name][:200]

    print(flagship_line(detail), flush=True)
    if errors:
        sys.exit(f"bench stages failed: {sorted(errors)}")


if __name__ == "__main__":
    main()
