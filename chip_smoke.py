"""Smoke run of the receiver on an NVIDIA GPU: the quickest proof that the
system still starts on the card.

    python chip_smoke.py               # one card, phases 0-3
    python chip_smoke.py --four-cards  # phase 1, then phase 2 on a 4-card
                                       # mesh and on one card, compared

Phase 0  finds a GPU (there is no CPU fallback) and prints the card, its
         power limit, the JAX version and the compile-cache directory.
Phase 1  synthesizes the 41 s Opensky-shaped capture (58 MHz int8 IQ,
         IF 4.58 MHz, 8 SVs, seed 11) on the card into .cache/.
Phase 2  runs the staged receiver through `pipeline.Receiver`, as a user
         would, and gates the fix.  Stage times are cold (compiles
         included) and informational.
Phase 3  runs each device program of that path on the GPU and on JAX's
         CPU backend at full width, on inputs cut from the capture, and
         compares them: every error is printed beside its tolerance.

Any failed phase, gate or comparison exits non-zero.  The last line of
standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, NamedTuple

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# PRNs the capture does not carry: their grid peaks are noise, which the
# acquisition comparison must reproduce as well
ABSENT_PRNS = (2, 5, 11, 19)
CT_MS, VT_MS = 3000, 1000


class Check(NamedTuple):
    """One gate or comparison: passes when err <= tol (a NaN fails)."""

    name: str
    err: float
    tol: float
    reason: str

    @property
    def ok(self) -> bool:
        return bool(self.err <= self.tol)

    def line(self) -> str:
        return (f"  [{'ok' if self.ok else 'FAIL'}] {self.name}: "
                f"{self.err!r} (tolerance {self.tol!r}: {self.reason})")


def card_line() -> str:
    """`name, power.limit` of the cards, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return " | ".join(out.stdout.strip().splitlines()) or out.stderr.strip()


def phase0():
    """The GPU, or exit non-zero."""
    import jax

    from gps_sdr_tpu.utils.jit_cache import enable_compilation_cache

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit("chip_smoke: JAX finds no GPU (devices: "
                         f"{[d.platform for d in devs]}); not running")
    card = card_line()
    print(f"phase 0 card: {card}")
    print(f"phase 0 jax {jax.__version__}: {len(devs)} x "
          f"{devs[0].device_kind}")
    print(f"phase 0 compile cache: {enable_compilation_cache()}")
    return card


def phase1(card: str) -> str:
    import bench

    t0 = time.perf_counter()
    path = bench.make_e2e_capture()
    print(f"phase 1 capture {path}: {os.path.getsize(path)} bytes in "
          f"{time.perf_counter() - t0:.3f} s [{card}]")
    return path


def run_receiver(mesh, card: str, label: str, art_dir: str):
    """Phase 2: the e2e stages through a fresh `Receiver`; returns
    (receiver, acquisition, usable SVs, WLS nav, VT sol)."""
    import bench
    from gps_sdr_tpu.io.ifdata import IFSampleSource
    from gps_sdr_tpu.pipeline import Receiver

    cfg = bench.e2e_cfg(bench.E2E_CAPTURE)
    rx = Receiver(cfg, IFSampleSource(bench.E2E_CAPTURE, cfg.file),
                  artifact_dir=art_dir, mesh=mesh)
    stages, acq, svs, nav, sol = bench.run_e2e_stages(rx, CT_MS, VT_MS)
    for k, v in stages.items():
        print(f"{label} {k} {v:.3f} (cold) [{card}]")
    print(f"{label} acquired PRNs {[int(p) for p in acq.sv]}, SNR dB "
          f"{np.round(acq.snr_db, 2).tolist()}; usable SVs {svs}")
    return rx, acq, svs, nav, sol


def fix_gates(acq, svs, nav, sol) -> List[Check]:
    import bench
    from gps_sdr_tpu.geo.coords import llh2xyz

    truth = np.asarray(llh2xyz(np.asarray(bench.E2E_TRUTH_LLH)))
    err = np.linalg.norm(nav.usr_pos - truth, axis=1)
    verr = np.linalg.norm(sol.usr_pos - truth, axis=1)
    print(f"  WLS median error {np.median(err)!r} m over {len(err)} epochs;"
          f" VT median error {np.median(verr)!r} m over {len(verr)} ms")
    missing = set(bench.E2E_PRNS) - {int(p) for p in acq.sv}
    return [
        Check("synthesized PRNs not acquired", len(missing), 0,
              "all 8 SVs of the capture"),
        Check("usable SVs short of 4", max(0, 4 - len(svs)), 0,
              "a fix needs 4; 8 expected"),
        Check("non-finite WLS fixes", int(np.sum(~np.isfinite(
            nav.usr_pos).all(axis=1))), 0, "every epoch"),
        Check("non-finite VT fixes", int(np.sum(~np.isfinite(
            sol.usr_pos).all(axis=1))), 0, "every ms"),
        Check("WLS median error [m]", float(np.median(err)), 120.0,
              "working-receiver gate; the capture's error floor is the "
              "C/A cross-correlation DLL bias"),
    ]


def _max_abs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def compare_acquisition(src, cfg, prns, dev_ref, dev_test) -> List[Check]:
    """(a) `acquisition_power_grid` + `peak_statistics` on both devices
    over the capture's first non-coherent blocks."""
    import jax

    from gps_sdr_tpu.acquisition import (acquisition_power_grid,
                                         doppler_carriers, peak_statistics,
                                         sampled_codes)

    S = cfg.signal.samples_per_ms
    B = cfg.acq.n_noncoherent_ms
    blocks = src.read_complex(cfg.file.skip_ms * S, B * S).reshape(B, S)
    inputs = (blocks, doppler_carriers(cfg),
              np.fft.fft(sampled_codes(cfg, prns)).astype(np.complex64))
    stats = []
    for dev in (dev_ref, dev_test):
        with jax.default_device(dev):
            power = acquisition_power_grid(
                *[jax.device_put(x, dev) for x in inputs])
            stats.append(peak_statistics(power, cfg))
    (snr0, f0, d0), (snr1, f1, d1) = stats
    return [
        Check("acquisition code-delay mismatches", int(np.sum(d0 != d1)),
              0, "exact: argmax of the same grid"),
        Check("acquisition Doppler-bin mismatches", int(np.sum(f0 != f1)),
              0, "exact: argmax of the same grid"),
        Check("acquisition SNR max |diff| [dB]", _max_abs(snr0, snr1),
              0.01, "f32 FFT round-off and summation order"),
    ]


def run_tracking_on(dev, src, cfg, prns, code_delays, fine_freqs, params,
                    n_ms: int):
    """Free-running `run_tracking` from the acquired state with `dev` as
    the default device (every array it stages lands there)."""
    import jax

    from gps_sdr_tpu.tracking import init_track_state, run_tracking

    with jax.default_device(dev):
        st = init_track_state(cfg, code_delays, fine_freqs)
        rec, _ = run_tracking(src, cfg, list(prns), st, params, n_ms)
    return rec


def _placement(target):
    """(default device, put) for a device or a Mesh (replicated on it)."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    if isinstance(target, Mesh):
        sharding = NamedSharding(target, PartitionSpec())
        return target.devices.flat[0], lambda x: jax.device_put(x, sharding)
    return target, lambda x: jax.device_put(x, target)


def _chunk(src, ptrs, n_steps: int, S: int, blk: int):
    """(start, int IQ values) covering n_steps 1 ms blocks from `ptrs`."""
    ptrs = np.asarray(ptrs)
    start = int(ptrs.min())
    n = int(ptrs.max()) - start + (n_steps + 1) * S + blk + 64
    return start, src.read_iq_values(start, n)


def tracking_step(src, cfg, prns, params, state0, n_steps: int, target):
    """step(state) -> (state, records): one block of the production
    tracking scan (`track_scan`, or `sharded_track_scan` when `target`
    is a Mesh) on `target`, over a chunk that covers n_steps blocks."""
    import functools

    import jax
    from jax.sharding import Mesh

    from gps_sdr_tpu.ops.cacode import ca_code_table
    from gps_sdr_tpu.tracking import (TrackState, _stage_raw,
                                      build_shift_tables, track_scan)

    S = cfg.signal.samples_per_ms
    fs, cfb = float(cfg.signal.fs), float(cfg.signal.code_freq_basis)
    blk = -(-(S * params.pdi_ms + 256) // 128) * 128
    if params.replica == "shift":
        tables, margin = build_shift_tables(cfg, prns, blk)
    else:
        tables = np.stack([ca_code_table()[p - 1] for p in prns])
        margin = 0
    start, vals = _chunk(src, state0.ptr, n_steps * params.pdi_ms, S, blk)
    if isinstance(target, Mesh):
        from gps_sdr_tpu.parallel.tracking import (pad_channels,
                                                   sharded_track_scan)

        sharded = sharded_track_scan(target, params, 1, fs, blk, cfb, margin)

        def fn(raw, start, st, tab):
            # channels padded to the mesh size, as run_tracking does
            st, tab, n_pad = pad_channels(st, tab, target.size)
            st, rec = sharded(raw, start, st, tab)
            n = st.ptr.shape[0] - n_pad
            return (TrackState(*[f[:n] for f in st]),
                    {k: v[:, :n] for k, v in rec.items()})
    else:
        fn = functools.partial(track_scan, params=params, n_steps=1, fs=fs,
                               blk=blk, code_freq_basis=cfb, margin=margin)
    dev, put = _placement(target)
    with jax.default_device(dev):
        raw = _stage_raw(put(vals))
        tab = put(np.asarray(tables, np.float32))
        start = put(np.int64(start))

    def step(st):
        with jax.default_device(dev):
            return fn(raw, start, put(st), tab)

    return step


def vt_step(vt_kw: Dict, n_steps: int, target, precision=None):
    """step(state) -> (state, records): one ms of the production VT scan
    (`vt_scan`, or `sharded_vt_scan` on a Mesh) on `target`; the Kepler
    geometry is refreshed every step (each call is its own group).
    `precision` sets jax.default_matmul_precision for the step."""
    import contextlib
    import functools

    import jax
    from jax.sharding import Mesh

    from gps_sdr_tpu.ops.cacode import ca_code_table
    from gps_sdr_tpu.receiver.vt import vt_scan
    from gps_sdr_tpu.tracking import _stage_raw

    cfg, params, prns = vt_kw["cfg"], vt_kw["params"], vt_kw["prns"]
    S = cfg.signal.samples_per_ms
    blk = -(-(S * params.pdi_ms + 256) // 128) * 128
    statics = dict(fs=float(cfg.signal.fs), blk=blk,
                   f_if=float(cfg.signal.f_if), fc=float(cfg.signal.fc),
                   code_freq_basis=float(cfg.signal.code_freq_basis),
                   doy=int(cfg.cmn.day_of_year))
    start, vals = _chunk(vt_kw["source"], vt_kw["state"].ptr, n_steps, S,
                         blk)
    if isinstance(target, Mesh):
        from gps_sdr_tpu.parallel.vt import pad_vt_state, sharded_vt_scan
        from gps_sdr_tpu.receiver.vt import (_VT_REC_GLOBAL,
                                             _VT_STATE_REPLICATED, VTState)

        n = len(prns)
        sharded = sharded_vt_scan(target, params, 1, n_real=n, **statics)

        def fn(raw, start, st, tab, eph, alpha, beta):
            # channels padded to the mesh size, as run_vector_tracking does
            st, tab, eph, _ = pad_vt_state(st, tab, eph, target.size)
            st, rec = sharded(raw, start, st, tab, eph, alpha, beta)
            return (VTState(**{
                f: v if f in _VT_STATE_REPLICATED else v[:n]
                for f, v in st._asdict().items()}),
                {k: v if k in _VT_REC_GLOBAL else v[:, :n]
                 for k, v in rec.items()})
    else:
        fn = functools.partial(vt_scan, params=params, n_steps=1, **statics)
    dev, put = _placement(target)
    tables = np.stack([ca_code_table()[p - 1] for p in prns])
    with jax.default_device(dev):
        raw = _stage_raw(put(vals))
        start = put(np.int64(start))
        tab, eph, alpha, beta = (put(x) for x in (
            tables.astype(np.float32), vt_kw["eph_struct"],
            np.asarray(cfg.cmn.iono_alpha, np.float64),
            np.asarray(cfg.cmn.iono_beta, np.float64)))
    prec = (jax.default_matmul_precision(precision) if precision
            else contextlib.nullcontext())

    def step(st):
        with jax.default_device(dev), prec:
            return fn(raw, start, put(st), tab, eph, alpha, beta)

    return step


def replay(ref_step, test_step, state0, n_steps: int):
    """One-step-ahead replay: `test_step` runs n_steps times from state0,
    carrying its own state, and at every step `ref_step` runs the same
    step from that state.  Closed loops amplify round-off — a carrier
    NCO word that rounds the other way shifts the phase, and the loops
    feed it back — so two free runs drift apart at loop-noise level
    within ~100 ms; stepping both from one state compares the device
    programs themselves.  Returns (ref, test) records, each field
    stacked over the steps."""
    import types

    import jax

    refs, tests, st = [], [], state0
    for _ in range(n_steps):
        refs.append(jax.device_get(ref_step(st)[1]))
        st, rec = test_step(st)
        tests.append(jax.device_get(rec))

    def stack(rs):
        return types.SimpleNamespace(**{
            k: np.concatenate([np.asarray(r[k]) for r in rs]) for k in rs[0]})

    return stack(refs), stack(tests)


def compare_tracking(label: str, ref, test) -> List[Check]:
    """(b)/(c) tracking records of a replay (same state in, one block)."""
    scale = max(float(np.max(np.abs(ref.corr))), 1.0)
    return [
        Check(f"{label} num_sample mismatches",
              int(np.sum(ref.num_sample != test.num_sample)), 0,
              "exact: block lengths from the same f64 NCO state"),
        Check(f"{label} absolute_sample mismatches",
              int(np.sum(ref.absolute_sample != test.absolute_sample)), 0,
              "exact: integer sample pointers"),
        Check(f"{label} corr max |diff| / max |corr|",
              _max_abs(ref.corr, test.corr) / scale, 1e-4,
              "f32 sums of ~58k products in another order (HIGHEST "
              "precision: no TF32)"),
        Check(f"{label} code_freq max |diff| [Hz]",
              _max_abs(ref.code_freq, test.code_freq), 1e-3,
              "f64 DLL: ~50x the f32 discriminator round-off"),
        Check(f"{label} carr_freq max |diff| [Hz]",
              _max_abs(ref.carr_freq, test.carr_freq), 1e-3,
              "f64 PLL: ~160x the f32 discriminator round-off"),
    ]


def compare_vt(label: str, ref, test) -> List[Check]:
    """(d) VT records and EKF state of a replay."""
    scale = max(float(np.max(np.abs(ref.corr))), 1.0)
    why = ("f64 EKF fed by f32 measurements: the correlator round-off "
           "through the gain")
    x0, x1 = ref.total_state, test.total_state
    return [
        Check(f"{label} absolute_sample mismatches",
              int(np.sum(ref.absolute_sample != test.absolute_sample)), 0,
              "exact: block lengths from the same state"),
        Check(f"{label} corr max |diff| / max |corr|",
              _max_abs(ref.corr, test.corr) / scale, 1e-4,
              "f32 sums of ~58k products in another order"),
        Check(f"{label} code_freq max |diff| [Hz]",
              _max_abs(ref.code_freq, test.code_freq), 1e-3,
              "nav-driven code NCO from the f64 predicted range"),
        Check(f"{label} EKF position max |diff| [m]",
              _max_abs(x0[:, :3], x1[:, :3]), 0.01, why),
        Check(f"{label} EKF velocity max |diff| [m/s]",
              _max_abs(x0[:, 3:6], x1[:, 3:6]), 1e-3, why),
        Check(f"{label} EKF clock bias max |diff| [m]",
              _max_abs(x0[:, 6], x1[:, 6]), 0.01, why),
    ]


def compare_shift_nco(shift, nco) -> List[Check]:
    """(e) the `shift` engine against `nco` on one device, free-running,
    over the second half of the run (both loops settled), as
    tests/test_tracking.py bounds them on the CPU."""
    tail = slice(shift.num_sample.shape[0] // 2, None)
    why = ("nominal-rate replica: it neglects the within-block code "
           "Doppler drift (< 0.2 samples/ms)")
    a, b = shift.p_i[tail], nco.p_i[tail]
    rel = np.abs(a - b) / np.maximum(np.abs(b), 1.0)
    return [
        Check("shift vs nco carr_freq mean |diff| [Hz]", float(np.max(
            np.abs(shift.carr_freq[tail].mean(0)
                   - nco.carr_freq[tail].mean(0)))), 2.0, why),
        Check("shift vs nco code_freq mean |diff| [Hz]", float(np.max(
            np.abs(shift.code_freq[tail].mean(0)
                   - nco.code_freq[tail].mean(0)))), 1.5, why),
        Check("shift vs nco prompt median relative diff",
              float(np.median(rel)), 0.04, why),
        Check("shift vs nco prompt sign disagreement", float(np.mean(
            np.sign(a) != np.sign(b))), 0.001, why),
    ]


def phase3(rx, acq, card: str) -> List[Check]:
    """GPU against the CPU backend, and `shift` against `nco` on the GPU."""
    import jax

    import bench
    from gps_sdr_tpu.tracking import TrackParams, init_track_state

    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    cfg, src = rx.cfg, rx.source
    prns = list(bench.E2E_PRNS)
    order = [acq.channel_index(p) for p in prns]
    delays, fines = acq.code_delay[order], acq.fine_freq_hz[order]
    checks = []

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        print(f"phase 3 {name} {time.perf_counter() - t0:.3f} s [{card}]")
        return out

    checks += timed("(a) acquisition grid, CPU then GPU",
                    compare_acquisition, src, cfg,
                    prns + list(ABSENT_PRNS), cpu, gpu)
    st0 = init_track_state(cfg, delays, fines)
    for tag, params, n in (("(b)", TrackParams.epl(cfg), 200),
                           ("(c)", TrackParams.pos_multicorr(cfg), 100)):
        name = f"tracking {len(params.taps)}-tap {n} ms replay"
        ref, test = timed(f"{tag} {name}", replay,
                          tracking_step(src, cfg, prns, params, st0, n, cpu),
                          tracking_step(src, cfg, prns, params, st0, n, gpu),
                          st0, n)
        checks += compare_tracking(name, ref, test)
    vt_kw = rx.vt_inputs(CT_MS)
    ref, test = timed("(d) VT 200 ms replay", replay,
                      vt_step(vt_kw, 200, cpu), vt_step(vt_kw, 200, gpu),
                      vt_kw["state"], 200)
    checks += compare_vt("VT 200 ms replay", ref, test)
    # do VT's f32 products need HIGHEST too?  the same replay with every
    # f32 product at HIGHEST, printed beside the default's errors
    ref, high = timed("(d) VT 200 ms replay, HIGHEST", replay,
                      vt_step(vt_kw, 200, cpu),
                      vt_step(vt_kw, 200, gpu, precision="highest"),
                      vt_kw["state"], 200)
    for c in compare_vt("VT 200 ms replay at HIGHEST", ref, high):
        print(f"  [info] {c.name}: {c.err!r}")
    nco = timed("(e) tracking nco gpu 200 ms", run_tracking_on, gpu, src,
                cfg, prns, delays, fines, TrackParams.epl(cfg), 200)
    shift = timed("(e) tracking shift gpu 200 ms", run_tracking_on, gpu,
                  src, cfg, prns, delays, fines,
                  TrackParams.epl(cfg, replica="shift"), 200)
    checks += compare_shift_nco(shift, nco)
    return checks


def compare_mesh(one, four, mesh) -> List[Check]:
    """The 4-card receiver against the one-card receiver: acquisition and
    decode exactly, the sharded tracking and VT programs by replay from
    one state, and the two free-running fixes printed side by side."""
    import jax

    from gps_sdr_tpu.tracking import TrackParams, init_track_state

    rx1, acq1, svs1, nav1, sol1 = one
    rx4, acq4, svs4, nav4, sol4 = four
    eph1, eph4 = rx1.decode()[0], rx4.decode()[0]
    gpu = jax.devices()[0]
    cfg, src = rx1.cfg, rx1.source
    prns = [int(p) for p in acq1.sv]
    checks = [
        Check("mesh acquisition mismatches (PRN, delay, bin)", int(
            not (np.array_equal(acq1.sv, acq4.sv)
                 and np.array_equal(acq1.code_delay, acq4.code_delay)
                 and np.array_equal(acq1.doppler_hz, acq4.doppler_hz))), 0,
            "exact: argmax of the same grid, PRN-sharded"),
        Check("mesh decoded-ephemeris mismatches", sum(
            int(not np.array_equal(eph1[p].latest(0)["sqrta"],
                                   eph4[p].latest(0)["sqrta"]))
            for p in svs1) + int(svs1 != svs4), 0,
            "exact: the same nav bits"),
    ]
    st0 = init_track_state(cfg, acq1.code_delay, acq1.fine_freq_hz)
    params = TrackParams.epl(cfg)
    ref, test = replay(tracking_step(src, cfg, prns, params, st0, 200, gpu),
                       tracking_step(src, cfg, prns, params, st0, 200, mesh),
                       st0, 200)
    checks += compare_tracking("mesh tracking 200 ms replay", ref, test)
    vt_kw = rx1.vt_inputs(CT_MS)
    ref, test = replay(vt_step(vt_kw, 200, gpu), vt_step(vt_kw, 200, mesh),
                       vt_kw["state"], 200)
    checks += compare_vt("mesh VT 200 ms replay", ref, test)
    print(f"  [info] free-running WLS fixes, max |diff| "
          f"{_max_abs(nav1.usr_pos, nav4.usr_pos)!r} m; VT fixes, max "
          f"|diff| {_max_abs(sol1.usr_pos, sol4.usr_pos)!r} m")
    return checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run phase 2 on a 4-card mesh and on one card, "
                         "compare them, and nothing else")
    args = ap.parse_args(argv)

    import gps_sdr_tpu  # noqa: F401  (enables float64)
    import jax

    card = phase0()
    phase1(card)
    art = tempfile.mkdtemp(prefix="chip_smoke_",
                           dir=os.path.join(REPO, ".cache"))
    checks: List[Check] = []

    def report(new: List[Check]):
        for c in new:
            print(c.line(), flush=True)
        checks.extend(new)

    try:
        if args.four_cards:
            from gps_sdr_tpu.parallel.mesh import make_mesh

            if len(jax.devices()) < 4:
                raise SystemExit("chip_smoke --four-cards: needs 4 GPUs, "
                                 f"JAX finds {len(jax.devices())}")
            mesh = make_mesh(4)
            runs = {}
            for label, m in (("phase 2 [4-card mesh]", mesh),
                             ("phase 2 [one card]", None)):
                d = os.path.join(art, "mesh4" if m else "one")
                runs[label] = run_receiver(m, card, label, d)
                report(fix_gates(*runs[label][1:]))
            report(compare_mesh(runs["phase 2 [one card]"],
                                runs["phase 2 [4-card mesh]"], mesh))
        else:
            rx, acq, svs, nav, sol = run_receiver(None, card, "phase 2",
                                                  art)
            report(fix_gates(acq, svs, nav, sol))
            report(phase3(rx, acq, card))
    finally:
        shutil.rmtree(art, ignore_errors=True)
    failed = [c.name for c in checks if not c.ok]
    if failed:
        print(f"chip_smoke: {len(failed)} checks failed: {failed}",
              file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
