"""Multi-PROCESS execution harness on the CPU backend.

This module runs the production sharded stages on a mesh that SPANS OS
processes under `jax.distributed` — per-process local devices, a global
mesh, collectives crossing the process boundary over Gloo.  It is a
CPU-only harness: its workers force `jax_platforms="cpu"` and never open
an accelerator, so it checks the multi-process code path (process
groups, cross-process collectives, host-local IF ingest), not device
collectives:

- **track**: `parallel.tracking.sharded_track_scan` with the channel
  axis split across two processes' devices; each process's shard must
  be bit-identical to a locally-computed unsharded reference.
- **epoch**: `parallel.epoch.sharded_wls_normal_equations` — the psum
  crosses the process boundary; checked against the NumPy normal
  equations.
- **vt**: `parallel.vt.sharded_vt_scan` — the VDFLL's per-ms
  measurement all-gather rides the cross-process backend; same
  exact/allclose split as tests/test_mesh_pipeline.py's single-process
  equivalence (per-channel f64 geometry series carry SIMD batch-width
  ulp wobble).
- **ingest**: host-local file sharding (SURVEY.md §2.9 comm row) — the
  capture's time axis is segmented (parallel.time_segments overlap-save)
  and EACH PROCESS READS ONLY THE BYTE RANGE its segments need
  (reported in the result so the caller can assert near-disjointness;
  the halo overlap is inherent to overlap-save).  The full record is
  assembled by a cross-process all-gather and stitched; it must equal
  the single-process segmented run bit-exactly.

Entry point: `launch()` spawns the N worker processes (used by
tests/test_distributed.py and `__graft_entry__.dryrun_multichip`'s
2-process leg).  Workers are bootstrapped with
`jax.distributed.initialize` BEFORE any gps_sdr_tpu import — package
imports jit module constants, which initializes the XLA backend and
would make a later initialize() fail.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from typing import Dict, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# shared fixtures (must be bit-reproducible across processes)

_SMALL_SIG = dict(f_if=2.5e5, fs=1.023e6)
_EPH_BASE = dict(sqrta=5153.6413, ecc=0.0012, i0=0.9668, w=-0.8925,
                 deltan=4.3e-09, omegadot=-7.2e-09, idot=-4.2e-10,
                 cuc=1.5e-07, cus=2.4e-07, crc=287.5, crs=-2.6,
                 cic=-7.5e-09, cis=1.3e-08, toe=388800.0, toc=388800.0,
                 af0=1.8e-04, af1=2.0e-12, af2=0.0, tgd=-7.5e-09)
INGEST_SVS = (7, 21)
INGEST_N_MS = 360
INGEST_SEG = 4
INGEST_SEG_MS = 90
INGEST_HALO_MS = 40


def _small_cfg():
    from gps_sdr_tpu.config import (FileConfig, ReceiverConfig,
                                    SignalConfig)

    return ReceiverConfig(file=FileConfig(name="dist", skip_ms=0),
                          signal=SignalConfig(**_SMALL_SIG))


def write_ingest_capture(path: str) -> None:
    """Deterministic int8 IQ capture for the ingest leg (written once by
    the launcher; workers read disjoint-ish byte ranges of it)."""
    from gps_sdr_tpu.io.synthetic import SyntheticSV, generate_if_samples

    cfg = _small_cfg()
    svs = [SyntheticSV(prn=p, amplitude=2.5 + 0.3 * i,
                       doppler_hz=(1234.5, -2500.25)[i],
                       code_delay_samples=(80.0, 345.0)[i])
           for i, p in enumerate(INGEST_SVS)]
    dur = INGEST_SEG * INGEST_SEG_MS + INGEST_HALO_MS + 8
    iq = generate_if_samples(cfg, svs, dur, noise_std=4.0, seed=9)
    vals = np.empty(2 * iq.size)
    vals[0::2] = iq.real
    vals[1::2] = iq.imag
    np.clip(np.round(vals), -127, 127).astype(np.int8).tofile(path)


def _ingest_init():
    cfg = _small_cfg()
    S = cfg.signal.samples_per_ms
    delays, fine = [], []
    for i in range(len(INGEST_SVS)):
        dop = (1234.5, -2500.25)[i]
        delay = (80.0, 345.0)[i]
        f_code = cfg.signal.code_freq_basis * (1 + dop / cfg.signal.fc)
        next_epoch = delay % (1023 / f_code * cfg.signal.fs)
        delays.append(int(round((S - next_epoch) % S)))
        fine.append(cfg.signal.f_if + dop + 3.0)
    return cfg, np.array(delays), np.array(fine)


# ---------------------------------------------------------------------------
# worker legs


def _leg_track(mesh, pid, nproc):
    import jax
    import jax.numpy as jnp
    from jax.experimental.multihost_utils import (
        global_array_to_host_local_array, host_local_array_to_global_array)
    from jax.sharding import PartitionSpec as P

    from gps_sdr_tpu.parallel.mesh import AXIS
    from gps_sdr_tpu.parallel.tracking import sharded_track_scan
    from gps_sdr_tpu.tracking import (TrackParams, TrackState,
                                      build_shift_tables,
                                      init_track_state, track_scan)

    cfg = _small_cfg()
    S = cfg.signal.samples_per_ms
    blk = -(-(S + 256) // 128) * 128
    params = TrackParams.epl(cfg, replica="shift")
    n_ch = len(jax.devices())            # one channel per global device
    n_steps = 100
    rng = np.random.default_rng(0)       # same stream on every process
    raw_np = rng.integers(-64, 64, size=((n_steps + 2) * S + blk, 2)
                          ).astype(np.float32)
    tables, margin = build_shift_tables(cfg, range(1, n_ch + 1), blk)
    st = init_track_state(cfg, np.zeros(n_ch, np.int64),
                          np.full(n_ch, cfg.signal.f_if + 1000.0))
    st = st._replace(ptr=jnp.zeros(n_ch, jnp.int64))

    # unsharded reference, computed identically on every process
    ref_st, ref = track_scan(jnp.asarray(raw_np), jnp.int64(0), st,
                             jnp.asarray(tables), params, n_steps,
                             float(cfg.signal.fs), blk,
                             float(cfg.signal.code_freq_basis), margin)
    ref = {k: np.asarray(v) for k, v in ref.items()}

    lo, hi = pid * n_ch // nproc, (pid + 1) * n_ch // nproc
    chan = P(AXIS)
    st_g = TrackState(*[host_local_array_to_global_array(
        np.asarray(f)[lo:hi], mesh, chan) for f in st])
    tab_g = host_local_array_to_global_array(tables[lo:hi], mesh,
                                             P(AXIS, None))
    raw_g = host_local_array_to_global_array(raw_np, mesh, P())
    start_g = host_local_array_to_global_array(np.int64(0), mesh, P())
    fn = sharded_track_scan(mesh, params, n_steps, float(cfg.signal.fs),
                            blk, float(cfg.signal.code_freq_basis),
                            margin)
    _, rec = fn(raw_g, start_g, st_g, tab_g)
    ok = True
    for k, v in rec.items():
        spec = (P(None, AXIS, None, None) if k == "corr"
                else P(None, AXIS))
        local = np.asarray(global_array_to_host_local_array(v, mesh, spec))
        ok = ok and np.array_equal(local, ref[k][:, lo:hi])
    return {"ok": bool(ok), "n_channels": n_ch,
            "local_channels": [int(lo), int(hi)]}


def _leg_epoch(mesh, pid, nproc):
    import jax
    from jax.experimental.multihost_utils import (
        host_local_array_to_global_array)
    from jax.sharding import PartitionSpec as P

    from gps_sdr_tpu.parallel.epoch import sharded_wls_normal_equations
    from gps_sdr_tpu.parallel.mesh import AXIS

    n_sv = len(jax.devices())
    rng = np.random.default_rng(1)
    sv_pos = rng.normal(scale=2.6e7, size=(n_sv, 3))
    resid = rng.normal(scale=30.0, size=(n_sv,))
    usr = np.array([-2.4e6, 5.38e6, 2.41e6])
    # NumPy reference Gauss-Newton step (olspos.m:40-53 semantics)
    d = sv_pos - usr
    r = np.linalg.norm(d, axis=1)
    h = np.concatenate([-d / r[:, None], np.ones((n_sv, 1))], axis=1)
    delta_ref = np.linalg.solve(h.T @ h, h.T @ resid)

    lo, hi = pid * n_sv // nproc, (pid + 1) * n_sv // nproc
    fn = sharded_wls_normal_equations(mesh)
    delta = fn(
        host_local_array_to_global_array(sv_pos[lo:hi], mesh,
                                         P(AXIS, None)),
        host_local_array_to_global_array(resid[lo:hi], mesh, P(AXIS)),
        host_local_array_to_global_array(usr, mesh, P(None)))
    ok = np.allclose(np.asarray(delta), delta_ref, rtol=1e-9, atol=1e-9)
    return {"ok": bool(ok), "n_sv": n_sv}


def _vt_fixture(n_ch):
    """Synthetic-but-plausible VT scan inputs (bench.bench_vt's fixture
    at the small front-end shape), bit-reproducible across processes."""
    import jax.numpy as jnp

    from gps_sdr_tpu.geo.ephemeris import Ephemeris
    from gps_sdr_tpu.ops.cacode import ca_code_table
    from gps_sdr_tpu.receiver.vt import VTParams, VTState

    cfg = _small_cfg()
    S = cfg.signal.samples_per_ms
    blk = -(-(S + 256) // 128) * 128
    params = VTParams()
    rng = np.random.default_rng(3)
    eph = Ephemeris(**{
        k: jnp.asarray(np.full(n_ch, v, np.float64))
        for k, v in _EPH_BASE.items()
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
    tables = np.stack([ca_code_table()[p] for p in range(n_ch)]
                      ).astype(np.float32)
    n_steps = 40
    rng2 = np.random.default_rng(4)
    raw = rng2.integers(-64, 64, size=((n_steps + 2) * S + blk, 2)
                        ).astype(np.float32)
    return cfg, params, state, eph, tables, raw, blk, n_steps


def _leg_vt(mesh, pid, nproc):
    import jax
    import jax.numpy as jnp
    from jax.experimental.multihost_utils import (
        global_array_to_host_local_array, host_local_array_to_global_array)
    from jax.sharding import PartitionSpec as P

    from gps_sdr_tpu.parallel.mesh import AXIS
    from gps_sdr_tpu.parallel.vt import (_REC_KEYS, _rec_spec,
                                         _STATE_SPEC, sharded_vt_scan)
    from gps_sdr_tpu.receiver.vt import (_VT_REC_GLOBAL, VTState, vt_scan)

    n_ch = len(jax.devices())
    cfg, params, state, eph, tables, raw_np, blk, n_steps = _vt_fixture(n_ch)
    alpha = jnp.asarray(cfg.cmn.iono_alpha, jnp.float64)
    beta = jnp.asarray(cfg.cmn.iono_beta, jnp.float64)
    args = (float(cfg.signal.fs), blk, float(cfg.signal.f_if),
            float(cfg.signal.fc), float(cfg.signal.code_freq_basis),
            int(cfg.cmn.day_of_year))

    _, ref = vt_scan(jnp.asarray(raw_np), jnp.int64(0), state,
                     jnp.asarray(tables), eph, alpha, beta, params,
                     n_steps, *args)
    ref = {k: np.asarray(v) for k, v in ref.items()}

    lo, hi = pid * n_ch // nproc, (pid + 1) * n_ch // nproc

    def shard(a, spec):
        a = np.asarray(a)
        if spec == P(AXIS) or (len(spec) >= 1 and spec[0] == AXIS):
            a = a[lo:hi]
        return host_local_array_to_global_array(a, mesh, spec)

    st_g = VTState(**{
        f: shard(getattr(state, f), getattr(_STATE_SPEC, f))
        for f in VTState._fields})
    eph_g = type(eph)(*[shard(f, P(AXIS)) for f in eph])
    fn = sharded_vt_scan(mesh, params, n_steps, *args, n_ch)
    _, rec = fn(shard(raw_np, P()), shard(np.int64(0), P()), st_g,
                shard(tables, P(AXIS, None)), eph_g,
                shard(np.asarray(alpha), P()), shard(np.asarray(beta), P()))
    exact = ("corr", "carr_err", "code_err", "num_sample",
             "absolute_sample", "rem_phase")
    rec_specs = _rec_spec(_REC_KEYS)
    ok_exact = ok_close = True
    for k, v in rec.items():
        spec = rec_specs[k]
        local = np.asarray(global_array_to_host_local_array(v, mesh, spec))
        want = ref[k] if k in _VT_REC_GLOBAL else ref[k][:, lo:hi]
        if k in exact or k in _VT_REC_GLOBAL:
            ok_exact = ok_exact and np.array_equal(local, want)
        else:
            ok_close = ok_close and np.allclose(local, want, rtol=1e-9,
                                                atol=1e-4)
    return {"ok": bool(ok_exact and ok_close),
            "ok_exact": bool(ok_exact), "ok_close": bool(ok_close)}


def _leg_ingest(pid, nproc, capture_path):
    """Host-local IF ingest: this process reads ONLY the byte range its
    time segments need, tracks them locally, and the full record is
    assembled by a cross-process all-gather + overlap-save stitch."""
    from jax.experimental import multihost_utils

    from gps_sdr_tpu.io.ifdata import IFSampleSource
    from gps_sdr_tpu.parallel.time_segments import (
        segmented_initial_state, stitch_segments)
    from gps_sdr_tpu.tracking import (TrackParams, TrackState,
                                      run_tracking)

    cfg, delays, fine = _ingest_init()
    n = len(INGEST_SVS)
    params = TrackParams.epl(cfg, replica="shift")
    S = cfg.signal.samples_per_ms
    blk = -(-(S + 256) // 128) * 128
    state = segmented_initial_state(cfg, delays, fine, INGEST_SEG,
                                    INGEST_SEG_MS, INGEST_HALO_MS)
    s_lo = pid * INGEST_SEG // nproc
    s_hi = (pid + 1) * INGEST_SEG // nproc
    ptrs = np.asarray(state.ptr).reshape(INGEST_SEG, n)
    my_ptr_lo = int(ptrs[s_lo:s_hi].min())
    need = (INGEST_SEG_MS + INGEST_HALO_MS + 2) * S + blk + 64
    my_ptr_hi = int(ptrs[s_lo:s_hi].max()) + need
    bps = cfg.file.bytes_per_sample          # interleaved IQ bytes/sample
    byte_lo, byte_hi = my_ptr_lo * bps, my_ptr_hi * bps
    file_bytes = os.path.getsize(capture_path)
    byte_hi = min(byte_hi, file_bytes)

    # the HOST-LOCAL read: only [byte_lo, byte_hi) of the capture
    with open(capture_path, "rb") as f:
        f.seek(byte_lo)
        sl = np.frombuffer(f.read(byte_hi - byte_lo), np.int8)
    src = IFSampleSource.from_array(sl, cfg.file)

    # rebase this process's segment states into the slice's coordinates
    my = TrackState(*[np.asarray(f).reshape(INGEST_SEG, n)[s_lo:s_hi]
                      .reshape(-1) for f in state])
    my = my._replace(ptr=np.asarray(my.ptr) - my_ptr_lo)
    import jax.numpy as jnp
    my = TrackState(*[jnp.asarray(f) for f in my])
    prns_rep = [p for _ in range(s_hi - s_lo) for p in INGEST_SVS]
    rec, _ = run_tracking(src, cfg, prns_rep, my, params,
                          INGEST_SEG_MS + INGEST_HALO_MS,
                          per_channel_io=True)
    rec.absolute_sample += my_ptr_lo         # back to capture coordinates

    # cross-process assembly: all-gather each record field and stitch
    fields = ("corr", "code_err", "carr_err", "code_freq", "carr_freq",
              "num_sample", "rem_chip", "rem_phase", "absolute_sample")
    gathered = multihost_utils.process_allgather(
        {f: getattr(rec, f) for f in fields})
    from gps_sdr_tpu.tracking import TrackRecords
    full = TrackRecords(
        **{f: np.concatenate(list(gathered[f]), axis=1) for f in fields},
        i_early=params.i_early, i_prompt=params.i_prompt,
        i_late=params.i_late)
    stitched = stitch_segments(full, n, INGEST_SEG, INGEST_SEG_MS,
                               INGEST_HALO_MS, INGEST_N_MS, params)

    # single-process reference over the whole file (the equivalence
    # target; only this reference opens the full capture)
    from gps_sdr_tpu.parallel.time_segments import run_tracking_segmented
    ref = run_tracking_segmented(
        IFSampleSource(capture_path, cfg.file), cfg, INGEST_SVS, delays,
        fine, params, INGEST_N_MS, n_segments=INGEST_SEG,
        halo_ms=INGEST_HALO_MS)
    ok = all(np.array_equal(getattr(stitched, f), getattr(ref, f))
             for f in fields)
    return {"ok": bool(ok), "byte_range": [int(byte_lo), int(byte_hi)],
            "file_bytes": int(file_bytes),
            "read_fraction": round((byte_hi - byte_lo) / file_bytes, 3)}


# ---------------------------------------------------------------------------
# worker entry


def run_legs(pid: int, nproc: int, legs_csv: str, out_path: str,
             capture: str = None) -> int:
    """Worker body.  `jax.distributed.initialize` MUST already have run
    (the launcher's bootstrap does it BEFORE any gps_sdr_tpu import —
    package imports jit-compile module constants, which initializes the
    XLA backend and would make a later initialize() fail)."""
    import jax

    from gps_sdr_tpu.parallel.mesh import make_mesh

    mesh = make_mesh()
    out: Dict[str, dict] = {
        "process_id": pid,
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }
    for leg in legs_csv.split(","):
        if leg == "track":
            out[leg] = _leg_track(mesh, pid, nproc)
        elif leg == "epoch":
            out[leg] = _leg_epoch(mesh, pid, nproc)
        elif leg == "vt":
            out[leg] = _leg_vt(mesh, pid, nproc)
        elif leg == "ingest":
            out[leg] = _leg_ingest(pid, nproc, capture)
        else:
            raise ValueError(f"unknown leg {leg!r}")
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


# ---------------------------------------------------------------------------
# launcher


def launch(legs: Sequence[str] = ("track", "epoch"), n_processes: int = 2,
           devices_per_process: int = 4, timeout_s: int = 900,
           work_dir: str = None) -> Dict[int, dict]:
    """Spawn `n_processes` CPU worker processes under jax.distributed,
    run the requested legs, and return {process_id: result dict}.
    Raises on any worker failure."""
    import socket
    import tempfile

    with socket.socket() as s:                 # free coordinator port
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    work_dir = work_dir or tempfile.mkdtemp(prefix="gps_sdr_dist_")
    os.makedirs(work_dir, exist_ok=True)
    capture = None
    if "ingest" in legs:
        capture = os.path.join(work_dir, "ingest_capture.bin")
        if not os.path.exists(capture):
            write_ingest_capture(capture)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    this_file = os.path.abspath(__file__)
    procs = []
    outs = []
    for pid in range(n_processes):
        outf = os.path.join(work_dir, f"result_{pid}.json")
        outs.append(outf)
        env = dict(
            os.environ, JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count="
                      f"{devices_per_process}",
            PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
        # bootstrap: distributed MUST initialize before any gps_sdr_tpu
        # import (package imports initialize the XLA backend), so the
        # worker module is loaded BY FILE PATH after initialize()
        boot = (
            "import sys, jax, importlib.util;"
            "jax.config.update('jax_platforms','cpu');"
            "jax.config.update('jax_cpu_collectives_implementation',"
            "'gloo');"
            "jax.distributed.initialize("
            f"coordinator_address='localhost:{port}',"
            f"num_processes={n_processes}, process_id={pid});"
            "spec=importlib.util.spec_from_file_location("
            f"'gps_dist_worker', {this_file!r});"
            "m=importlib.util.module_from_spec(spec);"
            "spec.loader.exec_module(m);"
            f"sys.exit(m.run_legs({pid}, {n_processes}, "
            f"{','.join(legs)!r}, {outf!r}, {capture!r}))")
        cmd = [sys.executable, "-c", boot]
        procs.append(subprocess.Popen(cmd, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT,
                                      text=True))
    results: Dict[int, dict] = {}
    errs = []
    for pid, p in enumerate(procs):
        try:
            stdout, _ = p.communicate(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            p.kill()
            stdout, _ = p.communicate()
            errs.append(f"process {pid} timed out\n{stdout[-2000:]}")
            continue
        if p.returncode != 0:
            errs.append(f"process {pid} rc={p.returncode}\n"
                        f"{stdout[-2000:]}")
            continue
        with open(outs[pid]) as f:
            results[pid] = json.load(f)
    if errs:
        raise RuntimeError("distributed launch failed:\n"
                           + "\n---\n".join(errs))
    return results


if __name__ == "__main__":
    sys.exit("workers are spawned by launch() — direct execution would "
             "import the package (initializing the XLA backend) before "
             "jax.distributed.initialize can run")
