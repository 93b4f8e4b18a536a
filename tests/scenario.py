"""Shared synthetic end-to-end scenario: a static receiver at the
reference's surveyed ground-truth location observing 5 GPS SVs whose
signals are generated from broadcast ephemerides with full transmit-time
geometry.  Expensive artifacts (capture file, tracking records) are cached
under .cache/; stage artifacts are keyed on the capture's identity."""

from __future__ import annotations

import os

import numpy as np

from gps_sdr_tpu.config import (CommonConfig, FileConfig, ReceiverConfig,
                                SignalConfig, SolutionConfig)
from gps_sdr_tpu.geo.coords import llh2xyz
from gps_sdr_tpu.geo.ephemeris import Ephemeris, sv_pos_vel_clock
from gps_sdr_tpu.io.ifdata import IFSampleSource
from gps_sdr_tpu.io.synthetic import GeometrySignal, GeometrySV

CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".cache")

TOW0 = 388799.0  # 1 s before a frame (subframe-1) boundary so IDs 1..5
# all complete within ~31 s of capture
WEEK = 2239

TRUTH_LLH = (np.deg2rad(22.328444770087565),
             np.deg2rad(114.1713630049711), 4.0)

CFG = ReceiverConfig(
    file=FileConfig(name="geo_scn", skip_ms=0),
    signal=SignalConfig(f_if=1.25e6, fs=5e6),  # incommensurate
    # fs/fchip (4.89 samples/chip): commensurate sampling locks every chip
    # to the same fractional alignment and biases the E-L discriminator
    solu=SolutionConfig(truth_llh=TRUTH_LLH),
    # 3-tap E/P/L banks for the shared fast path; the multicorrelator
    # configurations have their own dedicated tests
    cmn=CommonConfig(multicorr_ct=False, multicorr_vt=False),
)

BASE_EPH = dict(
    sqrta=5153.6413, ecc=0.00122963, m0=2.14587329, omega0=1.25789432,
    i0=0.96679784, w=-0.89245321, deltan=4.3267e-09, omegadot=-7.2345e-09,
    idot=-4.2e-10, cuc=1.5272e-07, cus=2.3842e-07, crc=287.46875,
    crs=-2.59375, cic=-7.45058e-09, cis=1.3039e-08, toe=388800.0,
    toc=388800.0, af0=1.8364e-04, af1=2.0464e-12, af2=0.0,
    tgd=-7.4506e-09, iodc=23, iode=23, health=0, ura=0)


def visible_constellation(n_sv: int = 5, min_el_deg: float = 20.0):
    """Pick (omega0, m0) variations of BASE_EPH visible from the truth
    position at TOW0, with spread azimuths."""
    usr = np.asarray(llh2xyz(np.asarray(TRUTH_LLH)))
    picked = []
    rng = np.random.default_rng(7)
    candidates = [(o, m) for o in np.linspace(0, 2 * np.pi, 24, endpoint=False)
                  for m in np.linspace(0, 2 * np.pi, 12, endpoint=False)]
    rng.shuffle(candidates)
    az_used = []
    for om, m0 in candidates:
        eph = dict(BASE_EPH, omega0=float(om), m0=float(m0),
                   af0=float(rng.uniform(-2e-4, 2e-4)))
        e = Ephemeris(**{k: np.asarray([eph[k]], np.float64)
                         for k in Ephemeris._fields})
        pos = np.asarray(sv_pos_vel_clock(e, np.array([TOW0]))["pos"])[0]
        los = pos - usr
        up = usr / np.linalg.norm(usr)
        el = np.rad2deg(np.arcsin(np.dot(los, up) / np.linalg.norm(los)))
        if el < min_el_deg:
            continue
        east = np.cross([0.0, 0.0, 1.0], up)
        east /= np.linalg.norm(east)
        north = np.cross(up, east)
        az = np.arctan2(np.dot(los, east), np.dot(los, north))
        if any(abs((az - a + np.pi) % (2 * np.pi) - np.pi) < 0.5
               for a in az_used):
            continue
        az_used.append(az)
        picked.append(eph)
        if len(picked) == n_sv:
            break
    assert len(picked) == n_sv, "not enough visible candidates"
    return picked


# Stable PRN assignment for the scenario
SCN_PRNS = (3, 7, 16, 22, 27)
CLK_BIAS_S = 5e-4
CLK_DRIFT_SPS = 2e-9  # ~0.6 m/s clock drift
NOISE_STD = 8.0
AMPLITUDES = (3.0, 2.6, 2.8, 2.4, 2.7)
DURATION_MS = 32000


def scenario_path() -> str:
    os.makedirs(CACHE_DIR, exist_ok=True)
    return os.path.join(CACHE_DIR, "geo_scn_v6.bin")


def build_scenario_source() -> IFSampleSource:
    """Generate (or load cached) capture + return a sample source.

    Test workers share the cache: one builds the capture under a lock
    while the others wait, and the file appears only once complete.  The
    shared eph-tracking and decode artifacts are built here too, with the
    scenario's parameters (31.8 s of tracking, decode from 200 ms): their
    stems do not name those parameters, so a test that decodes with
    other ones first would otherwise decide them for every later test."""
    from gps_sdr_tpu.pipeline import Receiver
    from gps_sdr_tpu.utils.atomic import file_lock

    path = scenario_path()
    n_bytes = DURATION_MS * CFG.signal.samples_per_ms * 2
    with file_lock(path):
        if not (os.path.exists(path) and os.path.getsize(path) == n_bytes):
            ephs = visible_constellation(len(SCN_PRNS))
            svs = [GeometrySV(prn=p, eph=e, amplitude=a)
                   for p, e, a in zip(SCN_PRNS, ephs, AMPLITUDES)]
            gs = GeometrySignal(
                CFG, svs, np.asarray(llh2xyz(np.asarray(TRUTH_LLH))), TOW0,
                clk_bias_s=CLK_BIAS_S, clk_drift_sps=CLK_DRIFT_SPS,
                atmosphere=True, iono_alpha=CFG.cmn.iono_alpha,
                iono_beta=CFG.cmn.iono_beta, doy=CFG.cmn.day_of_year)
            gs.write_file(path, DURATION_MS, noise_std=NOISE_STD, seed=11)
        src = IFSampleSource(path, CFG.file)
        rx = Receiver(CFG, src, artifact_dir=CACHE_DIR, mesh=None)
        if not os.path.exists(os.path.join(CACHE_DIR, f"eph_{rx.key}.pkl")):
            rx.track_for_eph(n_ms=DURATION_MS - 200)
            rx.decode(start_offset_ms=200)
    return src
