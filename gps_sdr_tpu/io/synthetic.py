"""Synthetic GPS L1 C/A IF-signal generation.

Replaces the reference's reliance on the (undistributed) Opensky/Urban
captures for verification: every pipeline stage is tested against signals
with known truth.  Two fidelity levels:

- `generate_if_samples`: constant Doppler/delay per SV with nav bits —
  unit tests for acquisition/tracking/decode.
- `GeometrySignal`: full transmit-time geometry from broadcast ephemeris
  (SV orbits, SV clock, receiver clock bias/drift, optional atmosphere) so
  recovered WLS/EKF positions can be checked against the true antenna
  location.  This is the synthetic-signal analog of the reference's
  verification-by-ground-truth (initParameters.m:23, Plot_task_4.m).

Sample convention matches the Opensky capture as read by the reference
(acquisition.m:36): interleaved values v[2k]+1j·v[2k+1], and a signal at
carrier phase θ contributes  A·code·bit·(sin θ + i·cos θ)  so that the
receiver's I = imag(raw·e^{iθ̂}) convention (trackingCT.m:113-114) yields
the data bit on the in-phase arm at lock.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from gps_sdr_tpu.config import C_LIGHT, ReceiverConfig
from gps_sdr_tpu.geo.ephemeris import Ephemeris, sv_pos_vel_clock
from gps_sdr_tpu.ops.cacode import CODE_LENGTH, ca_code


@dataclasses.dataclass
class SyntheticSV:
    """One emitter in simple (constant-dynamics) mode."""

    prn: int
    amplitude: float = 20.0
    doppler_hz: float = 0.0            # carrier Doppler excluding IF
    code_delay_samples: float = 0.0    # delay of the code epoch, in samples
    nav_bits: Optional[np.ndarray] = None  # {0,1} at 50 bps
    phase0_rad: float = 0.0


def _carrier_iq(theta: np.ndarray) -> np.ndarray:
    return np.sin(theta) + 1j * np.cos(theta)


def generate_if_samples(cfg: ReceiverConfig, svs: Sequence[SyntheticSV],
                        duration_ms: int, noise_std: float = 0.0,
                        seed: int = 0) -> np.ndarray:
    """Constant-dynamics IF stream, complex128 (n_samples,)."""
    sig = cfg.signal
    n = int(round(sig.fs * duration_ms * 1e-3))
    t = np.arange(n, dtype=np.float64) / sig.fs
    out = np.zeros(n, dtype=np.complex128)
    for sv in svs:
        f_carr = sig.f_if + sv.doppler_hz
        f_code = sig.code_freq_basis * (1.0 + sv.doppler_hz / sig.fc)
        chips = ca_code(sv.prn).astype(np.float64)
        chip_phase = (t - sv.code_delay_samples / sig.fs) * f_code
        code = chips[np.floor(chip_phase).astype(np.int64) % CODE_LENGTH]
        if sv.nav_bits is not None:
            bit_idx = np.floor(chip_phase / (CODE_LENGTH * 20)).astype(np.int64)
            bit_idx = np.clip(bit_idx, 0, len(sv.nav_bits) - 1)
            bit_pm = 1.0 - 2.0 * np.asarray(sv.nav_bits, np.float64)[bit_idx]
        else:
            bit_pm = 1.0
        theta = 2.0 * np.pi * f_carr * t + sv.phase0_rad
        out += sv.amplitude * code * bit_pm * _carrier_iq(theta)
    if noise_std > 0:
        rng = np.random.default_rng(seed)
        out += rng.normal(0.0, noise_std, n) + 1j * rng.normal(0.0, noise_std, n)
    return out


@dataclasses.dataclass
class GeometrySV:
    """One emitter in geometry mode."""

    prn: int
    eph: Dict[str, float]        # SI-unit ephemeris fields (lnav schema)
    amplitude: float = 20.0


class GeometrySignal:
    """Transmit-time-consistent IF signal for a static receiver.

    For receiver-clock sample time t, each SV contributes code/carrier at
    SV-clock transmit time  T_sv(t) = t − δt_rx(t) − τ_geo + δt_sv  where
    τ_geo solves the light-time equation against the broadcast orbit.
    T_sv is evaluated exactly at ms boundaries and linearly interpolated
    within (range acceleration contributes sub-µm over 1 ms).

    Nav bits come from the LNAV encoder; bit edges align with SV-clock
    20 ms boundaries, as in the real signal.
    """

    def __init__(self, cfg: ReceiverConfig, svs: Sequence[GeometrySV],
                 usr_pos_ecef: np.ndarray, tow0: float,
                 clk_bias_s: float = 0.0, clk_drift_sps: float = 0.0,
                 nav_message_tow0: Optional[float] = None,
                 nav_bits: Optional[Dict[int, np.ndarray]] = None,
                 n_subframes: int = 14, weeknum: int = 2239,
                 atmosphere: bool = False, iono_alpha=None, iono_beta=None,
                 doy: int = 171):
        from gps_sdr_tpu.io import lnav

        self.cfg = cfg
        self.svs = list(svs)
        self.usr = np.asarray(usr_pos_ecef, dtype=np.float64)
        self.tow0 = float(tow0)
        self.clk_bias_s = float(clk_bias_s)
        self.clk_drift_sps = float(clk_drift_sps)
        self.atmosphere = atmosphere
        self.iono_alpha, self.iono_beta, self.doy = iono_alpha, iono_beta, doy
        # encode the broadcast message from the earliest subframe boundary
        # at least ~80 ms of travel time before tow0
        self.msg_tow0 = (nav_message_tow0 if nav_message_tow0 is not None
                         else (np.floor((tow0 - 1.0) / 30.0)) * 30.0)
        self.bits: Dict[int, np.ndarray] = {}
        for sv in self.svs:
            if nav_bits is not None and sv.prn in nav_bits:
                self.bits[sv.prn] = np.asarray(nav_bits[sv.prn], np.int8)
            else:
                self.bits[sv.prn] = lnav.encode_frames(
                    sv.eph, weeknum, self.msg_tow0, n_subframes)
        self._eph_struct = {
            sv.prn: Ephemeris(**{k: np.asarray([sv.eph[k]], np.float64)
                                 for k in Ephemeris._fields})
            for sv in self.svs}

    def _atmos_delay_s(self, sv_pos: np.ndarray, tow: np.ndarray) -> np.ndarray:
        """Vectorized Klobuchar + UNB3 group delay [s] for (T,3)/(T,) inputs."""
        if not self.atmosphere:
            return np.zeros(np.shape(tow))
        from gps_sdr_tpu.geo.atmosphere import klobuchar_delay, tropo_unb3_delay
        from gps_sdr_tpu.geo.coords import xyz2llh, elevation_azimuth
        iono = np.asarray(klobuchar_delay(tow, sv_pos, self.usr,
                                          self.iono_alpha, self.iono_beta))
        llh = np.asarray(xyz2llh(self.usr))
        el, _ = elevation_azimuth(sv_pos, self.usr)
        tropo = np.abs(np.asarray(tropo_unb3_delay(
            self.doy, np.rad2deg(llh[0]), llh[2], np.rad2deg(np.asarray(el)))))
        return (iono + tropo) / C_LIGHT

    def sv_clock_delta(self, prn: int, tau_rel: np.ndarray) -> np.ndarray:
        """delta = T_sv − t_rx_clock at capture offsets `tau_rel` [s].

        Light-time solve.  delta = −δt_rx − τ_geo + δt_sv stays O(0.1 s),
        so carrier phase fc·delta keeps full f64 precision (fc·t at
        t≈4e5 s would lose phase to ulp≈0.06 cycles).
        """
        eph = self._eph_struct[prn]
        dt_rx = self.clk_bias_s + self.clk_drift_sps * tau_rel
        t_rx_gps = self.tow0 + tau_rel - dt_rx
        tau = np.full(tau_rel.shape, 0.075)
        for _ in range(3):
            out = sv_pos_vel_clock(eph, t_rx_gps - tau)
            pos = np.asarray(out["pos"])
            # Sagnac: during propagation the ECEF frame rotates; the
            # range must use the transmit position expressed in the
            # reception-epoch frame (the effect erotcorr.m undoes)
            from gps_sdr_tpu.geo.earth import earth_rotation_correction
            pos_rot = np.asarray(earth_rotation_correction(
                pos, tau * C_LIGHT))
            r = np.linalg.norm(pos_rot - self.usr, axis=-1)
            atm = (self._atmos_delay_s(pos_rot, t_rx_gps)
                   if self.atmosphere else 0.0)
            tau = r / C_LIGHT + atm
        clk = np.asarray(out["clk_m"]) / C_LIGHT - np.asarray(out["tgd_s"])
        return -dt_rx - tau + clk

    def generate_ms(self, ms_start: int, n_ms: int,
                    noise_std: float = 0.0, seed: int = 0) -> np.ndarray:
        """Complex IF samples for ms block [ms_start, ms_start+n_ms)."""
        sig = self.cfg.signal
        spm = sig.samples_per_ms
        n = n_ms * spm
        n0 = ms_start * spm
        # capture offsets of ms boundaries (receiver clock), exact in f64
        tau_b = (n0 + np.arange(n_ms + 1, dtype=np.float64) * spm) / sig.fs
        frac = np.arange(spm, dtype=np.float64)[None, :] / spm  # within-ms
        tau_n = (tau_b[:-1, None] * (1.0 - frac)
                 + tau_b[1:, None] * frac).reshape(-1)
        out = np.zeros(n, dtype=np.complex128)
        rebase = self.tow0 - self.msg_tow0  # ≤ 30 s, exact-ish
        for sv in self.svs:
            delta_b = self.sv_clock_delta(sv.prn, tau_b)  # (n_ms+1,)
            delta = (delta_b[:-1, None] * (1.0 - frac)
                     + delta_b[1:, None] * frac).reshape(-1)
            # SV-clock time since the start of the encoded message
            trel = rebase + tau_n + delta
            chips = ca_code(sv.prn).astype(np.float64)
            chip_phase = trel * sig.code_freq_basis
            code = chips[np.floor(chip_phase).astype(np.int64) % CODE_LENGTH]
            bits = self.bits[sv.prn]
            bit_idx = np.clip(np.floor(trel * 50.0).astype(np.int64),
                              0, len(bits) - 1)
            bit_pm = 1.0 - 2.0 * bits[bit_idx].astype(np.float64)
            # IF carrier phase: RF locked to the SV clock, downconverted by
            # an LO at (fc − IF) on the receiver clock:
            #   θ = 2π(fc·T_sv − (fc−IF)·t_rx) = 2π(fc·delta + f_if·t_rx)+c0
            cycles = sig.fc * delta + sig.f_if * tau_n
            theta = 2.0 * np.pi * np.mod(cycles, 1.0)
            out += sv.amplitude * code * bit_pm * _carrier_iq(theta)
        if noise_std > 0:
            rng = np.random.default_rng(seed + ms_start)
            out += (rng.normal(0.0, noise_std, n)
                    + 1j * rng.normal(0.0, noise_std, n))
        return out

    def write_file(self, path: str, duration_ms: int, noise_std: float = 0.0,
                   seed: int = 0, chunk_ms: int = 1000) -> None:
        """Stream the capture to an interleaved int8/int16 file.  The file
        appears under `path` only once it is complete.  Chunks are
        independent (noise is seeded per chunk start), so a few threads
        generate them at once — NumPy's array passes release the GIL."""
        from concurrent.futures import ThreadPoolExecutor

        from gps_sdr_tpu.utils.atomic import atomic_write

        dtype = np.int8 if self.cfg.file.data_precision == 1 else np.int16
        info = np.iinfo(dtype)

        def chunk(ms):
            iq = self.generate_ms(ms, min(chunk_ms, duration_ms - ms),
                                  noise_std, seed)
            vals = np.empty(2 * iq.size, dtype=np.float64)
            vals[0::2] = iq.real
            vals[1::2] = iq.imag
            return np.clip(np.round(vals), info.min, info.max).astype(dtype)

        workers = min(4, os.cpu_count() or 1)
        with atomic_write(path) as f, ThreadPoolExecutor(workers) as ex:
            for vals in ex.map(chunk, range(0, duration_ms, chunk_ms)):
                vals.tofile(f)

    def write_file_fast(self, path: str, duration_ms: int,
                        noise_std: float = 0.0, seed: int = 0,
                        chunk_ms: int = 100) -> None:
        """Jitted synthesis for LARGE captures (the 58 MHz e2e bench
        capture: `generate_ms`'s eager complex128 path runs ~1 M
        sample·SV/s, hours at 58 MHz × 40 s).

        Same signal model, reformulated around the fact that BOTH phase
        arguments are exactly linear within a ms (delta and tau are
        linearly interpolated between ms boundaries): per (SV, ms) the
        host computes the f64 boundary values and the jitted kernel
        evaluates carrier = e^{2πi·mod(c0+k·dc, 1)} (f64 mod, f32
        sin/cos — ≤6e-8 cycle error, far under the int8 quantization
        step) and the code/bit gathers in int32.  Noise uses JAX's
        threefry stream, so sample noise differs from `write_file`'s
        NumPy stream — use only where the capture itself is the product
        (benchmarks), not for golden comparisons.  Runs on the default
        device; the file appears under `path` only once it is complete."""
        import jax
        import jax.numpy as jnp

        from gps_sdr_tpu.utils.atomic import atomic_write

        sig = self.cfg.signal
        spm = sig.samples_per_ms
        dtype = np.int8 if self.cfg.file.data_precision == 1 else np.int16
        info = np.iinfo(dtype)
        rebase = self.tow0 - self.msg_tow0
        n_sv = len(self.svs)
        # f64 boundary chains, one light-time solve per ms boundary
        tau_b = np.arange(duration_ms + 1, dtype=np.float64) * (spm / sig.fs)
        cyc_b = np.empty((n_sv, duration_ms + 1))
        chp_b = np.empty((n_sv, duration_ms + 1))
        amps = np.array([sv.amplitude for sv in self.svs], np.float32)
        chips_tbl = np.stack([ca_code(sv.prn).astype(np.float32)
                              for sv in self.svs])
        max_bits = max(len(self.bits[sv.prn]) for sv in self.svs)
        bits_pm = np.zeros((n_sv, max_bits), np.float32)
        for i, sv in enumerate(self.svs):
            delta_b = self.sv_clock_delta(sv.prn, tau_b)
            cyc_b[i] = sig.fc * delta_b + sig.f_if * tau_b
            chp_b[i] = (rebase + tau_b + delta_b) * sig.code_freq_basis
            b = self.bits[sv.prn]
            bits_pm[i, :len(b)] = 1.0 - 2.0 * b.astype(np.float32)

        k = jnp.arange(spm, dtype=jnp.float64)

        @jax.jit
        def synth(c0, dc, p0, dp, key):
            # c0/dc/p0/dp: (n_sv, nm) f64 per-ms linear-phase params
            def one(c0v, dcv, p0v, dpv, tbl, bpm, amp):
                th = (2.0 * np.pi) * jnp.mod(
                    c0v[:, None] + k[None, :] * dcv[:, None], 1.0
                ).astype(jnp.float32)
                chip = jnp.floor(p0v[:, None] + k[None, :] * dpv[:, None])
                code = tbl[jnp.mod(chip, float(CODE_LENGTH)
                                   ).astype(jnp.int32)]
                bit = bpm[jnp.clip(chip / float(CODE_LENGTH * 20), 0,
                                   bpm.shape[0] - 1).astype(jnp.int32)]
                cb = amp * code * bit
                # carrier convention: sin θ + i·cos θ (_carrier_iq)
                return cb * jnp.sin(th), cb * jnp.cos(th)

            re, im = jax.vmap(one)(c0, dc, p0, dp, jnp.asarray(chips_tbl),
                                   jnp.asarray(bits_pm),
                                   jnp.asarray(amps))
            re, im = jnp.sum(re, 0), jnp.sum(im, 0)   # (nm, spm)
            if noise_std > 0:
                nz = noise_std * jax.random.normal(
                    key, (2,) + re.shape, jnp.float32)
                re, im = re + nz[0], im + nz[1]
            out = jnp.stack([re, im], axis=-1)        # (nm, spm, 2)
            return jnp.clip(jnp.round(out), info.min, info.max
                            ).astype(jnp.int8 if dtype == np.int8
                                     else jnp.int16)

        key0 = jax.random.PRNGKey(seed)
        with atomic_write(path) as f:
            for ms in range(0, duration_ms, chunk_ms):
                nm = min(chunk_ms, duration_ms - ms)
                sl = slice(ms, ms + nm)
                sl1 = slice(ms + 1, ms + nm + 1)
                c0 = jnp.asarray(cyc_b[:, sl])
                dc = jnp.asarray((cyc_b[:, sl1] - cyc_b[:, sl]) / spm)
                p0 = jnp.asarray(chp_b[:, sl])
                dp = jnp.asarray((chp_b[:, sl1] - chp_b[:, sl]) / spm)
                out = synth(c0, dc, p0, dp,
                            jax.random.fold_in(key0, ms))
                np.asarray(out).tofile(f)
