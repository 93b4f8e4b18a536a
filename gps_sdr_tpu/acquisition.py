"""FFT parallel code-phase acquisition.

A re-design of the reference's `acquisition.m`: instead of the
triple python loop (32 PRN × 20 blocks × 41 Doppler bins of 58k-point
FFTs, acquisition.m:47-61), the whole search grid is one jitted program —

  X[b,f]   = FFT(block_b · carrier_f)                 (batched over F)
  P[p,f,:] += |IFFT(C[p] · conj(X[b,f]))|²            (batched over p,f)

with a `lax.scan` over the non-coherent blocks (constant memory in B) and
an inner scan over PRN chunks (bounds the (chunk,F,S) complex transient).
The (P,F,S) power grid stays on device; only the per-PRN peak statistics
come back to host.  `parallel/acquisition.py` shards the PRN axis over a
device mesh.

Fine Doppler uses the reference's long-FFT method (acquisition.m:102-121):
strip the code over `L` ms at the acquired delay, zero-pad ×20, take the
spectrum peak.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from gps_sdr_tpu.config import ReceiverConfig
from gps_sdr_tpu.io.ifdata import IFSampleSource
from gps_sdr_tpu.ops.cacode import CODE_LENGTH, ca_code_table


@dataclasses.dataclass
class AcquisitionResult:
    """Equivalent of the reference's `Acquired` struct."""

    sv: np.ndarray                 # acquired PRNs (1-based)
    snr_db: np.ndarray
    doppler_hz: np.ndarray         # coarse Doppler (grid bin)
    code_delay: np.ndarray         # 0-based sample delay (acquisition.m:74)
    fine_freq_hz: np.ndarray       # absolute fine carrier freq (IF-relative
                                   # Doppler = fine_freq − IF)

    def channel_index(self, prn: int) -> int:
        return int(np.nonzero(self.sv == prn)[0][0])


def doppler_carriers(cfg: ReceiverConfig, n_samples: Optional[int] = None
                     ) -> np.ndarray:
    """(F, n) complex64 carrier grid exp(+i·2π(IF+fd)·k/fs), k=1..n
    (acquisition.m:41-44).  Phase accumulated in f64, wrapped, then cast."""
    sig, acq = cfg.signal, cfg.acq
    n = n_samples or sig.samples_per_ms
    k = np.arange(1, n + 1, dtype=np.float64)
    f = np.asarray(acq.doppler_bins_hz, dtype=np.float64) + sig.f_if
    cycles = np.mod(f[:, None] * k[None, :] / sig.fs, 1.0)
    return np.exp(2j * np.pi * cycles).astype(np.complex64)


def sampled_codes(cfg: ReceiverConfig, prns: Sequence[int]) -> np.ndarray:
    """(P, S) float32 code replicas at the sampling rate.

    scode[k] = code[ceil((k+1)·fchip/fs)] (acquisition.m:49-51).
    """
    sig = cfg.signal
    k = np.arange(1, sig.samples_per_ms + 1, dtype=np.float64)
    chip = (np.ceil(k * sig.code_freq_basis / sig.fs).astype(np.int64) - 1
            ) % CODE_LENGTH
    table = ca_code_table()
    return np.stack([table[p - 1][chip] for p in prns])


@functools.partial(jax.jit, static_argnames=("prn_chunk",))
def acquisition_power_grid(blocks: jnp.ndarray, carriers: jnp.ndarray,
                           code_fft: jnp.ndarray, prn_chunk: int = 8
                           ) -> jnp.ndarray:
    """Non-coherent power accumulation over the full search grid —
    circular-correlation formulation (exactly acquisition.m:53-61).

    blocks   (B, S) complex64 — B 1-ms sample blocks
    carriers (F, S) complex64 — Doppler carrier grid
    code_fft (P, S) complex64 — FFT of sampled code replicas
    returns  (P, F, S) float32 power, P padded to a multiple of prn_chunk
    """
    P, S = code_fft.shape
    F = carriers.shape[0]
    pad = (-P) % prn_chunk
    code_fft = jnp.pad(code_fft, ((0, pad), (0, 0)))
    codes = code_fft.reshape(-1, prn_chunk, S)

    def block_step(acc, x_ms):
        xc = jnp.conj(jnp.fft.fft(x_ms[None, :] * carriers, axis=-1))  # (F,S)

        def chunk_step(_, cf):
            y = jnp.fft.ifft(cf[:, None, :] * xc[None, :, :], axis=-1)
            return None, jnp.abs(y).astype(jnp.float32) ** 2

        _, pw = jax.lax.scan(chunk_step, None, codes)
        return acc + pw.reshape(P + pad, F, S), None

    acc0 = jnp.zeros((P + pad, F, S), jnp.float32)
    acc, _ = jax.lax.scan(block_step, acc0, blocks)
    return acc[:P]


@functools.partial(jax.jit, static_argnames=("chip_w",))
def _peak_statistics_device(power: jnp.ndarray, chip_w: int):
    """Device-side per-PRN peak pick + SNR — only (P,)-shaped statistics
    leave the device (the full grid can be hundreds of MB).

    SNR per acquisition.m:62-68: peak² over the mean squared off-peak
    power of the best frequency row, excluding ±1 chip around the peak.
    """
    P, F, S = power.shape
    flat = power.reshape(P, F * S)
    arg = jnp.argmax(flat, axis=1)
    fbin = arg // S
    delay = arg % S
    peak = jnp.take_along_axis(flat, arg[:, None], axis=1)[:, 0]
    row = power[jnp.arange(P), fbin]                     # (P, S)
    idx = jnp.arange(S)[None, :]
    keep = (idx <= delay[:, None] - chip_w) | (idx >= delay[:, None] + chip_w)
    mean_off = (jnp.sum(jnp.where(keep, row, 0.0) ** 2, axis=1)
                / jnp.sum(keep, axis=1))
    snr = 10.0 * jnp.log10(peak ** 2 / mean_off)
    return snr, fbin, delay


def peak_statistics(power_pf_s, cfg: ReceiverConfig):
    """Per-PRN (snr_db, best_freq_idx, code_delay) from the power grid."""
    chip_w = int(np.ceil(cfg.signal.fs / cfg.signal.code_freq_basis))
    snr, fbin, delay = _peak_statistics_device(jnp.asarray(power_pf_s),
                                               chip_w)
    return np.asarray(snr), np.asarray(fbin), np.asarray(delay)


def _fine_segment(long_signal: np.ndarray, prn: int, code_delay: int,
                  cfg: ReceiverConfig) -> np.ndarray:
    """Code-stripped fine-Doppler segment (acquisition.m:104-106)."""
    sig, acq = cfg.signal, cfg.acq
    S = sig.samples_per_ms
    n = acq.fine_fft_ms * S
    k = np.arange(1, n + 1, dtype=np.float64)
    # ceil-based resampling like the rest of the receiver; the reference's
    # floor((k·fchip)/fs)+1 (acquisition.m:104-105) agrees except when
    # fs/fchip is an exact integer ratio, where floor lands on chip
    # boundaries and misaligns the replica by one sample per chip.
    chip = (np.ceil(k * sig.code_freq_basis / sig.fs).astype(np.int64) - 1
            ) % CODE_LENGTH
    code = ca_code_table()[prn - 1][chip]
    # 0-based sample of the first code epoch after the first ms
    # (acquisition.m:106; validated against synthetic truth — the epoch
    # lands at S − codedelay in this pipeline's 0-based convention)
    start = S - int(code_delay)
    return np.asarray(long_signal[start:start + n],
                      dtype=np.complex64) * code


def _fine_freq_from_index(raw_idx: int, fftlen: int,
                          cfg: ReceiverConfig) -> float:
    """Spectrum-peak index → carrier frequency, with the reference's
    fftshift + sign-flip convention for IQ front ends
    (acquisition.m:109-119)."""
    fs = cfg.signal.fs
    if cfg.file.data_type == 2:
        idx = (raw_idx + fftlen // 2) % fftlen + 1  # fftshift map
        return float(-idx * (fs / fftlen) + fs / 2.0)
    return float((raw_idx + 1) * (fs / fftlen))


def fine_doppler(long_signal: np.ndarray, prn: int, code_delay: int,
                 cfg: ReceiverConfig) -> float:
    """Fine carrier frequency via the ×20 zero-padded long FFT
    (acquisition.m:102-121).  Resolution fs/(L·S·20) ≈ 5 Hz at 58 MHz.
    A host NumPy FFT: one spectrum per acquired SV."""
    seg = _fine_segment(long_signal, prn, code_delay, cfg)
    fftlen = seg.shape[0] * cfg.acq.n_noncoherent_ms
    spec = np.abs(np.fft.fft(seg, fftlen))
    return _fine_freq_from_index(int(np.argmax(spec)), fftlen, cfg)


def fine_doppler_batch(long_signal: np.ndarray, prns, code_delays,
                       cfg: ReceiverConfig) -> np.ndarray:
    """Fine Doppler for a batch of acquired SVs (one `fine_doppler` per
    SV)."""
    return np.array([fine_doppler(long_signal, int(p), int(d), cfg)
                     for p, d in zip(prns, code_delays)])


def run_acquisition(source: IFSampleSource, cfg: ReceiverConfig,
                    prns: Optional[Sequence[int]] = None,
                    power_fn=None) -> AcquisitionResult:
    """Full acquisition stage on one capture (acquisition.m end to end).

    `power_fn` overrides the grid computation (e.g. the mesh-sharded
    `parallel.acquisition.sharded_acquisition_power`); it is called as
    power_fn(blocks, carriers, code_fft) with the complex arrays of
    :func:`acquisition_power_grid`.
    """
    prns = list(prns if prns is not None else cfg.acq.prn_list)
    acq = cfg.acq
    S = cfg.signal.samples_per_ms
    start = cfg.file.skip_ms * S

    raw = source.read_complex(start, acq.n_noncoherent_ms * S)
    blocks = raw.reshape(acq.n_noncoherent_ms, S)
    carriers = doppler_carriers(cfg)
    code_fft = np.fft.fft(sampled_codes(cfg, prns)).astype(np.complex64)
    fn = power_fn if power_fn is not None else acquisition_power_grid
    power = fn(jnp.asarray(blocks), jnp.asarray(carriers),
               jnp.asarray(code_fft))
    snr, fbin, delay = peak_statistics(power, cfg)

    keep = snr >= acq.snr_threshold_db
    sv = np.asarray(prns)[keep]
    doppler = acq.freq_min + acq.freq_step * fbin[keep]
    code_delay = delay[keep]

    long_raw = source.read_complex(start, (acq.fine_fft_ms + 1) * S)
    fine = fine_doppler_batch(long_raw, sv, code_delay, cfg)
    return AcquisitionResult(sv=sv, snr_db=snr[keep], doppler_hz=doppler,
                             code_delay=code_delay, fine_freq_hz=fine)
