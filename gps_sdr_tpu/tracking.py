"""Scan-based DLL/PLL tracking engine.

The reference tracks each channel with a per-ms MATLAB loop doing a
variable-length `fread` whose size depends on the code NCO
(`numSample = round((1023·pdi − remChip)/(codeFreq/Fs))`, trackingCT.m:80)
— shapes change every iteration, which is XLA-hostile.  This engine is the
TPU-first reformulation promised in SURVEY.md §7.1:

- **Time is a `lax.scan`** over coherent-integration blocks; the loop
  carry holds the full per-channel NCO/loop-filter state.
- **Channels are a batch axis** (`vmap`): all N channels advance in
  lock-step through a shared device-resident sample chunk; each channel
  reads a *fixed-size* window with `dynamic_slice` and masks the tail
  beyond its data-dependent `numSample`.
- **NCOs are Q32 fixed-point accumulators** (like hardware receivers):
  carrier phase is an int32 that wraps exactly mod 2³² (= mod 1 cycle) and
  the code chip index is an int64 Q32 accumulator, so phase never loses
  precision over multi-minute captures — no float64 wideband arrays, the
  per-sample compute is all int32/float32.
- The multi-tap correlator bank is one (ntaps, BLK) × (BLK, 2) matmul per
  channel per block (batched over channels → MXU).

Loop behavior (discriminators, 2nd-order filters, update order, the
reference's stage-specific sign/offset quirks) matches the reference so
that its golden artifacts remain the parity target:
- trackingCT.m:137-150   DLL/PLL recurrences, codeFreq = basis − nco
- trackingCT_POS_updated.m:210-270  E/P/L from the 25-tap grid with the
  +0.05-chip prompt offset, codeFreq = basis + nco, ceil() block length
- trackingCT.m:447-449   negated correlator outputs in the 10 ms phase
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gps_sdr_tpu.config import ReceiverConfig
from gps_sdr_tpu.io.ifdata import IFSampleSource
from gps_sdr_tpu.ops.cacode import CODE_LENGTH, ca_code_table
from gps_sdr_tpu.ops.loops import loop_coefficients

Q32 = 4294967296.0  # 2**32


class TrackState(NamedTuple):
    """Per-channel tracking carry; every field is shape (N,)."""

    ptr: jnp.ndarray            # int64 absolute sample index of next block
    rem_chip: jnp.ndarray      # f64 code phase remainder [chips]
    code_freq: jnp.ndarray     # f64 [Hz]
    carr_freq: jnp.ndarray     # f64 [Hz]
    carr_freq_basis: jnp.ndarray  # f64 [Hz]
    phase_fp: jnp.ndarray      # int32 Q32 carrier phase fraction
    dll_nco: jnp.ndarray       # f64 loop filter accumulators
    dll_last: jnp.ndarray
    pll_nco: jnp.ndarray
    pll_last: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class TrackParams:
    """Static configuration of one tracking segment."""

    pdi_ms: int                    # coherent integration [ms]
    taps: Tuple[float, ...]        # correlator offsets [chips]
    i_early: int
    i_prompt: int
    i_late: int
    dll_freq_sign: float = -1.0    # codeFreq = basis + sign·nco
    negate_iq: bool = False        # the 10 ms eph phase negates outputs
    rounding: str = "round"        # numSample: "round" (trackingCT) or
                                   # "ceil" (POS/VT stages)
    dll_bw_hz: float = 2.0
    dll_damping: float = 0.707
    dll_gain: float = 0.1
    pll_bw_hz: float = 15.0
    pll_damping: float = 0.707
    pll_gain: float = 0.25
    loop_dt_s: float = 1e-3        # the reference integrates with 0.001
                                   # regardless of pdi except phase (b)
    remove_dc: bool = False        # int16 front-ends
    replica: str = "nco"           # "nco": exact per-sample Q32 chip
                                   # indexing (gather); "shift": nominal-
                                   # rate code table addressed by one
                                   # fractional block shift per tap —
                                   # contiguous slices + linear interp,
                                   # no gathers (the within-block code-
                                   # Doppler drift both neglect is < 0.2
                                   # samples per ms)

    def __post_init__(self):
        object.__setattr__(self, "replica", resolve_replica(self.replica))

    @staticmethod
    def epl(cfg: ReceiverConfig, pdi_ms: int = 1, **kw) -> "TrackParams":
        """trackingCT-style 3-tap [−d, 0, +d] configuration."""
        d = cfg.track.correlator_spacing
        defaults = dict(
            pdi_ms=pdi_ms, taps=(-d, 0.0, d), i_early=0, i_prompt=1,
            i_late=2, dll_freq_sign=-1.0,
            replica=cfg.track.replica,
            dll_bw_hz=cfg.track.dll_bw_hz, dll_damping=cfg.track.dll_damping,
            dll_gain=cfg.track.dll_gain, pll_bw_hz=cfg.track.pll_bw_hz,
            pll_damping=cfg.track.pll_damping, pll_gain=cfg.track.pll_gain,
            remove_dc=cfg.file.data_precision == 2)
        defaults.update(kw)
        return TrackParams(**defaults)

    @staticmethod
    def pos_epl(cfg: ReceiverConfig, pdi_ms: int = 1, **kw) -> "TrackParams":
        """CT-POS 3-tap configuration: taps (+0.5, +0.05, −0.5) with the
        prompt-offset quirk, ceil block length, codeFreq = basis + nco
        (trackingCT_POS_updated.m:210-217,262)."""
        d = cfg.track.correlator_spacing
        defaults = dict(
            pdi_ms=pdi_ms, taps=(d, 0.05, -d), i_early=0, i_prompt=1,
            i_late=2, dll_freq_sign=+1.0, rounding="ceil",
            replica=cfg.track.replica,
            dll_bw_hz=cfg.track.dll_bw_hz, dll_damping=cfg.track.dll_damping,
            dll_gain=cfg.track.dll_gain, pll_bw_hz=cfg.track.pll_bw_hz,
            pll_damping=cfg.track.pll_damping, pll_gain=cfg.track.pll_gain,
            remove_dc=cfg.file.data_precision == 2)
        defaults.update(kw)
        return TrackParams(**defaults)

    @staticmethod
    def pos_multicorr(cfg: ReceiverConfig, pdi_ms: int = 1, **kw
                      ) -> "TrackParams":
        """25-tap grid 0.6:−0.05:−0.6 (trackingCT_POS_updated.m:42);
        loop closes on the ±0.5/P taps (indices 2/12/22), with the
        +0.05-chip prompt quirk folded into the prompt tap."""
        grid = [round(0.6 - 0.05 * i, 4) for i in range(25)]
        grid[12] = 0.05
        defaults = dict(
            pdi_ms=pdi_ms, taps=tuple(grid), i_early=2, i_prompt=12,
            i_late=22, dll_freq_sign=+1.0, rounding="ceil",
            replica=cfg.track.replica,
            dll_bw_hz=cfg.track.dll_bw_hz, dll_damping=cfg.track.dll_damping,
            dll_gain=cfg.track.dll_gain, pll_bw_hz=cfg.track.pll_bw_hz,
            pll_damping=cfg.track.pll_damping, pll_gain=cfg.track.pll_gain,
            remove_dc=cfg.file.data_precision == 2)
        defaults.update(kw)
        return TrackParams(**defaults)


@jax.jit
def _stage_raw(raw_vals: jnp.ndarray) -> jnp.ndarray:
    """Device-side int→f32 cast of raw interleaved int IQ values (L, 2),
    so the host ships native int8/int16 (io/ifdata.read_iq_values)."""
    return raw_vals.astype(jnp.float32)


REPLICAS = ("nco", "shift")


def resolve_replica(mode: str) -> str:
    """Correlator replica engine: "auto" → the exact Q32 "nco" replica;
    "nco" and "shift" select themselves.  The TPU-only "pallas" and
    "fused" kernels were removed."""
    if mode == "auto":
        return "nco"
    if mode in ("pallas", "fused"):
        raise ValueError(f"replica={mode!r} was removed: it was a TPU-only "
                         "kernel; use 'auto', 'nco' or 'shift'")
    if mode not in REPLICAS:
        raise ValueError(f"unknown replica {mode!r}; use 'auto', 'nco' or "
                         "'shift'")
    return mode


def init_track_state(cfg: ReceiverConfig, code_delays: np.ndarray,
                     fine_freqs: np.ndarray) -> TrackState:
    """Initial state from acquisition results.

    File-pointer convention matches trackingCT.m:63 /
    trackingCT_POS_updated.m:108-110: start at absolute sample
    skip·S + S − codedelay + 1.
    """
    S = cfg.signal.samples_per_ms
    n = len(code_delays)
    ptr0 = (cfg.file.skip_ms * S + S - np.asarray(code_delays, np.int64) + 1)
    z = np.zeros(n, dtype=np.float64)
    return TrackState(
        ptr=jnp.asarray(ptr0, jnp.int64),
        rem_chip=jnp.asarray(z),
        code_freq=jnp.full(n, cfg.signal.code_freq_basis, jnp.float64),
        carr_freq=jnp.asarray(fine_freqs, jnp.float64),
        carr_freq_basis=jnp.asarray(fine_freqs, jnp.float64),
        phase_fp=jnp.zeros(n, jnp.int32),
        dll_nco=jnp.asarray(z), dll_last=jnp.asarray(z),
        pll_nco=jnp.asarray(z), pll_last=jnp.asarray(z),
    )


def build_shift_tables(cfg: ReceiverConfig, prns, blk: int):
    """(N, T_len) nominal-rate sampled code tables for replica="shift".

    T[m] = chips[(ceil((m − margin)·fchip/fs) − 1) mod 1023]: the code at
    sample offset (m − margin) from a block start at zero code phase.
    """
    spc = cfg.signal.fs / cfg.signal.code_freq_basis
    margin = int(np.ceil(2.5 * spc))
    t_len = blk + 2 * margin + 8
    m = np.arange(t_len, dtype=np.float64) - margin
    chip_idx = (np.ceil(m * (1.0 / spc)).astype(np.int64) - 1) % CODE_LENGTH
    tables = np.stack([ca_code_table()[p - 1][chip_idx] for p in prns])
    return tables.astype(np.float32), margin


def correlate_block(raw: jnp.ndarray, chunk_start, ptr, rem_chip, code_freq,
                    carr_freq, phase_fp, chips: jnp.ndarray,
                    taps: jnp.ndarray, fs: float, n_chips: int, blk: int,
                    rounding: str, remove_dc: bool, num=None,
                    replica_mode: str = "nco", margin: int = 0,
                    code_freq_basis: float = 1.023e6):
    """One channel × one coherent block: fixed-shape correlator bank.

    If `num` is given, the block length is externally imposed (the VT loop
    sizes the read with the *previous* predicted code frequency while the
    replica steps at the new one, trackingVT_POS_updated.m:164,227).
    Returns (corr (ntaps,2) [I,Q], num_sample, new rem_chip, new phase_fp).
    """
    step = code_freq / fs
    if num is None:
        n_exact = (n_chips - rem_chip) / step
        num = (jnp.ceil(n_exact) if rounding == "ceil"
               else jnp.round(n_exact)).astype(jnp.int64)
    offset = (ptr - chunk_start).astype(jnp.int32)
    # raw is (L, 2) float32 [re, im]: the capture's interleaved I/Q
    x = jax.lax.dynamic_slice(raw, (offset, jnp.int32(0)), (blk, 2))
    k = jnp.arange(blk, dtype=jnp.int32)
    mask = (k < num.astype(jnp.int32))[:, None]
    x = jnp.where(mask, x, 0.0)
    num_f = num.astype(jnp.float64)
    if remove_dc:
        dc = (jnp.sum(x, axis=0) / num_f.astype(jnp.float32))[None, :]
        x = jnp.where(mask, x - dc, 0.0)

    # carrier mix — Q32 phase accumulator, exact wrap mod one cycle.
    # θ_k = θ_q + θ_r with k = 128·q + r, both phases exact in Q32, and
    # the carrier formed as a phasor outer product: 455+128 sin/cos
    # evaluations instead of 58k per block.
    carr_fp = jnp.round(carr_freq / fs * Q32).astype(jnp.int64).astype(jnp.int32)
    nq = blk // 128
    to_rad = jnp.float32(2.0 * jnp.pi / Q32)
    phq = (phase_fp + jnp.arange(nq, dtype=jnp.int32) * (carr_fp * 128)
           ).astype(jnp.float32) * to_rad
    phr = (jnp.arange(128, dtype=jnp.int32) * carr_fp
           ).astype(jnp.float32) * to_rad
    uc, us = jnp.cos(phq), jnp.sin(phq)
    vc, vs = jnp.cos(phr), jnp.sin(phr)
    c = (uc[:, None] * vc[None, :] - us[:, None] * vs[None, :]).reshape(blk)
    s = (uc[:, None] * vs[None, :] + us[:, None] * vc[None, :]).reshape(blk)
    xr, xi = x[:, 0], x[:, 1]
    # mixed = x·e^{iθ}: I = imag = xr·s + xi·c, Q = real = xr·c − xi·s
    # (trackingCT.m:113: Inphase = imag(raw·carrsig))
    iq = jnp.stack([xr * s + xi * c, xr * c - xi * s], axis=-1)

    if replica_mode == "shift":
        # chips is a (T_len,) nominal-rate sampled table with `margin`
        # lead-in samples; position each tap by one fractional shift
        step_nom = code_freq_basis / fs
        pos = margin + (rem_chip + taps) / step_nom           # (ntaps,) f64
        i0 = jnp.floor(pos).astype(jnp.int32)
        frac = (pos - jnp.floor(pos)).astype(jnp.float32)

        def tap_slice(i):
            return jax.lax.dynamic_slice(chips, (i,), (blk + 1,))

        sl = jax.vmap(tap_slice)(i0)                          # (ntaps, blk+1)
        code_vals = sl[:, :blk] * (1.0 - frac)[:, None] \
            + sl[:, 1:] * frac[:, None]
    else:
        # exact Q32 chip-index accumulator; chip = (ceil(t)−1) mod 1023
        step_fp = jnp.round(step * Q32).astype(jnp.int64)
        base_fp = jnp.round(rem_chip * Q32).astype(jnp.int64)
        tap_fp = jnp.round(taps * Q32).astype(jnp.int64)      # (ntaps,)
        idx = ((base_fp + tap_fp)[:, None]
               + k.astype(jnp.int64)[None, :] * step_fp - 1) >> 32
        chip_idx = jnp.remainder(idx, CODE_LENGTH).astype(jnp.int32)
        code_vals = chips[chip_idx]                           # (ntaps, blk)
    # HIGHEST: a memory-bound matrix-vector product, so a TF32 pass on
    # the GPU would buy no time and cost agreement with the f32 reference
    corr = jnp.einsum("tb,bc->tc", code_vals, iq,
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)

    rem_chip_new = num_f * step + rem_chip - n_chips
    phase_new = phase_fp + (num.astype(jnp.int32)) * carr_fp
    return corr, num, rem_chip_new, phase_new


@functools.partial(
    jax.jit,
    static_argnames=("params", "n_steps", "fs", "blk", "code_freq_basis",
                     "margin"))
def track_scan(raw: jnp.ndarray, chunk_start: jnp.ndarray, state: TrackState,
               chip_tables: jnp.ndarray, params: TrackParams, n_steps: int,
               fs: float, blk: int, code_freq_basis: float = 1.023e6,
               margin: int = 0):
    """Track all channels for `n_steps` coherent blocks within one chunk.

    raw          (L, 2) float32 [re, im] chunk shared by all channels,
                 or (N, L, 2) per-channel windows (time-segmented
                 tracking, where channel pointers span the whole capture)
    chunk_start  int64 absolute sample index of raw[0] — scalar, or (N,)
                 when raw is per-channel
    chip_tables  (N, 1023) float32 for replica="nco"; the
                 build_shift_tables layout for "shift"
    Returns (new_state, records) with records as (T, N, ...) arrays.
    """
    n_chips = CODE_LENGTH * params.pdi_ms
    taps = jnp.asarray(params.taps, jnp.float64)
    tau1c, tau2c = loop_coefficients(params.dll_bw_hz, params.dll_damping,
                                     params.dll_gain)
    tau1r, tau2r = loop_coefficients(params.pll_bw_hz, params.pll_damping,
                                     params.pll_gain)
    dt = params.loop_dt_s
    sign = params.negate_iq and -1.0 or 1.0
    raw_axis = 0 if raw.ndim == 3 else None
    fn = functools.partial(
        correlate_block, taps=taps, fs=fs, n_chips=n_chips, blk=blk,
        rounding=params.rounding, remove_dc=params.remove_dc,
        replica_mode=params.replica, margin=margin,
        code_freq_basis=code_freq_basis)
    correlate = jax.vmap(fn, in_axes=(raw_axis, raw_axis, 0, 0, 0, 0, 0, 0))

    def scan_step(st: TrackState, _):
        corr, num, rem_new, phase_new = correlate(
            raw, chunk_start, st.ptr, st.rem_chip, st.code_freq,
            st.carr_freq, st.phase_fp, chip_tables)
        corr = corr * jnp.float32(sign)                 # (N, ntaps, 2)
        e_i, e_q = corr[:, params.i_early, 0], corr[:, params.i_early, 1]
        p_i, p_q = corr[:, params.i_prompt, 0], corr[:, params.i_prompt, 1]
        l_i, l_q = corr[:, params.i_late, 0], corr[:, params.i_late, 1]

        e = jnp.sqrt(e_i * e_i + e_q * e_q).astype(jnp.float64)
        l = jnp.sqrt(l_i * l_i + l_q * l_q).astype(jnp.float64)
        code_err = 0.5 * (e - l) / jnp.maximum(e + l, 1e-30)
        dll = st.dll_nco + (tau2c / tau1c) * (code_err - st.dll_last) \
            + code_err * (dt / tau1c)
        # codeFreq = basis + sign·nco (trackingCT.m:143 vs
        # trackingCT_POS_updated.m:262)
        code_freq_new = code_freq_basis + params.dll_freq_sign * dll

        safe_pi = jnp.where(p_i == 0, 1e-30, p_i)
        carr_err = (jnp.arctan(p_q / safe_pi) / (2.0 * jnp.pi)
                    ).astype(jnp.float64)
        pll = st.pll_nco + (tau2r / tau1r) * (carr_err - st.pll_last) \
            + carr_err * (dt / tau1r)
        carr_freq_new = st.carr_freq_basis + pll

        ptr_new = st.ptr + num
        rec = dict(corr=corr, code_err=code_err, carr_err=carr_err,
                   code_freq=code_freq_new, carr_freq=carr_freq_new,
                   num_sample=num, rem_chip=rem_new,
                   rem_phase=jnp.remainder(
                       phase_new.astype(jnp.float64) * (2.0 * jnp.pi / Q32),
                       2.0 * jnp.pi),
                   absolute_sample=ptr_new)
        new_st = TrackState(
            ptr=ptr_new, rem_chip=rem_new, code_freq=code_freq_new,
            carr_freq=carr_freq_new, carr_freq_basis=st.carr_freq_basis,
            phase_fp=phase_new, dll_nco=dll, dll_last=code_err,
            pll_nco=pll, pll_last=carr_err)
        return new_st, rec

    new_state, records = jax.lax.scan(scan_step, state, None, length=n_steps)
    return new_state, records


def state_from_records(records: "TrackRecords", rows: np.ndarray,
                       carr_freq_basis: np.ndarray,
                       dll_freq_sign: float = -1.0,
                       code_freq_basis: float = 1.023e6) -> TrackState:
    """Reconstruct the scan carry as it was after record row `rows[ch]`
    of each channel.

    The per-block records determine the full loop state: the Q32 phase
    round-trips exactly through rem_phase, and the loop-filter
    accumulators invert from the recorded frequencies
    (codeFreq = basis + sign·dll ⇒ dll = sign·(codeFreq − basis);
    carrFreq = carrBasis + pll).  This lets batched scans resume at
    *per-channel* time offsets — the reference instead re-tracks each
    channel separately (trackingCT.m:215-369)."""
    n = records.absolute_sample.shape[1]
    sel = (np.asarray(rows, np.int64), np.arange(n))
    code_freq = records.code_freq[sel]
    carr_freq = records.carr_freq[sel]
    basis = np.asarray(carr_freq_basis, np.float64)
    phase_fp = (np.round(records.rem_phase[sel] / (2.0 * np.pi) * Q32)
                .astype(np.int64).astype(np.int32))
    return TrackState(
        ptr=jnp.asarray(records.absolute_sample[sel], jnp.int64),
        rem_chip=jnp.asarray(records.rem_chip[sel]),
        code_freq=jnp.asarray(code_freq),
        carr_freq=jnp.asarray(carr_freq),
        carr_freq_basis=jnp.asarray(basis),
        phase_fp=jnp.asarray(phase_fp),
        dll_nco=jnp.asarray(dll_freq_sign * (code_freq - code_freq_basis)),
        dll_last=jnp.asarray(records.code_err[sel]),
        pll_nco=jnp.asarray(carr_freq - basis),
        pll_last=jnp.asarray(records.carr_err[sel]))


@dataclasses.dataclass
class TrackRecords:
    """Struct-of-arrays tracking log, (T, N) per field — the reference's
    TckResult struct transposed (trackingCT.m:153-170)."""

    corr: np.ndarray           # (T, N, ntaps, 2) I/Q correlator bank
    code_err: np.ndarray
    carr_err: np.ndarray
    code_freq: np.ndarray
    carr_freq: np.ndarray
    num_sample: np.ndarray
    rem_chip: np.ndarray
    rem_phase: np.ndarray
    absolute_sample: np.ndarray
    i_early: int = 0
    i_prompt: int = 1
    i_late: int = 2

    @property
    def p_i(self):
        return self.corr[:, :, self.i_prompt, 0]

    @property
    def p_q(self):
        return self.corr[:, :, self.i_prompt, 1]

    @property
    def e_i(self):
        return self.corr[:, :, self.i_early, 0]

    @property
    def l_i(self):
        return self.corr[:, :, self.i_late, 0]

    @staticmethod
    def concatenate(parts):
        return TrackRecords(*[np.concatenate([getattr(p, f) for p in parts])
                              for f in ("corr", "code_err", "carr_err",
                                        "code_freq", "carr_freq",
                                        "num_sample", "rem_chip", "rem_phase",
                                        "absolute_sample")],
                            i_early=parts[0].i_early,
                            i_prompt=parts[0].i_prompt,
                            i_late=parts[0].i_late)


def run_tracking(source: IFSampleSource, cfg: ReceiverConfig, prns,
                 state: TrackState, params: TrackParams, n_ms: int,
                 chunk_ms: int = 1000, per_channel_io: bool = False,
                 mesh=None) -> Tuple[TrackRecords, TrackState]:
    """Host driver: stream chunks to device, run the jitted scan per chunk.

    `prns` orders the channels; `state` comes from `init_track_state` or a
    previous segment (the 3-phase eph schedule chains segments).

    `mesh` (a jax.sharding.Mesh) shards the channel axis over devices
    (SURVEY.md §2.9 per-channel parallelism): channels are padded to a
    multiple of the mesh size (duplicates of channel 0, dropped from the
    output), per-channel arithmetic is unchanged, so records are
    bit-identical to the single-device scan.
    """
    S = cfg.signal.samples_per_ms
    fs = float(cfg.signal.fs)
    # blk multiple of 128: the carrier outer-product factorization needs it
    blk = -(-(S * params.pdi_ms + 256) // 128) * 128
    margin = 0
    if params.replica == "shift":
        chip_tables, margin = build_shift_tables(cfg, prns, blk)
        chip_tables = jnp.asarray(chip_tables)
    else:
        chip_tables = jnp.asarray(
            np.stack([ca_code_table()[p - 1] for p in prns]), jnp.float32)

    if len(prns) == 0:
        raise ValueError("no channels to track (empty PRN list)")
    # fail fast when the capture is too short (the reference prints
    # 'Not enough raw data' and aborts, trackingCT.m:108-112)
    need = int(np.max(np.asarray(state.ptr))) + (n_ms + 2) * S
    if need > source.n_samples:
        raise ValueError(
            f"capture too short: tracking {n_ms} ms needs ~{need} samples, "
            f"file has {source.n_samples}")
    n_blocks_total = n_ms // params.pdi_ms
    blocks_per_chunk = max(1, chunk_ms // params.pdi_ms)
    if mesh is not None and per_channel_io:
        import warnings
        warnings.warn(
            "run_tracking: mesh is ignored with per_channel_io=True "
            "(per-channel raw windows are host-gathered; the sharded "
            "scan needs one replicated chunk) — running single-device",
            stacklevel=2)
    use_mesh = (mesh is not None and getattr(mesh, "size", 1) > 1
                and not per_channel_io)
    n_pad = 0
    if use_mesh:
        from gps_sdr_tpu.parallel.tracking import (pad_channels,
                                                   sharded_track_scan)
        state, chip_tables, n_pad = pad_channels(state, chip_tables,
                                                 mesh.size)
        sharded_fns: Dict[int, object] = {}
    # host ships the native ints (a quarter of the f32 bytes); the cast
    # happens on device (_stage_raw)
    read_fn = source.read_iq_values
    # overlap the next chunk's host-side read with the device scan of
    # the current one (the scan dispatch is async; SURVEY.md §2.9 PP)
    prefetcher = None
    if not per_channel_io:
        from gps_sdr_tpu.io.ifdata import ChunkPrefetcher
        prefetcher = ChunkPrefetcher(read_fn, slice_axis=0)
    parts = []
    done = 0
    try:
        while done < n_blocks_total:
            nb = min(blocks_per_chunk, n_blocks_total - done)
            ptrs = np.asarray(state.ptr)
            ptr_min = int(np.min(ptrs))
            ptr_max = int(np.max(ptrs))
            win = nb * params.pdi_ms * S + blk + 64
            if per_channel_io:
                # channels far apart (time-segmented): per-channel windows
                raw = jnp.asarray(np.stack([
                    source.read_iq_pairs(int(p), win, remove_dc=False)
                    for p in ptrs]))
                start = jnp.asarray(ptrs, jnp.int64)
            else:
                length = (ptr_max - ptr_min) + win
                raw = _stage_raw(jnp.asarray(prefetcher.fetch(
                    ptr_min, length)))
                start = jnp.int64(ptr_min)
            if use_mesh:
                fn = sharded_fns.get(nb)
                if fn is None:
                    fn = sharded_track_scan(
                        mesh, params, nb, fs, blk,
                        float(cfg.signal.code_freq_basis), margin)
                    sharded_fns[nb] = fn
                state, rec = fn(raw, start, state, chip_tables)
            else:
                state, rec = track_scan(raw, start, state, chip_tables,
                                        params, nb, fs, blk,
                                        float(cfg.signal.code_freq_basis),
                                        margin)
            if n_pad:
                rec = {k: v[:, :-n_pad] for k, v in rec.items()}
            nb_next = min(blocks_per_chunk, n_blocks_total - done - nb)
            if prefetcher is not None and nb_next > 0:
                # pointers advance by ~nb·pdi·S with ≤ tens of samples of
                # code-Doppler drift; 2·S of slack each side covers it
                adv = nb * params.pdi_ms * S
                prefetcher.prefetch(
                    ptr_min + adv - 2 * S,
                    (ptr_max - ptr_min)
                    + nb_next * params.pdi_ms * S + blk + 64 + 4 * S)
            parts.append(TrackRecords(
                corr=np.asarray(rec["corr"]),
                code_err=np.asarray(rec["code_err"]),
                carr_err=np.asarray(rec["carr_err"]),
                code_freq=np.asarray(rec["code_freq"]),
                carr_freq=np.asarray(rec["carr_freq"]),
                num_sample=np.asarray(rec["num_sample"]),
                rem_chip=np.asarray(rec["rem_chip"]),
                rem_phase=np.asarray(rec["rem_phase"]),
                absolute_sample=np.asarray(rec["absolute_sample"]),
                i_early=params.i_early, i_prompt=params.i_prompt,
                i_late=params.i_late))
            done += nb
    finally:
        if prefetcher is not None:
            prefetcher.close()
    if n_pad:
        state = TrackState(*[f[:-n_pad] for f in state])
    return TrackRecords.concatenate(parts), state
