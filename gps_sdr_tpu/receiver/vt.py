"""Vector tracking + 8-state EKF positioning (VDFLL).

A re-design of the reference's `trackingVT_POS_updated.m`: the
entire vector loop — per-channel correlators, nav-solution-driven code
NCOs, scalar PLLs, SV ephemeris evaluation, atmospheric corrections, and
the error-state EKF that couples all channels — is ONE `lax.scan` over ms
blocks, jitted end to end.  Per step:

1. block length from the *predicted* code frequency (ceil, …:164)
2. transmitTime += numSample/fs (…:181)
3. SV pos/vel/clock at transmit time — full Kepler once per
   `kepler_update_ms` group head, velocity + central-gravity
   extrapolation between (the reference re-solves per ms, …:185)
4. predicted pseudorange with clock/Sagnac/iono/tropo corrections
   (…:208-215) — full f64 chain at the group head, linearized f32
   delta terms per step (error budget in kepler_refresh); iono/tropo
   refreshed every 100 ms (…:84-86,190-204)
5. **vector loop closure**: codeFreq = f0·(1 − ΔPr/(c·Δt)) — the code NCO
   is driven by the navigation solution, not a local DLL (…:218-223)
6. fixed-shape E/P/L correlator bank (tracking.correlate_block)
7. scalar Costas PLL per channel (…:307-313)
8. code discriminator → pseudorange-error measurement
   Z_pr = δτ·c/codeFreq (…:316-321); carrier → pseudorange-rate
   measurement (physically-signed; see note below) (…:379-382)
9. EKF predict/update on the 8-state error vector
   [δp(3) δv(3) δb δḃ] in f64 (covariance symmetrized each step),
   total-state feedback + propagation (…:388-442)
10. adaptive measurement noise from innovation variance every 200 ms with
    the reference's clamps (…:445-467)

Sign note: the reference computes prr_measured = (carrFreq+IF)·c/Fc
(…:380), which embeds a front-end-specific convention; this implementation
uses +(carrFreq − IF)·c/fc, which matches prr_pred = a·(Vest−Vs) = −ṙ and
the H rows [0 −a 0 1] for any IF (derivation at the prr_meas assignment).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gps_sdr_tpu.config import C_LIGHT, ReceiverConfig
from gps_sdr_tpu.geo.atmosphere import klobuchar_delay, tropo_unb3_delay
from gps_sdr_tpu.geo.coords import xyz2enu, xyz2llh
from gps_sdr_tpu.geo.earth import earth_rotation_correction
from gps_sdr_tpu.geo.ephemeris import Ephemeris, sv_pos_vel_clock
from gps_sdr_tpu.io.ifdata import IFSampleSource
from gps_sdr_tpu.ops.cacode import ca_code_table
from gps_sdr_tpu.ops.loops import loop_coefficients
from gps_sdr_tpu.tracking import Q32, TrackRecords, correlate_block


class VTState(NamedTuple):
    """Vector-tracking scan carry."""

    # per-channel signal state, shape (N,)
    ptr: jnp.ndarray
    rem_chip: jnp.ndarray
    code_freq: jnp.ndarray
    carr_freq: jnp.ndarray
    carr_freq_basis: jnp.ndarray
    phase_fp: jnp.ndarray
    pll_nco: jnp.ndarray
    pll_last: jnp.ndarray
    transmit_time: jnp.ndarray     # f64 SV transmit time [s of week]
    predicted_pr_last: jnp.ndarray
    iono_m: jnp.ndarray            # cached corrections
    tropo_m: jnp.ndarray
    el_rad: jnp.ndarray
    az_rad: jnp.ndarray
    # EKF state
    total_state: jnp.ndarray       # (8,) [pos, vel, clk_bias_m, clk_drift_ms]
    state_cov: jnp.ndarray         # (8,8)
    r_diag: jnp.ndarray            # (2N,) measurement noise diagonal
    innov_sq_sum: jnp.ndarray      # (2N,) running Z² for adaptive R
    step_count: jnp.ndarray        # int32 scalar
    # measurement-validity gate (SURVEY.md §5): moment-method window over
    # the prompt powers; channels whose post-correlation SNR averaged
    # over the last 5 windows falls below params.mask_snr_db have their
    # pr/prr rows deweighted out of the EKF update (threshold rationale:
    # utils/metrics.cn0_series gate note)
    zk: jnp.ndarray                # (N, K) prompt-power window
    snr_hist: jnp.ndarray          # (N, 5) last window SNRs [dB]
    cn0: jnp.ndarray               # (N,) latest C/N0 estimate [dB-Hz]
    valid: jnp.ndarray             # (N,) bool gate


@dataclasses.dataclass(frozen=True)
class VTParams:
    pdi_ms: int = 1
    taps: Tuple[float, ...] = (0.5, 0.0, -0.5)  # VT E/P/L (…:230-232)
    i_early: int = 0
    i_prompt: int = 1
    i_late: int = 2
    pll_bw_hz: float = 15.0
    pll_damping: float = 0.707
    pll_gain: float = 0.25
    corr_update_ms: int = 100       # iono/tropo cadence (…:84-86)
    r_update_ms: int = 200          # adaptive-R cadence (…:63)
    q_pos: float = 1.0              # process noise (…:51-54)
    q_vel: float = 0.1
    q_clk: float = 0.1
    q_clkd: float = 0.01
    r_pr0: float = 0.3              # initial R (…:55-56)
    r_prr0: float = 0.1
    r_pr_max: float = 12000.0       # clamps (…:451-463)
    r_prr_max: float = 400.0
    r_min: float = 0.01
    remove_dc: bool = False
    mask_snr_db: float = 1.0        # post-corr SNR gate (mean of last 5
                                    # windows; utils/metrics.cn0_series
                                    # gate note); 0 disables
    cn0_window: int = 20            # K of the Zk window (trackingCT.m:120)
    r_masked: float = 1e8           # R inflation for gated-out channels —
                                    # an effective no-op deweighting (gain
                                    # contribution ≲1e-8) kept ≤1e8 so the
                                    # innovation-covariance solve stays
                                    # well conditioned even with
                                    # r_min=0.01 (cond(S) ≲ 1e10)
    kepler_update_ms: int = 50      # full Kepler cadence: SV pos/vel/clock
                                    # solved every K ms and extrapolated
                                    # along velocity + central-gravity
                                    # acceleration between (≤1e-7 m over
                                    # 50 ms vs ~0.6 m/s² SV acceleration;
                                    # the reference re-solves per ms,
                                    # trackingVT_POS_updated.m:185).
                                    # 1 = exact per-ms solve

    @staticmethod
    def legacy(**kw) -> "VTParams":
        """The legacy total-state VT (trackingVT_POS.m): fixed
        measurement noise (no adaptive-R machinery, R_pr=1e-1,
        R_prr=1e-2, trackingVT_POS.m:75-76) and the 1e1-scaled process
        noise (:74).  Its per-ms total-state update — state re-seeded
        as [0,0,0,v,0,ḋ], delta added to pos/clock, vel/drift
        overwritten (:375-387) — is algebraically the error-state
        update this engine runs, so the same scan covers both
        formulations; only the noise model and 3000 ms run length
        differ (:37)."""
        defaults = dict(r_pr0=1e-1, r_prr0=1e-2,
                        r_update_ms=1 << 30,       # adaptive R off
                        q_pos=1.0, q_vel=0.1, q_clk=100.0, q_clkd=10.0)
        defaults.update(kw)
        return VTParams(**defaults)

    @staticmethod
    def multicorr(**kw) -> "VTParams":
        """29-tap grid 0.7:-0.05:-0.7 with the loop on ±0.5/P taps
        (trackingVT_POS_updated.m:29,230-232; multicorrelator variant
        records the full bank, trackingVT_POS_updated_multicorrelator.m)."""
        grid = tuple(round(0.7 - 0.05 * i, 4) for i in range(29))
        defaults = dict(taps=grid, i_early=4, i_prompt=14, i_late=24)
        defaults.update(kw)
        return VTParams(**defaults)


@functools.partial(jax.jit, static_argnames=(
    "params", "n_steps", "fs", "blk", "f_if", "fc", "code_freq_basis",
    "doy", "axis_name", "n_real", "ablate"))
def vt_scan(raw, chunk_start, state: VTState, chip_tables, eph: Ephemeris,
            iono_alpha, iono_beta, params: VTParams, n_steps: int, fs: float,
            blk: int, f_if: float, fc: float, code_freq_basis: float,
            doy: int, axis_name: str = None,
            n_real: int = None, ablate: str = ""):
    """Run `n_steps` ms of vector tracking inside one raw chunk.

    The correlators vmap the exact Q32 replica over channels (raw is
    (L, 2) float32 pairs, chip_tables (N, 1023)).

    `axis_name` (set by parallel/vt.sharded_vt_scan, which wraps this in
    shard_map) runs the scan with the CHANNEL axis sharded over a device
    mesh: all per-channel work — correlators, NCOs, scalar PLLs, Kepler,
    atmosphere — stays device-local, and each step all-gathers only the
    per-channel measurement contributions (unit line-of-sight rows at
    the group head; z_pr/z_prr/validity per ms — ~10 floats/channel)
    so every device applies the IDENTICAL replicated 8-state EKF
    update (trackingVT_POS_updated.m:388-404, the coupled update,
    distributed).  `n_real` is the global channel count before padding
    (padding channels, appended last, are sliced off the gather so they
    contribute nothing); results are bit-identical to the single-device
    scan at any device count (tests/test_mesh_pipeline.py).

    `ablate` is a BENCH-ONLY diagnostic (bench.py's VT per-phase
    breakdown) — it zeroes a stage's outputs
    so XLA dead-code-eliminates that stage's ops, isolating its wall
    cost by subtraction: "no_ekf" removes the gain/solve/Joseph chain,
    "no_geom" additionally removes the predicted-pseudorange/Kepler
    delta chain (the code NCO freezes), "corr_only" leaves only the
    correlator + PLL.  Never set in production paths."""
    n_ch = state.ptr.shape[0]         # LOCAL channels (global/D if sharded)
    if axis_name is None:
        n_real = n_ch

        def gather(x):
            return x
    else:
        if n_real is None:
            raise ValueError("sharded vt_scan needs n_real")

        def gather(x):
            return jax.lax.all_gather(x, axis_name, tiled=True)[:n_real]
    taps = jnp.asarray(params.taps, jnp.float64)
    tau1, tau2 = loop_coefficients(params.pll_bw_hz, params.pll_damping,
                                   params.pll_gain)
    dt = params.pdi_ms * 1e-3
    n_chips = 1023 * params.pdi_ms

    F = jnp.eye(8, dtype=jnp.float64)
    F = F.at[0, 3].set(dt).at[1, 4].set(dt).at[2, 5].set(dt).at[6, 7].set(dt)
    Qn = jnp.diag(jnp.asarray(
        [params.q_pos] * 3 + [params.q_vel] * 3
        + [params.q_clk, params.q_clkd], jnp.float64))
    # the EKF runs in f64: at the warm start S is ~1e7-conditioned, where
    # f32 gains differ between backends by metres of state correction
    state = state._replace(
        state_cov=state.state_cov.astype(jnp.float64),
        r_diag=state.r_diag.astype(jnp.float64),
        innov_sq_sum=state.innov_sq_sum.astype(jnp.float64))

    tgd_m = eph.tgd * C_LIGHT
    mu_earth = 3.986005e14  # WGS-84 GM (geo/ephemeris.py MU_EARTH)

    def kepler_refresh(st: VTState, group_len: int):
        """Full-precision geometry once per group head: Kepler solve,
        Sagnac-rotated range, unit line-of-sight, measurement matrix, and
        (on its own cadence) atmosphere.  The inner steps extrapolate SV
        motion along velocity + central-gravity acceleration and
        LINEARIZE the predicted pseudorange around this head state —
        second-order range error over a 50 ms group is |Δsv|²/2r ≈
        4·10⁻⁴ m, ~10⁻⁵ of the code chip, while removing the per-step
        f64 norm/rotation chains from the serial loop."""
        est_pos_h = st.total_state[:3]
        clk_bias_h = st.total_state[6]
        sv = sv_pos_vel_clock(eph, st.transmit_time)
        pos0, vel0 = sv["pos"], sv["vel"]
        r3 = jnp.sum(pos0 * pos0, axis=-1, keepdims=True) ** 1.5
        acc0 = -mu_earth * pos0 / r3

        def refresh_corr(_):
            enu_r = xyz2enu(pos0, est_pos_h)
            el = jnp.arctan2(enu_r[..., 2],
                             jnp.linalg.norm(enu_r[..., :2], axis=-1))
            az = jnp.arctan2(enu_r[..., 0], enu_r[..., 1])
            llh = xyz2llh(est_pos_h)
            iono = klobuchar_delay(st.transmit_time, pos0, est_pos_h,
                                   iono_alpha, iono_beta)
            tropo = jnp.abs(tropo_unb3_delay(
                doy, jnp.rad2deg(llh[0]), llh[2], jnp.rad2deg(el)))
            return iono, tropo, el, az

        # atmosphere refreshes at the group head whose steps contain a
        # multiple of corr_update_ms — the cadence holds for ANY
        # group length / chunking, never slower than corr_update_ms + K
        corr = params.corr_update_ms
        due = ((corr - st.step_count % corr) % corr) < group_len
        iono, tropo, el, az = jax.lax.cond(
            due, refresh_corr,
            lambda _: (st.iono_m, st.tropo_m, st.el_rad, st.az_rad),
            operand=None)
        st = st._replace(iono_m=iono, tropo_m=tropo, el_rad=el, az_rad=az)

        # head pseudorange chain (…:208-215), f64, once per group
        r0 = jnp.linalg.norm(pos0 - est_pos_h[None, :], axis=-1)
        corr_m = clk_bias_h + sv["clk_m"] - tgd_m - tropo - iono
        svp_rot = earth_rotation_correction(pos0, r0 + corr_m)
        diff = svp_rot - est_pos_h[None, :]
        r1 = jnp.linalg.norm(diff, axis=-1)
        pred_pr_head = r1 + corr_m
        a32 = (diff / r1[:, None]).astype(jnp.float32)   # unit LOS (N,3)
        # measurement matrix (…:374-376): LOS direction changes by
        # ~|Δ|/r < 10⁻⁵ rad across a group — constant per group.  H is
        # GLOBAL (all real channels): the sharded path gathers the LOS
        # rows here, once per group
        a32_g = gather(a32)
        H = jnp.zeros((2 * n_real, 8), jnp.float64)
        H = H.at[:n_real, 0:3].set(-a32_g).at[:n_real, 6].set(1.0)
        H = H.at[n_real:, 3:6].set(-a32_g).at[n_real:, 7].set(1.0)
        cache = (st.transmit_time, vel0, acc0, sv["clk_rate_ms"],
                 pred_pr_head, a32, est_pos_h, clk_bias_h, H,
                 vel0.astype(jnp.float32), acc0.astype(jnp.float32),
                 sv["clk_rate_ms"].astype(jnp.float32), pos0)
        return st, cache

    f32 = jnp.float32

    def step(st: VTState, kcache):
        (tt0, vel0, acc0, sv_clk_rate, pred_pr_head, a32, est_pos_h,
         clk_bias_h, H, vel0_32, acc0_32, clk_rate_32, pos0) = kcache
        est_pos = st.total_state[:3]
        est_vel32 = st.total_state[3:6].astype(f32)
        clk_bias = st.total_state[6]
        clk_drift = st.total_state[7]
        iono, tropo, el, az = st.iono_m, st.tropo_m, st.el_rad, st.az_rad

        # --- per-channel block length & transmit-time advance ---
        step_chips = st.code_freq / fs
        # clip: a diverged code NCO must not produce a block length
        # outside the fixed window (legitimate num is always ≤ blk−196;
        # an unclipped garbage value would corrupt ptr/transmit-time
        # for the rest of the run instead of letting the C/N0 gate
        # drop the channel)
        num = jnp.clip(
            jnp.ceil((n_chips - st.rem_chip) / step_chips),
            1.0, float(blk)).astype(jnp.int64)
        tt = st.transmit_time + num.astype(jnp.float64) / fs

        # --- predicted pseudorange: head value + f32 delta terms
        # (…:208-223 re-evaluates the whole chain per ms; see
        # kepler_refresh for the error budget) ---
        if ablate in ("no_geom", "corr_only"):
            # bench ablation: freeze the nav-driven code NCO so XLA
            # dead-code-eliminates the whole delta chain
            pred_pr = st.predicted_pr_last
            delta_pr = jnp.zeros_like(pred_pr)
            code_freq = st.code_freq
            sv_delta32 = jnp.zeros((n_ch, 3), f32)
            sv_vel32 = vel0_32
        else:
            dt_e = tt - tt0                               # f64 (N,)
            dte32 = dt_e.astype(f32)[:, None]
            sv_delta32 = vel0_32 * dte32 + (0.5 * dte32 * dte32) * acc0_32
            sv_vel32 = vel0_32 + acc0_32 * dte32          # (N,3) f32
            d_range32 = (jnp.sum(a32 * sv_delta32, axis=-1)
                         - a32 @ (est_pos - est_pos_h).astype(f32))
            pred_pr = (pred_pr_head + (clk_bias - clk_bias_h)
                       + sv_clk_rate * dt_e
                       + d_range32.astype(jnp.float64))
            delta_pr = (pred_pr - st.predicted_pr_last) / dt
            code_freq = jnp.where(
                st.step_count == 0, st.code_freq,
                code_freq_basis * (1.0 - delta_pr / C_LIGHT))

        # --- correlate (fixed-shape bank); block length `num` was sized
        # with the previous code frequency, replica steps at the new one
        # (…:164,227-232) ---
        def chan_corr(ptr, rem, cfq, cfr, pfp, chips, n):
            return correlate_block(raw, chunk_start, ptr, rem, cfq, cfr,
                                   pfp, chips, taps, fs, n_chips, blk,
                                   "ceil", params.remove_dc, num=n)

        corr, num2, rem_new, phase_new = jax.vmap(chan_corr)(
            st.ptr, st.rem_chip, code_freq, st.carr_freq, st.phase_fp,
            chip_tables, num)
        e_i, e_q = corr[:, params.i_early, 0], corr[:, params.i_early, 1]
        p_i, p_q = corr[:, params.i_prompt, 0], corr[:, params.i_prompt, 1]
        l_i, l_q = corr[:, params.i_late, 0], corr[:, params.i_late, 1]

        # --- scalar PLL (…:307-313) ---
        safe_pi = jnp.where(p_i == 0, 1e-30, p_i)
        carr_err = (jnp.arctan(p_q / safe_pi) / (2 * jnp.pi)).astype(jnp.float64)
        pll = st.pll_nco + (tau2 / tau1) * (carr_err - st.pll_last) \
            + carr_err * (dt / tau1)
        carr_freq = st.carr_freq_basis + pll

        # --- measurement-validity gate: moment-method window over the
        # prompt powers, refreshed every K blocks (estimator per
        # trackingCT.m:120-134; the gating itself is this build's
        # failure-handling layer, SURVEY.md §5 — the reference feeds all
        # channels always).  Gate = post-correlation SNR (no 1/T term)
        # averaged over the last 5 windows — the averaging is what
        # separates weak-lock (≈+4 dB at 31 dB-Hz, 1 ms) from noise
        # (≈−2.7 dB); hard failures crash the mean within one window.
        from gps_sdr_tpu.ops.loops import cn0_moment_estimator
        k_win = params.cn0_window
        pp = (p_i.astype(jnp.float64) ** 2 + p_q.astype(jnp.float64) ** 2)
        zk = jax.lax.dynamic_update_slice_in_dim(
            st.zk, pp[:, None], st.step_count % k_win, axis=1)

        def refresh_cn0(_):
            snr = cn0_moment_estimator(zk, 1.0, signed=True)
            cn0 = snr - 10.0 * jnp.log10(dt)
            hist = jnp.concatenate([st.snr_hist[:, 1:], snr[:, None]],
                                   axis=1)
            # hysteresis (utils/metrics.gate_mask rationale): drop below
            # the threshold, re-enter only 3 dB above it — noise strings
            # 5 positive windows ~0.04% of the time, so a dead channel
            # would flicker back in without the margin
            m5 = jnp.mean(hist, axis=1)
            gated = (jnp.where(st.valid, m5 >= params.mask_snr_db,
                               m5 >= params.mask_snr_db + 3.0)
                     if params.mask_snr_db > 0
                     else jnp.ones_like(st.valid))
            return hist, cn0, gated

        if ablate == "corr_only":
            snr_hist, cn0, valid = st.snr_hist, st.cn0, st.valid
        else:
            snr_hist, cn0, valid = jax.lax.cond(
                (st.step_count + 1) % k_win == 0, refresh_cn0,
                lambda _: (st.snr_hist, st.cn0, st.valid), operand=None)

        # --- DLL discriminator → pseudorange-error measurement (…:316-321)
        e = jnp.sqrt(e_i * e_i + e_q * e_q)
        l = jnp.sqrt(l_i * l_i + l_q * l_q)
        code_err = -0.5 * (e - l) / jnp.maximum(e + l, 1e-30)   # f32
        z_pr = code_err * (f32(C_LIGHT) / code_freq.astype(f32))

        # prr_pred = a·(Vest−Vs) = −ṙ_est, so the matching measurement is
        # +(carrFreq−IF)·c/fc = −ṙ − c·drift + sv_clk_rate; the EKF's
        # clock-drift state then converges to +c·(fractional clock drift)
        # — the OPPOSITE sign convention from the WLS dtRV it warm-starts
        # from (the filter re-converges within a few hundred ms).
        prr_meas = ((carr_freq - f_if) * (C_LIGHT / fc)).astype(f32)
        prr_pred = jnp.sum((est_vel32[None, :] - sv_vel32) * a32, axis=-1)
        z_prr = (prr_pred - prr_meas - clk_drift.astype(f32)
                 + clk_rate_32)
        # GLOBAL measurement vector: the sharded path's per-ms collective
        # — each device contributes its channels' rows and receives all
        if ablate == "corr_only":
            z = jnp.zeros(2 * n_real, jnp.float64)
        else:
            z = jnp.concatenate([gather(z_pr), gather(z_prr)]
                                ).astype(jnp.float64)           # (2N,)

        # --- EKF predict + update (…:388-404) in f64.  Gated-out channels
        # have both measurement rows deweighted by r_masked. ---
        valid_g = gather(valid)
        valid2 = jnp.concatenate([valid_g, valid_g])
        r_used = jnp.where(valid2, st.r_diag, params.r_masked)
        P = F @ st.state_cov @ F.T + Qn
        if ablate:                    # any ablation drops the gain chain
            K = jnp.zeros((8, 2 * n_real), jnp.float64)
            err = jnp.zeros(8, jnp.float64)
        else:
            PHt = P @ H.T
            S = H @ PHt + jnp.diag(r_used)
            # Jacobi-scaled LU gain solve: S is ~1e7-conditioned at the
            # warm start; partial-pivoting LU on the symmetrically scaled
            # S̃ = D^{-1/2}·S·D^{-1/2} (equalizing the ~1e5 m²
            # pseudorange rows against the ~1e-1 (m/s)² rate rows)
            # keeps the factorization accurate.
            # K = PHt·D^{-1/2}·S̃⁻¹·D^{-1/2} is the same linear system,
            # just well-scaled.
            dsc = jax.lax.rsqrt(jnp.diagonal(S))
            S_t = S * dsc[:, None] * dsc[None, :]
            K = (jnp.linalg.solve(S_t, (PHt * dsc[None, :]).T).T
                 * dsc[None, :])
            err = K @ z
            # Joseph-form covariance update: (I−KH)P(I−KH)ᵀ + K·R·Kᵀ
            # stays positive-semidefinite under round-off, where the plain
            # (I−KH)P can go indefinite over ~1e4-step runs (the extra
            # two 8×8 matmuls are negligible next to the correlators)
            ikh = jnp.eye(8, dtype=jnp.float64) - K @ H
            P = ikh @ P @ ikh.T + (K * r_used[None, :]) @ K.T
            P = 0.5 * (P + P.T)      # keep symmetric against round-off
        total = st.total_state + err
        # propagate to next epoch (…:440-442)
        total_next = F @ total

        # --- adaptive R (…:445-467); gated-out innovations are excluded
        # so a recovering channel re-enters with a sane R ---
        sq = st.innov_sq_sum + jnp.where(valid2, z * z, 0.0)
        cnt = st.step_count + 1

        def update_r(_):
            m = sq / float(params.r_update_ms)
            rp = jnp.clip(m[:n_real] * 10.0, params.r_min, params.r_pr_max)
            rr_ = jnp.clip(m[n_real:], params.r_min, params.r_prr_max)
            return jnp.concatenate([rp, rr_]), jnp.zeros_like(sq)

        r_diag, sq = jax.lax.cond(
            cnt % params.r_update_ms == 0, update_r,
            lambda _: (st.r_diag, sq), operand=None)

        new_state = VTState(
            ptr=st.ptr + num2, rem_chip=rem_new, code_freq=code_freq,
            carr_freq=carr_freq, carr_freq_basis=st.carr_freq_basis,
            phase_fp=phase_new, pll_nco=pll, pll_last=carr_err,
            transmit_time=tt, predicted_pr_last=pred_pr,
            iono_m=iono, tropo_m=tropo, el_rad=el, az_rad=az,
            total_state=total_next, state_cov=P, r_diag=r_diag,
            innov_sq_sum=sq, step_count=cnt, zk=zk, snr_hist=snr_hist,
            cn0=cn0, valid=valid)

        # common-epoch time for the record (the earliest channel's block
        # start): tt − (num − min(num) + 1)/fs, as before the H hoist;
        # min over the REAL global channels (gathered when sharded)
        tt_g, num2_g = gather(tt), gather(num2)
        num_min = jnp.min(num2_g) - 1
        local_time = jnp.min(
            tt_g - (num2_g - num_min).astype(jnp.float64) / fs)
        rec = dict(corr=corr, carr_err=carr_err, code_err=code_err,
                   code_freq=code_freq, carr_freq=carr_freq,
                   delta_pr=delta_pr, num_sample=num2,
                   absolute_sample=st.ptr + num2,
                   # remaining chip/carrier phase + the PLL NCO value —
                   # the TckResultVT per-ms fields remChip/remCarrPhase/
                   # carrNco (trackingVT_POS_updated.m:339-345); phase in
                   # radians from the Q32 accumulator as tracking.py does
                   rem_chip=rem_new,
                   rem_phase=jnp.remainder(
                       phase_new.astype(jnp.float64) * (2.0 * jnp.pi / Q32),
                       2.0 * jnp.pi),
                   carr_nco=pll,
                   # extrapolated SV position (navSolutionsVT.svxyz_pos,
                   # …:431) and the post-fit predicted measurement H·δx
                   # (navSolutionsVT.predicted_z/meas_inno, …:433-435)
                   sv_pos=pos0 + sv_delta32.astype(jnp.float64),
                   predicted_z=H @ err,
                   total_state=total, state_cov_diag=jnp.diagonal(P),
                   kalman_gain=K, innovation=z, r_diag=r_diag,
                   # per-measurement equivalent loop bandwidth [Hz]:
                   # diag(H·K)/4/293/0.001 — the 2021 VT variant's
                   # diagnostic (trackingVT_POS_updated_by_20210621.m:384;
                   # 293 m/chip, 1 ms update); diag(H@K) without the
                   # full matmul
                   loop_bw_hz=jnp.sum(H * K.T, axis=1)
                   / (4.0 * 293.0 * 1e-3),
                   el=el, az=az, sv_vel=sv_vel32,
                   local_time=local_time, transmit_time=tt,
                   cn0=cn0, valid=valid)
        return new_state, rec

    K = max(1, int(params.kepler_update_ms))

    def run_group(st: VTState, n: int):
        st, cache = kepler_refresh(st, n)
        return jax.lax.scan(lambda s, _: step(s, cache), st, None, length=n)

    n_groups, rem = divmod(n_steps, K)
    if n_groups == 0:
        return run_group(state, rem)
    st, recs = jax.lax.scan(lambda s, _: run_group(s, K), state, None,
                            length=n_groups)
    recs = jax.tree.map(
        lambda a: a.reshape((n_groups * K,) + a.shape[2:]), recs)
    if rem:
        st, recs_r = run_group(st, rem)
        recs = jax.tree.map(lambda a, b: jnp.concatenate([a, b]),
                            recs, recs_r)
    return st, recs


# scan-record keys that are EKF-layer GLOBAL series (identical on every
# device when the channel axis is sharded — parallel/vt.py replicates
# them; everything else is per-channel with the channel on axis 1)
_VT_REC_GLOBAL = frozenset((
    "total_state", "state_cov_diag", "kalman_gain", "innovation",
    "r_diag", "loop_bw_hz", "predicted_z", "local_time"))

# VTState fields replicated across the mesh (the EKF layer; never padded
# or sliced on the channel axis) — the single source for parallel/vt.py's
# shard specs, pad_vt_state, and run_vector_tracking's unpad
_VT_STATE_REPLICATED = frozenset((
    "total_state", "state_cov", "r_diag", "innov_sq_sum", "step_count"))


@dataclasses.dataclass
class VTSolutions:
    """navSolutionsVT equivalent (…:418-437) — one row per ms."""

    usr_pos: np.ndarray
    usr_vel: np.ndarray
    usr_pos_enu: np.ndarray
    usr_pos_llh: np.ndarray
    clk_bias_m: np.ndarray
    clk_drift_ms: np.ndarray
    local_time: np.ndarray
    state_cov_diag: np.ndarray
    kalman_gain: np.ndarray        # (T, 8, 2N)
    innovation: np.ndarray         # (T, 2N)
    r_diag: np.ndarray
    sat_el_deg: np.ndarray
    sat_az_deg: np.ndarray
    cn0_dbhz: np.ndarray = None    # (T, N)
    valid: np.ndarray = None       # (T, N) channels in the EKF update
    loop_bw_hz: np.ndarray = None  # (T, 2N) equivalent loop bandwidth
                                   # (trackingVT_POS_updated_by_20210621.m:384)
    usr_vel_enu: np.ndarray = None  # (T, 3) ENU velocity at the anchor
                                    # (up-positive; the reference's
                                    # usrVelENU U row is down-positive,
                                    # …:408-415 — flipped at .mat export)
    predicted_z: np.ndarray = None  # (T, 2N) H·δx post-update (…:435);
                                    # meas_inno = innovation − predicted_z
    sv_pos: np.ndarray = None       # (T, N, 3) svxyz_pos (…:431)


@dataclasses.dataclass
class VTTrackRecords:
    """TckResultVT equivalent (…:324-352)."""

    corr: np.ndarray
    carr_err: np.ndarray
    code_err: np.ndarray
    code_freq: np.ndarray
    carr_freq: np.ndarray
    delta_pr: np.ndarray
    num_sample: np.ndarray
    absolute_sample: np.ndarray
    transmit_time: np.ndarray
    sv_vel: np.ndarray
    rem_chip: np.ndarray = None     # (T, N) remChip (…:339)
    rem_phase: np.ndarray = None    # (T, N) remCarrPhase [rad] (…:340)
    carr_nco: np.ndarray = None     # (T, N) carrNco (…:343)


def init_vt_state(cfg: ReceiverConfig, ct_records: TrackRecords,
                  prn_channels: Sequence[int], start_slot_ms: Dict[int, int],
                  transmit_time0: np.ndarray, est_pos: np.ndarray,
                  est_vel: np.ndarray, clk_bias_m: float,
                  clk_drift_ms: float, params: VTParams) -> VTState:
    """Warm start from conventional tracking (…:66-70,109-132).

    `prn_channels` are channel indices into `ct_records`; `start_slot_ms`
    maps channel→0-based record row to hand off from; `transmit_time0` is
    the transmit time at each channel's handoff sample.
    """
    chans = list(prn_channels)
    n = len(chans)
    rows = np.array([start_slot_ms[c] for c in chans])
    sel = (rows, np.array(chans))
    rem_phase = ct_records.rem_phase[sel]
    carr = ct_records.carr_freq[sel]
    z2 = np.zeros(2 * n)
    return VTState(
        ptr=jnp.asarray(ct_records.absolute_sample[sel], jnp.int64),
        rem_chip=jnp.asarray(ct_records.rem_chip[sel]),
        code_freq=jnp.asarray(ct_records.code_freq[sel]),
        carr_freq=jnp.asarray(carr),
        carr_freq_basis=jnp.asarray(carr),
        phase_fp=jnp.asarray(
            np.round(rem_phase / (2 * np.pi) * Q32).astype(np.int64)
            .astype(np.int32)),
        pll_nco=jnp.zeros(n, jnp.float64),
        pll_last=jnp.asarray(ct_records.carr_err[sel]),
        transmit_time=jnp.asarray(transmit_time0, jnp.float64),
        predicted_pr_last=jnp.zeros(n, jnp.float64),
        iono_m=jnp.zeros(n, jnp.float64), tropo_m=jnp.zeros(n, jnp.float64),
        el_rad=jnp.full(n, np.pi / 4), az_rad=jnp.zeros(n, jnp.float64),
        total_state=jnp.asarray(
            np.concatenate([est_pos, est_vel, [clk_bias_m, clk_drift_ms]]),
            jnp.float64),
        state_cov=jnp.asarray(
            1e5 * np.diag([0.1] * 6 + [1.0, 1.0]), jnp.float64),
        r_diag=jnp.asarray(np.concatenate([
            np.full(n, params.r_pr0), np.full(n, params.r_prr0)])),
        innov_sq_sum=jnp.asarray(z2), step_count=jnp.asarray(0, jnp.int32),
        zk=jnp.zeros((n, params.cn0_window), jnp.float64),
        snr_hist=jnp.full((n, 5), 99.0, jnp.float64),
        cn0=jnp.full(n, 99.0, jnp.float64),
        valid=jnp.ones(n, bool))


def run_vector_tracking(source: IFSampleSource, cfg: ReceiverConfig,
                        prns: Sequence[int], eph_struct: Ephemeris,
                        state: VTState, params: VTParams, n_ms: int,
                        init_pos_ecef: np.ndarray, chunk_ms: int = 1000,
                        mesh=None
                        ) -> Tuple[VTTrackRecords, VTSolutions, VTState]:
    """Host driver for the VT scan: chunk the capture, collect records.

    `mesh` (a jax.sharding.Mesh) shards the channel axis over devices
    (parallel/vt.py): correlators/NCOs/PLLs/Kepler stay per-channel
    local, the EKF update runs replicated from all-gathered measurement
    rows — records and solutions are bit-identical to the single-device
    scan at any device count."""
    S = cfg.signal.samples_per_ms
    fs = float(cfg.signal.fs)
    blk = -(-(S * params.pdi_ms + 256) // 128) * 128
    chip_tables = jnp.asarray(
        np.stack([ca_code_table()[p - 1] for p in prns]), jnp.float32)
    alpha = jnp.asarray(cfg.cmn.iono_alpha, jnp.float64)
    beta = jnp.asarray(cfg.cmn.iono_beta, jnp.float64)

    n_real = len(prns)
    n_pad = 0
    use_mesh = mesh is not None and getattr(mesh, "size", 1) > 1
    if use_mesh:
        from gps_sdr_tpu.parallel.vt import pad_vt_state, sharded_vt_scan
        state, chip_tables, eph_struct, n_pad = pad_vt_state(
            state, chip_tables, eph_struct, mesh.size)
        sharded_fns: Dict[int, object] = {}

    from gps_sdr_tpu.io.ifdata import ChunkPrefetcher

    from gps_sdr_tpu.tracking import _stage_raw

    # host ships native ints; the cast happens on device (_stage_raw)
    prefetcher = ChunkPrefetcher(source.read_iq_values, slice_axis=0)
    recs: Dict[str, list] = {}
    done = 0
    try:
        while done < n_ms:
            nb = min(chunk_ms, n_ms - done)
            ptr_min = int(np.min(np.asarray(state.ptr)))
            ptr_max = int(np.max(np.asarray(state.ptr)))
            length = (ptr_max - ptr_min) + nb * params.pdi_ms * S + blk + 64
            raw = _stage_raw(jnp.asarray(prefetcher.fetch(ptr_min, length)))
            if use_mesh:
                fn = sharded_fns.get(nb)
                if fn is None:
                    fn = sharded_vt_scan(
                        mesh, params, nb, fs, blk,
                        float(cfg.signal.f_if), float(cfg.signal.fc),
                        float(cfg.signal.code_freq_basis),
                        int(cfg.cmn.day_of_year), n_real)
                    sharded_fns[nb] = fn
                state, rec = fn(raw, jnp.int64(ptr_min), state,
                                chip_tables, eph_struct, alpha, beta)
            else:
                state, rec = vt_scan(
                    raw, jnp.int64(ptr_min), state, chip_tables,
                    eph_struct, alpha, beta, params, nb, fs, blk,
                    float(cfg.signal.f_if), float(cfg.signal.fc),
                    float(cfg.signal.code_freq_basis),
                    int(cfg.cmn.day_of_year))
            if n_pad:
                rec = {k: (v if k in _VT_REC_GLOBAL else v[:, :n_real])
                       for k, v in rec.items()}
            nb_next = min(chunk_ms, n_ms - done - nb)
            if nb_next > 0:
                adv = nb * params.pdi_ms * S
                prefetcher.prefetch(
                    ptr_min + adv - 2 * S,
                    (ptr_max - ptr_min) + nb_next * params.pdi_ms * S
                    + blk + 64 + 4 * S)
            for k, v in rec.items():
                recs.setdefault(k, []).append(np.asarray(v))
            done += nb
    finally:
        prefetcher.close()
    if n_pad:
        state = VTState(**{
            f: (getattr(state, f) if f in _VT_STATE_REPLICATED
                else getattr(state, f)[:n_real])
            for f in VTState._fields})
    cat = {k: np.concatenate(v) for k, v in recs.items()}

    pos = cat["total_state"][:, :3]
    vel = cat["total_state"][:, 3:6]
    anchor = np.asarray(init_pos_ecef)
    # coordinate transforms on the host CPU (utils/device.py: small eager
    # f64 math between device scans costs less there than one launch each)
    from gps_sdr_tpu.utils.device import host_epoch_device
    with host_epoch_device():
        enu = np.asarray(xyz2enu(pos, anchor))
        # ENU velocity by rotation at the anchor (the reference rotates
        # at cnslxyz, trackingVT_POS_updated.m:408-415; up-positive here)
        vel_enu = np.asarray(xyz2enu(anchor[None, :] + vel, anchor))
        llh = np.asarray(xyz2llh(pos))
    llh = np.stack([np.rad2deg(llh[:, 0]), np.rad2deg(llh[:, 1]),
                    llh[:, 2]], axis=-1)
    sol = VTSolutions(
        usr_pos=pos, usr_vel=vel,
        usr_pos_enu=enu, usr_pos_llh=llh,
        clk_bias_m=cat["total_state"][:, 6],
        clk_drift_ms=cat["total_state"][:, 7],
        local_time=cat["local_time"],
        state_cov_diag=cat["state_cov_diag"],
        kalman_gain=cat["kalman_gain"], innovation=cat["innovation"],
        r_diag=cat["r_diag"], sat_el_deg=np.rad2deg(cat["el"]),
        sat_az_deg=np.rad2deg(cat["az"]),
        cn0_dbhz=cat["cn0"], valid=cat["valid"],
        loop_bw_hz=cat["loop_bw_hz"], usr_vel_enu=vel_enu,
        predicted_z=cat["predicted_z"], sv_pos=cat["sv_pos"])
    trk = VTTrackRecords(
        corr=cat["corr"], carr_err=cat["carr_err"], code_err=cat["code_err"],
        code_freq=cat["code_freq"], carr_freq=cat["carr_freq"],
        delta_pr=cat["delta_pr"], num_sample=cat["num_sample"],
        absolute_sample=cat["absolute_sample"],
        transmit_time=cat["transmit_time"], sv_vel=cat["sv_vel"],
        rem_chip=cat["rem_chip"], rem_phase=cat["rem_phase"],
        carr_nco=cat["carr_nco"])
    return trk, sol, state
