"""Typed receiver configuration.

Re-design of the reference's six hard-coded config structs
(`initParameters.m:1-85`) as frozen dataclasses.  Field values default to
the Opensky capture configuration so `ReceiverConfig()` reproduces the
reference workload exactly; everything is overridable for synthetic or
Urban-style front-ends.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

C_LIGHT = 299_792_458.0  # speed of light [m/s]  (initParameters.m:84)
L1_FREQ = 1_575.42e6     # GPS L1 carrier [Hz]
L1_WAVELENGTH = 0.190293672798365  # [m], value used by the reference
                                   # (trackingCT_POS_updated.m:514)


@dataclasses.dataclass(frozen=True)
class FileConfig:
    """IF capture file parameters (initParameters.m:20-38)."""

    path: str = ""
    name: str = "Opensky"
    skip_ms: int = 5000          # ms of capture to skip before acquisition
    data_type: int = 2           # 1: real (I only); 2: interleaved IQ
    data_precision: int = 1      # 1: int8; 2: int16
    skiptime_vt_ms: int = 100    # VT start offset after first CT epoch

    @property
    def bytes_per_value(self) -> int:
        return 1 if self.data_precision == 1 else 2

    @property
    def values_per_sample(self) -> int:
        return self.data_type

    @property
    def bytes_per_sample(self) -> int:
        return self.bytes_per_value * self.values_per_sample


@dataclasses.dataclass(frozen=True)
class SignalConfig:
    """Front-end signal parameters (initParameters.m:41-47)."""

    f_if: float = 4.58e6          # intermediate frequency [Hz]
    fs: float = 58e6              # sampling rate [Hz]
    fc: float = L1_FREQ           # RF carrier [Hz]
    code_freq_basis: float = 1.023e6  # C/A chip rate [Hz]
    ms: float = 1e-3              # coherent block quantum [s]

    @property
    def samples_per_ms(self) -> int:
        """signal.Sample = ceil(Fs*ms) (initParameters.m:46)."""
        return int(math.ceil(self.fs * self.ms))

    @property
    def code_length(self) -> int:
        """Chips per code period (=1023) (initParameters.m:47)."""
        return int(round(self.code_freq_basis * self.ms))


@dataclasses.dataclass(frozen=True)
class AcqConfig:
    """Acquisition search grid (initParameters.m:50-55)."""

    prn_list: Tuple[int, ...] = tuple(range(1, 33))
    freq_step: float = 500.0      # Doppler bin width [Hz]
    freq_min: float = -10_000.0   # lowest Doppler bin [Hz]
    n_noncoherent_ms: int = 20    # acq.datalen: non-coherent blocks
    fine_fft_ms: int = 10         # acq.L: ms of data in the fine-Doppler FFT
    snr_threshold_db: float = 12.0  # acquisition.m:70

    @property
    def n_freq_bins(self) -> int:
        return int(2 * abs(self.freq_min) / self.freq_step) + 1

    @property
    def doppler_bins_hz(self) -> Tuple[float, ...]:
        return tuple(self.freq_min + self.freq_step * i
                     for i in range(self.n_freq_bins))


@dataclasses.dataclass(frozen=True)
class TrackConfig:
    """DLL/PLL loop + schedule parameters (initParameters.m:59-70)."""

    correlator_spacing: float = 0.5  # chips (E/P/L)
    dll_bw_hz: float = 2.0
    dll_damping: float = 0.707
    dll_gain: float = 0.1
    pll_bw_hz: float = 15.0
    pll_damping: float = 0.707
    pll_gain: float = 0.25
    ms_eph_1ms: int = 1000        # track.msToProcessCT_1ms
    ms_eph_10ms: int = 40000      # track.msToProcessCT_10ms
    ms_ct_pos: int = 3000         # track.ctPOS ("number of index")
    ms_vt: int = 5000             # track.msToProcessVT
    pdi_ms: int = 1               # coherent integration per loop update
    # CT-POS per-channel coherent-integration switch: channels move from
    # pdi=1 ms to pdi=10 ms at ct_pdi_switch_ms + countinx rows
    # (trackingCT_POS_updated.m:183,294 switches at msToProcessCT_1ms).
    # None keeps the whole stage at pdi=1.
    ct_pdi_switch_ms: Optional[int] = None
    # Correlator replica engine (tracking.resolve_replica): "auto" is the
    # exact Q32 NCO replica "nco"; "shift" is the nominal-rate table.
    replica: str = "auto"

    # Multi-correlator tap grid: the CT-POS stages evaluate a 25-tap grid
    # 0.6:-0.05:-0.6 (trackingCT_POS_updated.m:42); VT uses 29 taps over
    # ±0.7 (trackingVT_POS_updated.m:29).  Only ±0.5/0 close the loops.
    multicorr_halfwidth: float = 0.6
    multicorr_step: float = 0.05


@dataclasses.dataclass(frozen=True)
class SolutionConfig:
    """Navigation solution parameters (initParameters.m:23,74-75)."""

    nav_sol_period_ms: int = 20
    mode: int = 2                        # 0: WLS; 1: KF; 2: VT
    # Measurement-validity gate: channels drop out of the WLS/EKF epochs
    # when their post-correlation SNR — 10·log10(NA²/2σ²_IQ) from the
    # moment-method window (trackingCT.m:120-134), i.e. C/N0 without the
    # 1/T term — averaged over the last 5 K=20 windows falls below this.
    # Pure noise averages −2.7 ± 1.1 dB over 5 windows; a locked
    # 31 dB-Hz channel at 1 ms pdi (the reference Opensky capture's
    # weakest) averages +4.4 ± 1.1 — the +1 dB threshold splits them at
    # ~0.1% error either side (utils/metrics.cn0_series gate note).
    # 0 disables masking (the reference's behavior — it computes C/N0
    # but never gates on it; SURVEY.md §5 failure-handling).
    mask_snr_db: float = 1.0
    # Surveyed ground-truth antenna LLH (rad, rad, m) (initParameters.m:23)
    truth_llh: Tuple[float, float, float] = (
        22.328444770087565 / 180.0 * math.pi,
        114.1713630049711 / 180.0 * math.pi,
        4.0,
    )


@dataclasses.dataclass(frozen=True)
class CommonConfig:
    """Shared constants + mode switches (initParameters.m:29-32,79-85)."""

    # Klobuchar broadcast coefficients (initParameters.m:30-31)
    iono_alpha: Tuple[float, float, float, float] = (
        9.3132e-09, 1.4901e-08, -5.9605e-08, -1.1921e-07)
    iono_beta: Tuple[float, float, float, float] = (
        8.8064e+04, 4.9152e+04, -1.3107e+05, -3.2768e+05)
    day_of_year: int = 171
    vt_enable: bool = True
    multicorr_ct: bool = True
    multicorr_vt: bool = False
    c: float = C_LIGHT


@dataclasses.dataclass(frozen=True)
class ReceiverConfig:
    """Full receiver configuration bundle (the 6 structs of initParameters.m)."""

    file: FileConfig = dataclasses.field(default_factory=FileConfig)
    signal: SignalConfig = dataclasses.field(default_factory=SignalConfig)
    acq: AcqConfig = dataclasses.field(default_factory=AcqConfig)
    track: TrackConfig = dataclasses.field(default_factory=TrackConfig)
    solu: SolutionConfig = dataclasses.field(default_factory=SolutionConfig)
    cmn: CommonConfig = dataclasses.field(default_factory=CommonConfig)

    def replace(self, **kw) -> "ReceiverConfig":
        return dataclasses.replace(self, **kw)


def opensky_config(path: str = "") -> ReceiverConfig:
    """The Opensky capture configuration (58 MHz int8 IQ, IF 4.58 MHz).

    Matches the reference run end to end, including the CT-POS pdi
    1→10 ms switch at msToProcessCT_1ms + countinx (the shipped
    tckRstCT_10ms_Opensky artifact) — the generic default leaves the
    switch off because n_ms then counts iterations, not signal ms.
    """
    return ReceiverConfig(file=FileConfig(path=path, name="Opensky"),
                          track=TrackConfig(ct_pdi_switch_ms=1000))


def urban_config(path: str = "") -> ReceiverConfig:
    """The Urban capture configuration: near-zero IF, int16 IQ front-end.

    Inferred from the int16/fftshift code paths (acquisition.m:28-32,109-119)
    and the shipped nAcquired_Urban fineFreq values (BASELINE.md).
    """
    return ReceiverConfig(
        file=FileConfig(path=path, name="Urban", data_precision=2),
        signal=SignalConfig(f_if=0.0, fs=26e6),
    )


def synthetic_config(fs: float = 26e6, f_if: float = 4.58e6,
                     n_sv: Optional[int] = None) -> ReceiverConfig:
    """A lighter-weight configuration for synthetic-signal tests."""
    return ReceiverConfig(
        file=FileConfig(path="", name="Synthetic", skip_ms=0),
        signal=SignalConfig(f_if=f_if, fs=fs),
    )
