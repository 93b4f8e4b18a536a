"""gps_sdr_tpu — a GPS L1 C/A software-defined receiver in JAX.

A ground-up JAX/XLA re-design of the capabilities of the reference MATLAB
receiver (KangWelly/Assignment-for-AAE6102_GNSS-SDR, itself built on
Bing Xu & L.T. Hsu's GPSSDR_vt): FFT parallel code-phase acquisition,
DLL/PLL scalar tracking (3-tap and multi-correlator), navigation-data
decoding, WLS positioning, and vector-tracking EKF positioning — all
reformulated as compiled array programs for an accelerator (an NVIDIA
GPU; the tests run on JAX's CPU backend):

- fixed-shape sample blocks + fractional NCO accumulators instead of the
  reference's variable-length per-ms reads,
- channels as a batch axis (`vmap`), time as `lax.scan`,
- the acquisition PRN×Doppler×block grid as batched FFTs shardable over a
  `jax.sharding.Mesh`,
- float64 only for phase/time accumulators (scalars), float32 for the
  wideband compute.

Package layout:
    config        typed receiver configuration (reference: initParameters.m)
    ops/          DSP primitives: C/A codes, correlators, loop filters, C/N0
    geo/          geodesy: Kepler ephemeris solver, atmosphere, coordinates
    io/           IF sample ingest (memmap) + synthetic IF signal generator
    acquisition   FFT parallel code-phase search stage
    tracking      scan-based DLL/PLL tracking engine
    navdecode     LNAV bit sync / preamble / parity / ephemeris decode
    positioning/  WLS PVT + DOP, Doppler velocity LS, 8-state EKF
    receiver/     pipeline stages: CT (tracking+WLS) and VT (vector/EKF)
    parallel/     mesh + sharding helpers (multi-device acquisition/tracking)
    analysis/     plots, ACF multipath features, multipath simulator
"""

import jax

# Phase/time accumulators (code phase, transmit time, pseudoranges) need
# float64; wideband arrays are explicitly float32/complex64 in the kernels.
jax.config.update("jax_enable_x64", True)

__version__ = "0.1.0"
