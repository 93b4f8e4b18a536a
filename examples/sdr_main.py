"""SDR_main.m equivalent — the full staged receiver as one command.

The reference's driver (`SDR_MATLAB-main/SDR_main.m`) runs
acquisition → ephemeris tracking → nav decode → usable-SV filter →
CT/WLS positioning → (optionally) VT/EKF positioning, checkpointing
every stage to `.mat` files.  This script is the same driver on this
framework: stage artifacts checkpoint to `--artifacts` (re-running
resumes; delete the directory for a cold run), results export as
reference-schema `.mat` files plus the Task-1..5 plots.

    # the reference's Opensky run (SDR_main.m with initParameters.m
    # defaults), on the real capture:
    python examples/sdr_main.py --preset opensky /path/to/Opensky.bin \
        --out results_opensky

    # the Urban front end (int16 IQ, IF≈0):
    python examples/sdr_main.py --preset urban /path/to/Urban.bin \
        --out results_urban

    # any capture with explicit front-end parameters (this exact run is
    # validated against the 42 s synthetic soak capture the test suite
    # generates in .cache/ — ~9 min on CPU, all 5 SVs decode, WLS ~29 m
    # median vs the surveyed truth, VT/EKF holds it):
    python examples/sdr_main.py .cache/soak_scn_v2.bin --fs 5e6 \
        --f-if 1.25e6 --iq-bytes 1 --ct-ms 8500 --vt-ms 1000 --cpu \
        --out /tmp/sdr_out

Multi-device execution is automatic: with more than one visible JAX
device the Receiver builds a mesh and shards acquisition (PRN axis),
tracking and vector tracking (channel axis), and the WLS epochs
(psum normal equations) — results are equivalent at any device count.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# backend selection must happen BEFORE the package imports: module-level
# jnp constants would otherwise initialize the default backend and a later
# jax.config.update would be too late
if "--cpu" in sys.argv:
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np

from gps_sdr_tpu.config import (FileConfig, ReceiverConfig, SignalConfig,
                                opensky_config, urban_config)
from gps_sdr_tpu.geo.coords import llh2xyz
from gps_sdr_tpu.io.ifdata import IFSampleSource
from gps_sdr_tpu.pipeline import Receiver
from gps_sdr_tpu.utils.metrics import format_acquisition_table


def build_config(args) -> ReceiverConfig:
    import dataclasses

    if args.preset == "opensky":
        cfg = opensky_config(args.capture)
    elif args.preset == "urban":
        cfg = urban_config(args.capture)
    else:
        cfg = ReceiverConfig(
            file=FileConfig(path=args.capture, name=args.name,
                            skip_ms=args.skip_ms or 0,
                            data_precision=args.iq_bytes),
            signal=SignalConfig(f_if=args.f_if, fs=args.fs))
    if args.skip_ms is not None:
        cfg = cfg.replace(
            file=dataclasses.replace(cfg.file, skip_ms=args.skip_ms))
    return cfg


def main():
    ap = argparse.ArgumentParser(
        description="Full GNSS SDR run (SDR_main.m equivalent)")
    ap.add_argument("capture", help="raw IF capture file (interleaved IQ)")
    ap.add_argument("--preset", choices=("opensky", "urban", "none"),
                    default="none")
    ap.add_argument("--fs", type=float, default=58e6,
                    help="sampling rate [Hz] (ignored with a preset)")
    ap.add_argument("--f-if", type=float, default=4.58e6,
                    help="intermediate frequency [Hz]")
    ap.add_argument("--iq-bytes", type=int, default=1, choices=(1, 2),
                    help="bytes per I/Q component (int8 or int16)")
    ap.add_argument("--skip-ms", type=int, default=None,
                    help="skip this many ms of capture before acquisition")
    ap.add_argument("--name", default="capture",
                    help="artifact-name stem (ignored with a preset)")
    ap.add_argument("--out", default="sdr_out",
                    help="output directory (plots + .mat exports)")
    ap.add_argument("--artifacts", default=None,
                    help="stage-checkpoint directory "
                         "(default: <out>/artifacts)")
    ap.add_argument("--ct-ms", type=int, default=None,
                    help="CT positioning length (track.ms_ct_pos)")
    ap.add_argument("--vt-ms", type=int, default=None,
                    help="VT positioning length (track.ms_vt)")
    ap.add_argument("--no-vt", action="store_true",
                    help="stop after the WLS stage (cmn.vtEnable=0)")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (applied at import time "
                         "— see the module header)")
    args = ap.parse_args()

    cfg = build_config(args)
    src = IFSampleSource(args.capture, cfg.file)
    art = args.artifacts or os.path.join(args.out, "artifacts")
    rx = Receiver(cfg, src, artifact_dir=art)

    acq = rx.acquisition()
    print(format_acquisition_table(acq, cfg.signal.f_if))
    rx.track_for_eph_reference()        # the reference's 3-phase schedule
    eph, _ = rx.decode()
    svs = rx.usable_svs()
    print(f"usable SVs (complete healthy ephemeris): {svs}")

    truth = np.asarray(llh2xyz(np.asarray(cfg.solu.truth_llh)))
    ct_kw = {} if args.ct_ms is None else dict(n_ms=args.ct_ms)
    _, nav = rx.ct_position(**ct_kw)
    err = np.linalg.norm(nav.usr_pos - truth, axis=1)
    print(f"WLS: {len(nav.local_time)} epochs, "
          f"median error vs configured truth {np.median(err):.1f} m, "
          f"LLH {nav.usr_pos_llh[-1][0]:.6f} {nav.usr_pos_llh[-1][1]:.6f}")

    vt_kw = None
    if not args.no_vt and cfg.cmn.vt_enable:
        vt_kw = ({} if args.vt_ms is None else dict(n_ms=args.vt_ms))
        if args.ct_ms is not None:
            vt_kw["ct_n_ms"] = args.ct_ms
        _, sol = rx.vt_position(**vt_kw)
        verr = np.linalg.norm(sol.usr_pos - truth, axis=1)
        print(f"VT/EKF: {len(sol.local_time)} ms, "
              f"median error {np.median(verr):.1f} m")

    os.makedirs(args.out, exist_ok=True)
    rx.export_mat(os.path.join(args.out, "mat"), ct_kw=ct_kw,
                  vt=vt_kw is not None, vt_kw=vt_kw)
    rx.report(os.path.join(args.out, "plots"), vt=vt_kw is not None,
              ct_kw=ct_kw, vt_kw=vt_kw)
    print(f"artifacts: {art}\nexports:   {args.out}/mat\n"
          f"plots:     {args.out}/plots")


if __name__ == "__main__":
    main()
