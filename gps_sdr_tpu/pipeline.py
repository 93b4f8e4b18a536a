"""Receiver pipeline orchestration with artifact checkpointing.

Equivalent of the reference driver `SDR_main.m`: runs
acquisition → eph tracking → nav decode → usable-SV filter →
CT positioning → (optionally) VT positioning, with every stage output
checkpointed to disk and skipped when the artifact already exists
(SDR_main.m:21-27,34-61 cache guards).  Artifacts are .npz/.pkl files
with the schemas of SURVEY.md §4, named after the capture's identity
(`IFSampleSource.identity`), written atomically, and built by one process
at a time when several share an artifact directory.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import pickle
from typing import Dict, Optional, Sequence

import jax.numpy as jnp
import numpy as np

from gps_sdr_tpu import navdecode
from gps_sdr_tpu.acquisition import AcquisitionResult, run_acquisition
from gps_sdr_tpu.config import ReceiverConfig
from gps_sdr_tpu.geo.coords import llh2xyz
from gps_sdr_tpu.io.ifdata import IFSampleSource
from gps_sdr_tpu.receiver.ct import NavSolutions, run_ct_positioning
from gps_sdr_tpu.tracking import (TrackParams, TrackRecords, init_track_state,
                                  run_tracking)
from gps_sdr_tpu.utils.atomic import atomic_write, file_lock

_REC_FIELDS = ("corr", "code_err", "carr_err", "code_freq", "carr_freq",
               "num_sample", "rem_chip", "rem_phase", "absolute_sample")


def detect_bit_transition(p_i: np.ndarray, min_index: int = 600) -> int:
    """`countinx`: ms offset of the first clean data-bit transition.

    Matches trackingCT.m:178-213: find i ≥ min_index where the 6 previous
    ms disagree with ms i and the following 17 agree; return mod(i,20)−1.
    """
    s = np.sign(p_i)
    n = len(s)
    for i in range(max(6, min_index - 1), n - 18):
        if np.all(s[i - 6:i] != s[i]) and np.all(s[i + 1:i + 18] == s[i]):
            return int((i + 1) % 20 - 1)  # reference index is 1-based
    return 0


class Receiver:
    """Staged receiver with artifact caching.

    Stage artifacts (mirroring SDR_main.m's .mat files), with
    key = {name}_{capture identity}:
      acquired_{key}_{skip}.npz    Acquired{sv,SNR,Doppler,codedelay,fineFreq}
      tckeph_{key}.npz             per-ms tracking records for nav decode
      eph_{key}.pkl                {prn: EphemerisRecord} + sbf{nav1,sfb1}
      tckct_… / navct_…            CT-POS records + WLS solutions
    """

    def __init__(self, cfg: ReceiverConfig, source: IFSampleSource,
                 artifact_dir: Optional[str] = None, mesh="auto"):
        """`mesh` enables multi-device execution (SURVEY.md §2.9):
        "auto" (default) builds a 1-D mesh over all devices when more
        than one is visible, None forces single-device, or pass a
        jax.sharding.Mesh.  With a mesh: the acquisition grid is
        sharded over PRNs, tracking shards the channel axis
        (bit-identical records at any device count), and every WLS
        epoch reduces its normal equations with psum
        (parallel/{acquisition,tracking,epoch}.py), and vector tracking
        shards its channel axis with the per-ms EKF coupling carried by
        an all-gather of the measurement rows (parallel/vt.py,
        bit-identical to single-device)."""
        import jax

        from gps_sdr_tpu.utils.jit_cache import enable_compilation_cache

        self.cfg = cfg
        self.source = source
        self.dir = artifact_dir
        # artifacts of another (or a rewritten) capture under the same
        # name never match this key
        self.key = f"{cfg.file.name}_{source.identity()}"
        if mesh == "auto":
            from gps_sdr_tpu.parallel.mesh import make_mesh
            mesh = make_mesh() if len(jax.devices()) > 1 else None
        self.mesh = mesh
        if artifact_dir:
            os.makedirs(artifact_dir, exist_ok=True)
        enable_compilation_cache()
        self._acq: Optional[AcquisitionResult] = None
        self._eph_records: Optional[TrackRecords] = None
        self._eph = None
        self._sbf = None

    # ---------- artifact helpers ----------
    def _path(self, stem: str) -> Optional[str]:
        if not self.dir:
            return None
        return os.path.join(self.dir, stem)

    def _have(self, stem: str) -> bool:
        p = self._path(stem)
        return p is not None and os.path.exists(p)

    def _stage(self, stem: str):
        """Hold the artifact's lock while a stage checks for and builds
        it, so processes sharing the directory build it once."""
        p = self._path(stem)
        return file_lock(p) if p else contextlib.nullcontext()

    def _save_npz(self, stem: str, **arrays) -> None:
        with atomic_write(self._path(stem)) as f:
            np.savez(f, **arrays)

    def _save_pickle(self, stem: str, obj) -> None:
        with atomic_write(self._path(stem)) as f:
            pickle.dump(obj, f)

    def _load_pickle(self, stem: str):
        with open(self._path(stem), "rb") as f:
            return pickle.load(f)

    def _save_records(self, stem: str, rec: TrackRecords) -> None:
        with atomic_write(self._path(stem)) as f:
            np.savez_compressed(
                f, i_early=rec.i_early, i_prompt=rec.i_prompt,
                i_late=rec.i_late,
                **{f_: getattr(rec, f_) for f_ in _REC_FIELDS})

    @staticmethod
    def _load_records(path: str) -> TrackRecords:
        z = np.load(path)
        return TrackRecords(**{f: z[f] for f in _REC_FIELDS},
                            i_early=int(z["i_early"]),
                            i_prompt=int(z["i_prompt"]),
                            i_late=int(z["i_late"]))

    # ---------- stages ----------
    def acquisition(self, power_fn=None) -> AcquisitionResult:
        """Stage 1 (SDR_main.m:22): FFT parallel code-phase search."""
        if self._acq is not None:
            return self._acq
        if power_fn is None and self.mesh is not None:
            from gps_sdr_tpu.parallel.acquisition import (
                sharded_acquisition_power)
            power_fn = sharded_acquisition_power(self.mesh)
        stem = f"acquired_{self.key}_{self.cfg.file.skip_ms}.npz"
        with self._stage(stem):
            if self._have(stem):
                z = np.load(self._path(stem))
                self._acq = AcquisitionResult(
                    sv=z["sv"], snr_db=z["snr_db"],
                    doppler_hz=z["doppler_hz"],
                    code_delay=z["code_delay"],
                    fine_freq_hz=z["fine_freq_hz"])
            else:
                self._acq = run_acquisition(self.source, self.cfg,
                                            power_fn=power_fn)
                if self.dir:
                    self._save_npz(stem, **dataclasses.asdict(self._acq))
        return self._acq

    def track_for_eph(self, n_ms: Optional[int] = None,
                      chunk_ms: int = 1000,
                      n_segments: int = 1) -> TrackRecords:
        """Stage 2 (SDR_main.m:38): 1 ms scalar tracking long enough to
        decode the ephemerides (≥ ~31 s of bits).

        `n_segments > 1` uses overlap-save time parallelism
        (parallel/time_segments.py): D× shorter scan, D× wider batch.
        """
        if self._eph_records is not None:
            return self._eph_records
        stem = f"tckeph_{self.key}.npz"
        with self._stage(stem):
            if self._have(stem):
                self._eph_records = self._load_records(self._path(stem))
            else:
                self._eph_records = self._track_for_eph(n_ms, chunk_ms,
                                                        n_segments)
                if self.dir:
                    self._save_records(stem, self._eph_records)
        return self._eph_records

    def _track_for_eph(self, n_ms, chunk_ms, n_segments) -> TrackRecords:
        acq = self.acquisition()
        n_ms = n_ms or (self.cfg.track.ms_eph_1ms + self.cfg.track.ms_eph_10ms)
        params = TrackParams.epl(self.cfg)
        if n_segments > 1:
            from gps_sdr_tpu.parallel.time_segments import (
                run_tracking_segmented)
            rec = run_tracking_segmented(
                self.source, self.cfg, list(acq.sv), acq.code_delay,
                acq.fine_freq_hz, params, n_ms, n_segments=n_segments,
                chunk_ms=chunk_ms)
        else:
            state = init_track_state(self.cfg, acq.code_delay,
                                     acq.fine_freq_hz)
            rec, _ = run_tracking(self.source, self.cfg, list(acq.sv),
                                  state, params, n_ms, chunk_ms=chunk_ms,
                                  mesh=self.mesh)
        return rec

    def track_for_eph_reference(self, chunk_ms: int = 1000,
                                min_transition_index: int = 600
                                ) -> TrackRecords:
        """The reference's 3-phase eph-decoding schedule (trackingCT.m):

        (a) 1000 ms @ 1 ms from the acquisition pointer → detect the first
            data-bit transition offset `countinx` (trackingCT.m:178-213)
        (b) re-track 1000+countinx ms @ 1 ms from the same pointer
            (trackingCT.m:215-369)
        (c) 40000 ms @ 10 ms with negated correlator outputs, each block
            replicated ×10 into the per-ms record (trackingCT.m:377-525)

        All channels run in ONE batched scan per phase (the reference
        loops channels in MATLAB; trackingCT.m:73-525): phase (b) tracks
        every channel for n1 + max(countinx) blocks and each channel
        keeps only its first n1 + countinx rows; phase (c) resumes the
        per-channel loop state from the (b) records at each channel's
        own switch row (tracking.state_from_records) with the re-based
        pointer ptr0 + (1000+countinx)·S (trackingCT.m:403).

        Checkpoint/resume: shares the `tckeph_` artifact stem with
        track_for_eph — both produce the stage-2 per-ms eph record the
        decode stage consumes, so a resumed run (or one that already
        ran the plain schedule) loads it instead of re-tracking
        (SDR_main.m:34-38's trackFlag skip).
        """
        if self._eph_records is not None:
            return self._eph_records
        stem = f"tckeph_{self.key}.npz"
        with self._stage(stem):
            if self._have(stem):
                self._eph_records = self._load_records(self._path(stem))
            else:
                self._eph_records = self._track_for_eph_reference(
                    chunk_ms, min_transition_index)
                if self.dir:
                    self._save_records(stem, self._eph_records)
        return self._eph_records

    def _track_for_eph_reference(self, chunk_ms: int,
                                 min_transition_index: int) -> TrackRecords:
        cfg = self.cfg
        acq = self.acquisition()
        S = cfg.signal.samples_per_ms
        n1, n10 = cfg.track.ms_eph_1ms, cfg.track.ms_eph_10ms
        prns = [int(p) for p in acq.sv]
        n_ch = len(prns)
        params1 = TrackParams.epl(cfg)

        # (a) batched 1 ms tracking → countinx per channel
        st = init_track_state(cfg, acq.code_delay, acq.fine_freq_hz)
        rec_a, _ = run_tracking(self.source, cfg, prns, st, params1, n1,
                                chunk_ms=chunk_ms, mesh=self.mesh)
        cnt = np.array([detect_bit_transition(
            rec_a.p_i[:, ch], min_index=min_transition_index)
            for ch in range(n_ch)])
        cnt_max = int(cnt.max())

        # (b) batched re-track to the latest switch point
        st = init_track_state(cfg, acq.code_delay, acq.fine_freq_hz)
        rec_b, _ = run_tracking(self.source, cfg, prns, st, params1,
                                n1 + cnt_max, chunk_ms=chunk_ms,
                                mesh=self.mesh)

        # (c) batched 10 ms blocks, negated, from per-channel re-based
        # pointers; loop state resumed at each channel's switch row
        from gps_sdr_tpu.tracking import state_from_records
        st_c = state_from_records(rec_b, n1 + cnt - 1, acq.fine_freq_hz,
                                  params1.dll_freq_sign,
                                  cfg.signal.code_freq_basis)
        ptr0 = (cfg.file.skip_ms * S + S
                - acq.code_delay.astype(np.int64) + 1)
        st_c = st_c._replace(
            ptr=jnp.asarray(ptr0 + (n1 + cnt) * S, jnp.int64))
        rec_c, _ = run_tracking(
            self.source, cfg, prns, st_c,
            TrackParams.epl(cfg, pdi_ms=10, negate_iq=True),
            n10, chunk_ms=chunk_ms, mesh=self.mesh)

        # merge: per channel, its own (b) prefix + ×10-replicated (c)
        # rows, edge-padded to the common length
        t_max = n1 + cnt_max + n10
        merged = []
        for f in _REC_FIELDS:
            b, c = getattr(rec_b, f), np.repeat(getattr(rec_c, f), 10,
                                                axis=0)
            rows = []
            for ch in range(n_ch):
                a = np.concatenate([b[:n1 + cnt[ch], ch], c[:, ch]])
                pad = t_max - a.shape[0]
                if pad:
                    a = np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])
                rows.append(a)
            merged.append(np.stack(rows, axis=1))
        return TrackRecords(*merged)

    def countinx(self, min_transition_index: int = 600) -> np.ndarray:
        """Per-channel first-bit-transition offsets, ordered like acq.sv
        (the reference persists these as countinx.mat, trackingCT.m:530,
        and the CT-POS stage keys its pdi switch on them)."""
        acq = self.acquisition()
        stem = f"countinx_{self.key}.npz"
        with self._stage(stem):
            if self._have(stem):
                return np.load(self._path(stem))["countinx"]
            rec = self.track_for_eph()
            cnt = np.array([detect_bit_transition(
                rec.p_i[:, ch], min_index=min_transition_index)
                for ch in range(len(acq.sv))])
            if self.dir:
                self._save_npz(stem, sv=acq.sv, countinx=cnt)
        return cnt

    def decode(self, start_offset_ms: int = 3000):
        """Stage 3 (SDR_main.m:54): nav decode → ephemerides + sbf."""
        if self._eph is not None:
            return self._eph, self._sbf
        stem = f"eph_{self.key}.pkl"
        with self._stage(stem):
            if self._have(stem):
                self._eph, self._sbf = self._load_pickle(stem)
                return self._eph, self._sbf
            acq = self.acquisition()
            rec = self.track_for_eph()
            streams = {int(p): rec.p_i[:, ch]
                       for ch, p in enumerate(acq.sv)}
            self._eph, self._sbf = navdecode.decode_all(streams,
                                                        start_offset_ms)
            if self.dir:
                self._save_pickle(stem, (self._eph, self._sbf))
        return self._eph, self._sbf

    def usable_svs(self):
        """Stage 4 (SDR_main.m:65, findPosSV.m): PRNs with complete
        healthy ephemerides; the acquisition fields filtered to that set
        are persisted as the nAcquired-style artifact (findPosSV.m:42)."""
        eph, _ = self.decode()
        svs = navdecode.usable_svs(eph)
        stem = f"nacquired_{self.key}_{self.cfg.file.skip_ms}.npz"
        if self.dir and not self._have(stem):
            acq = self.acquisition()
            ch = [acq.channel_index(p) for p in svs]
            self._save_npz(stem, sv=np.asarray(svs),
                           snr_db=acq.snr_db[ch],
                           doppler_hz=acq.doppler_hz[ch],
                           code_delay=acq.code_delay[ch],
                           fine_freq_hz=acq.fine_freq_hz[ch])
        return svs

    @staticmethod
    def _init_token(init_pos_ecef) -> str:
        if init_pos_ecef is None:
            return "def"
        import hashlib
        h = hashlib.sha1(np.asarray(init_pos_ecef, np.float64).tobytes())
        return h.hexdigest()[:8]

    def ct_position(self, n_ms: Optional[int] = None,
                    init_pos_ecef: Optional[np.ndarray] = None,
                    multicorr: Optional[bool] = None, chunk_ms: int = 1000,
                    pdi_switch_ms: Optional[int] = None,
                    countinx: Optional[np.ndarray] = None):
        """Stage 5 (SDR_main.m:110-115): CT tracking + WLS positioning.

        Re-tracks the usable SVs with the POS correlator configuration
        (25-tap bank if `multicorr`; default from cmn.multicorr_ct, the
        reference's cmn.mltCorrON(1)), then forms WLS epochs.

        `pdi_switch_ms` enables the reference's per-channel coherent-
        integration switch (trackingCT_POS_updated.m:183,294): channel
        ch runs pdi = 1 ms for its first pdi_switch_ms + countinx[ch]
        record rows and pdi = 10 ms after — `n_ms` then counts record
        rows ("number of index", initParameters.m:68), not signal ms.
        `countinx` overrides the detected offsets (ordered like the
        usable-SV list).  Returns (TrackRecords, NavSolutions).
        """
        cfg = self.cfg
        if multicorr is None:
            multicorr = cfg.cmn.multicorr_ct
        if pdi_switch_ms is None:
            pdi_switch_ms = cfg.track.ct_pdi_switch_ms
        n_ms = n_ms or cfg.track.ms_ct_pos
        tag = "mc" if multicorr else "epl"
        key = (f"{tag}_{self.key}_{n_ms}"
               + (f"_sw{pdi_switch_ms}" if pdi_switch_ms else "")
               + ("" if countinx is None else
                  "_c" + "_".join(str(int(c)) for c in countinx))
               + f"_{self._init_token(init_pos_ecef)}")
        stem_t, stem_n = f"tckct_{key}.npz", f"navct_{key}.pkl"
        eph, sbf = self.decode()
        pos_svs = self.usable_svs()
        if len(pos_svs) < 4:
            raise ValueError(
                f"only {len(pos_svs)} SVs with complete ephemeris "
                f"({pos_svs}); positioning needs >= 4 — capture too "
                "short (< ~31 s of nav data) or signals too weak")
        acq = self.acquisition()
        if init_pos_ecef is None:
            init_pos_ecef = np.asarray(llh2xyz(np.asarray(
                cfg.solu.truth_llh)))
        with self._stage(stem_n):
            if self._have(stem_t) and self._have(stem_n):
                return (self._load_records(self._path(stem_t)),
                        self._load_pickle(stem_n))

            chans = [acq.channel_index(p) for p in pos_svs]
            state = init_track_state(cfg, acq.code_delay[chans],
                                     acq.fine_freq_hz[chans])
            mk = (TrackParams.pos_multicorr if multicorr
                  else TrackParams.pos_epl)
            params1 = mk(cfg)
            if pdi_switch_ms is None:
                rec, _ = run_tracking(self.source, cfg, pos_svs, state,
                                      params1, n_ms, chunk_ms=chunk_ms,
                                      mesh=self.mesh)
                pdi_rows: np.ndarray | int = 1
            else:
                from gps_sdr_tpu.tracking import state_from_records
                cnt = np.asarray(countinx if countinx is not None
                                 else self.countinx()[chans])
                sw = pdi_switch_ms + cnt            # (N,) rows at pdi=1
                sw_max, sw_min = int(sw.max()), int(sw.min())
                if n_ms <= sw_max:
                    raise ValueError(f"n_ms={n_ms} rows must exceed the "
                                     f"last pdi switch at row {sw_max}")
                rec1, _ = run_tracking(self.source, cfg, pos_svs, state,
                                       params1, sw_max, chunk_ms=chunk_ms,
                                       mesh=self.mesh)
                st2 = state_from_records(rec1, sw - 1,
                                         acq.fine_freq_hz[chans],
                                         params1.dll_freq_sign,
                                         cfg.signal.code_freq_basis)
                # run_tracking counts SIGNAL milliseconds:
                # (n_ms − sw_min)·10 signal-ms at pdi=10 is exactly
                # (n_ms − sw_min) blocks = record rows — one row per block,
                # the most any channel's merge below consumes
                # (n_ms − sw[ch] rows; no over-tracking)
                rec2, _ = run_tracking(self.source, cfg, pos_svs, st2,
                                       mk(cfg, pdi_ms=10),
                                       (n_ms - sw_min) * 10,
                                       chunk_ms=chunk_ms, mesh=self.mesh)
                merged = []
                n_ch = len(pos_svs)
                for f in _REC_FIELDS:
                    a, b = getattr(rec1, f), getattr(rec2, f)
                    merged.append(np.stack(
                        [np.concatenate([a[:sw[ch], ch],
                                         b[:n_ms - sw[ch], ch]])
                         for ch in range(n_ch)], axis=1))
                rec = TrackRecords(*merged, i_early=params1.i_early,
                                   i_prompt=params1.i_prompt,
                                   i_late=params1.i_late)
                rows = np.arange(n_ms)[:, None]
                pdi_rows = np.where(rows < sw[None, :], 1, 10)
            nav = run_ct_positioning(rec, cfg, pos_svs, eph, sbf,
                                     init_pos_ecef,
                                     pdi_ms_per_block=pdi_rows,
                                     mesh=self.mesh)
            if self.dir:
                self._save_records(stem_t, rec)
                self._save_pickle(stem_n, nav)
            return rec, nav

    def ct_position_kf(self, n_ms: Optional[int] = None,
                       init_pos_ecef: Optional[np.ndarray] = None,
                       epoch_ms: Optional[int] = None,
                       chunk_ms: int = 1000):
        """Legacy stage (trackingCT_POS.m, the generation SDR_main.m no
        longer calls): 1 ms E/P/L tracking + per-epoch position-domain
        8-state EKF over relative pseudoranges (receiver/ct_legacy.py).
        Kept as the real `solu.mode == 1` path."""
        from gps_sdr_tpu.receiver.ct_legacy import run_ct_positioning_kf

        cfg = self.cfg
        n_ms = n_ms or cfg.track.ms_ct_pos
        key = (f"kf_{self.key}_{n_ms}_{epoch_ms or 'def'}"
               f"_{self._init_token(init_pos_ecef)}")
        stem_t, stem_n = f"tckct_{key}.npz", f"navct_{key}.pkl"
        eph, sbf = self.decode()
        pos_svs = self.usable_svs()
        if len(pos_svs) < 4:
            raise ValueError(f"only {len(pos_svs)} usable SVs")
        acq = self.acquisition()
        if init_pos_ecef is None:
            init_pos_ecef = np.asarray(llh2xyz(np.asarray(
                cfg.solu.truth_llh)))
        with self._stage(stem_n):
            if self._have(stem_t) and self._have(stem_n):
                return (self._load_records(self._path(stem_t)),
                        self._load_pickle(stem_n))
            chans = [acq.channel_index(p) for p in pos_svs]
            state = init_track_state(cfg, acq.code_delay[chans],
                                     acq.fine_freq_hz[chans])
            rec, _ = run_tracking(self.source, cfg, pos_svs, state,
                                  TrackParams.pos_epl(cfg), n_ms,
                                  chunk_ms=chunk_ms, mesh=self.mesh)
            nav = run_ct_positioning_kf(rec, cfg, pos_svs, eph, sbf,
                                        init_pos_ecef, epoch_ms=epoch_ms)
            if self.dir:
                self._save_records(stem_t, rec)
                self._save_pickle(stem_n, nav)
            return rec, nav

    def _vt_stem(self, n_ms: Optional[int] = None,
                 ct_n_ms: Optional[int] = None,
                 init_pos_ecef: Optional[np.ndarray] = None,
                 multicorr: Optional[bool] = None, **_ignored) -> str:
        """Artifact stem of a vt_position result for the given kwargs —
        shared by vt_position's cache and export_mat's has-VT-run
        check."""
        cfg = self.cfg
        if multicorr is None:
            multicorr = cfg.cmn.multicorr_vt
        n_ms = n_ms or cfg.track.ms_vt
        # navvt2_: stem bumped when VTTrackRecords gained
        # rem_chip/rem_phase/carr_nco — a pre-bump pickle would restore
        # without the attributes and break export_mat (ADVICE r4)
        return (f"navvt2_{'mc_' if multicorr else ''}{self.key}"
                f"_{n_ms}_{ct_n_ms or 'def'}"
                f"_{self._init_token(init_pos_ecef)}.pkl")

    def vt_position(self, n_ms: Optional[int] = None,
                    ct_n_ms: Optional[int] = None,
                    init_pos_ecef: Optional[np.ndarray] = None,
                    multicorr: Optional[bool] = None,
                    chunk_ms: int = 1000):
        """Stage 6 (SDR_main.m:94-99): vector tracking + EKF, warm-started
        from the CT stage (trackingVT_POS_updated.m:66-70,109-132).

        `multicorr` selects the 29-tap recording bank
        (trackingVT_POS_updated_multicorrelator.m:26); default from
        cmn.multicorr_vt (the reference's cmn.mltCorrON(2)).
        With a Receiver mesh, the VDFLL channel axis is sharded over it
        (parallel/vt.py — the same nav/EKF chain at any device count:
        bit-identical on the CPU backend, to f64 round-off on GPUs).
        Returns (VTTrackRecords, VTSolutions).
        """
        from gps_sdr_tpu.receiver.vt import run_vector_tracking

        cfg = self.cfg
        if multicorr is None:
            multicorr = cfg.cmn.multicorr_vt
        n_ms = n_ms or cfg.track.ms_vt
        stem = self._vt_stem(n_ms=n_ms, ct_n_ms=ct_n_ms,
                             init_pos_ecef=init_pos_ecef,
                             multicorr=multicorr)
        with self._stage(stem):
            if self._have(stem):
                return self._load_pickle(stem)
            trk, sol, _ = run_vector_tracking(
                **self.vt_inputs(ct_n_ms, init_pos_ecef, multicorr,
                                 chunk_ms),
                n_ms=n_ms, chunk_ms=chunk_ms, mesh=self.mesh)
            if self.dir:
                self._save_pickle(stem, (trk, sol))
        return trk, sol

    def vt_inputs(self, ct_n_ms: Optional[int] = None,
                  init_pos_ecef: Optional[np.ndarray] = None,
                  multicorr: Optional[bool] = None, chunk_ms: int = 1000):
        """The VT stage's warm start from the CT stage: keyword arguments
        of `receiver.vt.run_vector_tracking` except n_ms/chunk_ms/mesh
        (source, cfg, prns, eph_struct, state, params, init_pos_ecef)."""
        from gps_sdr_tpu.geo.ephemeris import Ephemeris
        from gps_sdr_tpu.receiver.vt import VTParams, init_vt_state

        cfg = self.cfg
        if multicorr is None:
            multicorr = cfg.cmn.multicorr_vt
        eph, sbf = self.decode()
        pos_svs = self.usable_svs()
        # the CT stage's own default init, so its artifact is reused
        ct_rec, ct_nav = self.ct_position(n_ms=ct_n_ms,
                                          init_pos_ecef=init_pos_ecef,
                                          chunk_ms=chunk_ms)
        if init_pos_ecef is None:
            init_pos_ecef = np.asarray(llh2xyz(np.asarray(
                cfg.solu.truth_llh)))

        # warm-start PVT from the CT epoch at skiptime_vt
        epoch0 = cfg.file.skiptime_vt_ms // cfg.solu.nav_sol_period_ms - 1
        est_pos = ct_nav.usr_pos[epoch0]
        est_vel = ct_nav.usr_vel[epoch0]
        clk_bias = float(ct_nav.clk_bias_m[epoch0])
        clk_drift = float(ct_nav.clk_drift_ms[epoch0])

        # per-channel NCO handoff at first-subframe + skiptime_vt ms
        nav1 = {p: sbf["nav1"][p] for p in pos_svs}
        sfb1 = {p: eph[p].sfb[0] for p in pos_svs}
        tow1 = {p: eph[p].tow[0] for p in pos_svs}
        start_slot = {}
        tt0 = np.empty(len(pos_svs))
        for ch, p in enumerate(pos_svs):
            first_sf_ms = nav1[p] + sfb1[p] * 20
            slot = first_sf_ms + cfg.file.skiptime_vt_ms - 1  # 0-based row
            start_slot[ch] = slot
            tt0[ch] = (tow1[p] + (slot + 1 - first_sf_ms) / 1000.0
                       + ct_rec.rem_chip[slot, ch]
                       / cfg.signal.code_freq_basis)
        vt_kw = dict(remove_dc=cfg.file.data_precision == 2,
                     pll_bw_hz=cfg.track.pll_bw_hz,
                     pll_damping=cfg.track.pll_damping,
                     pll_gain=cfg.track.pll_gain)
        params = (VTParams.multicorr(**vt_kw) if multicorr
                  else VTParams(**vt_kw))
        state = init_vt_state(cfg, ct_rec, list(range(len(pos_svs))),
                              start_slot, tt0, est_pos, est_vel, clk_bias,
                              clk_drift, params)
        eph_struct = Ephemeris(**{
            k: np.asarray([eph[p].latest(0)[k] for p in pos_svs])
            for k in Ephemeris._fields})
        return dict(source=self.source, cfg=cfg, prns=pos_svs,
                    eph_struct=eph_struct, state=state, params=params,
                    init_pos_ecef=init_pos_ecef)

    def position(self, **kw):
        """Mode dispatch (SDR_main.m:73-121 on solu.mode / cmn.vtEnable):
        mode 0 → WLS (CT) solutions; mode 1 → the legacy position-domain
        EKF over relative pseudoranges (trackingCT_POS.m via
        receiver/ct_legacy.py); mode 2 (with cmn.vt_enable) → VT/EKF
        warm-started from CT."""
        if self.cfg.solu.mode == 2 and self.cfg.cmn.vt_enable:
            return self.vt_position(**kw)
        if self.cfg.solu.mode == 1:
            return self.ct_position_kf(**kw)
        return self.ct_position(**kw)

    def export_mat(self, out_dir: str, ct_kw: Optional[Dict] = None,
                   vt: Optional[bool] = None,
                   vt_kw: Optional[Dict] = None) -> None:
        """Write the stage artifacts as MATLAB `.mat` files in the
        reference's exact schemas (SDR_main.m's artifact chain:
        nAcquired / eph / sbf / tckRstCT / navSolCT, plus
        tckRstVT / navSolVT when the VT stage runs,
        trackingVT_POS_updated.m:532-533) so reference users keep their
        MATLAB tooling.  Loaders in io/matref.py round-trip these
        (tests/test_golden_mat.py::test_mat_export_roundtrip,
        tests/test_e2e_vt.py VT round-trip).

        `vt` controls the VT chain: None (default) exports it when the
        configured mode enables VT (solu.mode == 2 with cmn.vt_enable —
        SDR_main.m:73's dispatch) AND the VT stage has already run for
        `vt_kw` (its artifact is cached), so a plain CT export never
        silently triggers minutes of vector tracking; True forces the
        VT chain (running the stage if needed), False skips it."""
        from gps_sdr_tpu.io import matref

        os.makedirs(out_dir, exist_ok=True)
        cfg = self.cfg
        eph, sbf = self.decode()
        pos_svs = self.usable_svs()
        acq = self.acquisition()
        ch = [acq.channel_index(p) for p in pos_svs]
        name = cfg.file.name
        matref.save_nacquired_mat(
            os.path.join(out_dir, f"nAcquired_{name}_{cfg.file.skip_ms}.mat"),
            pos_svs, acq.snr_db[ch], acq.doppler_hz[ch],
            acq.code_delay[ch], acq.fine_freq_hz[ch])
        matref.save_eph_mat(
            os.path.join(out_dir, f"eph_{name}.mat"), eph, sbf=sbf,
            sbf_path=os.path.join(out_dir, f"sbf_{name}.mat"))
        rec, nav = self.ct_position(**(ct_kw or {}))
        from gps_sdr_tpu.utils.metrics import cn0_series
        # per-row coherent time recovered exactly from the block sizes
        # and the configured sample rate — the records carry the
        # per-channel pdi 1→10 ms switch when ct_pdi_switch_ms is set
        # (e.g. opensky_config), and the C/N0 windows must be normalized
        # by it (utils/metrics note); the file tag is the final pdi,
        # matching the reference's tckRstCT_10ms_* naming for the
        # switch configuration
        pdi_rows, _ = matref.pdi_from_block_sizes(
            rec.num_sample, cfg.signal.samples_per_ms)
        cn0 = cn0_series(rec.p_i, rec.p_q, t_coh_s=pdi_rows * 1e-3)
        tag = int(pdi_rows.max())
        matref.save_tck_records_mat(
            os.path.join(out_dir, f"tckRstCT_{tag}ms_{name}.mat"), rec,
            pos_svs, bytes_per_sample=cfg.file.bytes_per_sample,
            cn0_ct=cn0, samples_per_ms=cfg.signal.samples_per_ms)
        matref.save_navsol_mat(
            os.path.join(out_dir, f"navSolCT_{tag}ms_{name}.mat"), nav)

        if vt is None:
            vt = (cfg.solu.mode == 2 and cfg.cmn.vt_enable
                  and self._have(self._vt_stem(**(vt_kw or {}))))
        if vt:
            vt_trk, vt_sol = self.vt_position(**(vt_kw or {}))
            multicorr = (vt_kw or {}).get("multicorr",
                                          cfg.cmn.multicorr_vt)
            if multicorr is None:
                multicorr = cfg.cmn.multicorr_vt
            from gps_sdr_tpu.receiver.vt import VTParams
            p = VTParams.multicorr() if multicorr else VTParams()
            ie, ip, il = p.i_early, p.i_prompt, p.i_late
            # CN0_VT: one row per moment-estimator window — the recorded
            # per-ms cn0 refreshes every cn0_window blocks, so the fresh
            # values sit at rows k·W−1 (vt.py refresh_cn0;
            # trackingVT_POS_updated.m:294-303 fills CN0_VT per window)
            cn0_vt = vt_sol.cn0_dbhz[p.cn0_window - 1::p.cn0_window]
            matref.save_vt_records_mat(
                os.path.join(out_dir, f"tckRstVT_{name}_updated.mat"),
                vt_trk, pos_svs,
                bytes_per_sample=cfg.file.bytes_per_sample,
                samples_per_ms=cfg.signal.samples_per_ms,
                cn0_vt=cn0_vt, i_early=ie, i_prompt=ip, i_late=il)
            matref.save_navsol_vt_mat(
                os.path.join(out_dir, f"navSolVT_{name}_updated.mat"),
                vt_sol, eph={p_: eph[p_] for p_ in pos_svs},
                trk=vt_trk, r_update_ms=p.r_update_ms)

    def report(self, out_dir: str, vt: bool = True,
               ct_kw: Optional[Dict] = None,
               vt_kw: Optional[Dict] = None) -> None:
        """Stage 7: Task 1-5 result plots (Plot_task_1..5.m equivalents)
        plus the decoded-ephemeris CSV (Task_3_table.m)."""
        from gps_sdr_tpu.analysis import plots
        from gps_sdr_tpu.utils.metrics import export_ephemeris_table

        acq = self.acquisition()
        eph, _ = self.decode()
        pos_svs = self.usable_svs()
        truth = np.asarray(llh2xyz(np.asarray(self.cfg.solu.truth_llh)))
        rec, nav = self.ct_position(**(ct_kw or {}))
        vt_sol = vt_trk = None
        if vt:
            vt_trk, vt_sol = self.vt_position(**(vt_kw or {}))
        plots.save_all(acq=acq, records=rec, prns=pos_svs, eph=eph,
                       nav=nav, vt_sol=vt_sol, truth_ecef=truth,
                       out_dir=out_dir, vt_trk=vt_trk)
        export_ephemeris_table(
            eph, os.path.join(out_dir, "task3_ephemeris.csv"), pos_svs)
