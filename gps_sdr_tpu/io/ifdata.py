"""IF capture-file ingest.

The reference re-opens and `fseek`/`fread`s the raw capture inside every
stage — per channel, per millisecond in the positioning loops
(trackingCT_POS_updated.m:193-205).  Here ingest is a single memory-mapped
view; stages take fixed-shape sample windows by absolute sample index and
stage them to device once per scan chunk.  Supported formats match
`initParameters.m:37-38` + the read paths in `acquisition.m:27-38`:

  data_type=2, precision=1  int8 interleaved IQ  (Opensky / NSL STEREO)
  data_type=2, precision=2  int16 interleaved IQ (Urban; per-block DC removal)
  data_type=1               real-only samples

Complex convention (acquisition.m:36): sample = v[0] + 1j·v[1] for each
interleaved pair.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from gps_sdr_tpu.config import FileConfig


class IFSampleSource:
    """Memory-mapped random-access view of an IF capture.

    Sample indices are absolute complex-sample (or real-sample for
    data_type=1) positions from the start of the file.
    """

    def __init__(self, path: str, file_cfg: FileConfig):
        self.cfg = file_cfg
        self.path = path
        dtype = np.int8 if file_cfg.data_precision == 1 else np.int16
        self._raw = np.memmap(path, dtype=dtype, mode="r")
        self.n_samples = self._raw.size // file_cfg.values_per_sample

    @classmethod
    def from_array(cls, values: np.ndarray, file_cfg: FileConfig
                   ) -> "IFSampleSource":
        """Wrap an in-memory interleaved value array (for synthetic data)."""
        obj = cls.__new__(cls)
        obj.cfg = file_cfg
        obj.path = None
        obj._raw = np.ascontiguousarray(values)
        obj.n_samples = obj._raw.size // file_cfg.values_per_sample
        return obj

    def identity(self) -> str:
        """Short tag of this capture's version — path, size and
        modification time of the file, or the size of an in-memory array
        — so that artifacts cached from an older capture are never
        reused for a rewritten one."""
        if self.path is None:
            return f"mem{self._raw.size}"
        st = os.stat(self.path)
        key = f"{os.path.realpath(self.path)}:{st.st_size}:{st.st_mtime_ns}"
        return hashlib.sha1(key.encode()).hexdigest()[:10]

    def read_values(self, start_sample: int, n_samples: int) -> np.ndarray:
        """Raw interleaved values for [start, start+n) samples, zero-padded."""
        vps = self.cfg.values_per_sample
        v0 = start_sample * vps
        v1 = v0 + n_samples * vps
        lo = max(v0, 0)
        hi = min(v1, self._raw.size)
        out = np.zeros(n_samples * vps, dtype=self._raw.dtype)
        if hi > lo:
            out[lo - v0: hi - v0] = self._raw[lo:hi]
        return out

    def read_complex(self, start_sample: int, n_samples: int,
                     remove_dc: bool | None = None) -> np.ndarray:
        """Complex64 samples [start, start+n).

        `remove_dc` defaults to the reference behavior: int16 captures have
        per-block mean removal (acquisition.m:29-32); int8 do not.
        """
        v = self.read_values(start_sample, n_samples).astype(np.float32)
        if self.cfg.data_type == 2:
            i, q = v[0::2], v[1::2]
        else:
            i, q = v, np.zeros_like(v)
        if remove_dc is None:
            remove_dc = self.cfg.data_precision == 2
        if remove_dc:
            i = i - i.mean()
            q = q - q.mean()
        return (i + 1j * q).astype(np.complex64)

    def read_iq_values(self, start_sample: int, n_samples: int
                       ) -> np.ndarray:
        """(n, 2) RAW interleaved int8/int16 IQ values — the minimal
        device-staging payload.  The int→float conversion happens on the
        device (tracking._stage_raw): shipping the native integers instead
        of f32 pairs cuts host→device traffic 4× (2× for int16).  DC
        handling stays in the compute kernels."""
        v = self.read_values(start_sample, n_samples)
        if self.cfg.data_type == 2:
            return v.reshape(-1, 2)
        return np.stack([v, np.zeros_like(v)], axis=-1)

    def read_iq_pairs(self, start_sample: int, n_samples: int,
                      remove_dc: bool | None = None) -> np.ndarray:
        """(n, 2) float32 [re, im] pairs — the tracking engines' sample
        format (channel windows that the host gathers itself)."""
        c = self.read_complex(start_sample, n_samples, remove_dc)
        return np.stack([c.real, c.imag], axis=-1).astype(np.float32)


class ChunkPrefetcher:
    """Overlap host-side chunk preparation with device compute
    (SURVEY.md §2.9 pipeline-parallel row: the reference's stage chain
    is fully sequential; round 1's chunk streaming was too).

    The tracking drivers dispatch a device scan asynchronously, then
    schedule the NEXT chunk's memmap-gather/deinterleave/float-cast on a
    worker thread while the device works.  Window starts are
    data-dependent (the code NCO drifts the pointers by ~tens of samples
    per second), so the prefetch covers a slack margin and `fetch`
    serves any contained window by slicing; a miss falls back to a
    direct read.
    """

    def __init__(self, read_fn, slice_axis: int = 0):
        from concurrent.futures import ThreadPoolExecutor

        self._read = read_fn
        self._axis = slice_axis
        self._pool = ThreadPoolExecutor(1)
        self._pending = None       # (start, n, future)
        self.hits = 0
        self.misses = 0

    def prefetch(self, start: int, n: int) -> None:
        self._pending = (start, n, self._pool.submit(self._read, start, n))

    def fetch(self, start: int, n: int) -> np.ndarray:
        if self._pending is not None:
            p_start, p_n, fut = self._pending
            self._pending = None
            arr = fut.result()
            if p_start <= start and start + n <= p_start + p_n:
                self.hits += 1
                off = start - p_start
                sl = [slice(None)] * arr.ndim
                sl[self._axis] = slice(off, off + n)
                return arr[tuple(sl)]
        self.misses += 1
        return self._read(start, n)

    def close(self) -> None:
        self._pool.shutdown(wait=False)


def write_if_file(path: str, iq: np.ndarray, file_cfg: FileConfig) -> None:
    """Write complex samples as an interleaved capture file."""
    dtype = np.int8 if file_cfg.data_precision == 1 else np.int16
    info = np.iinfo(dtype)
    if file_cfg.data_type == 2:
        vals = np.empty(2 * iq.size, dtype=np.float64)
        vals[0::2] = iq.real
        vals[1::2] = iq.imag
    else:
        vals = iq.real.astype(np.float64)
    np.clip(np.round(vals), info.min, info.max).astype(dtype).tofile(path)
