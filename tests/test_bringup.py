"""What runs on the card, checked on the CPU: engine dispatch, correlator
precision, the compile-cache location, capture identity and safe writes,
and `chip_smoke.py`'s refusal to run without a GPU and its comparison
helpers (CPU device against CPU device must agree exactly)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gps_sdr_tpu.config import FileConfig, ReceiverConfig, SignalConfig
from gps_sdr_tpu.io.ifdata import IFSampleSource
from gps_sdr_tpu.io.synthetic import SyntheticSV, generate_if_samples
from gps_sdr_tpu.tracking import (TrackParams, init_track_state,
                                  resolve_replica, track_scan)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = ReceiverConfig(file=FileConfig(name="bringup", skip_ms=0),
                     signal=SignalConfig(f_if=1.023e6, fs=4.092e6))
SVS = (SyntheticSV(prn=7, amplitude=3.0, doppler_hz=1500.0,
                   code_delay_samples=800.0),
       SyntheticSV(prn=21, amplitude=2.5, doppler_hz=-2500.0,
                   code_delay_samples=2345.0))


def _int8_source(iq, cfg=CFG):
    vals = np.empty(2 * iq.size)
    vals[0::2], vals[1::2] = iq.real, iq.imag
    return IFSampleSource.from_array(
        np.clip(np.round(vals), -127, 127).astype(np.int8), cfg.file)


@pytest.fixture(scope="module")
def tiny():
    return _int8_source(generate_if_samples(CFG, SVS, duration_ms=60,
                                            noise_std=6.0, seed=5))


def test_auto_replica_is_nco():
    assert resolve_replica("auto") == "nco"
    assert TrackParams.epl(CFG).replica == "nco"
    assert TrackParams.epl(CFG, replica="auto").replica == "nco"
    assert TrackParams.epl(CFG, replica="shift").replica == "shift"


@pytest.mark.parametrize("mode", ["pallas", "fused"])
def test_removed_replicas_raise(mode):
    with pytest.raises(ValueError, match="removed"):
        resolve_replica(mode)
    with pytest.raises(ValueError, match="removed"):
        TrackParams.epl(CFG, replica=mode)


def test_unknown_replica_raises():
    with pytest.raises(ValueError, match="unknown replica"):
        TrackParams.pos_epl(CFG, replica="gather")


def _dot_precisions(jaxpr):
    """precision params of every dot_general in a jaxpr, nested ones too."""
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            found.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else (v,)):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    found += _dot_precisions(inner)
    return found


@pytest.mark.parametrize("replica", ["nco", "shift"])
def test_correlator_contraction_is_highest_precision(replica):
    """The (ntaps × blk) · (blk × 2) correlator product must not run as
    TF32 on the GPU: its dot_general carries Precision.HIGHEST."""
    from gps_sdr_tpu.tracking import build_shift_tables

    S = CFG.signal.samples_per_ms
    blk = -(-(S + 256) // 128) * 128
    params = TrackParams.epl(CFG, replica=replica)
    state = init_track_state(CFG, np.zeros(2, np.int64),
                             np.full(2, CFG.signal.f_if))
    if replica == "shift":
        tables, margin = build_shift_tables(CFG, [1, 2], blk)
    else:
        tables, margin = np.ones((2, 1023), np.float32), 0
    raw = jnp.zeros((4 * S + blk, 2), jnp.float32)
    jaxpr = jax.make_jaxpr(
        lambda r, s, t: track_scan(r, jnp.int64(0), s, t, params, 2,
                                   CFG.signal.fs, blk,
                                   CFG.signal.code_freq_basis, margin)
    )(raw, state, jnp.asarray(tables))
    precs = _dot_precisions(jaxpr.jaxpr)
    assert precs, "no dot_general in track_scan"
    highest = jax.lax.Precision.HIGHEST
    assert all(p == (highest, highest) for p in precs), precs


@pytest.fixture
def restore_cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env(monkeypatch, tmp_path,
                                   restore_cache_config):
    from gps_sdr_tpu.utils.jit_cache import enable_compilation_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc"))
    assert enable_compilation_cache() == str(tmp_path / "jc")
    assert jax.config.jax_compilation_cache_dir == str(tmp_path / "jc")
    assert os.path.isdir(tmp_path / "jc")


def test_compile_cache_defaults_to_repo(monkeypatch, restore_cache_config):
    from gps_sdr_tpu.utils.jit_cache import enable_compilation_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    expect = os.path.join(REPO, ".cache", "jax_cache")
    assert enable_compilation_cache() == expect
    assert jax.config.jax_compilation_cache_dir == expect


def test_receiver_keeps_cache_out_of_artifact_dir(tmp_path, tiny,
                                                  monkeypatch,
                                                  restore_cache_config):
    from gps_sdr_tpu.pipeline import Receiver

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    art = tmp_path / "art"
    Receiver(CFG, tiny, artifact_dir=str(art), mesh=None)
    assert os.listdir(art) == []
    assert jax.config.jax_compilation_cache_dir == os.path.join(
        REPO, ".cache", "jax_cache")


def test_capture_identity_follows_rewrites(tmp_path):
    path = str(tmp_path / "cap.bin")
    np.zeros(64, np.int8).tofile(path)
    first = IFSampleSource(path, CFG.file).identity()
    assert first == IFSampleSource(path, CFG.file).identity()
    os.utime(path, ns=(1, 1))                 # a rewrite moves the mtime
    assert IFSampleSource(path, CFG.file).identity() != first
    mem = IFSampleSource.from_array(np.zeros(64, np.int8), CFG.file)
    assert mem.identity() == "mem64"


def test_atomic_write_publishes_only_complete_files(tmp_path):
    from gps_sdr_tpu.utils.atomic import atomic_write

    path = str(tmp_path / "a.bin")
    with pytest.raises(RuntimeError):
        with atomic_write(path) as f:
            f.write(b"partial")
            raise RuntimeError("writer died")
    assert os.listdir(tmp_path) == []
    with atomic_write(path) as f:
        f.write(b"whole")
    assert open(path, "rb").read() == b"whole"
    assert os.listdir(tmp_path) == ["a.bin"]


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU" in out.stderr


def _two_cpus():
    devs = jax.devices("cpu")
    return devs[0], devs[-1]


def _all_zero(checks):
    assert checks
    for c in checks:
        assert c.err == 0, c.line()


def test_smoke_acquisition_comparison_cpu_vs_cpu(tiny):
    import chip_smoke

    a, b = _two_cpus()
    _all_zero(chip_smoke.compare_acquisition(tiny, CFG, [7, 21, 2, 5],
                                             a, b))


@pytest.fixture(scope="module")
def cpu_mesh():
    from gps_sdr_tpu.parallel.mesh import make_mesh

    return make_mesh(2)


@pytest.mark.parametrize("mk,target", [("epl", "device"),
                                       ("pos_multicorr", "device"),
                                       ("epl", "mesh")])
def test_smoke_tracking_replay_cpu_vs_cpu(tiny, cpu_mesh, mk, target):
    """One-step replay of the tracking scan: a second CPU device — or a
    2-device mesh running the sharded scan, as --four-cards does on
    GPUs — agrees exactly with the first."""
    import chip_smoke

    a, b = _two_cpus()
    params = getattr(TrackParams, mk)(CFG)
    st0 = init_track_state(CFG, np.array([3292, 1747]),
                           np.array([CFG.signal.f_if + 1500.0,
                                     CFG.signal.f_if - 2500.0]))
    args = (tiny, CFG, [7, 21], params, st0, 20)
    test = cpu_mesh if target == "mesh" else b
    ref, got = chip_smoke.replay(chip_smoke.tracking_step(*args, a),
                                 chip_smoke.tracking_step(*args, test),
                                 st0, 20)
    assert ref.corr.shape == (20, 2, len(params.taps), 2)
    assert np.all(np.diff(got.absolute_sample, axis=0) > 0)
    _all_zero(chip_smoke.compare_tracking(mk, ref, got))


@pytest.mark.parametrize("target", ["device", "mesh"])
def test_smoke_vt_replay_cpu_vs_cpu(cpu_mesh, target):
    import chip_smoke
    from gps_sdr_tpu.parallel.distributed import _vt_fixture

    cfg, params, state, eph, _, raw, _, _ = _vt_fixture(4)
    src = IFSampleSource.from_array(raw.astype(np.int8).reshape(-1),
                                    cfg.file)
    vt_kw = dict(source=src, cfg=cfg, prns=[1, 2, 3, 4], eph_struct=eph,
                 state=state, params=params)
    a, b = _two_cpus()
    test = cpu_mesh if target == "mesh" else b
    ref, got = chip_smoke.replay(chip_smoke.vt_step(vt_kw, 20, a),
                                 chip_smoke.vt_step(vt_kw, 20, test),
                                 state, 20)
    assert ref.total_state.shape == (20, 8)
    assert np.all(np.isfinite(got.total_state))
    _all_zero(chip_smoke.compare_vt("vt", ref, got))
