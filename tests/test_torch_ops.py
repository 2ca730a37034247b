"""Parity of the PyTorch port's ops with the JAX package's.

The same seeded numpy inputs go through ``cueball_tpu.ops`` (the
reference; its Pallas FIR kernel in interpret mode, as tests/test_ops.py
runs it) and ``cueball_tpu_torch.ops`` on the CPU, where the port's FIR
wrapper takes its plain version.
"""

import numpy as np
import pytest

jax = pytest.importorskip('jax')
torch = pytest.importorskip('torch')
import jax.numpy as jnp  # noqa: E402

from cueball_tpu import codel as mod_codel  # noqa: E402
from cueball_tpu import ops as jops  # noqa: E402
from cueball_tpu.ops.backoff import backoff_at as j_backoff_at  # noqa: E402
from cueball_tpu.pool import FIRFilter, gen_taps as gen_taps_py  # noqa: E402
from cueball_tpu_torch import ops as tops  # noqa: E402
from cueball_tpu_torch.ops import backoff as tbackoff  # noqa: E402
from cueball_tpu_torch.ops import codel_batch as tcodel  # noqa: E402
from cueball_tpu_torch.ops import fir as tfir  # noqa: E402

CPU = 'cpu'


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize('count', [128, 97])
def test_gen_taps_matches_jax_and_python(count):
    got = tops.gen_taps(count, device=CPU).numpy()
    assert got.dtype == np.float32 and got.shape == (count,)
    # exp differs from XLA's in the last bit (up to ~5e-10 here).
    np.testing.assert_allclose(got, np.asarray(jops.gen_taps(count)),
                               rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(got, gen_taps_py(count, -0.2),
                               rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize('k', [128, 97])
@pytest.mark.parametrize('p', [1, 255, 256, 300])
def test_fir_apply_matches_jax(p, k):
    rng = np.random.default_rng(1000 * k + p)
    w = rng.uniform(0, 5, size=(p, k)).astype(np.float32)
    taps_np = np.asarray(jops.gen_taps(k))
    want = np.asarray(jops.fir_apply(jnp.asarray(w), jnp.asarray(taps_np)))
    want_pallas = np.asarray(jops.fir_apply_pallas(jnp.asarray(w),
                                                   jnp.asarray(taps_np)))
    for fn in (tops.fir_apply, tfir.fir_apply_plain):
        got = fn(_t(w), _t(taps_np)).numpy()
        assert got.shape == (p,) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-4)
        np.testing.assert_allclose(got, want_pallas, rtol=1e-4)


def test_fir_apply_matches_python_filter():
    rng = np.random.default_rng(42)
    samples = rng.uniform(0, 10, size=200)
    f = FIRFilter(gen_taps_py(128, -0.2))
    for s in samples:
        f.put(float(s))
    window = samples[-128:].astype(np.float32)[None, :]
    got = tops.fir_apply(_t(window), tops.gen_taps(128, device=CPU))
    np.testing.assert_allclose(float(got[0]), f.get(), rtol=1e-5)


def test_fir_apply_on_cpu_does_not_launch():
    before = tfir.fir_apply_cuda.launches
    tops.fir_apply(torch.ones((3, 4)), torch.ones(4))
    assert tfir.fir_apply_cuda.launches == before


def test_fir_apply_cuda_rejects_cpu_tensors():
    with pytest.raises(ValueError, match='CUDA'):
        tops.fir_apply_cuda(torch.ones((3, 128)), torch.ones(128))


def test_fir_smooth_matches_jax():
    rng = np.random.default_rng(3)
    series = rng.uniform(0, 5, size=(4, 200)).astype(np.float32)
    taps_np = np.asarray(jops.gen_taps(128))
    want = np.asarray(jops.fir_smooth(jnp.asarray(series),
                                      jnp.asarray(taps_np)))
    got = tops.fir_smooth(_t(series), _t(taps_np)).numpy()
    assert got.shape == (4, 200)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)
    # Final column equals fir_apply on the last window.
    np.testing.assert_allclose(
        got[:, -1], tops.fir_apply(_t(series[:, -128:]),
                                   _t(taps_np)).numpy(), rtol=1e-4)


def test_backoff_schedule_matches_jax_and_smgr_ladder():
    delay = np.array([100.0, 50.0, 7.5], np.float32)
    cap = np.array([1500.0, 10000.0, 90.0], np.float32)
    got = tops.backoff_schedule(_t(delay), _t(cap), 6).numpy()
    np.testing.assert_array_equal(got[0], [100, 200, 400, 800, 1500, 1500])
    np.testing.assert_array_equal(
        got, np.asarray(jops.backoff_schedule(jnp.asarray(delay),
                                              jnp.asarray(cap), 6)))


def test_backoff_at_matches_jax():
    rng = np.random.default_rng(8)
    n = 64
    delay = rng.uniform(10, 500, n).astype(np.float32)
    cap = rng.uniform(100, 20000, n).astype(np.float32)
    whole = rng.integers(0, 12, n).astype(np.float32)
    frac = rng.uniform(0, 12, n).astype(np.float32)
    got = tbackoff.backoff_at(_t(delay), _t(cap), _t(whole)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(j_backoff_at(delay, cap, whole)))
    np.testing.assert_array_equal(
        tbackoff.backoff_at([100.0, 50.0, 100.0], [1500.0, 10000.0, 100.0],
                            [4.0, 3.0, 0.0], device=CPU).numpy(),
        [1500.0, 400.0, 100.0])
    np.testing.assert_allclose(
        tbackoff.backoff_at(_t(delay), _t(cap), _t(frac)).numpy(),
        np.asarray(j_backoff_at(delay, cap, frac)), rtol=1e-6)


def test_spread_delays_matches_jax():
    rng = np.random.default_rng(1)
    base = rng.uniform(100, 5000, 1000).astype(np.float32)
    u = rng.uniform(size=1000).astype(np.float32)
    got = tops.spread_delays(_t(base), 0.2, _t(u)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jops.spread_delays(jnp.asarray(base), 0.2,
                                           jnp.asarray(u))))
    # Half-to-even, like jnp.round.
    np.testing.assert_array_equal(
        tops.spread_delays(_t(np.float32([2.5, 3.5])), 0.0,
                           _t(np.float32([0.0, 0.0]))).numpy(), [2.0, 4.0])


def test_codel_scan_matches_jax_and_scalar_codel(monkeypatch):
    target = 50.0
    T, Q = 300, 5
    times = np.arange(1, T + 1, dtype=np.float64) * 10.0  # 10 ms ticks
    rng = np.random.default_rng(5)
    # Column 0 replays tests/test_ops.py's trace for the scalar law
    # below; the others sit above target long enough to drop.
    sojourns = np.concatenate(
        [rng.uniform(0, 150, size=(T, 1)),
         rng.uniform(40, 300, size=(T, Q - 1))], axis=1)
    soj32 = sojourns.astype(np.float32)
    t32 = times.astype(np.float32)

    t_state, t_drops = tops.codel_scan(_t(soj32), _t(t32), target)
    j_state, j_drops = jops.codel_scan(jnp.asarray(soj32),
                                       jnp.asarray(t32), target)
    assert t_drops.dtype == torch.bool and t_drops.shape == (T, Q)
    assert t_drops.any()
    np.testing.assert_array_equal(t_drops.numpy(), np.asarray(j_drops))
    for name in tcodel.CodelState._fields:
        np.testing.assert_array_equal(getattr(t_state, name).numpy(),
                                      np.asarray(getattr(j_state, name)),
                                      err_msg=name)

    cd = mod_codel.ControlledDelay(target)
    cur = {'t': 0.0}
    monkeypatch.setattr(mod_codel, 'current_millis', lambda: cur['t'])
    scalar = []
    for now, soj in zip(times, sojourns[:, 0]):
        cur['t'] = now
        scalar.append(cd.overloaded(now - soj))
    assert t_drops[:, 0].tolist() == scalar


def test_codel_init_leaves_are_separate():
    st = tcodel.codel_init(4, device=CPU)
    ptrs = {getattr(st, f).data_ptr() for f in tcodel.CodelState._fields}
    assert len(ptrs) == 4
    assert st.dropping.dtype == torch.bool


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tops.gen_taps(128)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tcodel.codel_init(4)


def test_kernel_build_names_and_missing_nvcc(monkeypatch, tmp_path):
    from cueball_tpu_torch.kernels import build
    path = build.library_path('fir')
    assert path.parent == build.BUILD_DIR and path.name.startswith('fir-')
    monkeypatch.setattr(build.shutil, 'which', lambda name: None)
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    with pytest.raises(RuntimeError, match='nvcc not found'):
        build.nvcc()
