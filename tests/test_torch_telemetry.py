"""Parity of the PyTorch port's fleet telemetry step with the JAX one.

Both packages step from an identical state (carried across through
``cueball_tpu_torch.convert``) on identical seeded numpy inputs, on the
CPU. Floats agree to rtol 1e-5 (1e-4 for the FIR output `filtered`,
whose exp-derived taps differ from XLA's in the last bit); decisions
(`drop`, `clamped`, CoDel `dropping`) agree exactly, and so does
`target` on every row off its rounding boundary
(``convert.target_near_boundary``): the tests assert no row is on it.
"""

import numpy as np
import pytest

jax = pytest.importorskip('jax')
torch = pytest.importorskip('torch')

import __graft_entry__ as graft  # noqa: E402
from cueball_tpu.parallel import telemetry as jtel  # noqa: E402
from cueball_tpu_torch import convert, entry as tentry  # noqa: E402
from cueball_tpu_torch.ops import fir as tfir  # noqa: E402
from cueball_tpu_torch.parallel import telemetry as ttel  # noqa: E402

CPU = 'cpu'
EXACT = ('clamped', 'drop', 'dropping')


def _jnp(tree):
    return jax.tree.map(np.asarray, tree)


def _tick(rng, n, t):
    """One tick's inputs as numpy, with inactive and reset rows."""
    return dict(
        samples=rng.uniform(0, 8, n).astype(np.float32),
        sojourns=rng.uniform(0, 600, n).astype(np.float32),
        target_delay=np.where(np.arange(n) % 7 == 0, np.inf,
                              300.0).astype(np.float32),
        spares=rng.integers(0, 4, n).astype(np.float32),
        maximum=np.full(n, 12.0, np.float32),
        retry_delay=rng.uniform(50, 200, n).astype(np.float32),
        retry_max_delay=np.full(n, 8000.0, np.float32),
        retry_attempt=rng.integers(0, 8, n).astype(np.float32),
        n_retrying=rng.integers(0, 3, n).astype(np.float32),
        active=rng.uniform(size=n) < 0.8,
        reset=rng.uniform(size=n) < 0.1,
        now_ms=np.float32(200.0 * (t + 1)))


def _start_state(rng, n, k=128):
    """A JAX FleetState with a random carried window ring."""
    st = jtel.fleet_init(n, taps=k)
    return st._replace(windows=jax.numpy.asarray(
        rng.uniform(0, 8, (n, k)).astype(np.float32)))


def _check_target(t_out, j_out, inp, tag):
    j_filtered = np.asarray(j_out['filtered'])
    edge = convert.target_near_boundary(j_filtered, inp['samples'],
                                        inp['spares'])
    assert not edge.any(), '%s: rows on the rounding boundary: %s' % (
        tag, np.flatnonzero(edge))
    np.testing.assert_array_equal(t_out['target'],
                                  np.asarray(j_out['target']), err_msg=tag)


def _compare_outputs(t_out, t_fleet, j_out, j_fleet, inp, tag):
    t_out, t_fleet = convert.to_numpy((t_out, t_fleet))
    for name in ('filtered', 'retry_backoff', 'clamped', 'drop'):
        want = np.asarray(j_out[name])
        assert t_out[name].dtype == want.dtype, (tag, name)
        if name in EXACT:
            np.testing.assert_array_equal(t_out[name], want,
                                          err_msg='%s %s' % (tag, name))
        else:
            np.testing.assert_allclose(
                t_out[name], want, rtol=1e-4 if name == 'filtered' else 1e-5,
                atol=1e-6, err_msg='%s %s' % (tag, name))
    _check_target(t_out, j_out, inp, tag)
    for name, want in j_fleet.items():
        np.testing.assert_allclose(t_fleet[name], np.asarray(want),
                                   rtol=1e-5, err_msg='%s %s' % (tag, name))


def _compare_state(t_state, j_state, tag):
    t_state = convert.to_numpy(t_state)
    np.testing.assert_array_equal(t_state.windows,
                                  np.asarray(j_state.windows), err_msg=tag)
    for name in ('first_above', 'drop_next', 'count', 'dropping'):
        np.testing.assert_array_equal(
            getattr(t_state.codel, name),
            np.asarray(getattr(j_state.codel, name)),
            err_msg='%s codel.%s' % (tag, name))
    assert t_state.now_ms.shape == () and \
        t_state.now_ms == np.asarray(j_state.now_ms)


def _compare(t_state, t_out, t_fleet, j_state, j_out, j_fleet, inp, tag):
    _compare_outputs(t_out, t_fleet, j_out, j_fleet, inp, tag)
    _compare_state(t_state, j_state, tag)


def test_fleet_step_matches_jax_over_ticks():
    rng = np.random.default_rng(2024)
    n, ticks = 64, 12
    j_state = _start_state(rng, n)
    t_state = convert.fleet_state_from_numpy(_jnp(j_state), device=CPU)
    drops = 0
    for t in range(ticks):
        inp = _tick(rng, n, t)
        j_state, j_out, j_fleet = jtel.fleet_step(
            j_state, jtel.fleet_inputs(n, **inp))
        t_state, t_out, t_fleet = ttel.fleet_step(
            t_state, ttel.fleet_inputs(n, device=CPU, **inp))
        drops += int(t_out['drop'].sum())
        _compare(t_state, t_out, t_fleet, j_state, j_out, j_fleet, inp,
                 'tick %d' % t)
    assert drops > 0


def test_fleet_scan_matches_steps_and_jax():
    rng = np.random.default_rng(77)
    n, T = 16, 8
    ticks = [_tick(rng, n, t) for t in range(T)]
    j_state0 = _start_state(rng, n)
    stacked = {k: np.stack([tk[k] for tk in ticks]) for k in ticks[0]}
    j_fin, j_outs, j_fleets = jtel.fleet_scan(
        j_state0, jtel.FleetInputs(**stacked))

    t_state0 = convert.fleet_state_from_numpy(_jnp(j_state0), device=CPU)
    window = convert.fleet_inputs_from_numpy(
        jtel.FleetInputs(**stacked), device=CPU)
    t_fin, t_outs, t_fleets = ttel.fleet_scan(t_state0, window)

    state = t_state0
    for t, tk in enumerate(ticks):
        state, out, fleet = ttel.fleet_step(
            state, ttel.fleet_inputs(n, device=CPU, **tk))
        for k in out:
            assert torch.equal(t_outs[k][t], out[k]), (t, k)
        for k in fleet:
            assert torch.equal(t_fleets[k][t], fleet[k]), (t, k)
    for a, b in zip(jax.tree.leaves(convert.to_numpy(t_fin)),
                    jax.tree.leaves(convert.to_numpy(state))):
        np.testing.assert_array_equal(a, b)

    _compare_state(t_fin, j_fin, 'scan final')
    for t, tk in enumerate(ticks):
        _compare_outputs({k: v[t] for k, v in t_outs.items()},
                         {k: v[t] for k, v in t_fleets.items()},
                         {k: v[t] for k, v in j_outs.items()},
                         {k: v[t] for k, v in j_fleets.items()},
                         tk, 'scan tick %d' % t)


def test_rebase_state_matches_jax():
    rng = np.random.default_rng(5)
    n = 32
    j_state = jtel.fleet_init(n)
    fa = rng.choice([0.0, 50.0, 900.0, 5000.0], n).astype(np.float32)
    dn = rng.choice([0.0, -20.0, 300.0, 7000.0], n).astype(np.float32)
    j_state = j_state._replace(
        codel=j_state.codel._replace(first_above=jax.numpy.asarray(fa),
                                     drop_next=jax.numpy.asarray(dn)),
        now_ms=np.float32(6000.0))
    t_state = convert.fleet_state_from_numpy(_jnp(j_state), device=CPU)
    got = convert.to_numpy(ttel.rebase_state(t_state, 1000.0))
    want = _jnp(jtel.rebase_state(j_state, 1000.0))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_live_step_matches_fleet_step_and_reuses_buffers():
    rng = np.random.default_rng(9)
    n = 32
    live = ttel.make_live_step()
    ref = ttel.fleet_init(n, device=CPU)
    state = ttel.fleet_init(n, device=CPU)
    ptrs = []
    for t in range(6):
        inp = ttel.fleet_inputs(n, device=CPU, **_tick(rng, n, t))
        ref, r_out, r_fleet = ttel.fleet_step(ref, inp)
        state, out, fleet = live(state, inp)
        ptrs.append(state.windows.data_ptr())
        for a, b in zip(jax.tree.leaves(convert.to_numpy(
                (state, out, fleet))), jax.tree.leaves(convert.to_numpy(
                    (ref, r_out, r_fleet)))):
            np.testing.assert_array_equal(a, b)
    # Tick 0 allocates the spare; from then on two buffers alternate.
    assert len(set(ptrs)) == 2
    assert ptrs[1] == ptrs[3] == ptrs[5] and ptrs[2] == ptrs[4]
    assert ptrs[1] != ptrs[2]


def test_entry_matches_graft_entry():
    j_fn, (j_state, j_inp) = graft.entry()
    t_fn, (t_state, t_inp) = tentry.entry(device=CPU)
    assert t_inp.now_ms.dtype == torch.float32 and t_inp.now_ms.dim() == 0
    for name in ttel.FleetInputs._fields:
        np.testing.assert_array_equal(getattr(t_inp, name).numpy(),
                                      np.asarray(getattr(j_inp, name)),
                                      err_msg=name)
    j_out = j_fn(j_state, j_inp)
    t_out = t_fn(t_state, t_inp)
    inp = {'samples': np.asarray(j_inp.samples),
           'spares': np.asarray(j_inp.spares)}
    _compare(*t_out, *j_out, inp, 'entry')


def test_tick_inputs_match_graft():
    rng_j, rng_t = np.random.default_rng(4), np.random.default_rng(4)
    _, j_base = graft._example_inputs(40, seed=4)
    _, t_base = tentry.example_inputs(40, seed=4, device=CPU)
    for k in range(3):
        j_inp = graft._tick_inputs(j_base, rng_j, k)
        t_inp = tentry.tick_inputs(t_base, rng_t, k)
        for name in ttel.FleetInputs._fields:
            np.testing.assert_array_equal(
                getattr(t_inp, name).numpy(),
                np.asarray(getattr(j_inp, name)), err_msg=name)


def test_fleet_step_cuda_rejects_cpu_tensors():
    _, (state, inp) = tentry.entry(device=CPU)
    with pytest.raises(ValueError, match='CUDA'):
        ttel.fleet_step_cuda(state, inp)
    before = tfir.fir_apply_cuda.launches
    ttel.fleet_step_plain(state, inp)
    ttel.fleet_step(state, inp)
    assert tfir.fir_apply_cuda.launches == before


def test_fleet_inputs_dtypes():
    inp = ttel.fleet_inputs(5, device=CPU, now_ms=1e9 + 1.0,
                            active=np.ones(5, bool))
    assert inp.now_ms.dtype == torch.float32 and inp.now_ms.dim() == 0
    assert float(inp.now_ms) == float(np.float32(1e9 + 1.0))
    for name in ttel.FleetInputs._fields:
        v = getattr(inp, name)
        assert v.dtype == (torch.bool if name in ('active', 'reset')
                           else torch.float32), name
        if name != 'now_ms':
            assert v.shape == (5,), name
    assert torch.isinf(inp.target_delay).all()


def test_fold_backend_slots_matches_jax():
    cols = {'lat': np.arange(3, dtype=np.float32),
            'lat_buckets': np.ones((3, 4), np.int32)}
    got = ttel.fold_backend_slots(cols, 8)
    want = jtel.fold_backend_slots(cols, 8)
    for k in cols:
        np.testing.assert_array_equal(got[k], want[k])
    assert got['lat_buckets'].shape == (8, 4)
