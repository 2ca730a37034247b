"""Parity of the PyTorch port's control step with the JAX one.

Both packages step from the same state on identical seeded numpy
inputs, on the CPU. The decision columns (`codel_target`,
`plan_spares`, `plan_target`, `delta`, `epoch`) and the carried
`targets` agree bit for bit, since every reduction that feeds a
decision is an int32 sum or a max; `mean_load`, a float sum, agrees to
rtol 1e-5. The host-side actuation helpers are ported as they are.

Where a decision's float is NaN, infinite or outside the int32 range,
both packages cast it by XLA's saturating rule (NaN to 0, the rest
clamped to the int32 bounds): the port through ``to_int32_xla``. The
fixed non-finite rows and the frozen JAX numbers are ``chip_smoke.py``'s
(phase 18 holds the card against them); here they are held against
the JAX package itself.
"""

import numpy as np
import pytest

jax = pytest.importorskip('jax')
torch = pytest.importorskip('torch')

import chip_smoke  # noqa: E402
from cueball_tpu.parallel import control as jctl  # noqa: E402
from cueball_tpu_torch import convert  # noqa: E402
from cueball_tpu_torch._cast import to_int32_xla  # noqa: E402
from cueball_tpu_torch.parallel import control as tctl  # noqa: E402
from cueball_tpu_torch.parallel.mesh import Mesh, unshard  # noqa: E402

CPU = 'cpu'
SOAK_ROWS = 4096
SOAK_STEPS = 4
FORMS = ('plain', 'mesh')
FUZZ_SEEDS = range(6)
FUZZ_ROWS = 64
FUZZ_SHARE = 0.2
FLOAT_INPUTS = ('samples', 'sojourns', 'filtered', 'target_delay', 'spares',
                'maximum')
CASES = chip_smoke.NONFINITE_CONTROL_CASES


def soak_inputs(rng, n, step):
    """One tick's adversarial columns as numpy (the law of
    tests/test_control.py's soak): a third of the fleet CoDel-less,
    sojourns straddling the targets, occasional resets."""
    target = np.where(rng.random(n) < 0.33, np.inf,
                      rng.integers(50, 800, n).astype(np.float64))
    return dict(
        samples=(rng.random(n) * 12.0).astype(np.float32),
        sojourns=(rng.random(n) * 900.0).astype(np.float32),
        filtered=(rng.random(n) * 10.0).astype(np.float32),
        target_delay=target.astype(np.float32),
        spares=rng.integers(0, 6, n).astype(np.float32),
        maximum=rng.integers(6, 20, n).astype(np.float32),
        active=rng.random(n) < 0.9,
        reset=rng.random(n) < 0.02,
        now_ms=np.float32(1000.0 * (step + 1)))


def test_soak_decisions_bit_identical_to_jax():
    rng = np.random.default_rng(11)
    j_state = jctl.control_init(SOAK_ROWS)
    t_state = tctl.control_init(SOAK_ROWS, device=CPU)
    step = tctl.make_control_step()
    moved = 0
    for k in range(SOAK_STEPS):
        cols = soak_inputs(rng, SOAK_ROWS, k)
        j_inp = jctl.control_inputs(SOAK_ROWS, **cols)
        t_inp = tctl.control_inputs(SOAK_ROWS, device=CPU, **cols)
        j_state, j_dec, j_fleet = jctl.control_step(j_state, j_inp)
        t_state, t_dec, t_fleet = step(t_state, t_inp)
        for name, want in j_dec.items():
            want = np.asarray(want)
            got = t_dec[name].numpy()
            assert got.dtype == want.dtype, (k, name)
            np.testing.assert_array_equal(got, want, err_msg='%d %s'
                                          % (k, name))
        np.testing.assert_array_equal(t_state.targets.numpy(),
                                      np.asarray(j_state.targets))
        assert t_state.epoch.dtype == torch.int32
        assert int(t_state.epoch) == k + 1
        for name in ('n_pools', 'pressure', 'max_sojourn'):
            assert float(t_fleet[name]) == float(j_fleet[name]), name
        assert float(t_fleet['mean_load']) == pytest.approx(
            float(j_fleet['mean_load']), rel=1e-5)
        moved += int((t_dec['codel_target'].numpy() > 0).sum())
    # The soak judged both sides of the law.
    assert moved > 0
    assert np.any(t_dec['delta'].numpy() != 0)


def test_state_and_inputs_carry_across_from_jax():
    """A JAX state and inputs carried over with convert step to the
    same decisions as stepping in JAX."""
    rng = np.random.default_rng(12)
    n = 64
    j_state = jctl.control_init(n, epoch=41)
    j_state = j_state._replace(targets=jax.numpy.asarray(
        rng.integers(0, 400, n).astype(np.float32)))
    j_inp = jctl.control_inputs(n, **soak_inputs(rng, n, 0))
    host = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    t_state = convert.control_state_from_numpy(host(j_state), device=CPU)
    t_inp = convert.control_inputs_from_numpy(host(j_inp), device=CPU)
    assert t_inp.active.dtype == torch.bool
    assert t_state.epoch.dtype == torch.int32
    _, j_dec, _ = jctl.control_step(j_state, j_inp)
    _, t_dec, _ = tctl.control_step(t_state, t_inp)
    for name, want in j_dec.items():
        np.testing.assert_array_equal(t_dec[name].numpy(), np.asarray(want))
    assert int(t_dec['epoch']) == 42


def test_defaults_to_cuda_and_mesh_is_not_ported():
    if torch.cuda.is_available():
        assert tctl.control_init(4).targets.device.type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match='CUDA'):
            tctl.control_init(4)
    # The mesh form exists: a 2-shard CPU mesh steps a sharded state.
    mesh = Mesh([CPU] * 2, ('pools',))
    step = tctl.make_control_step(mesh=mesh)
    states, dec, fleet = step(
        tctl.shard_control_state(tctl.control_init(4, device=CPU), mesh),
        tctl.shard_control_inputs(
            tctl.control_inputs(4, device=CPU, active=True), mesh))
    assert [s.targets.shape for s in states] == [(2,), (2,)]
    assert [float(f['n_pools']) for f in fleet] == [4.0, 4.0]
    assert [int(d['epoch']) for d in dec] == [1, 1]


class FakePool:
    def __init__(self, accept=True):
        self.accept = accept
        self.calls = []

    def apply_control_decision(self, epoch, codel_target=None,
                               spares=None, at_ms=None):
        self.calls.append((epoch, codel_target, spares, at_ms))
        return self.accept


@pytest.mark.parametrize('as_tensor', [False, True])
def test_apply_decisions_counts_and_zero_target(as_tensor):
    decisions = {
        'codel_target': np.asarray([150.0, 0.0, 200.0], np.float32),
        'plan_spares': np.asarray([2, 3, 4], np.int32),
        'epoch': np.int32(7),
    }
    if as_tensor:
        decisions = {k: torch.as_tensor(v) for k, v in decisions.items()}
    ok, nope = FakePool(True), FakePool(False)
    res = tctl.apply_decisions(
        {0: ok, 1: nope, 2: object()}, decisions, at_ms=50.0)
    assert res == {'applied': 1, 'rejected': 1, 'skipped': 1, 'epoch': 7}
    # 0.0 in the column means "no CoDel decision", passed as None.
    assert ok.calls == [(7, 150.0, 2, 50.0)]
    assert nope.calls == [(7, None, 3, 50.0)]


def test_reduce_control_weights_by_pool_count():
    a = {'fleet': {'n_pools': 3.0, 'pressure': 1.0, 'mean_load': 2.0,
                   'max_sojourn': 10.0}, 'applied': 2, 'rejected': 1}
    b = {'fleet': {'n_pools': 1.0, 'pressure': 0.0, 'mean_load': 6.0,
                   'max_sojourn': 40.0}, 'applied': 1, 'skipped': 3}
    out = tctl.reduce_control([a, None, b])
    assert out == jctl.reduce_control([a, None, b])
    assert out['n_pools'] == 4.0
    assert out['pressure'] == pytest.approx(0.75)
    assert out['mean_load'] == pytest.approx(3.0)
    assert out['max_sojourn'] == 40.0
    assert (out['applied'], out['rejected'], out['skipped']) == (3, 1, 3)
    empty = tctl.reduce_control([])
    assert empty['n_pools'] == 0.0 and empty['applied'] == 0


# -- non-finite and out-of-range inputs -------------------------------------

@pytest.mark.parametrize('value', chip_smoke.CAST_EDGES, ids=repr)
def test_to_int32_xla_matches_jax_at_the_edges(value):
    x = np.float32([value])
    got = to_int32_xla(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax.numpy.asarray(x).astype(jax.numpy.int32)))


def test_to_int32_xla_matches_jax_on_seeded_values():
    x = chip_smoke.cast_vector()
    want = np.asarray(jax.numpy.asarray(x).astype(jax.numpy.int32))
    np.testing.assert_array_equal(to_int32_xla(torch.from_numpy(x)).numpy(),
                                  want)
    # Hundreds of them lie outside the int32 range, where a plain cast
    # is undefined.
    assert (~(np.abs(x) < 2.0 ** 31)).sum() > 300


@pytest.fixture(scope='module')
def jax_tick():
    """One JAX control tick from ``control_init`` on numpy columns, as
    numpy, memoized by key for the module."""
    memo = {}

    def run(key, cols):
        if key not in memo:
            n = len(cols['active'])
            memo[key] = jax.tree.map(np.asarray, jctl.control_step(
                jctl.control_init(n), jctl.control_inputs(n, **cols)))
        return memo[key]
    return run


def port_tick(form, cols):
    """One port control tick from ``control_init`` on the CPU, plain or
    over a 2-shard mesh (unsharded after)."""
    n = len(cols['active'])
    state = tctl.control_init(n, device=CPU)
    inp = tctl.control_inputs(n, device=CPU, **cols)
    if form == 'plain':
        return tctl.control_step(state, inp)
    mesh = Mesh([CPU] * 2, ('pools',))
    out = tctl.make_control_step(mesh)(tctl.shard_control_state(state, mesh),
                                       tctl.shard_control_inputs(inp, mesh))
    return tuple(unshard(t) for t in out)


def assert_tick_matches(got, want, tag):
    """Decisions, carried targets and the fleet counts bit for bit (NaN
    equal to NaN), ``mean_load`` to rtol 1e-5."""
    (ts, td, tf), (js, jd, jf) = got, want
    for name, w in jd.items():
        assert td[name].numpy().dtype == w.dtype, (tag, name)
        np.testing.assert_array_equal(td[name].numpy(), w,
                                      err_msg='%s %s' % (tag, name))
    np.testing.assert_array_equal(ts.targets.numpy(), js.targets)
    for name in ('n_pools', 'pressure', 'max_sojourn'):
        np.testing.assert_array_equal(tf[name].numpy(), jf[name],
                                      err_msg='%s %s' % (tag, name))
    np.testing.assert_allclose(tf['mean_load'].numpy(), jf['mean_load'],
                               rtol=1e-5)


@pytest.mark.parametrize('form', FORMS)
@pytest.mark.parametrize('name,case', CASES, ids=[n for n, _ in CASES])
def test_nonfinite_row_decisions_match_jax(name, case, form, jax_tick):
    """Each non-finite or out-of-range row on row 0 of an ordinary
    16-pool fleet: a cast that does not saturate changes `plan_target`,
    `plan_spares` or `delta` there."""
    cols = chip_smoke.nonfinite_control_columns([case])
    assert_tick_matches(port_tick(form, cols), jax_tick(name, cols), name)


def test_frozen_nonfinite_decisions_are_the_jax_packages(jax_tick):
    """All five cases in one fleet: the JAX package's decisions are the
    numbers chip_smoke.py holds the card against, and the port's too."""
    cols = chip_smoke.nonfinite_control_columns([case for _, case in CASES])
    want = jax_tick('all', cols)
    for name, frozen in chip_smoke.JAX_NONFINITE_DECISIONS.items():
        assert want[1][name].tolist() == frozen, name
    assert_tick_matches(port_tick('plain', cols), want, 'all')


def fuzz_columns(seed):
    """The soak's columns over FUZZ_ROWS pools with FUZZ_SHARE of each
    float column replaced by NaN, +-inf, -5, +-4e9, 0 or 1e-30."""
    rng = np.random.default_rng(seed)
    cols = soak_inputs(rng, FUZZ_ROWS, 0)
    for name in FLOAT_INPUTS:
        cols[name] = chip_smoke.with_specials(rng, cols[name], FUZZ_SHARE)
    return cols


@pytest.mark.parametrize('form', FORMS)
@pytest.mark.parametrize('seed', FUZZ_SEEDS)
def test_nonfinite_fuzz_matches_jax(seed, form, jax_tick):
    cols = fuzz_columns(seed)
    assert np.isnan(np.stack([cols[k] for k in FLOAT_INPUTS])).any()
    assert_tick_matches(port_tick(form, cols),
                        jax_tick('fuzz %d' % seed, cols), 'seed %d' % seed)
