"""The PyTorch port's mesh forms against the JAX package's, on the CPU.

A port ``Mesh`` of eight ``cpu`` shards stands beside the JAX package's
``jax.sharding.Mesh`` over the eight virtual CPU devices that
``conftest`` forces, as a 1-D ('pools',) mesh and a 2-D ('host', 'chip')
2x4 one. Both packages step their sharded forms on identical seeded
numpy inputs, and the port's results, gathered with ``unshard``, are
held as the unsharded tests hold them:

- telemetry (gspmd, shard_map, live, scan; 64 pools, 6 ticks): floats
  to rtol 1e-5 (1e-4 for the FIR output `filtered`), `drop`, `clamped`,
  the window ring and the CoDel state exactly, `target` exactly off
  ``convert.target_near_boundary``;
- control (4,096 pools): decisions and carried targets bit-identical,
  `mean_load` to rtol 1e-5;
- health (1,024 backends): verdicts exactly off
  ``convert.health_score_near_boundary``, the int32 counts exactly;
  and every port leaf bit for bit against the port's unsharded step.

The JAX forms compile once per file (module-scoped fixtures).
"""

import numpy as np
import pytest

jax = pytest.importorskip('jax')
torch = pytest.importorskip('torch')

from jax.sharding import Mesh as JMesh  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402

from cueball_tpu.parallel import control as jctl  # noqa: E402
from cueball_tpu.parallel import health as jhl  # noqa: E402
from cueball_tpu.parallel import telemetry as jtel  # noqa: E402
from cueball_tpu_torch import convert  # noqa: E402
from cueball_tpu_torch._device import to_host_values  # noqa: E402
from cueball_tpu_torch.entry import dryrun_multichip  # noqa: E402
from cueball_tpu_torch.parallel import control as tctl  # noqa: E402
from cueball_tpu_torch.parallel import health as thl  # noqa: E402
from cueball_tpu_torch.parallel import telemetry as ttel  # noqa: E402
from cueball_tpu_torch.parallel.mesh import (Mesh, Reducer,  # noqa: E402
                                             shard_rows, unshard)

from test_torch_control import soak_inputs  # noqa: E402
from test_torch_health import check_against_jax  # noqa: E402
from test_torch_telemetry import (_compare, _compare_outputs,  # noqa: E402
                                  _compare_state, _jnp, _start_state, _tick)

CPU = 'cpu'
POOLS, TICKS = 64, 6
SHAPES = {'1d': (('pools',), (8,)), '2d': (('host', 'chip'), (2, 4))}


@pytest.fixture(scope='module')
def meshes():
    """name -> (JAX mesh, port mesh, axes) for the 1-D and 2-D meshes."""
    devs = np.array(jax.devices()[:8])
    assert devs.size == 8, 'conftest should have forced 8 CPU devices'
    return {name: (JMesh(devs.reshape(shape), axes),
                   Mesh(np.array([CPU] * 8, dtype=object).reshape(shape),
                        axes), axes)
            for name, (axes, shape) in SHAPES.items()}


def test_mesh_layout_and_reducer():
    """Shards are numbered in the grid's row-major order over `axes`;
    the flat and hierarchical reductions give the same int32 totals."""
    grid = np.array(['cpu'] * 8, dtype=object).reshape(2, 4)
    mesh = Mesh(grid, ('host', 'chip'))
    assert mesh.size == 8 and mesh.shape == {'host': 2, 'chip': 4}
    assert mesh.devices.shape == (2, 4)
    assert mesh.axis_names == ('host', 'chip')
    t = torch.arange(16, dtype=torch.int32)
    blocks = shard_rows(t, mesh, ('host', 'chip'))
    assert [b.tolist() for b in blocks] == [[2 * i, 2 * i + 1]
                                            for i in range(8)]
    assert all(b.is_contiguous() for b in blocks)
    parts = [b.sum(dtype=torch.int32) for b in blocks]
    for hier in (False, True):
        red = Reducer(mesh, ('host', 'chip'), hierarchical=hier)
        totals = red.all_reduce(parts)
        assert [int(x) for x in totals] == [120] * 8
        assert totals[0].dtype == torch.int32
        assert int(red.total(parts, 'max')) == 29
    with pytest.raises(ValueError, match='every mesh axis'):
        mesh.shard_devices(('chip',))
    with pytest.raises(ValueError, match='cannot split'):
        shard_rows(torch.arange(12), mesh, ('host', 'chip'))


def test_mesh_naming_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        assert Mesh(['cuda:0'] * 2, ('pools',)).size == 2
    else:
        with pytest.raises(RuntimeError, match='no CUDA device'):
            Mesh(['cuda:0'] * 2, ('pools',))


# -- telemetry ----------------------------------------------------------------

FORMS = {
    'gspmd': (jtel.make_sharded_step, ttel.make_sharded_step),
    'shard_map': (jtel.make_shardmap_step, ttel.make_shardmap_step),
    'live': (jtel.make_live_step, ttel.make_live_step),
}


@pytest.mark.parametrize('mesh_name', sorted(SHAPES))
@pytest.mark.parametrize('form', sorted(FORMS))
def test_telemetry_forms_match_jax(meshes, form, mesh_name):
    jmesh, mesh, axes = meshes[mesh_name]
    make_j, make_t = FORMS[form]
    j_step, t_step = make_j(jmesh, axes), make_t(mesh, axes)
    # The seeded inputs of test_torch_telemetry's 64-pool run, which
    # put no row on the target boundary.
    rng = np.random.default_rng(2024)
    j_state = _start_state(rng, POOLS)
    t_state = ttel.shard_state(
        convert.fleet_state_from_numpy(_jnp(j_state), device=CPU), mesh,
        axes)
    j_state = jtel.shard_state(j_state, jmesh, axes)
    ptrs = []
    for t in range(TICKS):
        inp = _tick(rng, POOLS, t)
        j_state, j_out, j_fleet = j_step(
            j_state, jtel.shard_inputs(jtel.fleet_inputs(POOLS, **inp),
                                       jmesh, axes))
        t_state, t_out, t_fleet = t_step(
            t_state, ttel.shard_inputs(
                ttel.fleet_inputs(POOLS, device=CPU, **inp), mesh, axes))
        assert len(t_state) == 8 and t_state[3].windows.shape == (8, 128)
        ptrs.append([s.windows.data_ptr() for s in t_state])
        _compare(unshard(t_state), unshard(t_out), unshard(t_fleet),
                 j_state, j_out, j_fleet, inp, '%s %s tick %d'
                 % (form, mesh_name, t))
    if form == 'live':
        # Each shard ping-pongs its own ring: no new buffer after the
        # second tick, and no two shards share one.
        assert ptrs[2] == ptrs[4] and ptrs[3] == ptrs[5]
        assert len(set(ptrs[2] + ptrs[3])) == 16


@pytest.mark.parametrize('mesh_name', sorted(SHAPES))
def test_sharded_scan_matches_jax(meshes, mesh_name):
    jmesh, mesh, axes = meshes[mesh_name]
    rng = np.random.default_rng(77)
    ticks = [_tick(rng, POOLS, t) for t in range(TICKS)]
    stacked = {k: np.stack([tk[k] for tk in ticks]) for k in ticks[0]}
    j_state0 = _start_state(rng, POOLS)
    t_state0 = convert.fleet_state_from_numpy(_jnp(j_state0), device=CPU)
    j_fin, j_outs, j_fleets = jtel.make_sharded_scan(jmesh, axes)(
        jtel.shard_state(j_state0, jmesh, axes),
        jtel.shard_window(jtel.FleetInputs(**stacked), jmesh, axes))
    window = convert.fleet_inputs_from_numpy(jtel.FleetInputs(**stacked),
                                             device=CPU)
    t_fin, t_outs, t_fleets = ttel.make_sharded_scan(mesh, axes)(
        ttel.shard_state(t_state0, mesh, axes),
        ttel.shard_window(window, mesh, axes))
    _, _, (_, out_specs, fleet_specs) = ttel._scan_shardings(axes)
    t_outs = unshard(t_outs, out_specs)
    t_fleets = unshard(t_fleets, fleet_specs)
    assert t_outs['filtered'].shape == (TICKS, POOLS)
    for t in range(TICKS):
        _compare_outputs({k: v[t] for k, v in t_outs.items()},
                         {k: v[t] for k, v in t_fleets.items()},
                         {k: v[t] for k, v in j_outs.items()},
                         {k: v[t] for k, v in j_fleets.items()},
                         ticks[t], 'scan %s tick %d' % (mesh_name, t))
    _compare_state(unshard(t_fin), j_fin, 'scan %s final' % mesh_name)


# -- control ------------------------------------------------------------------

CONTROL_ROWS, CONTROL_STEPS = 4096, 3
CONTROL_FORMS = {
    'gspmd': (jctl.make_control_step, tctl.make_control_step),
    'shard_map': (jctl.make_shardmap_control_step,
                  tctl.make_shardmap_control_step),
}


@pytest.mark.parametrize('mesh_name', sorted(SHAPES))
@pytest.mark.parametrize('form', sorted(CONTROL_FORMS))
def test_control_forms_bit_identical_to_jax(meshes, form, mesh_name):
    jmesh, mesh, axes = meshes[mesh_name]
    make_j, make_t = CONTROL_FORMS[form]
    j_step, t_step = make_j(jmesh, axes), make_t(mesh, axes)
    n = CONTROL_ROWS
    rng = np.random.default_rng(11)
    j_state = jctl.shard_control_state(jctl.control_init(n), jmesh, axes)
    t_state = tctl.shard_control_state(tctl.control_init(n, device=CPU),
                                       mesh, axes)
    plain = tctl.control_init(n, device=CPU)
    moved = 0
    for k in range(CONTROL_STEPS):
        cols = soak_inputs(rng, n, k)
        j_state, j_dec, j_fleet = j_step(j_state, jctl.shard_control_inputs(
            jctl.control_inputs(n, **cols), jmesh, axes))
        t_inp = tctl.control_inputs(n, device=CPU, **cols)
        t_state, t_dec, t_fleet = t_step(
            t_state, tctl.shard_control_inputs(t_inp, mesh, axes))
        plain, p_dec, _ = tctl.control_step(plain, t_inp)
        got, fleet = unshard(t_dec), to_host_values(t_fleet[0])
        for name, want in j_dec.items():
            want = np.asarray(want)
            assert got[name].dtype == p_dec[name].dtype, name
            np.testing.assert_array_equal(got[name].numpy(), want,
                                          err_msg='%d %s' % (k, name))
            assert torch.equal(got[name], p_dec[name]), (k, name)
        np.testing.assert_array_equal(unshard(t_state).targets.numpy(),
                                      np.asarray(j_state.targets))
        want = {key: np.asarray(v).item() for key, v in j_fleet.items()}
        for name in ('n_pools', 'pressure', 'max_sojourn'):
            assert fleet[name] == want[name], (k, name)
        assert fleet['mean_load'] == pytest.approx(want['mean_load'],
                                                   rel=1e-5)
        moved += int((got['codel_target'] > 0).sum())
    assert moved > 0


# -- health -------------------------------------------------------------------

HEALTH_ROWS, HEALTH_TICKS = 1024, 4
HEALTH_FORMS = {
    'gspmd': (jhl.make_health_step, thl.make_health_step),
    'shard_map': (jhl.make_shardmap_health_step,
                  thl.make_shardmap_health_step),
}


def health_cols(rng, n, t, slow):
    """One tick of seeded traffic (tests/test_torch_health.py's seeded
    run): gamma latencies, the `slow` rows 40x slower, errors, sheds,
    idle and reset rows."""
    lat = rng.gamma(2.0, 4.0, n).astype(np.float32)
    lat[slow] *= 40.0
    cnt = rng.integers(0, 20, n).astype(np.int32)
    buckets = np.zeros((n, thl.LAT_BINS), np.int32)
    bk = np.minimum((np.log2(1.0 + lat) * 4).astype(np.int32),
                    thl.LAT_BINS - 1)
    buckets[np.arange(n), bk] = cnt
    act = rng.random(n) < 0.95
    elig = act.copy()
    elig[0] = False
    return dict(lat_sum=lat * cnt, lat_count=cnt, lat_buckets=buckets,
                claim_buckets=buckets,
                errors=(rng.random(n) < 0.02).astype(np.int32),
                shed=(rng.random(n) < 0.01).astype(np.int32),
                active=act, eligible=elig, reset=rng.random(n) < 0.01,
                now_ms=np.float32(200.0 * (t + 1)))


@pytest.mark.parametrize('mesh_name', sorted(SHAPES))
@pytest.mark.parametrize('form', sorted(HEALTH_FORMS))
def test_health_forms_match_jax(meshes, form, mesh_name):
    jmesh, mesh, axes = meshes[mesh_name]
    make_j, make_t = HEALTH_FORMS[form]
    j_step, t_step = make_j(jmesh, axes), make_t(mesh, axes)
    n = HEALTH_ROWS
    rng = np.random.default_rng(21)
    slow = rng.random(n) < 0.02
    j_state = jhl.shard_health_state(jhl.health_init(n), jmesh, axes)
    t_state = thl.shard_health_state(thl.health_init(n, device=CPU), mesh,
                                     axes)
    plain = thl.health_init(n, device=CPU)
    edge_rows = grays = 0
    for t in range(HEALTH_TICKS):
        cols = health_cols(rng, n, t, slow)
        j_state, jv, jf = j_step(j_state, jhl.shard_health_inputs(
            jhl.health_inputs(n, **cols), jmesh, axes))
        t_inp = thl.health_inputs(n, device=CPU, **cols)
        t_state, tv, tf = t_step(t_state,
                                 thl.shard_health_inputs(t_inp, mesh, axes))
        plain, pv, pf = thl.health_step(plain, t_inp)
        tv, tf = unshard(tv), to_host_values(tf[0])
        # Sharded against unsharded in the port: every leaf exactly.
        for name, want in pv.items():
            assert torch.equal(tv[name], want), (t, name)
        assert tf == to_host_values(pf)
        for got, want in zip(unshard(t_state), plain):
            assert torch.equal(got, want), t
        edge_rows += check_against_jax({k: v.numpy() for k, v in tv.items()},
                                       tf, jv, jf, '%s %d' % (form, t))
        grays += tf['n_gray']
    assert grays > 0
    # The backend-ticks on the score boundary in this seeded run.
    assert edge_rows == 1


# -- partition rules ----------------------------------------------------------

def _port_spec_paths(tree, path=()):
    """{'a/b': placement} of a port placement tree. A plain tuple is a
    node when it holds NamedTuples or dicts, else a placement."""
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, '_fields'):
        items = zip(tree._fields, tree)
    elif any(isinstance(x, dict) or hasattr(x, '_fields') for x in tree):
        items = enumerate(tree)
    else:
        return {'/'.join(map(str, path)): tree}
    out = {}
    for k, v in items:
        out.update(_port_spec_paths(v, path + (k,)))
    return out


def _jax_spec_paths(tree, spec_of=tuple):
    """{'a/b': placement} of a JAX PartitionSpec or NamedSharding tree,
    each leaf as the port writes it (a tuple)."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    def norm(spec):
        # JAX writes a one-axis entry as the bare axis name.
        return tuple((e,) if isinstance(e, str) else e for e in spec)
    return {jctl._path_str(path): norm(spec_of(leaf))
            for path, leaf in leaves}


@pytest.mark.parametrize('mesh_name', sorted(SHAPES))
def test_every_leaf_placed_as_jax_places_it(meshes, mesh_name):
    jmesh, _, axes = meshes[mesh_name]
    for t_specs, j_specs in ((tctl.control_specs(axes),
                              jctl.control_specs(axes)),
                             (thl.health_specs(axes),
                              jhl.health_specs(axes))):
        for t_tree, j_tree in zip(t_specs, j_specs):
            got = _port_spec_paths(t_tree)
            assert got == _jax_spec_paths(j_tree)
            assert all(spec == () or spec[0] == axes
                       for spec in got.values())
    for t_tree, j_tree in zip(ttel._step_shardings(axes),
                              jtel._step_shardings(jmesh, axes)):
        assert _port_spec_paths(t_tree) == _jax_spec_paths(
            j_tree, lambda sh: tuple(sh.spec))


def test_dryrun_multichip_on_8_cpu_shards():
    legs = dryrun_multichip(8, device=CPU)
    assert legs == ['gspmd', 'gspmd', 'shard_map', 'shard_map', 'gspmd-2d',
                    'shard_map-2d', 'live', 'live-2d', 'scan', 'scan-2d']
