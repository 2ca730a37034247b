"""The port on the card: the CUDA kernel against its plain version (and
its build from four threads at once), the control and health steps
against their CPU runs, the live sampler through the kernel, the mesh
forms over shards that share the card against the unsharded steps,
the fleet passes over shard loop threads, the port bench's stages, the
saturating float-to-int32 cast on the non-finite rows whose JAX
numbers ``chip_smoke.py`` freezes, and a small fleet of the port's own
pools sampled on the card (``chip_smoke.py``'s phase 19 in small).

These tests need an NVIDIA GPU and nvcc: they carry the ``cuda`` marker
and skip without a card. On a GPU machine run them with
``python -m pytest tests/test_torch_cuda.py -m cuda``.
"""

import asyncio
import threading

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import chip_smoke  # noqa: E402
from cueball_tpu_torch import bench, convert  # noqa: E402
from cueball_tpu_torch._cast import to_int32_xla  # noqa: E402
from cueball_tpu_torch._device import to_host_values  # noqa: E402
from cueball_tpu_torch.kernels import build  # noqa: E402
from cueball_tpu_torch.monitor import PoolMonitor  # noqa: E402
from cueball_tpu_torch.ops import fir  # noqa: E402
from cueball_tpu_torch.parallel import control as ctl  # noqa: E402
from cueball_tpu_torch.parallel import health as hl  # noqa: E402
from cueball_tpu_torch.parallel import telemetry as tel  # noqa: E402
from cueball_tpu_torch.parallel.mesh import Mesh, unshard  # noqa: E402
from cueball_tpu_torch.parallel.sampler import FleetSampler  # noqa: E402
from cueball_tpu_torch.examples import (  # noqa: E402
    discovered_fleet, pool_fleet)
from cueball_tpu_torch.entry import (ShardedWorkload,  # noqa: E402
                                     SyntheticPool, example_inputs,
                                     health_example_columns, tick_inputs)
from cueball_tpu_torch.shard import FleetRuntime  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.parametrize('k', [128, 97, 1])
@pytest.mark.parametrize('p', [1, 255, 256, 300, 65536])
def test_fir_kernel_matches_plain(card, p, k):
    g = torch.Generator(device='cpu').manual_seed(p * 1000 + k)
    w = torch.rand((p, k), generator=g).mul_(8.0).to(card)
    taps = fir.gen_taps(k, device=card)
    before = fir.fir_apply_cuda.launches
    got = fir.fir_apply_cuda(w, taps)
    torch.cuda.synchronize()
    assert fir.fir_apply_cuda.launches == before + 1
    torch.testing.assert_close(got, fir.fir_apply_plain(w, taps),
                               rtol=1e-5, atol=1e-5)


def test_build_from_four_threads(card, tmp_path):
    """Four threads load the kernel into an empty build directory at
    once: one nvcc runs, all four get the one library, and the kernel it
    holds matches its plain version."""
    saved = build.BUILD_DIR
    build.set_build_dir(tmp_path / 'kernels')
    try:
        runs = build.nvcc_runs
        libs, errors = [], []
        barrier = threading.Barrier(4)

        def ask():
            barrier.wait()
            try:
                libs.append(build.load('fir'))
            except Exception as e:     # reported below
                errors.append(e)

        threads = [threading.Thread(target=ask) for _ in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
        assert not any(th.is_alive() for th in threads)
        assert errors == []
        assert build.nvcc_runs == runs + 1
        assert len(libs) == 4 and all(lib is libs[0] for lib in libs)
        assert [p.name for p in (tmp_path / 'kernels').iterdir()] == [
            build.library_path('fir').name]
        w = torch.rand((4096, 128), device=card)
        taps = fir.gen_taps(128, device=card)
        torch.testing.assert_close(fir.fir_apply_cuda(w, taps),
                                   fir.fir_apply_plain(w, taps),
                                   rtol=1e-5, atol=1e-5)
    finally:
        build.set_build_dir(saved)


def test_fleet_passes_launch_the_kernel_once_per_shard(card):
    """FleetRuntime over a 4-shard workload on the card against its CPU
    twin: the fleet rows agree, and each pass launches the FIR kernel
    once per shard, from the shard loops' threads."""
    on_card, on_cpu = ShardedWorkload(4, 512), ShardedWorkload(4, 512)
    rt = FleetRuntime(on_card, on_card.options())
    twin = FleetRuntime(on_cpu, on_cpu.options(device='cpu'))

    async def t():
        for k in range(3):
            on_card.advance()
            on_cpu.advance()
            before = fir.fir_apply_cuda.launches
            got = await rt.sample_fleet()
            assert fir.fir_apply_cuda.launches == before + 4
            want = await twin.sample_fleet()
            assert got['n_pools'] == want['n_pools'] == 2048.0
            for key, v in want.items():
                assert got[key] == pytest.approx(v, rel=1e-5, abs=1e-5), key
            assert (await rt.control_fleet())['n_pools'] == 2048.0
            await twin.control_fleet()
        await rt.stop()
        await twin.stop()
    try:
        asyncio.run(t())
    finally:
        on_card.close()
        on_cpu.close()


def test_fir_kernel_rejects_bad_args(card):
    w = torch.ones((4, 8), device=card)
    with pytest.raises(TypeError):
        fir.fir_apply_cuda(w.double(), torch.ones(8, device=card).double())
    with pytest.raises(ValueError):
        fir.fir_apply_cuda(w, torch.ones(7, device=card))
    with pytest.raises(ValueError):
        fir.fir_apply_cuda(w.t(), torch.ones(4, device=card))


def test_fleet_step_on_card_uses_kernel(card):
    rng = np.random.default_rng(3)
    state, base = example_inputs(4096, seed=3, device=card)
    ref = state
    live = tel.make_live_step()
    before = fir.fir_apply_cuda.launches
    for k in range(4):
        inp = tick_inputs(base, rng, k)
        ref, r_out, _ = tel.fleet_step_plain(ref, inp)
        state, out, _ = live(state, inp)
        torch.testing.assert_close(out['filtered'], r_out['filtered'],
                                   rtol=1e-5, atol=1e-5)
        assert torch.equal(out['drop'], r_out['drop'])
        assert torch.equal(state.windows, ref.windows)
    assert fir.fir_apply_cuda.launches == before + 4


def _cpu(tree):
    return type(tree)(*(t.cpu() for t in tree))


def test_control_step_on_card_matches_cpu(card):
    rng = np.random.default_rng(4)
    n = 65536
    state = ctl.control_init(n, device=card)
    ref = ctl.control_init(n, device='cpu')
    step = ctl.make_control_step()
    for k in range(4):
        target = np.where(rng.random(n) < 0.33, np.inf,
                          rng.integers(50, 800, n).astype(np.float64))
        inp = ctl.control_inputs(
            n, device=card, samples=rng.random(n) * 12.0,
            sojourns=rng.random(n) * 900.0, filtered=rng.random(n) * 10.0,
            target_delay=target, spares=rng.integers(0, 6, n),
            maximum=rng.integers(6, 20, n), active=rng.random(n) < 0.9,
            reset=rng.random(n) < 0.02, now_ms=1000.0 * (k + 1))
        state, dec, fleet = step(state, inp)
        ref, r_dec, r_fleet = step(ref, _cpu(inp))
        for name in dec:
            assert torch.equal(dec[name].cpu(), r_dec[name]), name
        assert torch.equal(state.targets.cpu(), ref.targets)
        torch.testing.assert_close(fleet['mean_load'].cpu(),
                                   r_fleet['mean_load'], rtol=1e-5, atol=0)


def test_health_step_on_card_matches_cpu(card):
    n = 10240
    cols = dict(health_example_columns(n), now_ms=np.float32(1000.0))
    state = hl.health_init(n, device=card)
    ref = hl.health_init(n, device='cpu')
    for _ in range(hl.ENTER_STREAK + 1):
        state, v, f = hl.health_step(state, hl.health_inputs(
            n, device=card, **cols))
        ref, rv, rf = hl.health_step(ref, hl.health_inputs(
            n, device='cpu', **cols))
        off = torch.as_tensor(~convert.health_score_near_boundary(
            rv['ewma_ms'].numpy()))
        for name in ('gray', 'score'):
            assert torch.equal(v[name].cpu()[off], rv[name][off]), name
        for name in ('n_backends', 'median_score', 'mad_score', 'n_gray',
                     'ops', 'errors'):
            assert torch.equal(f[name].cpu(), rf[name]), name
        torch.testing.assert_close(v['ewma_ms'].cpu(), rv['ewma_ms'],
                                   rtol=1e-5, atol=1e-6)
    assert int(f['n_gray']) > 0


def test_sampler_on_card_launches_the_fir_kernel_each_tick(card):
    mon = PoolMonitor()
    for i in range(300):
        mon.register_pool(SyntheticPool(i))
    on_card = FleetSampler({'monitor': mon, 'control': True,
                            'health': True})
    on_cpu = FleetSampler({'monitor': mon, 'control': True,
                           'health': True, 'device': 'cpu'})
    assert on_card.fs_device.type == 'cuda'
    before = fir.fir_apply_cuda.launches
    for k in range(5):
        got, want = on_card.sample_once(), on_cpu.sample_once()
        assert fir.fir_apply_cuda.launches == before + k + 1
        for key, v in want['fleet'].items():
            assert got['fleet'][key] == pytest.approx(v, rel=1e-5), key
        assert got['control']['epoch'] == want['control']['epoch']
    assert on_card.fs_state.windows.device.type == 'cuda'
    on_card.stop()
    on_cpu.stop()


def _leaves(state):
    return [state.windows, *state.codel, state.now_ms]


def test_sharded_live_step_equals_unsharded_kernel_step(card):
    """Two shards on one card: each launches the FIR kernel on its rows,
    so every per-pool output and state leaf equals the unsharded kernel
    step bit for bit; the aggregates agree to rtol 1e-5, n_pools
    exactly. Each shard ping-pongs its own ring: after the second tick
    no [P/2, K] buffer is allocated."""
    mesh = Mesh([card] * 2, ('pools',))
    rng = np.random.default_rng(6)
    state, base = example_inputs(4096, seed=6, device=card)
    sharded = tel.shard_state(
        type(state)(state.windows.clone(), state.codel, state.now_ms), mesh)
    live, live2 = tel.make_live_step(), tel.make_live_step(mesh)
    ptrs = []
    for k in range(5):
        inp = tick_inputs(base, rng, k)
        state, out, fleet = live(state, inp)
        before = fir.fir_apply_cuda.launches
        sharded, s_out, s_fleet = live2(sharded, tel.shard_inputs(inp, mesh))
        assert fir.fir_apply_cuda.launches == before + 2
        ptrs.append([s.windows.data_ptr() for s in sharded])
        got_out, got_fleet = unshard(s_out), unshard(s_fleet)
        for name in out:
            assert torch.equal(got_out[name], out[name]), (k, name)
        for got, want in zip(_leaves(unshard(sharded)), _leaves(state)):
            assert torch.equal(got, want), k
        assert torch.equal(got_fleet['n_pools'], fleet['n_pools'])
        for name in fleet:
            torch.testing.assert_close(got_fleet[name], fleet[name],
                                       rtol=1e-5, atol=1e-5)
    assert ptrs[2] == ptrs[4] and ptrs[3] != ptrs[2]


def test_bench_stages_measure_the_kernel(card):
    """The port bench's guarded run at its small sizes: every stage
    lands with finite, positive rates, the FIR kernel launches in the
    live, kernel, scan and tick stages and never in the plain one, and
    the record names the card and its power limit."""
    rec = bench.run_guarded(timeout_s=600.0, pools=bench.TELEM_SMALL)
    assert 'error' not in rec, rec.get('error')
    assert rec['stages_completed'] == bench.stage_names(bench.TELEM_SMALL)
    assert bench.bad_rates(rec) == []
    for stage in ('step_live', 'step_kernel', 'scan', 'tick_cost_1024',
                  'tick_cost_10240'):
        assert rec['fir_launches_' + stage] > 0, stage
    assert rec['fir_launches_step_plain'] == 0
    assert rec['default_is_kernel'] is True
    assert rec['device_name'] == torch.cuda.get_device_name(0)
    assert rec['power_limit'].endswith(' W')
    assert rec['code_hash'] == bench.code_hash()


def test_to_int32_xla_on_card_matches_cpu(card):
    x = torch.from_numpy(chip_smoke.cast_vector())
    got = to_int32_xla(x.to(card))
    assert got.device.type == 'cuda' and got.dtype == torch.int32
    assert torch.equal(got.cpu(), to_int32_xla(x))


def test_nonfinite_control_rows_on_card(card):
    """The five non-finite cases in one fleet: the card's decisions are
    the JAX package's frozen numbers and the CPU port's."""
    n = chip_smoke.NONFINITE_POOLS
    inp = ctl.control_inputs(n, device=card,
                             **chip_smoke.nonfinite_control_columns(
                                 [case for _, case in
                                  chip_smoke.NONFINITE_CONTROL_CASES]))
    _, dec, _ = ctl.control_step(ctl.control_init(n, device=card), inp)
    _, r_dec, _ = ctl.control_step(ctl.control_init(n, device='cpu'),
                                   _cpu(inp))
    for name, frozen in chip_smoke.JAX_NONFINITE_DECISIONS.items():
        assert dec[name].tolist() == frozen == r_dec[name].tolist(), name


@pytest.mark.parametrize('name,lat_sum', chip_smoke.NONFINITE_LAT_SUMS,
                         ids=[n for n, _ in chip_smoke.NONFINITE_LAT_SUMS])
def test_nonfinite_health_rows_on_card(card, name, lat_sum):
    """A NaN score float bins at 0 on the card as in the JAX package."""
    n = chip_smoke.NONFINITE_BACKENDS
    cols = chip_smoke.nonfinite_health_columns(lat_sum)
    _, v, f = hl.health_step(hl.health_init(n, device=card),
                             hl.health_inputs(n, device=card, **cols))
    _, rv, _ = hl.health_step(hl.health_init(n, device='cpu'),
                              hl.health_inputs(n, device='cpu', **cols))
    frozen = chip_smoke.JAX_NONFINITE_SCORES[name]
    assert v['score'].tolist() == frozen == rv['score'].tolist()
    assert not v['gray'].any()
    fleet = to_host_values({k: f[k]
                            for k in chip_smoke.JAX_NONFINITE_HEALTH_FLEET})
    assert fleet == chip_smoke.JAX_NONFINITE_HEALTH_FLEET


def test_pool_fleet_on_card_matches_cpu_twin(card):
    """Phase 19 in small: 8 pools over 4 servers, 200 claims at a
    concurrency of 8, a tick every 10 claims with 4 taps, so that the
    pools see advisories and decisions."""
    before = fir.fir_apply_cuda.launches
    res = asyncio.run(pool_fleet.run(pools=8, servers=4, claims=200,
                                     concurrency=8, tick_every=10, taps=4))
    assert res['served'] == 200 and res['failed'] == []
    assert res['ticks'] == 22 == len(res['twin_records'])
    assert fir.fir_apply_cuda.launches - before == res['fir_launches'] == 22
    for k, (got, want) in enumerate(zip(res['records'],
                                        res['twin_records'])):
        chip_smoke.check_sampler_records('tick %d' % k, got, want,
                                         counts=False)
    reached = res['reached']
    assert reached['applied'] > 0 and reached['decisions'] > 0
    assert reached['advisories'] > 0


def test_discovered_fleet_on_card_matches_cpu_twin(card):
    """Phase 20 in small: 8 pools discovered in DNS, 200 claims at a
    concurrency of 8 with the SRV sets changed at claim 100, a tick
    every 10 claims with 4 taps, then 10 agent requests by hostname."""
    before = fir.fir_apply_cuda.launches
    res = asyncio.run(discovered_fleet.run(
        services=8, claims=200, swap_at=100, concurrency=8, tick_every=10,
        taps=4, agent_requests=10))
    assert res['served'] == 200 and res['failed'] == []
    assert res['agent'] == {'ok': 10, 'failed': 0}
    assert res['ticks'] == 22 == len(res['twin_records'])
    assert fir.fir_apply_cuda.launches - before == res['fir_launches'] == 22
    for k, (got, want) in enumerate(zip(res['records'],
                                        res['twin_records'])):
        chip_smoke.check_sampler_records('tick %d' % k, got, want,
                                         counts=False)
    swap = res['swap']
    assert swap['pools_removed_b0'] == swap['pools_added_b8'] == 8
    assert swap['pools_on_server0'] == 0 and swap['b8_in_health']
