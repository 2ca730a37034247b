"""The port's bench (``cueball_tpu_torch.bench``) and its chip-capture
tool on the CPU, at tiny sizes: every stage lands its keys, a killed
child leaves the stages that landed in its progress file, the code hash
tracks the CUDA source, the default device is the card with no CPU
fallback, and the capture tool publishes only a complete record."""

import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip('torch')

from cueball_tpu_torch import bench  # noqa: E402
from cueball_tpu_torch.tools import chip_bench  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(pools=128, max_iters=2)

STAGE_KEYS = {
    'device': {'device', 'device_name', 'nvidia_smi', 'power_limit',
               'torch', 'cuda'},
    'dispatch_floor': {'dispatch_floor_us'},
    'step_small': {'small_pools', 'small_pools_per_sec'},
    'step_live': {'pools', 'pools_per_sec_live', 'live_ms_rounds'},
    'fleet_sweep': {'telemetry_pools_per_sec_sweep',
                    'control_step_pools_per_sec'},
    'step_plain': {'pools_per_sec_plain'},
    'step_kernel': {'pools_per_sec_kernel', 'default_is_kernel'},
    'scan': {'pools_per_sec_scan'},
    'tick_sizes': {'tick_sizes'},
    'tick_cost_128': {'tick_us_128', 'gather_us_128', 'gather_full_us_128'},
    'health_sweep': {'health_step_pools_per_sec', 'health_step_us'},
}


def test_every_stage_emits_its_keys():
    recs = []
    bench.run_stages(recs.append, device='cpu', **TINY)
    assert [r['stage'] for r in recs] == bench.stage_names(128)
    acc = {}
    for r in recs:
        stage = r.pop('stage')
        want = set(STAGE_KEYS[stage])
        if stage != 'device':
            want.add('fir_launches_' + stage)
            assert r['fir_launches_' + stage] == 0   # no kernel on the CPU
        assert set(r) == want, stage
        acc.update(r)
    assert acc['device'] == 'cpu' and acc['nvidia_smi'] is None
    assert acc['pools'] == 128 and acc['small_pools'] == 128
    assert len(acc['live_ms_rounds']) == bench.LIVE_ROUNDS
    assert list(acc['control_step_pools_per_sec']) == ['128']
    assert list(acc['health_step_us']) == ['128']
    assert acc['tick_sizes'] == [128]
    assert acc['default_is_kernel'] is False
    # Every rate and time is finite and positive, but the kernel's,
    # which has no CPU form.
    assert bench.bad_rates(acc) == ['pools_per_sec_kernel']


def test_step_pools_are_the_shapes_the_stages_step(monkeypatch):
    """step_pools lists every fleet size at which the stages run the
    FIR: the default step's FIR sees exactly those row counts (the
    stage sizes capped three ways at 2048 pools: the small stage and
    the sweep at 2048, the tick at 1024, the kernel probe at 8)."""
    from cueball_tpu_torch.parallel import telemetry as tel
    seen = set()
    real = tel.fir_apply

    def recording(windows, taps):
        seen.add(windows.shape[0])
        return real(windows, taps)
    monkeypatch.setattr(tel, 'fir_apply', recording)
    bench.run_stages(lambda rec: None, device='cpu', pools=2048,
                     max_iters=1)
    assert sorted(seen) == bench.step_pools(2048) == [8, 1024, 2048]


_WEDGED_CHILD = """
import sys, time
from cueball_tpu_torch import bench

def wedge(*args, **kw):      # a card that stops answering mid-run
    time.sleep(600)

bench._fleet_sweeps = wedge
bench.child_main(sys.argv[1], 'cpu', **%r)
""" % TINY


def test_progress_survives_a_killed_child(tmp_path):
    """The child wedges at the fleet sweep and is killed; the four
    stages before it are read back from its progress file, and a line
    the kill cut short is skipped."""
    progress = tmp_path / 'progress.jsonl'
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    child = subprocess.Popen([sys.executable, '-c', _WEDGED_CHILD,
                              str(progress)], cwd=str(ROOT), env=env,
                             stdout=subprocess.DEVNULL,
                             stderr=subprocess.PIPE)
    landed = bench.stage_names(128)[:4]
    try:
        deadline = time.monotonic() + 60
        while bench.read_progress(progress)[0] != landed:
            assert child.poll() is None, child.stderr.read()
            assert time.monotonic() < deadline, 'the child never wedged'
            time.sleep(0.02)
    finally:
        child.kill()
        child.wait()
        child.stderr.close()
    assert child.returncode == -9
    with open(progress, 'a', encoding='utf-8') as f:
        f.write('{"stage": "fleet_sw')      # a write the kill cut short
    stages, acc = bench.read_progress(progress)
    assert stages == landed
    assert acc['device'] == 'cpu' and acc['pools'] == 128
    assert acc['dispatch_floor_us'] > 0 and acc['pools_per_sec_live'] > 0


def test_guarded_run_reports_its_kill():
    rec = bench.run_guarded(timeout_s=0.2, device='cpu')
    assert rec['stages_completed'] == []
    assert 'killed after 0.2s' in rec['error']
    assert rec['code_hash'] == bench.code_hash()


def test_code_hash_tracks_the_cuda_source(tmp_path):
    pkg = tmp_path / 'cueball_tpu_torch'
    for rel in bench._CODE:
        src = bench.PACKAGE / rel
        if src.is_dir():
            shutil.copytree(src, pkg / rel,
                            ignore=shutil.ignore_patterns('__pycache__'))
        else:
            pkg.mkdir(exist_ok=True)
            shutil.copy(src, pkg / rel)
    base = bench.code_hash(pkg)
    assert base == bench.code_hash()
    cu = pkg / 'csrc' / 'fir.cu'
    source = cu.read_bytes()
    cu.write_bytes(source.replace(b'__global__', b'__global__ ', 1))
    assert bench.code_hash(pkg) != base
    cu.write_bytes(source)
    assert bench.code_hash(pkg) == base


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)

    def no_child(*args, **kw):
        raise AssertionError('a child started without a card')
    monkeypatch.setattr(bench.subprocess, 'run', no_child)
    emitted = []
    with pytest.raises(RuntimeError, match='no CUDA device'):
        bench.run_stages(emitted.append, **TINY)
    assert emitted == []
    with pytest.raises(RuntimeError, match='no CUDA device'):
        bench.run_guarded(timeout_s=5.0)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        bench.main([])


def _complete_record():
    return {'device': 'cuda', 'device_name': 'NVIDIA H100 80GB HBM3',
            'nvidia_smi': 'NVIDIA H100 80GB HBM3, 700.00 W',
            'power_limit': '700.00 W', 'torch': '2.11.0+cu128',
            'cuda': '12.8', 'pools': 1 << 20, 'pools_per_sec_live': 6e8,
            'pools_per_sec_plain': 4e8, 'pools_per_sec_kernel': 5e8,
            'pools_per_sec_scan': 6e8, 'dispatch_floor_us': 9.0,
            'tick_us_1024': 900.0, 'stages_completed': bench.stage_names(),
            'code_hash': bench.code_hash()}


@pytest.mark.parametrize('case', ['probe_fails', 'incomplete', 'complete'])
def test_chip_bench_publishes_only_a_complete_record(case, tmp_path,
                                                     monkeypatch):
    out, log = tmp_path / 'BENCH_H100.json', tmp_path / 'probe.md'
    rec = _complete_record()
    if case == 'incomplete':
        del rec['pools_per_sec_scan'], rec['tick_us_1024']
        rec['error'] = 'bench child killed after 900s'
    monkeypatch.setattr(chip_bench, 'probe', lambda timeout_s: (
        {'error': 'no CUDA device (exit 0)'} if case == 'probe_fails' else
        {'device': rec['device_name'], 'nvidia_smi': rec['nvidia_smi']}))
    monkeypatch.setattr(chip_bench.bench, 'run_guarded',
                        lambda *args: dict(rec))
    rc = chip_bench.main(['--out', str(out), '--log', str(log)])
    lines = log.read_text().splitlines()
    if case != 'complete':
        assert rc == 1 and not out.exists()
        assert ('probe: FAILED' if case == 'probe_fails'
                else 'capture: INCOMPLETE') in lines[-1]
        if case == 'incomplete':
            assert 'missing: pools_per_sec_scan,tick_us_*' in lines[-1]
        return
    assert rc == 0 and len(lines) == 2 and 'capture: OK' in lines[1]
    art = json.loads(out.read_text())
    assert art['artifact'] == 'BENCH_H100'
    for key in ('device_name', 'power_limit', 'torch', 'cuda', 'code_hash'):
        assert art[key] == rec[key]


def test_chip_bench_writes_no_existing_artifact():
    """The tool's default artifact and probe log are new files at the
    root of the checkout, kept out of git: not the JAX bench's
    ``BENCH_TPU.json``, ``BENCH_r*.json`` or ``CHIP_PROBE_r*.md``."""
    ignored = (ROOT / '.gitignore').read_text().split()
    assert chip_bench.ARTIFACT == ROOT / 'BENCH_H100.json'
    assert chip_bench.PROBE_LOG == ROOT / 'CHIP_PROBE_H100.md'
    for path in (chip_bench.ARTIFACT, chip_bench.PROBE_LOG):
        assert path.name in ignored
        assert not re.fullmatch(
            r'BENCH_(TPU.*|r\d+)\.json|CHIP_PROBE_r\d+\.md', path.name)
