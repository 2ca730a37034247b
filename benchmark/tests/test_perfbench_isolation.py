"""What a run of the benchmark may load, and where it refuses to run."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from benchmark.isolation import forbidden_modules

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / 'benchmark'


def test_top_level_names_compared_whole():
    names = ['jax', 'jax.numpy', 'jaxlib.xla_client', 'flax.linen',
             'cueball_tpu', 'cueball_tpu.pool', 'cueball_tpu_torch',
             'cueball_tpu_torch.pool', 'jaxtyping', 'cueball_tpux']
    assert forbidden_modules(names) == [
        'cueball_tpu', 'cueball_tpu.pool', 'flax.linen', 'jax', 'jax.numpy',
        'jaxlib.xla_client']


def _python(code: str, cwd=ROOT, env=None) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, '-c', code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=240)


def test_a_run_loads_no_jax_and_no_jax_package():
    """A whole small run on the CPU, then the loaded modules."""
    code = '''
import json, sys
from benchmark.tests.small import run_small
from benchmark.isolation import forbidden_modules
res = run_small('fleet65k-churn1', seconds=0.5)
assert res['readings']['live_err'] < 1e-5, res['readings']
print(json.dumps({'bad': forbidden_modules(),
                  'port': 'cueball_tpu_torch' in sys.modules}))
'''
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {'bad': [], 'port': True}


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return {n.split('.', 1)[0] for n in names}


def test_the_reference_loads_nothing_of_the_program():
    for path in sorted((BENCH / 'reference').glob('*.py')):
        assert not _imports(path) & {'cueball_tpu_torch', 'cueball_tpu',
                                     'jax', 'jaxlib'}, path
    code = '''
import sys
import benchmark.compare, benchmark.reference.follow
import benchmark.reference.fleet_model
print(sorted(n for n in sys.modules
             if n.split('.', 1)[0] in ('cueball_tpu_torch', 'cueball_tpu',
                                       'jax', 'jaxlib')))
'''
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == '[]'


def _no_card_env():
    env = dict(os.environ)
    env['CUDA_VISIBLE_DEVICES'] = ''
    return env


def test_the_run_command_fails_without_a_card():
    out = subprocess.run(
        [sys.executable, '-m', 'benchmark.run', '--workload',
         'fleet65k-churn1', '--seed', str(2 ** 31 + 11), '--seconds', '1',
         '--trace', '0'], cwd=ROOT, env=_no_card_env(), capture_output=True,
        text=True, timeout=240)
    assert out.returncode != 0
    assert out.stdout == ''
    assert 'CUDA card' in out.stderr


def test_the_run_command_fails_with_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path / 'BENCHMARK.json')
    shutil.copytree(BENCH, tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    out = subprocess.run(
        [sys.executable, '-m', 'benchmark.run', '--workload',
         'fleet65k-churn10', '--seed', '5', '--seconds', '1', '--trace', '0'],
        cwd=tmp_path, capture_output=True, text=True, timeout=240)
    assert out.returncode != 0
    assert out.stdout == ''
