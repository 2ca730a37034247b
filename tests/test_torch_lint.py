"""The port held to the repo's own analyzers, as ``make check`` holds
the JAX package: ``tools/cblint.py`` over the port, its examples and
``chip_smoke.py``, ``tools/cbfsm.py`` over the port's FSMs, and
``tools/cbflow.py`` over the whole package. Each reports no finding.

cbflow scopes its rules to files under a directory named
``cueball_tpu`` (it resolves the marshal modules and the ``utils`` seam
from there), so it reads a copy of the port under that name. Its A003
rule is what keeps every clock read of the port behind ``utils``."""

import importlib.util
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / 'cueball_tpu_torch'


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / 'tools' / ('%s.py' % name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cblint_finds_nothing_in_the_port():
    cblint = _load('cblint')
    targets = [str(PORT), str(ROOT / 'examples_torch'),
               str(ROOT / 'chip_smoke.py')]
    violations = [v for t in cblint.iter_targets(targets)
                  for v in cblint.lint_file(t)]
    assert violations == [], [str(v) for v in violations]


def test_cbfsm_finds_nothing_in_the_port():
    machines, violations = _load('cbfsm').analyze_paths([str(PORT)])
    assert violations == [], [str(v) for v in violations]
    assert {'ShardFSM', 'ConnectionPool', 'ConnectionSet'} <= {
        m.class_name for m in machines}


def test_cbflow_finds_nothing_in_the_port(tmp_path):
    copy = tmp_path / 'cueball_tpu'
    shutil.copytree(PORT, copy,
                    ignore=shutil.ignore_patterns('__pycache__'))
    program, violations = _load('cbflow').analyze_paths([str(copy)])
    assert violations == [], [str(v) for v in violations]
    assert {'utils.py', 'entry.py', 'shard/fleet.py'} <= set(program.files)
