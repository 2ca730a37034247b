"""The kernel build is safe to call from many threads at once, on the
CPU: ``nvcc`` is a stub script that sleeps, logs its call and copies
the source to its output, and the library loader is a stand-in, so the
test shows what ``kernels.build`` does around the compiler. Four
threads ask for one kernel into an empty build directory: one build
starts, under a temporary name of its own thread, and all four get the
one library."""

import os
import stat
import sys
import threading

import pytest

pytest.importorskip('torch')

from cueball_tpu_torch.kernels import build  # noqa: E402

STUB = '''#!%s
import shutil, sys, threading, time
args = sys.argv[1:]
out = args[args.index('-o') + 1]
with open(%r, 'a') as log:
    log.write(out + '\\n')
time.sleep(0.5)
shutil.copyfile(args[-1], out)
'''


class FakeLibrary:
    """What ctypes.CDLL returns, enough for load(): a path and settable
    function attributes."""

    def __init__(self, path):
        self.path = path
        self.fns = {}

    def __getattr__(self, name):
        return self.fns.setdefault(name, type('Fn', (), {})())


@pytest.fixture
def stub_nvcc(tmp_path, monkeypatch):
    log = tmp_path / 'nvcc.log'
    bindir = tmp_path / 'bin'
    bindir.mkdir()
    nvcc = bindir / 'nvcc'
    nvcc.write_text(STUB % (sys.executable, str(log)))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv('PATH', '%s%s%s' % (bindir, os.pathsep,
                                           os.environ.get('PATH', '')))
    monkeypatch.setattr(build.ctypes, 'CDLL', FakeLibrary)
    saved = build.BUILD_DIR
    build.set_build_dir(tmp_path / 'kernels')
    try:
        yield log
    finally:
        build.set_build_dir(saved)


def test_four_threads_start_one_build(stub_nvcc):
    runs = build.nvcc_runs
    libs, errors, idents = [], [], []
    barrier = threading.Barrier(4)

    def ask():
        idents.append(threading.get_ident())
        barrier.wait()
        try:
            libs.append(build.load('fir'))
        except Exception as e:     # reported below
            errors.append(e)

    threads = [threading.Thread(target=ask) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(30)
    assert not any(th.is_alive() for th in threads)
    assert errors == []
    assert build.nvcc_runs == runs + 1
    outputs = stub_nvcc.read_text().split()
    assert len(outputs) == 1
    # The temporary name carries the pid and the building thread.
    assert any(outputs[0].endswith('.%d.%d.tmp' % (os.getpid(), ident))
               for ident in idents)
    assert len(libs) == 4 and all(lib is libs[0] for lib in libs)
    assert libs[0].path == str(build.library_path('fir'))
    assert os.path.exists(libs[0].path)
    assert not os.path.exists(outputs[0])
    for fn, (argtypes, restype) in build.KERNELS['fir'][1].items():
        assert getattr(libs[0], fn).argtypes == argtypes


def test_set_build_dir_forgets_loaded_libraries(stub_nvcc, tmp_path):
    first = build.load('fir')
    assert build.load('fir') is first
    build.set_build_dir(tmp_path / 'other')
    second = build.load('fir')
    assert second is not first
    assert second.path.startswith(str(tmp_path / 'other'))
    assert len(stub_nvcc.read_text().split()) == 2
