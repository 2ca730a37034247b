"""Build and load the port's CUDA kernels.

Each source in ``cueball_tpu_torch/csrc/`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface, and
loaded with ``ctypes``. Libraries go to ``build/torch_kernels/`` at the
root of the checkout, named by a hash of the source and the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.
Nothing is built when this module is imported: :func:`load` builds on
first use, :func:`build_all` builds every source at once, one ``nvcc``
process per source, all started together.

Both take one process-wide lock, so threads that ask for a kernel at
once (shard loops whose samplers tick on their own timers) start one
``nvcc``: the others wait for it and load its library. Each build
writes a temporary file named by the process and the thread and
renames it into place, so no reader sees a half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from .. import utils

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / 'csrc'
BUILD_DIR = PACKAGE.parent / 'build' / 'torch_kernels'

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

# name -> (source file, {C function: (argtypes, restype)})
_P = ctypes.c_void_p
KERNELS = {
    'fir': ('fir.cu', {
        'cb_fir_apply_f32': ((_P, _P, _P, ctypes.c_int64, ctypes.c_int, _P),
                             ctypes.c_int),
        'cb_cuda_error_string': ((ctypes.c_int,), ctypes.c_char_p),
    }),
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
#: nvcc processes started by this process (under the lock).
nvcc_runs = 0


def nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    path = os.path.join(home, 'bin', 'nvcc')
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found on PATH or at %s; the CUDA '
                           'kernels are built on a machine with the CUDA '
                           'toolkit' % path)
    return path


def library_path(name: str) -> Path:
    source = CSRC / KERNELS[name][0]
    h = hashlib.sha256(source.read_bytes())
    h.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / ('%s-%s.so' % (name, h.hexdigest()[:16]))


def set_build_dir(path) -> None:
    """Build and load libraries under ``path`` from now on, forgetting
    the libraries loaded so far: the next :func:`load` of each kernel
    finds an empty directory and builds it."""
    global BUILD_DIR
    with _lock:
        BUILD_DIR = Path(path)
        _loaded.clear()


def build_all(names=None) -> dict:
    """Compile every named kernel (all by default) whose library is not
    built yet, one nvcc per source, in parallel. Returns {name:
    {'path', 'seconds', 'log'}}, where 'log' is nvcc's output (the
    ptxas register and shared-memory report) or '' for a library
    already built. Raises if any compile fails."""
    with _lock:
        return _build_all(names)


def _build_all(names) -> dict:
    global nvcc_runs
    names = list(KERNELS) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs, result = {}, {}
    start = utils.perf_seconds()
    for name in names:
        path = library_path(name)
        if path.exists():
            result[name] = {'path': str(path), 'seconds': 0.0, 'log': ''}
            continue
        tmp = path.with_name('%s.%d.%d.tmp' % (path.name, os.getpid(),
                                              threading.get_ident()))
        cmd = [nvcc(), *NVCC_FLAGS, '-o', str(tmp),
               str(CSRC / KERNELS[name][0])]
        jobs[name] = (path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
        nvcc_runs += 1
    failed = []
    for name, (path, tmp, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append('%s (exit %d):\n%s' % (name, proc.returncode, log))
            continue
        os.replace(tmp, path)
        result[name] = {'path': str(path),
                        'seconds': utils.perf_seconds() - start, 'log': log}
    if failed:
        raise RuntimeError('nvcc failed for ' + '\n'.join(failed))
    return result


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed,
    with argtypes and restype set on each of its C functions. A thread
    that asks while another builds it waits and gets the same
    library."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = _build_all([name])[name]['path']
            lib = ctypes.CDLL(path)
            for fn, (argtypes, restype) in KERNELS[name][1].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _loaded[name] = lib
    return lib


def error_string(lib: ctypes.CDLL, code: int) -> str:
    """CUDA's text for an error code a kernel's C function returned."""
    text = lib.cb_cuda_error_string(code)
    return '%s (cudaError %d)' % (text.decode() if text else '?', code)
