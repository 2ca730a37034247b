"""Build and load the port's CUDA kernels.

Each source in ``cueball_tpu_torch/csrc/`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface, and
loaded with ``ctypes``. Libraries go to ``build/torch_kernels/`` at the
root of the checkout, named by a hash of the source and the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.
Nothing is built when this module is imported: :func:`load` builds on
first use, :func:`build_all` builds every source at once, one ``nvcc``
process per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

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

_loaded: dict[str, ctypes.CDLL] = {}


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


def build_all(names=None) -> dict:
    """Compile every named kernel (all by default) whose library is not
    built yet, one nvcc per source, in parallel. Returns {name:
    {'path', 'seconds', 'log'}}, where 'log' is nvcc's output (the
    ptxas register and shared-memory report) or '' for a library
    already built. Raises if any compile fails."""
    names = list(KERNELS) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs, result = {}, {}
    start = time.perf_counter()
    for name in names:
        path = library_path(name)
        if path.exists():
            result[name] = {'path': str(path), 'seconds': 0.0, 'log': ''}
            continue
        tmp = path.with_name('%s.%d.tmp' % (path.name, os.getpid()))
        cmd = [nvcc(), *NVCC_FLAGS, '-o', str(tmp),
               str(CSRC / KERNELS[name][0])]
        jobs[name] = (path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (path, tmp, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append('%s (exit %d):\n%s' % (name, proc.returncode, log))
            continue
        os.replace(tmp, path)
        result[name] = {'path': str(path),
                        'seconds': time.perf_counter() - start, 'log': log}
    if failed:
        raise RuntimeError('nvcc failed for ' + '\n'.join(failed))
    return result


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed,
    with argtypes and restype set on each of its C functions."""
    lib = _loaded.get(name)
    if lib is None:
        path = build_all([name])[name]['path']
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
