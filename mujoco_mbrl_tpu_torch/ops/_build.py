"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``_build/lib<name>-<hash>.so`` (plain C
interface, no PyTorch headers, so a build takes seconds). The hash covers
the source text, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source or header rebuilds and an unchanged one is reused. All missing libraries build in parallel, one
``nvcc`` process per source, at the first kernel launch or on an explicit
``build_all()``. Nothing here runs when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(_PKG, '_build')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: Dict[str, float] = {}


def _nvcc() -> str:
    for cand in (shutil.which('nvcc'),
                 os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                              'bin', 'nvcc')):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found: the CUDA kernels build only on a '
                       'machine with the CUDA toolkit')


def sources() -> Dict[str, str]:
    return {f[:-3]: os.path.join(CSRC, f) for f in sorted(os.listdir(CSRC))
            if f.endswith('.cu')}


def _target(name: str, path: str) -> str:
    h = hashlib.sha256()
    headers = sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                     if f.endswith('.cuh'))
    for p in [path] + headers:
        with open(p, 'rb') as fh:
            h.update(fh.read())
    h.update(' '.join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f'lib{name}-{h.hexdigest()[:16]}.so')


def build_all() -> Dict[str, ctypes.CDLL]:
    """Build (in parallel) and load every kernel library; returns them."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    pending = {}
    for name, path in sources().items():
        if name in _LIBS:
            continue
        out = _target(name, path)
        if os.path.exists(out):
            continue
        fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
        os.close(fd)
        log = open(out[:-3] + '.log', 'w')
        pending[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, '-o', tmp, path], stdout=log,
            stderr=subprocess.STDOUT), tmp, out, log, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, log, t0) in pending.items():
        rc = proc.wait()
        log.close()
        BUILD_SECONDS[name] = time.perf_counter() - t0
        if rc != 0:
            os.unlink(tmp)
            failed.append((name, out[:-3] + '.log'))
        else:
            os.replace(tmp, out)
    if failed:
        msgs = []
        for name, logp in failed:
            with open(logp) as fh:
                msgs.append(f'--- {name} ---\n{fh.read()}')
        raise RuntimeError('nvcc failed:\n' + '\n'.join(msgs))
    for name, path in sources().items():
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(_target(name, path))
    return dict(_LIBS)


def library(name: str, signatures) -> ctypes.CDLL:
    """The loaded library `name` with each C entry's (restype, argtypes)
    from `signatures` declared (pointers and the stream as c_void_p)."""
    if name not in _LIBS:
        build_all()
    lib = _LIBS[name]
    for fn, (restype, argtypes) in signatures.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def build_log(name: str) -> str:
    """nvcc's output (with -Xptxas -v: registers, shared memory, spills)."""
    path = _target(name, sources()[name])[:-3] + '.log'
    if not os.path.exists(path):
        return ''
    with open(path) as fh:
        return fh.read()


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f'{what}: CUDA error {rc}')
