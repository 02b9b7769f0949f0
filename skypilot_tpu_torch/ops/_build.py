"""Build the CUDA kernels in `csrc/` with nvcc and load them with ctypes.

Each source file becomes its own shared library with a plain C
interface (no PyTorch headers, so one build takes seconds).  Libraries
land in `skypilot_tpu_torch/_build/`, named by a digest of their
source and flags, so an edited kernel is rebuilt and an unchanged one
is reused.  `build()` starts one nvcc per missing library, all at
once, and waits for them together.

Nothing here runs at import: the kernels are built the first time a
wrapper launches one on a CUDA tensor (or when a caller asks, as
chip_smoke.py does to time the build).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG / '_build'
SOURCES = ('paged_decode', 'ragged_prefill', 'flash_fwd', 'flash_bwd')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_lock = threading.Lock()
_launchers: Dict[str, Any] = {}
_libs: Dict[str, Any] = {}


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    default = '/usr/local/cuda/bin/nvcc'
    if os.path.exists(default):
        return default
    raise RuntimeError('nvcc not found: the CUDA kernels are built on a '
                       'machine with the CUDA toolkit')


def _lib_path(name: str) -> Path:
    src = (CSRC / f'{name}.cu').read_bytes()
    # Every shared header counts: a source may include any of them.
    for header in sorted(CSRC.glob('*.cuh')):
        src += header.read_bytes()
    digest = hashlib.sha256(src + ' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'lib{name}-{digest.hexdigest()[:16]}.so'


def build(names: Iterable[str] = SOURCES) -> Dict[str, Tuple[Path, str]]:
    """Compile every library of `names` that is not built yet, one
    nvcc per source, all started together.  Returns name -> (library
    path, compiler log); for a fresh build the log opens with a line
    `nvcc <name>.cu: <seconds> s` (that source's own compile time) and
    holds ptxas's register and shared memory report; it is empty for a
    reused one."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, Tuple[Path, str]] = {}
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        path = _lib_path(name)
        if path.exists():
            out[name] = (path, '')
            continue
        tmp = path.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp),
               str(CSRC / f'{name}.cu')]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, path)
    # One waiting thread a compiler, so that each finish time is its own.
    logs: Dict[str, str] = {}

    def wait(name: str, proc: subprocess.Popen) -> None:
        log, _ = proc.communicate()
        logs[name] = (f'nvcc {name}.cu: {time.perf_counter() - t0:.1f} s\n'
                      + log)

    waiters = [threading.Thread(target=wait, args=(name, proc))
               for name, (proc, _, _) in procs.items()]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    failed = []
    for name, (proc, tmp, path) in procs.items():
        log = logs[name]
        if proc.returncode != 0:
            failed.append(f'{name}.cu (nvcc exit {proc.returncode}):\n{log}')
            continue
        os.replace(tmp, path)
        out[name] = (path, log)
    if failed:
        raise RuntimeError('kernel build failed:\n' + '\n'.join(failed))
    return out


def launcher(name: str, argtypes: Sequence[Any],
             symbol: Optional[str] = None) -> Any:
    """The C launcher `symbol` (default `<name>_launch`) of
    `csrc/<name>.cu` (built and loaded on first use), returning a
    cudaError_t as int."""
    symbol = symbol or f'{name}_launch'
    with _lock:
        fn = _launchers.get(symbol)
        if fn is None:
            lib = _libs.get(name)
            if lib is None:
                path, _ = build([name])[name]
                lib = _libs[name] = ctypes.CDLL(str(path))
            fn = getattr(lib, symbol)
            fn.restype = ctypes.c_int
            fn.argtypes = list(argtypes)
            _launchers[symbol] = fn
        return fn


def check(err: int, what: str) -> None:
    """Raise when a C launcher returned a nonzero cudaError_t."""
    if err != 0:
        raise RuntimeError(f'{what}: CUDA error {err} at launch')


def dtype_code(dtype) -> int:
    """The kernels' element-type code: 0 float32, 1 bfloat16, 2 float16."""
    import torch
    codes = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
    if dtype not in codes:
        raise ValueError(f'unsupported kernel dtype {dtype}')
    return codes[dtype]
