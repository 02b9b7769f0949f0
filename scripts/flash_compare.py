#!/usr/bin/env python3
"""Time the flash forward and the dk/dv pass against other versions of
them, in turns, in one process on one card.

    mkdir -p _trees
    git show <commit>:skypilot_tpu_torch/csrc/flash_fwd.cu > _trees/flash_fwd_old.cu
    git show <commit>:skypilot_tpu_torch/csrc/flash_bwd.cu > _trees/flash_bwd_old.cu
    python3 scripts/flash_compare.py --old-fwd _trees/flash_fwd_old.cu \\
        --old-bwd _trees/flash_bwd_old.cu

Builds `--old-fwd` (a flash_fwd.cu with `flash_fwd_launch`) and
`--old-bwd` (a flash_bwd.cu with `flash_bwd_dkv_launch`) with the
package's nvcc flags (and csrc/ on the include path) into
skypilot_tpu_torch/_build/ (git-ignored), in parallel with the current
kernels, and prints every ptxas report.  At chip_smoke.py's FLASH_CASES
(the training shape B 2, H 32, kvh 8, S 4096, d 128; a 1024-token
window; a ragged S 1000 at d 64; causal, bf16, the same seeded inputs)
it holds both versions' out, lse, dk and dv to the plain versions at f32
within `flash_attention.rounding_bounds` (both backward versions on the
current forward's lse and delta), then times each pair with CUDA events
(chip_smoke.time_ms: device time, the launches queued behind a
busy-wait kernel) in the order old, new, new, old.  Prints one line a
case with each time and its bound, SDPA's forward and its backward alone
(cases without a window), and, last, one JSON line with every number.
Needs one NVIDIA card.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as c  # noqa: E402  pylint: disable=wrong-import-position
from skypilot_tpu_torch.ops import _build  # noqa: E402  pylint: disable=wrong-import-position
from skypilot_tpu_torch.ops import flash_attention as fa  # noqa: E402  pylint: disable=wrong-import-position


def _start_build(src: str, name: str):
    """nvcc of `src` into _build/, started; returns (process, library)."""
    digest = hashlib.sha256(open(src, 'rb').read()).hexdigest()[:16]
    lib = _build.BUILD_DIR / f'lib{name}-{digest}.so'
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, '-I', str(_build.CSRC),  # pylint: disable=protected-access
           '-o', str(lib), src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def _bind(lib, symbol, argtypes):
    fn = getattr(ctypes.CDLL(str(lib)), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def _old_kernels(fwd_lib, bwd_lib):
    """Functions with flash_fwd's and flash_bwd_dkv's arguments that
    launch the old libraries' kernels."""
    fwd_fn = _bind(fwd_lib, 'flash_fwd_launch', fa._FWD_ARGTYPES)  # pylint: disable=protected-access
    dkv_fn = _bind(bwd_lib, 'flash_bwd_dkv_launch', fa._DKV_ARGTYPES)  # pylint: disable=protected-access

    def fwd(q, k, v, *, scale, causal, window=None, offset=0):
        b, h, sq, _ = q.shape
        out = torch.empty_like(q)
        lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        err = fwd_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), lse.data_ptr(),
                     *fa._geometry(q, k, causal=causal, window=window,  # pylint: disable=protected-access
                                   offset=offset, scale=scale))
        _build.check(err, 'old flash_fwd_launch')
        return out, lse

    def dkv(q, k, v, do, lse, delta, *, scale, causal, window=None,
            offset=0):
        dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.empty(v.shape, dtype=torch.float32, device=q.device)
        err = dkv_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                     lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                     dv.data_ptr(),
                     *fa._geometry(q, k, causal=causal, window=window,  # pylint: disable=protected-access
                                   offset=offset, scale=scale))
        _build.check(err, 'old flash_bwd_dkv_launch')
        return dk, dv
    return fwd, dkv


def _ptxas(tag: str, log: str) -> None:
    for line in log.splitlines():
        if 'Compiling entry' in line or 'registers' in line \
                or 'spill' in line or line.startswith('nvcc '):
            c.log(f'{tag}: {line.strip()}')


def _worst(got, want, tol) -> float:
    """The largest |got - want| over its bound (an element whose bound
    is 0 must be exact)."""
    err = (got.float() - want.float()).abs()
    return torch.where(tol > 0, err / tol,
                       torch.where(err > 0, float('inf'), 0.0)).max().item()


def _turns(fns: dict, iters: int) -> dict:
    """Times of fns['old'] and fns['new'], in the order old, new, new,
    old."""
    times = {'old': [], 'new': []}
    for tag in ('old', 'new', 'new', 'old'):
        times[tag].append(c.time_ms(fns[tag], iters=iters))
    return times


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument('--old-fwd', required=True,
                        help='the other flash_fwd.cu')
    parser.add_argument('--old-bwd', required=True,
                        help='the other flash_bwd.cu (its dk/dv entry)')
    parser.add_argument('--iters', type=int, default=20)
    args = parser.parse_args()
    card = c.phase_device()
    builds = {'old fwd': _start_build(args.old_fwd, 'flash_fwd_old'),
              'old bwd': _start_build(args.old_bwd, 'flash_bwd_old')}
    new = _build.build(['flash_fwd', 'flash_bwd'])
    for tag, (proc, _) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f'{tag} build failed:\n{log}')
        _ptxas(tag, log)
    _ptxas('new fwd', new['flash_fwd'][1])
    _ptxas('new bwd', new['flash_bwd'][1])
    old_fwd, old_dkv = _old_kernels(builds['old fwd'][1],
                                    builds['old bwd'][1])
    dev = torch.device('cuda')
    results = []
    for ci, (case, b, h, kvh, s, d, window) in enumerate(c.FLASH_CASES):
        g = torch.Generator(device=dev).manual_seed(10 + ci)
        q, k, v, do = (torch.randn(*shape, generator=g, device=dev,
                                   dtype=c.DTYPE)
                       for shape in ((b, h, s, d), (b, kvh, s, d),
                                     (b, kvh, s, d), (b, h, s, d)))
        kw = dict(scale=d ** -0.5, causal=True, window=window)
        out, lse = fa.flash_fwd(q, k, v, **kw)
        delta = (do.float() * out.float()).sum(-1)
        tol = fa.rounding_bounds(q, k, v, do, lse, delta, **kw)
        f32 = [x.float() for x in (q, k, v, do)]
        want = dict(zip(('out', 'lse'), fa.flash_fwd_plain(*f32[:3], **kw)))
        want.update(zip(('dk', 'dv'), fa.flash_bwd_plain(
            *f32, lse, delta, **kw)[1:]))
        worst = {}
        for tag, fwd, dkv in (('old', old_fwd, old_dkv),
                              ('new', fa.flash_fwd, fa.flash_bwd_dkv)):
            got = dict(zip(('out', 'lse'), fwd(q, k, v, **kw)))
            got.update(zip(('dk', 'dv'), dkv(q, k, v, do, lse, delta, **kw)))
            torch.cuda.synchronize()
            for name in ('out', 'lse', 'dk', 'dv'):
                c.check_flash(f'{tag} {case} {name}', got[name], want[name],
                              tol[name])
            worst[tag] = max(_worst(got[n], want[n], tol[n]) for n in got)
            del got
        del want, tol, f32
        torch.cuda.empty_cache()
        fwd_t = _turns({'old': lambda: old_fwd(q, k, v, **kw),
                        'new': lambda: fa.flash_fwd(q, k, v, **kw)},
                       args.iters)
        dkv_t = _turns({'old': lambda: old_dkv(q, k, v, do, lse, delta,
                                               **kw),
                        'new': lambda: fa.flash_bwd_dkv(q, k, v, do, lse,
                                                        delta, **kw)},
                       args.iters)
        work = c._flash_work(b, h, kvh, s, d, window)  # pylint: disable=protected-access
        fwd_b, fwd_by = c.bound(*work['flash_fwd'])
        dkv_b, dkv_by = c.bound(*work['flash_bwd_dkv'])
        lib = (None, None) if window else c.sdpa_times(q, k, v, do,
                                                       kw['scale'])
        c.log(f'{case}: flash_fwd old {fwd_t["old"]} ms, new '
              f'{fwd_t["new"]} ms, bound {fwd_b:.4f} ms ({fwd_by}), sdpa '
              f'forward {lib[0]} ms; flash_bwd_dkv old {dkv_t["old"]} ms, '
              f'new {dkv_t["new"]} ms, bound {dkv_b:.4f} ms ({dkv_by}), '
              f'sdpa backward alone {lib[1]} ms (in the order old, new, '
              f'new, old); worst element over its bound old '
              f'{worst["old"]:.3f}, new {worst["new"]:.3f}')
        results.append(dict(
            case=case, fwd_old_ms=fwd_t['old'], fwd_new_ms=fwd_t['new'],
            fwd_bound_ms=fwd_b, fwd_bound_by=fwd_by, dkv_old_ms=dkv_t['old'],
            dkv_new_ms=dkv_t['new'], dkv_bound_ms=dkv_b, dkv_bound_by=dkv_by,
            sdpa_fwd_ms=lib[0], sdpa_bwd_ms=lib[1], worst=worst))
        del q, k, v, do, out, lse, delta
        torch.cuda.empty_cache()
    c.log(json.dumps({'card': card, 'cases': results}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
