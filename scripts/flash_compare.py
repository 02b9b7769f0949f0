#!/usr/bin/env python3
"""Time the flash kernels against other versions of them, in turns, in
one process on one card.

    mkdir -p _trees/old
    git archive <commit> skypilot_tpu_torch/csrc | tar -x -C _trees/old
    python3 scripts/flash_compare.py \
        --old-bwd _trees/old/skypilot_tpu_torch/csrc/flash_bwd.cu \
        [--old-fwd _trees/old/skypilot_tpu_torch/csrc/flash_fwd.cu]

Builds `--old-bwd` (a flash_bwd.cu with `flash_bwd_dq_launch` and
`flash_bwd_dkv_launch`) and, if given, `--old-fwd` (a flash_fwd.cu with
`flash_fwd_launch`) with the package's nvcc flags into
skypilot_tpu_torch/_build/ (git-ignored), in parallel with the current
kernels, and prints every ptxas report; an old source's own directory
comes first on the include path, so it takes the headers of its own
commit.  At
chip_smoke.py's FLASH_CASES (the training shape B 2, H 32, kvh 8, S
4096, d 128; a 1024-token window; a ragged S 1000 at d 64; causal,
bf16, the same seeded inputs) it holds both versions' dq, dk and dv
(and out and lse with --old-fwd) to the plain versions at f32 within
`flash_attention.rounding_bounds` (both backward versions on the current
forward's lse and delta), then times each pair with CUDA events
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
    """Functions with flash_fwd's (None without `fwd_lib`), flash_bwd_dq's
    and flash_bwd_dkv's arguments that launch the old libraries'
    kernels."""
    fwd_fn = fwd_lib and _bind(fwd_lib, 'flash_fwd_launch',
                               fa._FWD_ARGTYPES)  # pylint: disable=protected-access
    dq_fn = _bind(bwd_lib, 'flash_bwd_dq_launch', fa._DQ_ARGTYPES)  # pylint: disable=protected-access
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

    def dq(q, k, v, do, lse, delta, *, scale, causal, window=None,
           offset=0):
        out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        err = dq_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(), out.data_ptr(),
                    *fa._geometry(q, k, causal=causal, window=window,  # pylint: disable=protected-access
                                  offset=offset, scale=scale))
        _build.check(err, 'old flash_bwd_dq_launch')
        return out

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
    return (fwd if fwd_fn else None), dq, dkv


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
    parser.add_argument('--old-fwd', help='the other flash_fwd.cu')
    parser.add_argument('--old-bwd', required=True,
                        help='the other flash_bwd.cu (its dq and dk/dv '
                             'entries)')
    parser.add_argument('--iters', type=int, default=20)
    args = parser.parse_args()
    card = c.phase_device()
    builds = {'old bwd': _start_build(args.old_bwd, 'flash_bwd_old')}
    if args.old_fwd:
        builds['old fwd'] = _start_build(args.old_fwd, 'flash_fwd_old')
    new = _build.build(['flash_fwd', 'flash_bwd'])
    for tag, (proc, _) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f'{tag} build failed:\n{log}')
        _ptxas(tag, log)
    _ptxas('new fwd', new['flash_fwd'][1])
    _ptxas('new bwd', new['flash_bwd'][1])
    old_fwd, old_dq, old_dkv = _old_kernels(
        builds['old fwd'][1] if args.old_fwd else None,
        builds['old bwd'][1])
    kernels = {'old': dict(dq=old_dq, dkv=old_dkv),
               'new': dict(dq=fa.flash_bwd_dq, dkv=fa.flash_bwd_dkv)}
    if old_fwd:
        kernels['old']['fwd'] = old_fwd
        kernels['new']['fwd'] = fa.flash_fwd
    outputs = dict(fwd=('out', 'lse'), dq=('dq',), dkv=('dk', 'dv'))
    work_name = dict(fwd='flash_fwd', dq='flash_bwd_dq',
                     dkv='flash_bwd_dkv')
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
        want.update(zip(('dq', 'dk', 'dv'), fa.flash_bwd_plain(
            *f32, lse, delta, **kw)))
        bwd_args = (q, k, v, do, lse, delta)
        worst = {}
        for tag, fns in kernels.items():
            got = {}
            for name, fn in fns.items():
                res = fn(*(bwd_args[:3] if name == 'fwd' else bwd_args),
                         **kw)
                got.update(zip(outputs[name],
                               res if isinstance(res, tuple) else (res,)))
            torch.cuda.synchronize()
            for name in got:
                c.check_flash(f'{tag} {case} {name}', got[name], want[name],
                              tol[name])
            worst[tag] = {n: _worst(got[n], want[n], tol[n]) for n in got}
            del got
        del want, tol, f32
        torch.cuda.empty_cache()
        work = c._flash_work(b, h, kvh, s, d, window)  # pylint: disable=protected-access
        lib = (None, None) if window else c.sdpa_times(q, k, v, do,
                                                       kw['scale'])
        entry = dict(case=case, sdpa_fwd_ms=lib[0], sdpa_bwd_ms=lib[1],
                     worst=worst)
        for name in kernels['new']:
            args_ = bwd_args[:3] if name == 'fwd' else bwd_args
            t = _turns({tag: (lambda fn=kernels[tag][name]: fn(*args_, **kw))
                        for tag in ('old', 'new')}, args.iters)
            bms, by = c.bound(*work[work_name[name]])
            c.log(f'{case}: {work_name[name]} old {t["old"]} ms, new '
                  f'{t["new"]} ms (in the order old, new, new, old), bound '
                  f'{bms:.4f} ms ({by})')
            entry.update({f'{name}_old_ms': t['old'], f'{name}_new_ms':
                          t['new'], f'{name}_bound_ms': bms,
                          f'{name}_bound_by': by})
        c.log(f'{case}: sdpa forward {lib[0]} ms, backward alone {lib[1]} '
              f'ms; worst element over its bound {worst}')
        results.append(entry)
        del q, k, v, do, out, lse, delta, bwd_args
        torch.cuda.empty_cache()
    c.log(json.dumps({'card': card, 'cases': results}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
