#!/usr/bin/env python3
"""Time the ragged-prefill kernel against another version of it, in turns,
in one process on one card.

    git show <commit>:skypilot_tpu_torch/csrc/ragged_prefill.cu \
        > _trees/ragged_prefill_old.cu
    python3 scripts/prefill_compare.py --old _trees/ragged_prefill_old.cu

Builds `--old` (a ragged_prefill.cu with the same C interface) with the
package's nvcc flags into skypilot_tpu_torch/_build/ (git-ignored), in
parallel with the current kernel, and prints both ptxas reports.  At
chip_smoke.py's serving-shape chunks (q [1, 32, 512, 128] bf16 over a
[1, 8, 4096, 128] cache, page 16, kv_mask ending at 3000, cursor bases
0, 1536 and 2560; the same inputs as its kernel phase), float and int8
branches, it holds both versions to the plain version at f32 within
chip_smoke.py's rounding bound, then times them with CUDA events
(chip_smoke.time_ms: device time, the launches queued behind a busy-wait
kernel) in the order old, new, new, old.  Prints one line a
case and, last, one JSON line with every time and the case's bound.
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
from skypilot_tpu_torch.ops import ragged_prefill as rp  # noqa: E402  pylint: disable=wrong-import-position


def _start_old_build(src: str):
    """nvcc of `src` into _build/, started; returns (process, library)."""
    digest = hashlib.sha256(open(src, 'rb').read()).hexdigest()[:16]
    lib = _build.BUILD_DIR / f'libragged_prefill_old-{digest}.so'
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, '-o', str(lib), src]  # pylint: disable=protected-access
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def _old_prefill(lib):
    """A function with ragged_prefill_attention's arguments that launches
    the old library's kernel."""
    fns = {}
    for quant, sym, argtypes in (
            (False, 'ragged_prefill_launch', rp._ARGTYPES),  # pylint: disable=protected-access
            (True, 'ragged_prefill_int8_launch', rp._ARGTYPES_INT8)):  # pylint: disable=protected-access
        fn = getattr(lib, sym)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        fns[quant] = fn

    def run(q, keys, values, tbl, base, kv_mask, *, scale, probs_dtype,
            page_size, key_scale=None, value_scale=None):
        b, h, s, d = q.shape
        _, kvh, max_len, _ = keys.shape
        base = base.expand(b).contiguous()
        out = torch.empty((b, s, h, d), dtype=probs_dtype, device=q.device)
        head = (q.data_ptr(), keys.data_ptr(), values.data_ptr())
        if key_scale is not None:
            head += (key_scale.data_ptr(), value_scale.data_ptr())
        err = fns[key_scale is not None](
            *head, tbl.data_ptr(), base.data_ptr(), kv_mask.data_ptr(),
            out.data_ptr(), b, h, s, d, kvh, max_len, tbl.shape[1],
            page_size, 0, float(scale), _build.dtype_code(q.dtype),
            torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(err, 'old ragged_prefill launch')
        return out
    return run


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument('--old', required=True,
                        help='the other ragged_prefill.cu')
    parser.add_argument('--iters', type=int, default=50)
    args = parser.parse_args()
    card = c.phase_device()
    proc, old_lib = _start_old_build(args.old)
    new_log = _build.build(['ragged_prefill'])['ragged_prefill'][1]
    old_log, _ = proc.communicate()
    if proc.returncode != 0:
        raise SystemExit(f'old kernel build failed:\n{old_log}')
    for tag, log in (('old', old_log), ('new', new_log)):
        for line in log.splitlines():
            if ('Compiling entry' in line or 'registers' in line
                    or 'spill' in line):
                c.log(f'{tag}: {line.strip()}')
    old = _old_prefill(ctypes.CDLL(str(old_lib)))
    dev = torch.device('cuda')
    kv_mask = (torch.arange(c.PREFILL_MAX_LEN, device=dev)
               < c.PREFILL_TRUE_LEN)[None]
    results = []
    for quant in (False, True):
        branch = 'int8' if quant else 'float'
        g = torch.Generator(device=dev).manual_seed(2)
        keys, values, scales, _ = c._prefill_cache(dev, g, quant)  # pylint: disable=protected-access
        for base in (0, 1536, 2560):
            qp = torch.randn(1, c.H, 512, c.D, generator=g, device=dev,
                             dtype=c.DTYPE)
            n_read = -(-(base + 512) // 512) * 512 // c.PS
            tbl = torch.arange(n_read, dtype=torch.int32,
                               device=dev)[None].contiguous()
            kw = dict(scale=c.D ** -0.5, page_size=c.PS, **scales)
            base_t = torch.tensor([base], dtype=torch.int32, device=dev)
            args_ = (qp, keys, values, tbl, base_t, kv_mask)
            for tag, fn in (('old', old), ('new',
                                           rp.ragged_prefill_attention)):
                got = fn(*args_, probs_dtype=c.DTYPE, **kw)
                torch.cuda.synchronize()
                c.check_kernel(f'{tag} {branch} base {base}', got,
                               rp.ragged_prefill_attention_plain, args_, kw,
                               probs_rounded=True)
            times = {'old': [], 'new': []}
            for tag in ('old', 'new', 'new', 'old'):
                fn = old if tag == 'old' else rp.ragged_prefill_attention
                times[tag].append(c.time_ms(
                    lambda fn=fn: fn(*args_, probs_dtype=c.DTYPE, **kw),
                    iters=args.iters))
            bms, by = c.bound(*c.prefill_work(512, base, quant))
            c.log(f'{branch} base {base}: old {times["old"]} ms, new '
                  f'{times["new"]} ms (in the order old, new, new, old), '
                  f'bound {bms:.4f} ms ({by})')
            results.append(dict(branch=branch, base=base,
                                old_ms=times['old'], new_ms=times['new'],
                                bound_ms=bms, bound_by=by))
    c.log(json.dumps({'card': card, 'cases': results}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
