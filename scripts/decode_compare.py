#!/usr/bin/env python3
"""Time the paged-decode kernel against another version of it, in turns,
in one process on one card.

    git show <commit>:skypilot_tpu_torch/csrc/paged_decode.cu \
        > _trees/paged_decode_old.cu
    python3 scripts/decode_compare.py --old _trees/paged_decode_old.cu \
        [--chunks 4,8,16,32]

Builds `--old` (a paged_decode.cu whose `paged_decode_launch` and
`paged_decode_int8_launch` take the current arguments, the split walk's
workspace, counters and chunk length included) with the package's nvcc
flags into skypilot_tpu_torch/_build/ (git-ignored), in parallel with the
current kernel, and prints both ptxas reports and build times.  At
chip_smoke.py's decode shape (batch 8, contexts 100-4000 over a shuffled
pool of 16-token pages, H 32, kvh 8, d 128, bf16 q; the same seeded
inputs as its kernel phase), float and int8 branches, it holds both
versions to the plain version at f32 within chip_smoke.py's rounding
bound, then times them with CUDA events (chip_smoke.time_ms: device
time, the launches queued behind a busy-wait kernel) in the order old,
new, new, old.  With --chunks it then times the current kernel at each
chunk length (pages a block walks) in place of `decode_split`'s.  Prints
one line a case and, last, one JSON line with every time and the bound.
Needs one NVIDIA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as c  # noqa: E402  pylint: disable=wrong-import-position
from flash_compare import _ptxas, _start_build  # noqa: E402  pylint: disable=wrong-import-position
from skypilot_tpu_torch.ops import _build  # noqa: E402  pylint: disable=wrong-import-position
from skypilot_tpu_torch.ops import paged_attention as pa  # noqa: E402  pylint: disable=wrong-import-position


def _old_decode(lib):
    """A function with paged_decode_attention's arguments that launches
    the old library's kernel as the current wrapper does (decode_split's
    chunk, the wrapper's scratch, which both versions leave with its
    counters at 0)."""
    fns = {}
    for quant, sym, argtypes in (
            (False, 'paged_decode_launch', pa._ARGTYPES),  # pylint: disable=protected-access
            (True, 'paged_decode_int8_launch', pa._ARGTYPES_INT8)):  # pylint: disable=protected-access
        fn = getattr(lib, sym)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        fns[quant] = fn

    def run(q, pk, pv, table, mask, *, scale, probs_dtype, key_scale=None,
            value_scale=None):
        b, h, s, d = q.shape
        _, kvh, ps, _ = pk.shape
        n_read = table.shape[1]
        mask3 = mask[:, 0].expand(b, s, n_read * ps).contiguous()
        out = torch.empty((b, s, h, d), dtype=probs_dtype, device=q.device)
        head = (q.data_ptr(), pk.data_ptr(), pv.data_ptr())
        if key_scale is not None:
            head += (key_scale.data_ptr(), value_scale.data_ptr())
        stream = torch.cuda.current_stream(q.device).cuda_stream
        units = b * kvh * -(-(h // kvh * s) // pa.ROWS_PER_BLOCK)
        chunk, n_split = pa.decode_split(
            n_read, ps, units, torch.cuda.get_device_properties(
                q.device).multi_processor_count)
        work, counters = pa._workspace(  # pylint: disable=protected-access
            q.device, stream,
            units * n_split * pa.ROWS_PER_BLOCK * (d + 2), units)
        err = fns[key_scale is not None](
            *head, table.data_ptr(), mask3.data_ptr(), out.data_ptr(), b, h,
            s, d, kvh, ps, n_read, float(scale), _build.dtype_code(q.dtype),
            stream, work.data_ptr(), counters.data_ptr(), chunk)
        _build.check(err, 'old paged_decode launch')
        return out
    return run


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument('--old', required=True,
                        help='the other paged_decode.cu')
    parser.add_argument('--iters', type=int, default=50)
    parser.add_argument('--chunks', default='',
                        help='comma-separated chunk lengths (pages) to time '
                             'the current kernel at')
    args = parser.parse_args()
    card = c.phase_device()
    proc, old_lib = _start_build(args.old, 'paged_decode_old')
    new_log = _build.build(['paged_decode'])['paged_decode'][1]
    old_log, _ = proc.communicate()
    if proc.returncode != 0:
        raise SystemExit(f'old kernel build failed:\n{old_log}')
    _ptxas('old', old_log)
    _ptxas('new', new_log)
    old = _old_decode(ctypes.CDLL(str(old_lib)))
    dev = torch.device('cuda')
    chunks = [int(x) for x in args.chunks.split(',') if x]
    results = []
    for quant in (False, True):
        branch = 'int8' if quant else 'float'
        q, pk, pv, table, mask, ctxs, scales = c._decode_inputs(  # pylint: disable=protected-access
            dev, np.random.RandomState(0), quant)
        kw = dict(scale=c.D ** -0.5, **scales)
        args_ = (q, pk, pv, table, mask)
        for tag, fn in (('old', old), ('new', pa.paged_decode_attention)):
            got = fn(*args_, probs_dtype=c.DTYPE, **kw)
            torch.cuda.synchronize()
            c.check_kernel(f'{tag} {branch}', got,
                           pa.paged_decode_attention_plain, args_, kw,
                           probs_rounded=False)
        times = {'old': [], 'new': []}
        for tag in ('old', 'new', 'new', 'old'):
            fn = old if tag == 'old' else pa.paged_decode_attention
            times[tag].append(c.time_ms(
                lambda fn=fn: fn(*args_, probs_dtype=c.DTYPE, **kw),
                iters=args.iters))
        bms, by = c.bound(*c.decode_work(ctxs, table, mask, quant))
        sc = (scales['key_scale'], scales['value_scale']) if quant else None
        by_chunk = {}
        for chunk in chunks:
            launch = lambda chunk=chunk: pa._launch(  # pylint: disable=protected-access
                *args_, scale=kw['scale'], probs_dtype=c.DTYPE, scales=sc,
                chunk_pages=chunk)
            got = launch()
            torch.cuda.synchronize()
            c.check_kernel(f'new {branch} chunk {chunk}', got,
                           pa.paged_decode_attention_plain, args_, kw,
                           probs_rounded=False)
            by_chunk[chunk] = c.time_ms(launch, iters=args.iters)
        c.log(f'{branch}: old {times["old"]} ms, new {times["new"]} ms (in '
              f'the order old, new, new, old), bound {bms:.4f} ms ({by}); '
              f'new by chunk pages {by_chunk}')
        results.append(dict(branch=branch, old_ms=times['old'],
                            new_ms=times['new'], bound_ms=bms, bound_by=by,
                            new_ms_by_chunk=by_chunk))
    c.log(json.dumps({'card': card, 'cases': results}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
