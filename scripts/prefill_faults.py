#!/usr/bin/env python3
"""Planted faults in the ragged-prefill kernel must fail chip_smoke.py's
kernel check.

    python3 scripts/prefill_faults.py

For each fault below, copies the port (skypilot_tpu_torch/ and
chip_smoke.py) into skypilot_tpu_torch/_build/faults/<name>/
(git-ignored) and changes one line of the kernel's sources there
(csrc/ragged_prefill.cu or its main loop, csrc/attn_fwd_mainloop.cuh).
The copies' kernel libraries are built all at once, one process a copy.
Then, in each copy in turn, a fresh process runs chip_smoke.py's device
phase and its kernel phase for the ragged-prefill kernel alone: the
float branch, then the int8 branch, each at cursor bases 0, 1536 and
2560 and on every PREFILL_EDGES case, held to its rounding bound.  The
unchanged copy runs first as the control and must pass both branches;
every fault must fail at least one.  Prints one JSON line per run (the
fault, which branches failed, and the first check line over its bound
in each) and exits 0 only when the control passes and every fault
fails.  Needs one NVIDIA card.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

from flash_faults import WORK, _WORST, _copy, _plant

# (name, source file under csrc/, the text as it is, the text planted)
FAULTS = (
    # The liveness test of a tile is the causal bound of the walk: here it
    # drops the last tile a block's rows reach.
    ('causal_tile_bound_one_short', 'ragged_prefill.cu',
     'if (start <= q_hi &&',
     'if (start + kBC <= q_hi &&'),
    # The wait that opens a tile one group short: the newest group may be
    # read in flight (Q's at the first tile, issued just before; after
    # it the tile's own copy, issued a tile's products earlier).
    ('ring_wait_one_group_short', 'ragged_prefill.cu',
     'attn::cp_async_wait<0>();     // Q and tile j have landed',
     'attn::cp_async_wait<1>();     // Q and tile j have landed'),
    ('key_scale_dropped', 'ragged_prefill.cu',
     'if (kQuant) x *= c.ks;',
     'if (kQuant) x *= 1.f;'),
    ('value_scale_in_l', 'attn_fwd_mainloop.cuh',
     'psum[i] += p;',
     'psum[i] += p * w;'),
    ('key_scale_one_position_off', 'ragged_prefill.cu',
     'm_ks = ksc[head_off + pos];',
     'm_ks = ksc[head_off + (pos ^ 1)];'),
    ('int8_read_as_uint8', 'ragged_prefill.cu',
     'const int8_t* x = reinterpret_cast<const int8_t*>(&raw);',
     'const uint8_t* x = reinterpret_cast<const uint8_t*>(&raw);'),
)

_BUILD = ('from skypilot_tpu_torch.ops import _build\n'
          '_build.build(["ragged_prefill"])\n')

_RUN = ('import json, torch, chip_smoke as c\n'
        'c.phase_device()\n'
        'dev = torch.device("cuda")\n'
        'failed = {}\n'
        'for quant in (False, True):\n'
        '    try:\n'
        '        c.phase_kernels(dev, quant=(quant,),\n'
        '                        kernels=("ragged_prefill",))\n'
        '        failed["int8" if quant else "float"] = False\n'
        '    except AssertionError:\n'
        '        failed["int8" if quant else "float"] = True\n'
        '    torch.cuda.empty_cache()\n'
        'print("FAULT_RESULT " + json.dumps({"failed": failed}))\n')


def _check(name: str, tree: str) -> bool:
    """Runs the check in `tree`; returns whether a branch failed it.  A
    run that ends without its result line raises."""
    proc = subprocess.run([sys.executable, '-c', _RUN], cwd=tree,
                          capture_output=True, text=True, timeout=900)
    lines = proc.stdout.splitlines()
    result = next((json.loads(ln.split(' ', 1)[1]) for ln in lines
                   if ln.startswith('FAULT_RESULT ')), None)
    if proc.returncode != 0 or result is None:
        raise SystemExit(f'{name}: the run failed (exit {proc.returncode}): '
                         f'{proc.stderr.strip().splitlines()[-3:]}')
    over = {}
    for branch, tag in (('float', 'ragged_prefill '),
                        ('int8', 'ragged_prefill_int8 ')):
        over[branch] = next(
            (ln for ln in lines if ln.startswith(tag)
             and (m := _WORST.search(ln))
             and not float(m.group(1)) <= 1.0),   # over, or not finite
            None)
    print(json.dumps({'fault': name, **result, 'at': over}), flush=True)
    return any(result['failed'].values())


def main() -> int:
    trees = {'control': _copy('control')}
    for name, src, old, new in FAULTS:
        trees[name] = _copy(name)
        _plant(trees[name], src, old, new)
    builds = {name: subprocess.Popen([sys.executable, '-c', _BUILD],
                                     cwd=tree, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
              for name, tree in trees.items()}
    for name, proc in builds.items():
        log, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f'{name}: build failed:\n{log[-2000:]}')
    ok = not _check('control', trees['control'])
    for name, *_ in FAULTS:
        ok &= _check(name, trees[name])
    shutil.rmtree(WORK, ignore_errors=True)
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
