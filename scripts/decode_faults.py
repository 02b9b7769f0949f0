#!/usr/bin/env python3
"""Planted faults in the paged-decode kernel's split page walk must fail
chip_smoke.py's decode check.

    python3 scripts/decode_faults.py [fault name ...]

(The int8 branch's own faults are scripts/int8_faults.py's, which runs
them through `run` below.)  For each fault below (or each one named),
copies the port (skypilot_tpu_torch/ and chip_smoke.py) into
skypilot_tpu_torch/_build/faults/<name>/ (git-ignored) and changes one
line of csrc/paged_decode.cu there.  The copies' kernel libraries are
built all at once, one process a copy.  Then, in each copy in turn, a
fresh process runs chip_smoke.py's device phase and its kernel phase for
the decode kernel alone, in both branches (float pools and the int8
quant branch): the serving shape, then DECODE_EDGES (each case called
twice in a row on different inputs).  The unchanged copy runs first as
the control and must pass; every fault must fail.  Prints one JSON line
per run (the fault, whether the check failed and the check line that
failed it, the run's seconds; a CUDA error fails the check and is
reported) and exits 0 only when the control passes and every fault
fails.  Needs one NVIDIA card.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time

from flash_faults import WORK, _WORST, _copy, _plant

# (name, source file under csrc/, the text as it is, the text planted):
# the merge over the chunks' partials, its counter, the chunks' bounds,
# and the walk of a row that sees nothing.
FAULTS = (
    ('merge_drops_a_split', 'paged_decode.cu',
     'for (int c = 0; c < n_split; ++c) {\n'
     '    const size_t idx = (part0 + c) * kRows + r;',
     'for (int c = 0; c < n_split - 1; ++c) {\n'
     '    const size_t idx = (part0 + c) * kRows + r;'),
    ('merge_takes_a_split_twice', 'paged_decode.cu',
     'const size_t idx = (part0 + c) * kRows + r;',
     'const size_t idx = (part0 + (c == 1 ? 0 : c)) * kRows + r;'),
    ('counter_not_reset', 'paged_decode.cu',
     'if (s_last) *ctr = 0;  // ready for the next launch',
     '// the counter is left as it is'),
    ('chunk_bounds_one_page_off', 'paged_decode.cu',
     'const int p0 = split * chunk_pages;',
     'const int p0 = split * chunk_pages + 1;'),
    ('dead_row_skips_its_pages', 'paged_decode.cu',
     'live = any_dead;',
     'live = false;'),
)

_BUILD = ('from skypilot_tpu_torch.ops import _build\n'
          '_build.build(["paged_decode"])\n')

# The check a copy runs: both branches of the decode kernel.
_RUN = ('import json, torch, chip_smoke as c\n'
        'c.phase_device()\n'
        'dev = torch.device("cuda")\n'
        'crashed = None\n'
        'try:\n'
        '    c.phase_kernels(dev, kernels=("paged_decode",))\n'
        '    failed = False\n'
        'except AssertionError:\n'
        '    failed = True\n'
        'except RuntimeError as e:  # a CUDA error: the run cannot go on\n'
        '    failed, crashed = True, str(e).splitlines()[0]\n'
        'print("FAULT_RESULT " + json.dumps({\n'
        '    "kernel_check_failed": failed, "crashed": crashed}))\n')


def _check(name: str, tree: str, run_src: str, timeout: int) -> bool:
    """Runs `run_src` in `tree`; returns whether its kernel check failed.
    A run that ends without its result line raises."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, '-c', run_src], cwd=tree,
                          capture_output=True, text=True, timeout=timeout)
    lines = proc.stdout.splitlines()
    result = next((json.loads(ln.split(' ', 1)[1]) for ln in lines
                   if ln.startswith('FAULT_RESULT ')), None)
    if proc.returncode != 0 or result is None:
        raise SystemExit(f'{name}: the run failed (exit {proc.returncode}): '
                         f'{proc.stderr.strip().splitlines()[-3:]}')
    failed_at = next((ln for ln in lines if (m := _WORST.search(ln))
                      and float(m.group(1)) > 1.0), None)
    print(json.dumps({'fault': name, **result, 'at': failed_at,
                      'seconds': round(time.perf_counter() - t0, 1)}),
          flush=True)
    return result['kernel_check_failed']


def run(faults, run_src: str, timeout: int = 600) -> int:
    """Plants each of `faults` in its own copy, builds every copy's decode
    library in parallel, runs `run_src` in the control copy and then in
    each fault's; 0 when the control passes and every fault fails."""
    trees = {'control': _copy('control')}
    for name, src, old, new in faults:
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
    ok = not _check('control', trees['control'], run_src, timeout)
    for name, *_ in faults:
        ok &= _check(name, trees[name], run_src, timeout)
    shutil.rmtree(WORK, ignore_errors=True)
    return 0 if ok else 1


def main() -> int:
    only = sys.argv[1:]
    return run([f for f in FAULTS if not only or f[0] in only], _RUN)


if __name__ == '__main__':
    sys.exit(main())
