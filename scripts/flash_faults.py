#!/usr/bin/env python3
"""Planted faults in the flash-attention kernels must fail chip_smoke.py.

    python3 scripts/flash_faults.py [fault name ...]

For each fault below (or each one named), copies the port
(skypilot_tpu_torch/ and chip_smoke.py) into
skypilot_tpu_torch/_build/faults/<name>/ (git-ignored), changes one
line of a kernel source there, and runs in that copy, in a fresh
process, chip_smoke.py's device, build and flash-kernel phases (head
width 256 included),
then its train phase's kernels-vs-plain step (`train_gaps`: one step's
loss and grad norm with the kernels and with the plain versions, on two
batches).  The unchanged copy runs first as the control and must pass
the kernel check; every fault must fail it.  Prints one JSON line per
run (the fault, whether the kernel check failed and the check line that
failed it, the train step's gaps and whether they break chip_smoke.py's
limits, then train_gemma's check (the kernels-vs-plain step of gemma-2b
whole within its limits) and the line that reports its gaps, and the
run's seconds; a fault that ends in a CUDA error fails
the check, and its run reports the error instead of the gaps; a run
that hangs past RUN_TIMEOUT_S is stopped and fails it too) and exits 0
only when the control passes and every fault fails the kernel check.
Needs one NVIDIA card.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(ROOT, 'skypilot_tpu_torch', '_build', 'faults')
# A sound run takes about 67 s on an H100 (the head-width-256 cases and
# gemma-2b's step included).
RUN_TIMEOUT_S = 210

# (name, source file under csrc/, the text as it is, the text planted)
FAULTS = (
    ('causal_tile_bound_one_short', 'flash_fwd.cu',
     'const int j_hi = k_hi < k_lo ? j_lo - 1 : k_hi / BN;',
     'const int j_hi = k_hi < k_lo ? j_lo - 1 : k_hi / BN - 1;'),
    ('dkv_misses_a_group_member', 'flash_bwd.cu',
     'const int n_items = G * nq;',
     'const int n_items = (G - 1) * nq;'),
    ('dq_without_delta', 'flash_bwd.cu',
     'dlt[i] = row < Sq ? delta[at] : 0.f;',
     'dlt[i] = 0.f;'),
    ('fwd_scale_1pct_high', 'flash_fwd.cu',
     'window, offset, scale * kLog2e);',
     'window, offset, scale * kLog2e * 1.01f);'),
    # What the redesign added: the unmasked path, the mbarrier phases of
    # the TMA ring (the consumers stop waiting after the first round and
    # the producer, a phase behind, waits for ever: the run hangs), lse
    # in natural-log units, the dk/dv item stream and its cp.async ring.
    ('fwd_diagonal_tile_unmasked', 'flash_fwd.cu',
     '(causal && (k0 + BN - 1 > wpos_lo ||',
     '(causal && (k0 > wpos_hi ||'),
    ('fwd_phase_bit_not_flipped', 'flash_fwd.cu',
     'const uint32_t ph = (n / kStages) & 1;',
     'const uint32_t ph = 0;'),
    ('fwd_lse_left_in_base_2', 'flash_fwd.cu',
     ': (m[i] + log2f(l_safe)) * kLn2;',
     ': m[i] + log2f(l_safe);'),
    ('dkv_stream_q_tile_off_by_one', 'flash_bwd.cu',
     'const int q0 = (i_lo + n % nq) * kBQ2;  // item n\'s q tile, copied',
     'const int q0 = (i_lo + n % nq + 1) * kBQ2;'),
    ('dkv_ring_refills_the_stage_in_use', 'flash_bwd.cu',
     'if (n + 1 < n_items) issue(n + 1, st ^ 1);',
     'if (n + 1 < n_items) issue(n + 1, st);'),
    # What the dq pass's redesign added: its TMA ring (the producer no
    # longer waits for the consumers to free a stage), the consumers'
    # mbarrier phases, the tiles it runs unmasked.
    ('dq_ring_refills_the_stage_in_use', 'flash_bwd.cu',
     'hopper::mbar_wait(empty(s), ((n / kDqStages) & 1) ^ 1);',
     ';'),
    ('dq_phase_bit_not_flipped', 'flash_bwd.cu',
     'const uint32_t ph = (n / kDqStages) & 1;',
     'const uint32_t ph = 0;'),
    ('dq_boundary_tile_unmasked', 'flash_bwd.cu',
     '(causal && (k0 + BN - 1 > wpos_lo ||',
     '(causal && (k0 > wpos_hi ||'),
    # Head width 256: the second warp of each pair on 16 kv rows writes
    # the first half of dk's and dv's columns again, and the second half
    # is never written.
    ('dkv_d256_column_half_dropped', 'flash_bwd.cu',
     'const int c_lo = C::kSplit == 1 ? 0 : (warp / 4) * C::kDO;',
     'const int c_lo = 0;'),
)

_RUN = ('import json, gc, torch, chip_smoke as c\n'
        'from skypilot_tpu_torch.ops import _build\n'
        'c.phase_device()\n'
        '_build.build(["flash_fwd", "flash_bwd"])\n'
        'dev = torch.device("cuda")\n'
        'gaps, crashed = None, None\n'
        'try:\n'
        '    c.phase_flash_kernels(dev)\n'
        '    c.phase_flash_d256(dev)\n'
        '    failed = False\n'
        'except AssertionError:\n'
        '    failed = True\n'
        'except RuntimeError as e:  # a CUDA error: the run cannot go on\n'
        '    failed, crashed = True, str(e).splitlines()[0]\n'
        'if crashed is None:\n'
        '    gc.collect(); torch.cuda.empty_cache()\n'
        '    gaps = c.train_gaps(dev)[2]\n'
        'gemma_failed = None\n'
        'if crashed is None:\n'
        '    gc.collect(); torch.cuda.empty_cache()\n'
        '    model, batch, seq, chunk = c.GEMMA_TRAIN\n'
        '    try:\n'
        '        c.family_gaps_and_memorize(dev, model, {}, batch, seq,\n'
        '                                   chunk, "train_gemma")\n'
        '        gemma_failed = False\n'
        '    except AssertionError:\n'
        '        gemma_failed = True\n'
        'print("FAULT_RESULT " + json.dumps({\n'
        '    "kernel_check_failed": failed, "crashed": crashed,\n'
        '    "train_gaps": gaps,\n'
        '    "train_check_failed": None if gaps is None else any(\n'
        '        not (lg <= c.TRAIN_LOSS_REL_TOL\n'
        '             and ng <= c.TRAIN_GNORM_REL_TOL)\n'
        '        for lg, ng in gaps),\n'
        '    "train_gemma_check_failed": gemma_failed}))\n')


_WORST = re.compile(r'worst element at (\S+) of its bound')


def _copy(name: str) -> str:
    dst = os.path.join(WORK, name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, 'skypilot_tpu_torch'),
                    os.path.join(dst, 'skypilot_tpu_torch'),
                    ignore=shutil.ignore_patterns('_build', '__pycache__'))
    shutil.copy(os.path.join(ROOT, 'chip_smoke.py'), dst)
    return dst


def _plant(tree: str, src: str, old: str, new: str) -> None:
    path = os.path.join(tree, 'skypilot_tpu_torch', 'csrc', src)
    text = open(path).read()
    if text.count(old) != 1:
        raise SystemExit(f'{src}: {old!r} occurs {text.count(old)} times')
    with open(path, 'w') as f:
        f.write(text.replace(old, new))


def _check(name: str, tree: str) -> bool:
    """Runs the checks in `tree`; returns whether the kernel check
    failed.  A run that outlasts RUN_TIMEOUT_S has hung, which fails the
    check (chip_smoke.py would not end either); any other run that ends
    without its result line raises."""
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, '-c', _RUN], cwd=tree,
                              capture_output=True, text=True,
                              timeout=RUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        print(json.dumps({'fault': name, 'kernel_check_failed': True,
                          'hung': True, 'seconds': RUN_TIMEOUT_S}),
              flush=True)
        return True
    lines = proc.stdout.splitlines()
    result = next((json.loads(ln.split(' ', 1)[1]) for ln in lines
                   if ln.startswith('FAULT_RESULT ')), None)
    if proc.returncode != 0 or result is None:
        raise SystemExit(f'{name}: the run failed (exit {proc.returncode}): '
                         f'{proc.stderr.strip().splitlines()[-3:]}')
    failed = result['kernel_check_failed']
    failed_at = next((ln for ln in lines if (m := _WORST.search(ln))
                      and float(m.group(1)) > 1.0), None)
    gemma_at = next((ln for ln in lines if ln.startswith(
        'train_gemma[') and 'kernels vs plain' in ln), None)
    print(json.dumps({'fault': name, **result, 'at': failed_at,
                      'train_gemma_at': gemma_at,
                      'seconds': round(time.perf_counter() - t0, 1)}),
          flush=True)
    return failed


def main() -> int:
    only = sys.argv[1:]  # fault names to run (default: all)
    ok = not _check('control', _copy('control'))
    for name, src, old, new in FAULTS:
        if only and name not in only:
            continue
        tree = _copy(name)
        _plant(tree, src, old, new)
        ok &= _check(name, tree)
    shutil.rmtree(WORK, ignore_errors=True)
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
