#!/usr/bin/env python3
"""Planted faults in the int8 branch of the paged-decode kernel must fail
chip_smoke.py's int8 kernel check.

    python3 scripts/int8_faults.py

(The ragged-prefill kernel's faults, int8 branch included, are
scripts/prefill_faults.py's.)  For each fault below (four kinds in the
paged-decode kernel), copies the port (skypilot_tpu_torch/ and
chip_smoke.py) into skypilot_tpu_torch/_build/faults/<name>/
(git-ignored) and changes one line of a kernel source there.  The
copies' kernel libraries are built all at once, one process a copy.
Then, in each copy in turn, a fresh process runs chip_smoke.py's device
phase, its kernel phase for the int8 branches alone, and its serve_int8
logits check (`int8_logit_gaps`) on a llama3-8b engine at full depth
with an int8 KV cache and the smoke's weights and check prompts.  The
unchanged copy runs first as the control and must pass the kernel
check; every fault must fail it.  Prints one JSON line per run (the
fault, whether the kernel check failed and the check line that failed
it, the logits gaps and whether they break INT8_LOGITS_REL_TOL) and
exits 0 only when the control passes and every fault fails the kernel
check.  Needs one NVIDIA card.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

from flash_faults import WORK, _WORST, _copy, _plant

# (name, source file under csrc/, the line as it is, the line planted)
FAULTS = (
    ('decode_key_scale_dropped', 'paged_decode.cu',
     'if constexpr (kQuant) sc[r][c] *= ksc;',
     'if constexpr (kQuant) sc[r][c] *= 1.f;'),
    ('decode_value_scale_in_l', 'paged_decode.cu',
     'psum += sc[r][c];',
     'psum += sc[r][c] * (kQuant ? vs[scale_off + c] : 1.f);'),
    ('decode_scale_one_position_off', 'paged_decode.cu',
     'if constexpr (kQuant) ksc = ks[scale_off + c];',
     'if constexpr (kQuant) ksc = ks[scale_off + (c ^ 1)];'),
    ('decode_int8_read_as_uint8', 'paged_decode.cu',
     '  return static_cast<float>(x);',
     '  return static_cast<float>(static_cast<uint8_t>(x));'),
)
KERNELS = ['paged_decode']

_BUILD = ('from skypilot_tpu_torch.ops import _build\n'
          f'_build.build({KERNELS!r})\n')

_RUN = ('import json, torch, chip_smoke as c\n'
        'from skypilot_tpu_torch.infer import engine as engine_lib\n'
        'c.phase_device()\n'
        'dev = torch.device("cuda")\n'
        'try:\n'
        '    c.phase_kernels(dev, quant=(True,),\n'
        '                    kernels=("paged_decode",))\n'
        '    failed = False\n'
        'except AssertionError:\n'
        '    failed = True\n'
        'torch.cuda.empty_cache()\n'
        'eng = engine_lib.ContinuousBatchingEngine(\n'
        '    model="llama3-8b", n_slots=8, max_seq_len=4096,\n'
        '    prefill_chunk=512, page_size=16, kv_cache_dtype="int8",\n'
        '    device=dev)\n'
        'gaps, _ = c.int8_logit_gaps(\n'
        '    eng, c.int8_check_prompts(eng.config.vocab_size))\n'
        'print("FAULT_RESULT " + json.dumps({\n'
        '    "kernel_check_failed": failed, "logit_gaps": gaps,\n'
        '    "logits_check_failed": not max(max(g) for g in gaps)\n'
        '        <= c.INT8_LOGITS_REL_TOL}))\n')


def _check(name: str, tree: str) -> bool:
    """Runs the checks in `tree`; returns whether the kernel check
    failed.  A run that ends without its result line raises."""
    proc = subprocess.run([sys.executable, '-c', _RUN], cwd=tree,
                          capture_output=True, text=True, timeout=900)
    lines = proc.stdout.splitlines()
    result = next((json.loads(ln.split(' ', 1)[1]) for ln in lines
                   if ln.startswith('FAULT_RESULT ')), None)
    if proc.returncode != 0 or result is None:
        raise SystemExit(f'{name}: the run failed (exit {proc.returncode}): '
                         f'{proc.stderr.strip().splitlines()[-3:]}')
    failed_at = next((ln for ln in lines if (m := _WORST.search(ln))
                      and float(m.group(1)) > 1.0), None)
    print(json.dumps({'fault': name, **result, 'at': failed_at}),
          flush=True)
    return result['kernel_check_failed']


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
