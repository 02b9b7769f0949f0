#!/usr/bin/env python3
"""Planted faults in the paged-decode kernel's split page walk must fail
chip_smoke.py's decode check.

    python3 scripts/decode_faults.py [--serving] [fault name ...]

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
fails.  With --serving each copy then also runs chip_smoke.py's
multi-token serving checks on a llama3-8b engine at full depth (bf16
cache): the first verify forward (`verify_check`, S 5) and one mixed
step (`mixed_check`, S 64), kernels against plain within
LOGITS_REL_TOL; the line says which of them each fault breaks (the
control's line shows that it passes them).  Needs one NVIDIA card.
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
    result.update(next((json.loads(ln.split(' ', 1)[1]) for ln in lines
                        if ln.startswith('SERVING_RESULT ')), {}))
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


# The same, then the serving checks at S 5 and S 64 (each on its own).
_SERVING = (
    'from skypilot_tpu_torch.infer import engine as engine_lib\n'
    'serving = {}\n'
    'if crashed is None:\n'
    '    for name, kw in (("verify", dict(spec_k=c.SPEC_K)),\n'
    '                     ("mixed", dict(prefill_mix_budget=c.MIX_BUDGET))):\n'
    '        torch.cuda.empty_cache()\n'
    '        eng = engine_lib.ContinuousBatchingEngine(\n'
    '            model="llama3-8b", n_slots=8, max_seq_len=4096,\n'
    '            prefill_chunk=512, page_size=16, device=dev, **kw)\n'
    '        try:\n'
    '            if name == "verify":\n'
    '                prompts, echo = c.echo_prompts(\n'
    '                    eng, c.template_prompts(128256, 14))\n'
    '                prompts = [p for p, e in zip(prompts, echo) if e][:4]\n'
    '                c.verify_check(eng, prompts, c.LOGITS_REL_TOL, name)\n'
    '            else:\n'
    '                c.mixed_check(eng, 128256, c.LOGITS_REL_TOL, name)\n'
    '            serving[name + "_check_failed"] = False\n'
    '        except AssertionError:\n'
    '            serving[name + "_check_failed"] = True\n'
    '        del eng\n'
    'print("SERVING_RESULT " + json.dumps(serving))\n')
_RUN_SERVING = _RUN.replace('print("FAULT_RESULT',
                            _SERVING + 'print("FAULT_RESULT', 1)


def main() -> int:
    args = sys.argv[1:]
    serving = '--serving' in args
    only = [a for a in args if a != '--serving']
    return run([f for f in FAULTS if not only or f[0] in only],
               _RUN_SERVING if serving else _RUN,
               timeout=900 if serving else 600)


if __name__ == '__main__':
    sys.exit(main())
