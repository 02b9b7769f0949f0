#!/usr/bin/env python3
"""Planted faults in the host logic of speculative decoding and mixed
batches must fail the port's CPU tests against the JAX package.

    python3 scripts/spec_faults.py [fault name ...]

For each fault below (or each one named), copies skypilot_tpu_torch/ and
the two test files (tests/test_torch_spec.py, tests/test_torch_mixed.py)
into skypilot_tpu_torch/_build/faults/<name>/ (git-ignored) and changes
one line of the copy's models/llama.py or infer/engine.py.  Then pytest
runs both files in each copy (the copy's package first on the path, the
JAX package from this checkout; JAX on the CPU, no card needed), three
copies at a time.  The unchanged copy is the control and must pass;
every fault must fail at least one test.  Prints one JSON line per run
(the fault, whether the tests failed, the tests that failed, seconds)
and exits 0 only when the control passes and every fault fails.
"""
from __future__ import annotations

import concurrent.futures
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(ROOT, 'skypilot_tpu_torch', '_build', 'faults')
TESTS = ('tests/test_torch_spec.py', 'tests/test_torch_mixed.py')

# (name, file under skypilot_tpu_torch/, the text as it is, the text
# planted): where a multi-token forward writes, what a verify and a
# mixed step reveal and when, and the null-page redirect.
FAULTS = (
    ('verify_writes_one_late', 'models/llama.py',
     'return base, base[:, None] + torch.arange(s, device=kv_mask.device)',
     'return base, base[:, None] + torch.arange(s, device=kv_mask.device)'
     ' + (s > 1)'),
    ('reveal_counts_plus_one', 'infer/engine.py',
     'torch.where(mix_real > 0, mix_real, counts), act_w)',
     'torch.where(mix_real > 0, mix_real, counts) + 1, act_w)'),
    ('null_page_redirect_dropped', 'models/llama.py',
     'phys = torch.where(pos < max_len, cache.table.gather(1, lp).long(), 0)',
     'phys = cache.table.gather(1, lp).long()'),
    ('mixed_chunk_revealed_before_forward', 'infer/engine.py',
     'kv_mask[rows, cursors] |= has_work',
     'kv_mask |= spec_lib.commit_window(self.max_seq_len, cursors, '
     'n_commit, has_work)'),
    ('mixed_last_logits_at_query_0', 'infer/engine.py',
     "h['last_pos'][i] = take - 1 if h['update_last'][i] else 0",
     "h['last_pos'][i] = 0"),
)


def _copy(name: str) -> str:
    dst = os.path.join(WORK, name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, 'skypilot_tpu_torch'),
                    os.path.join(dst, 'skypilot_tpu_torch'),
                    ignore=shutil.ignore_patterns('_build', '__pycache__'))
    os.makedirs(os.path.join(dst, 'tests'))
    for test in TESTS:
        shutil.copy(os.path.join(ROOT, test), os.path.join(dst, test))
    return dst


def _plant(tree: str, src: str, old: str, new: str) -> None:
    path = os.path.join(tree, 'skypilot_tpu_torch', src)
    text = open(path).read()
    if text.count(old) != 1:
        raise SystemExit(f'{src}: {old!r} occurs {text.count(old)} times')
    with open(path, 'w') as f:
        f.write(text.replace(old, new))


def _check(name: str, tree: str) -> dict:
    """Runs the tests in `tree`; the JSON line of the run."""
    t0 = time.perf_counter()
    env = dict(os.environ, JAX_PLATFORMS='cpu',
               PYTHONPATH=os.pathsep.join([tree, ROOT]))
    proc = subprocess.run(
        [sys.executable, '-m', 'pytest', *TESTS, '-q', '-p',
         'no:cacheprovider', '--noconftest', '-o', 'addopts='],
        cwd=tree, env=env, capture_output=True, text=True, timeout=1200)
    failed = sorted(set(re.findall(r'^FAILED (\S+)', proc.stdout, re.M)))
    if proc.returncode not in (0, 1) or (proc.returncode == 1
                                         and not failed):
        raise SystemExit(f'{name}: pytest did not run (exit '
                         f'{proc.returncode}): {proc.stdout[-2000:]}')
    return {'fault': name, 'tests_failed': proc.returncode == 1,
            'failed': failed,
            'seconds': round(time.perf_counter() - t0, 1)}


def main() -> int:
    only = sys.argv[1:]
    faults = [f for f in FAULTS if not only or f[0] in only]
    trees = {'control': _copy('control')}
    for name, src, old, new in faults:
        trees[name] = _copy(name)
        _plant(trees[name], src, old, new)
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        runs = dict(zip(trees, pool.map(lambda kv: _check(*kv),
                                        trees.items())))
    for run in runs.values():
        print(json.dumps(run), flush=True)
    ok = not runs['control']['tests_failed'] and all(
        runs[name]['tests_failed'] for name, *_ in faults)
    shutil.rmtree(WORK, ignore_errors=True)
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
