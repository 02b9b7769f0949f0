#!/usr/bin/env python3
"""Planted faults in the host logic of the double-buffered decode
pipeline must fail the port's CPU tests of it.

    python3 scripts/async_faults.py [fault name ...]

For each fault below (or each one named), copies skypilot_tpu_torch/ and
tests/test_torch_async.py into skypilot_tpu_torch/_build/faults/<name>/
(git-ignored) and changes the copy's infer/engine.py.  Then pytest runs
the test file in each copy (the copy's package first on the path, the
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
TESTS = ('tests/test_torch_async.py',)
ENGINE = 'infer/engine.py'

# (name, [(the text as it is, the text planted), ...]) in infer/engine.py:
# the order of a tick's join and dispatch, when a step's tokens are
# committed, and when the prompts that rode it advance.
FAULTS = (
    # The next step's inputs are built before the step in flight is
    # committed: it reads the slots' state of one step back.
    ('dispatch_before_join', [
        ('        consumed = self._pipeline_join()\n'
         '        if self._fatal is not None:\n'
         '            return False\n',
         '        consumed = False\n'),
        ('        self._pipeline_put(self._dispatch(occupied, mixed))\n',
         '        handle = self._dispatch(occupied, mixed)\n'
         '        self._pipeline_join()\n'
         '        self._pipeline_put(handle)\n')]),
    # The step's tokens are committed as it is dispatched: nothing is
    # ever left in flight.
    ('tokens_committed_at_dispatch', [
        ('        self._pipeline_put(self._dispatch(occupied, mixed))\n',
         '        self._consume_step(self._dispatch(occupied, mixed))\n')]),
    # The mixed pendings' cursors advance when their chunks are
    # dispatched, not when the step is consumed.
    ('mix_advanced_at_dispatch', [
        ('            self._advance_mix(handle.mix, None)\n'
         '            return\n',
         '            return\n'),
        ('        host, event = self._fetch(tok)\n',
         "        self._advance_mix(inp['mix'], None)\n"
         '        host, event = self._fetch(tok)\n')]),
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


def _plant(tree: str, edits) -> None:
    path = os.path.join(tree, 'skypilot_tpu_torch', ENGINE)
    text = open(path).read()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f'{ENGINE}: {old!r} occurs {text.count(old)} '
                             'times')
        text = text.replace(old, new)
    with open(path, 'w') as f:
        f.write(text)


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
    for name, edits in faults:
        trees[name] = _copy(name)
        _plant(trees[name], edits)
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        runs = dict(zip(trees, pool.map(lambda kv: _check(*kv),
                                        trees.items())))
    for run in runs.values():
        print(json.dumps(run), flush=True)
    ok = not runs['control']['tests_failed'] and all(
        runs[name]['tests_failed'] for name, _ in faults)
    shutil.rmtree(WORK, ignore_errors=True)
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
