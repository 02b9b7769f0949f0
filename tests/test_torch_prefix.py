"""Prefix sharing in the port's paged engine against the JAX package's, on
the CPU.

The reference's paged engine looks up every page-aligned prompt page
already in the pool at admission, hydrates the prefill cache from those
pages, prefills only the rest, leaves the shared pages unwritten at the
insert and registers the prompt's pages for later requests
(tests/unit_tests/test_paged_kv_cache.py::TestPrefixSharing).  Here the
port does the same on the same weights and prompts, with the kernels'
wrappers (their plain versions on the CPU): identical greedy streams to
the JAX engine, which shares the same pages; the float cache against the
JAX 'xla' engine, the int8 cache against the JAX engine running its
Pallas kernels in interpret mode.  The cases: two requests with a common
2-page prefix (the second shares both pages, refcount 2 each), one
prompt served twice (its pages shared back out of the reclaimable LRU),
and chunked prefill where the shared length (16) is not a multiple of
the chunk (3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.infer import engine as jeng
from skypilot_tpu_torch import bridge
from skypilot_tpu_torch.infer import engine as teng

PS = 8
OV = dict(n_layers=2, n_heads=4, n_kv_heads=2, dim=64, ffn_dim=128,
          vocab_size=96, max_seq_len=64, dtype='float32')
SHARED = list(range(7, 7 + 2 * PS))          # 2 full pages
PROMPTS = [SHARED + [3, 9], SHARED + [60, 2, 11]]
NEW = 6


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    """The suite runs these tests beside XLA:CPU tests on the same cores:
    tiny f32 models need no intra-op threads of their own."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _engines(kv_cache_dtype='auto', **kw):
    """A fresh JAX paged engine and the port's on its weights: the int8
    cache through the fused kernels (Pallas in interpret mode on the JAX
    side), the float cache through the JAX 'xla' read, which computes the
    kernels' function."""
    kern = 'fused' if kv_cache_dtype == 'int8' else 'xla'
    kw = dict(model='llama-tiny', model_overrides=OV, n_slots=2,
              prefill_bucket=PS, page_size=PS, kv_cache_dtype=kv_cache_dtype,
              **kw)
    je = jeng.ContinuousBatchingEngine(
        **kw, async_pipeline=False, param_dtype=jnp.float32,
        decode_kernel=kern, prefill_kernel=kern)
    te = teng.ContinuousBatchingEngine(
        **kw, params=bridge.params_from_jax(
            jax.tree.map(np.asarray, je.params), je.config),
        param_dtype=torch.float32, decode_kernel='fused',
        prefill_kernel='fused', device='cpu')
    return je, te


def _greedy(eng, lib, prompts):
    return eng.generate(prompts, lib.SamplingConfig(max_new_tokens=NEW))


def _spy_finishes(eng):
    """Record (pages, shared_len, refcounts) at each finished prefill."""
    finishes = []
    orig = eng._finish_prefill  # pylint: disable=protected-access

    # (An engine without prefix sharing reads as shared_len 0, and its
    # refcounts as None.)
    refcount = getattr(eng._alloc, 'refcount', lambda page: None)  # pylint: disable=protected-access

    def spy(pending):
        orig(pending)
        finishes.append((list(pending.pages),
                         getattr(pending, 'shared_len', 0),
                         [refcount(p) for p in pending.pages]))
    eng._finish_prefill = spy  # pylint: disable=protected-access
    return finishes


@pytest.mark.parametrize('kv_cache_dtype', ['auto', 'int8'])
def test_shared_pages_allocated_once(kv_cache_dtype):
    je, te = _engines(kv_cache_dtype)
    want = _greedy(je, jeng, PROMPTS)
    finishes = _spy_finishes(te)
    assert _greedy(te, teng, PROMPTS) == want
    (pages_a, shared_a, _), (pages_b, shared_b, refs_b) = finishes
    # A prefilled from scratch; B found A's 2-page prefix and skipped it.
    assert shared_a == 0 and shared_b == 2 * PS
    assert pages_b[:2] == pages_a[:2]
    assert refs_b[:2] == [2, 2]
    assert len(set(pages_a) | set(pages_b)) == \
        len(pages_a) + len(pages_b) - 2
    assert te.prefix_hit_pages == 2
    # Everything released at completion; the prefix pages stay
    # reclaimable, so still allocatable.
    assert te._alloc.live_pages == 0  # pylint: disable=protected-access
    assert te._alloc.free_pages == te.n_pages - 1  # pylint: disable=protected-access
    assert te.allocator_leak_report() is None


def test_sequential_reuse_through_reclaimable():
    je, te = _engines()
    prompt = PROMPTS[0]
    want = _greedy(je, jeng, [prompt])
    assert _greedy(te, teng, [prompt]) == want
    # The prefix is reclaimable but intact: lookup resurrects it, and the
    # second run, which shares it, gives the same answer.
    shared = te._alloc.lookup_prefix(prompt)  # pylint: disable=protected-access
    assert len(shared) == 2
    for p in shared:
        te._alloc.release(p)  # pylint: disable=protected-access
    finishes = _spy_finishes(te)
    assert _greedy(te, teng, [prompt]) == _greedy(je, jeng, [prompt]) == want
    assert finishes[0][1] == 2 * PS
    assert te._alloc.live_pages == 0  # pylint: disable=protected-access


def test_shared_len_off_the_chunk_grid():
    # Chunks of 3: A prefills in 6 chunk steps; B, admitted after A is
    # done, starts its chunks at shared_len 16, which is not a multiple
    # of 3, so its chunk boundaries differ from a cold prefill's.
    je, te = _engines(prefill_chunk=3)
    finishes = _spy_finishes(te)
    for prompt in PROMPTS:
        assert _greedy(te, teng, [prompt]) == _greedy(je, jeng, [prompt])
    assert [f[1] for f in finishes] == [0, 2 * PS]
    assert te.prefix_hit_pages == 2
    assert te._alloc.live_pages == 0  # pylint: disable=protected-access
