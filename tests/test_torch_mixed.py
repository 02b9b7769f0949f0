"""Mixed prefill/decode batches in the port against the JAX package, on
the CPU.

With prefill_mix_budget > 0 a prompt is not prefilled on dedicated ticks:
its tokens ride decode steps, up to the budget a step, in the step's
S-query slot forward (S = the budget, at least 2; the k + 1 verify
window under speculation).  Here three prompts go through two slots, so
that the third is admitted while the others decode, with budgets of 1
(S = 2: the smallest multi-token width), 5 (prompts split into chunks,
and two pendings sharing one step's budget) and 64 (whole prompts);
prompts of 11 and 19 tokens are padded to 16 and 24, so a chunk's
reveal past the prompt's end would show.  Each port stream must equal
the JAX engine's unmixed greedy stream token for token: contiguous and
paged float caches (the JAX 'xla' engine as the oracle), the paged int8
cache (the JAX engine running its Pallas kernels in interpret mode), and
the mixed steps under n-gram and draft-model speculation.  The port's
engines here take the synchronous tick (async_pipeline=False; the
pipelined tick is tests/test_torch_async.py's), so after every step
the kv mask reveals exactly what the engine has committed: a
pending's prompt up to its cursor; a live slot's prompt and the decode
positions of its committed tokens (under speculation all but the last,
the pending token, which the next verify feeds), nothing of a rejected,
pad or unrevealed tail.  A pending canceled after its first chunk hands
back every page and its table row.

A pending that shares a prompt prefix and rides no chunk in a step (the
budget spent on an earlier pending) writes its pad queries to the null
page: the port writes a mixed pending's table row at its first ride.
The reference writes it at admission, so such a step writes over the
shared prefix's last position, in a page other requests read; the port's
shared page must hold what the unmixed engine wrote.
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
          vocab_size=96, max_seq_len=128, dtype='float32')
PROMPTS = [[5, 17, 3, 42, 5, 17, 3, 9, 5, 17, 3], [9, 1, 4, 9, 1, 4],
           [33, 2, 71, 8, 8, 40, 12, 90, 3, 3, 61, 7, 19, 54, 2, 2, 6, 81,
            30]]
NEW = 10


def _assert_reveals(eng):
    """Each working row's kv-mask row holds exactly its committed
    positions."""
    mask = eng._kv_mask.cpu().numpy()  # pylint: disable=protected-access
    want = {p.slot_idx: [(0, p.done)] for p in eng._prefills}  # pylint: disable=protected-access
    for i, s in enumerate(eng._slots):  # pylint: disable=protected-access
        if s is not None:
            in_cache = s.generated - (1 if eng.spec_k else 0)
            want[i] = [(0, s.prompt_len), (s.pad_len, s.pad_len + in_cache)]
    for i, spans in want.items():
        row = np.zeros(mask.shape[1], bool)
        for lo, hi in spans:
            row[lo:hi] = True
        assert (mask[i] == row).all(), (i, spans, np.flatnonzero(mask[i]))


def _generate(eng, prompts):
    """`eng.generate`, stepped by hand, the reveals checked every step."""
    rids = [eng.submit(p, teng.SamplingConfig(max_new_tokens=NEW))
            for p in prompts]
    while eng.step():
        _assert_reveals(eng)
    return [eng.wait(r, timeout=0.001) for r in rids]


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    """The suite runs these tests beside XLA:CPU tests on the same cores:
    tiny f32 models need no intra-op threads of their own."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _shared_prefix_beside_a_long_pending(je, sd):
    """A's 2-page prefix, then B (30 tokens, budget 5 a step: 6 steps)
    and C (A's prefix + 3 tokens, riding nothing until B is in)."""
    rng = np.random.RandomState(0)
    shared = rng.randint(0, 96, 2 * PS).tolist()
    a, b, c = shared + [3, 4, 5], rng.randint(0, 96, 30).tolist(), \
        shared + [7, 8, 9]
    je.generate([a], jeng.SamplingConfig(max_new_tokens=4))
    want = je.generate([b, c], jeng.SamplingConfig(max_new_tokens=NEW))
    eng = teng.ContinuousBatchingEngine(
        model='llama-tiny', model_overrides=OV, n_slots=2,
        prefill_bucket=PS, page_size=PS, params=sd,
        param_dtype=torch.float32, prefill_mix_budget=5,
        async_pipeline=False, device='cpu')
    eng.generate([a], teng.SamplingConfig(max_new_tokens=4))
    assert _generate(eng, [b, c]) == want
    assert eng.prefix_hit_pages == 2
    page = eng._alloc.lookup_prefix(a)[1]  # pylint: disable=protected-access
    jpage = je._alloc.lookup_prefix(a)[1]  # pylint: disable=protected-access
    jkey = np.asarray(je._cache['layers']['attention']['page_key'])  # pylint: disable=protected-access
    np.testing.assert_allclose(eng._cache.key[:, page].numpy(),  # pylint: disable=protected-access
                               jkey[:, jpage], atol=1e-5, rtol=0)


@pytest.mark.parametrize('page_size,kv_cache_dtype', [
    (0, 'auto'), (PS, 'auto'), (PS, 'int8')],
    ids=['contiguous', 'paged', 'paged_int8'])
def test_mixed_streams_equal_jax_unmixed(page_size, kv_cache_dtype):
    kern = 'fused' if kv_cache_dtype == 'int8' else 'xla'
    kw = dict(model='llama-tiny', model_overrides=OV, n_slots=2,
              prefill_bucket=PS, page_size=page_size,
              kv_cache_dtype=kv_cache_dtype)
    je = jeng.ContinuousBatchingEngine(
        **kw, async_pipeline=False, param_dtype=jnp.float32,
        decode_kernel=kern, prefill_kernel=kern)
    want = je.generate(PROMPTS, jeng.SamplingConfig(max_new_tokens=NEW))
    sd = bridge.params_from_jax(jax.tree.map(np.asarray, je.params),
                                je.config)
    runs = [dict(prefill_mix_budget=b) for b in (1, 5, 64)]
    runs += [dict(prefill_mix_budget=5, spec_k=4),
             dict(prefill_mix_budget=5, spec_k=4, draft_model='llama-tiny',
                  draft_overrides=OV, draft_params=sd)]
    for run in runs:
        eng = teng.ContinuousBatchingEngine(
            **kw, params=sd, param_dtype=torch.float32,
            async_pipeline=False, device='cpu', **run)
        assert _generate(eng, PROMPTS) == want, run
        assert eng.allocator_leak_report() is None
    if page_size and kv_cache_dtype == 'auto':
        _shared_prefix_beside_a_long_pending(je, sd)
    if page_size:
        # Cancel a pending after its first chunk rode a step: its pages
        # and table row are handed back.
        rid = eng.submit(list(range(40, 70)),
                         teng.SamplingConfig(max_new_tokens=4))
        eng.step()
        pending = eng._prefills[0]  # pylint: disable=protected-access
        assert pending.mixed and 0 < pending.done < pending.true_len
        assert eng._cache.table[pending.slot_idx].any()  # pylint: disable=protected-access
        eng.cancel(rid)
        eng.step()
        assert eng.is_idle() and eng.allocator_leak_report() is None
        assert not eng._cache.table.any()  # pylint: disable=protected-access
