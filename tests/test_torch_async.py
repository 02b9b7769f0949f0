"""The port's double-buffered decode pipeline, on the CPU.

A pipelined engine (async_pipeline=True, the default) runs a tick's host
front while the step dispatched last tick is in flight, then joins that
step, commits its tokens and dispatches the next.  It is a latency
device only: each request's stream must be the synchronous engine's.
Tiny f32 widths (2 layers, 4 heads over 2 KV heads, dim 64, vocab 96),
three prompts through two slots, so that the third is admitted after a
completion, which the pipeline sees one tick later:
  - greedy streams, pipelined against synchronous on the same weights,
    across the reference's matrix (tests/unit_tests/test_async_pipeline.py
    `_MATRIX`, its llama rows) and mixed batches: whole-prompt and
    chunked prefill into the contiguous cache (plain, n-gram), the paged
    cache with a same-config draft model, the paged int8 cache, and the
    paged cache with prefill_mix_budget 8.  The pipelined engine is
    stepped by hand: after every step the kv mask reveals exactly the
    committed positions plus what the step in flight reveals (its rows'
    write slots, its prompt chunks, a verify's accepted window), and at
    least one step was left in flight;
  - one seeded sampled run (temperature 0.8, top_k 8) gives the same
    streams pipelined and synchronous;
  - two pipelined port engines against the JAX package's pipelined
    engine on the same weights (paged with n-gram speculation, and the
    paged int8 cache), token for token;
  - the fence: a dispatching step leaves depth 1, a request canceled
    between a dispatch and its join takes none of that step's tokens,
    close() is idempotent and leaves depth 0, and a synchronous engine
    never has a step in flight;
  - the server: --async-pipeline is the default, --no-async-pipeline
    turns it off, and --no-continuous ignores it (no socket opened).
On the CPU a step is complete when its dispatch returns, so no step
counts as overlapped; the card's overlap is chip_smoke.py's to show.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.infer import engine as jeng
from skypilot_tpu_torch import bridge
from skypilot_tpu_torch.infer import engine as teng
from skypilot_tpu_torch.infer import server as tserver

PS = 8
K = 4
OV = dict(n_layers=2, n_heads=4, n_kv_heads=2, dim=64, ffn_dim=128,
          vocab_size=96, max_seq_len=128, dtype='float32')
# Repetitive prompts, so that n-gram self-drafting proposes; the third
# is longer than the mix budget, so that it rides several steps.
PROMPTS = [[5, 17, 3, 42, 5, 17, 3, 9, 5, 17, 3], [9, 1, 4, 9, 1, 4],
           [33, 2, 71, 8, 8, 40, 12, 90, 3, 3, 61, 7, 19, 54, 2, 2, 6, 81,
            30]]
NEW = 10
LAYOUTS = {
    'whole': {},
    'chunked': {'prefill_chunk': PS},
    'paged': {'page_size': PS},
    'paged-int8': {'page_size': PS, 'kv_cache_dtype': 'int8'},
}
MATRIX = [('whole', 'plain'), ('chunked', 'ngram'), ('paged', 'draft'),
          ('paged-int8', 'plain'), ('paged', 'mixed')]


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    """The suite runs these tests beside XLA:CPU tests on the same cores:
    tiny f32 models need no intra-op threads of their own."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def params():
    """One set of random port weights for every engine pair, so that a
    difference can only come from the loop."""
    return _engine().model.state_dict()


def _engine(sd=None, **kw):
    return teng.ContinuousBatchingEngine(
        'llama-tiny', model_overrides=OV, n_slots=2, prefill_bucket=PS,
        params=sd, param_dtype=torch.float32, device='cpu', **kw)


def _mode_kw(sd, mode):
    if mode == 'draft':
        # A same-config draft accepts nearly everything, so multi-token
        # commits run through the pipeline.
        return dict(spec_k=K, draft_model='llama-tiny', draft_overrides=OV,
                    draft_params=sd)
    if mode == 'ngram':
        return dict(spec_k=K)
    if mode == 'mixed':
        return dict(prefill_mix_budget=PS)
    return {}


def _sampling(i, **kw):
    return teng.SamplingConfig(max_new_tokens=NEW, seed=i, **kw)


def _assert_reveals(eng):
    """Each working row's kv-mask row (live slots and mixed pendings)
    holds exactly its committed positions and what the step in flight
    reveals of it."""
    handle = eng._inflight  # pylint: disable=protected-access
    flying, chunks = {}, {}
    if handle is not None:
        host = handle.host.numpy()
        for i in handle.occupied:
            flying[i] = int(host[i, -1]) if handle.mode == 'spec' else 1
        chunks = {id(p): take for p, take in handle.mix}
    mask = eng._kv_mask.numpy()  # pylint: disable=protected-access
    want = {p.slot_idx: [(0, p.done + chunks.get(id(p), 0))]
            for p in eng._prefills if p.mixed}  # pylint: disable=protected-access
    for i, s in enumerate(eng._slots):  # pylint: disable=protected-access
        if s is not None:
            in_cache = s.generated - (1 if eng.spec_k else 0)
            in_cache += flying.get(i, 0)
            want[i] = [(0, s.prompt_len), (s.pad_len, s.pad_len + in_cache)]
    for i, spans in want.items():
        row = np.zeros(mask.shape[1], bool)
        for lo, hi in spans:
            row[lo:hi] = True
        assert (mask[i] == row).all(), (i, spans, np.flatnonzero(mask[i]))


def _stepped(eng, prompts, **sampling):
    """The pipelined engine's streams, stepped by hand: the reveals
    checked after every step, and a step seen in flight."""
    rids = [eng.submit(p, _sampling(i, **sampling))
            for i, p in enumerate(prompts)]
    in_flight = False
    while eng.step():
        _assert_reveals(eng)
        in_flight |= eng.pipeline_info()['depth'] == 1
    assert in_flight and eng.pipeline_info()['depth'] == 0
    return [eng.wait(r, timeout=0.001) for r in rids]


def _synchronous(eng, prompts, **sampling):
    rids = [eng.submit(p, _sampling(i, **sampling))
            for i, p in enumerate(prompts)]
    while eng.step():
        assert eng.pipeline_info()['depth'] == 0
    return [eng.wait(r, timeout=0.001) for r in rids]


@pytest.mark.parametrize('layout,mode', MATRIX,
                         ids=['-'.join(row) for row in MATRIX])
def test_async_greedy_streams_equal_sync(params, layout, mode):
    kw = dict(LAYOUTS[layout], **_mode_kw(params, mode))
    want = _synchronous(_engine(params, async_pipeline=False, **kw),
                        PROMPTS)
    eng = _engine(params, **kw)
    assert eng.async_pipeline
    assert _stepped(eng, PROMPTS) == want
    assert all(len(w) == NEW for w in want)
    assert eng.allocator_leak_report() is None
    if mode in ('ngram', 'draft'):
        assert eng.speculation_info()['proposed_tokens'] > 0
    if mode == 'draft':
        assert eng.speculation_info()['acceptance_rate'] > 0.9


def test_async_sampled_streams_equal_sync(params):
    sampling = dict(temperature=0.8, top_k=8)
    want = _synchronous(_engine(params, page_size=PS, async_pipeline=False),
                        PROMPTS, **sampling)
    assert _stepped(_engine(params, page_size=PS), PROMPTS,
                    **sampling) == want


@pytest.mark.parametrize('kw', [dict(spec_k=K), dict(kv_cache_dtype='int8')],
                         ids=['paged-ngram', 'paged-int8'])
def test_async_streams_equal_jax_async(kw):
    je = jeng.ContinuousBatchingEngine(
        'llama-tiny', model_overrides=OV, n_slots=2, prefill_bucket=PS,
        page_size=PS, async_pipeline=True, param_dtype=jnp.float32,
        decode_kernel='xla', prefill_kernel='xla', **kw)
    try:
        want = je.generate(PROMPTS, jeng.SamplingConfig(max_new_tokens=NEW))
        sd = bridge.params_from_jax(jax.tree.map(np.asarray, je.params),
                                    je.config)
    finally:
        je.close()
    eng = _engine(sd, page_size=PS, decode_kernel='xla',
                  prefill_kernel='xla', **kw)
    assert eng.generate(
        PROMPTS, teng.SamplingConfig(max_new_tokens=NEW)) == want
    assert eng.pipeline_info()['depth'] == 0
    assert eng.allocator_leak_report() is None


def test_pipeline_fence(params):
    eng = _engine(params, page_size=PS)
    rids = [eng.submit(p, _sampling(i)) for i, p in enumerate(PROMPTS[:2])]
    assert eng.step()           # admits both, dispatches their first step
    assert eng.pipeline_info() == dict(mode='async', depth=1, max_depth=1,
                                       worker_alive=False,
                                       steps_overlapped=0)
    slots = [next(s for s in eng._slots  # pylint: disable=protected-access
                  if s is not None and s.request_id == r) for r in rids]
    assert [s.generated for s in slots] == [0, 0]   # not committed yet
    eng.cancel(rids[1])
    assert eng.step()           # evicts, joins, dispatches the next step
    assert slots[0].generated == 1
    assert slots[1].generated == 0 and slots[1].outputs == []
    assert all(s is None or s.request_id != rids[1]
               for s in eng._slots)  # pylint: disable=protected-access
    assert eng.pipeline_info()['depth'] == 1
    eng.close()
    eng.close()
    assert eng.pipeline_info()['depth'] == 0
    sync = _engine(params, page_size=PS, async_pipeline=False)
    sync.submit(PROMPTS[0], _sampling(0))
    for _ in range(3):
        assert sync.step()
        assert sync.pipeline_info()['depth'] == 0
    assert sync.pipeline_info()['mode'] == 'sync'
    assert sync.pipeline_info()['max_depth'] == 0
    sync.close()
    assert sync.pipeline_info()['depth'] == 0


def test_server_async_pipeline_flag(params):
    parser = tserver.build_parser()
    assert parser.parse_args([]).async_pipeline is True
    assert parser.parse_args(['--async-pipeline']).async_pipeline is True
    assert parser.parse_args(['--no-async-pipeline']).async_pipeline \
        is False
    kw = dict(model='llama-tiny', model_overrides=OV, params=params,
              param_dtype=torch.float32, port=0, host='127.0.0.1',
              device='cpu')
    for flag, mode in ((True, 'async'), (False, 'sync')):
        srv = tserver.InferenceServer(page_size=PS, async_pipeline=flag,
                                      **kw)
        assert srv.engine.async_pipeline is flag
        assert srv.health_detail()['pipeline'] == dict(
            mode=mode, depth=0, max_depth=int(flag), worker_alive=False,
            steps_overlapped=0)
        srv.shutdown()
    srv = tserver.InferenceServer(continuous=False, async_pipeline=False,
                                  **kw)
    assert isinstance(srv.engine, teng.InferenceEngine)
    assert 'pipeline' not in srv.health_detail()
    got = srv._handle_generate(  # pylint: disable=protected-access
        dict(prompt_ids=PROMPTS[:1], max_new_tokens=4))['tokens']
    assert len(got) == 1 and len(got[0]) == 4
    srv.shutdown()
