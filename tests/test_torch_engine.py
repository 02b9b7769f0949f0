"""The port's serving slice against the JAX package's, on the CPU.

A JAX ContinuousBatchingEngine (synchronous, paged, chunked prefill,
plain-XLA kernels, f32) and the port's engine, given the same params
through the bridge, must emit identical greedy token streams; so must
the port's InferenceServer over a real socket.  Sampling is checked as a
distribution: `fold_in` has no torch twin, so the port's draws are held
to the reference's exact filtered softmax (total variation < 0.05).
"""
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.infer import engine as jeng
from skypilot_tpu.infer import paging as jpaging
from skypilot_tpu_torch import bridge
from skypilot_tpu_torch.infer import engine as teng
from skypilot_tpu_torch.infer import paging as tpaging
from skypilot_tpu_torch.infer import server as tserver
from skypilot_tpu_torch.ops import paged_attention as tpa
from skypilot_tpu_torch.ops import ragged_prefill as trp

OV = dict(n_layers=2, n_heads=4, n_kv_heads=2, dim=64, ffn_dim=128,
          vocab_size=96, max_seq_len=64, dtype='float32')
ENGINE_KW = dict(model='llama-tiny', model_overrides=OV, page_size=8,
                 prefill_chunk=8, n_slots=2)
NEW = 12
# Lengths that end mid-page and cross page (8) and chunk (8) boundaries.
PROMPT_LENS = (5, 13, 21)


@pytest.fixture(scope='module')
def reference():
    """(JAX engine, its params as a port state_dict, prompts, greedy
    streams)."""
    je = jeng.ContinuousBatchingEngine(
        **ENGINE_KW, async_pipeline=False, param_dtype=jnp.float32,
        decode_kernel='xla', prefill_kernel='xla')
    sd = bridge.params_from_jax(jax.tree.map(np.asarray, je.params),
                                je.config)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 96, n).tolist() for n in PROMPT_LENS]
    streams = je.generate(prompts, jeng.SamplingConfig(max_new_tokens=NEW))
    return je, sd, prompts, streams


def _port_engine(sd, **kw):
    return teng.ContinuousBatchingEngine(
        **{**ENGINE_KW, **kw}, params=sd, param_dtype=torch.float32,
        device='cpu')


def test_greedy_streams_identical(reference):
    _, sd, prompts, streams = reference
    te = _port_engine(sd)
    assert te.decode_kernel == 'xla' and te.prefill_kernel == 'xla'
    got = te.generate(prompts, teng.SamplingConfig(max_new_tokens=NEW))
    assert got == streams
    assert te.allocator_leak_report() is None
    assert te.is_idle()


def test_whole_prompt_prefill_matches_chunked(reference):
    _, sd, prompts, streams = reference
    te = _port_engine(sd, prefill_chunk=0, n_slots=3)
    assert te.generate(prompts,
                       teng.SamplingConfig(max_new_tokens=NEW)) == streams


def _post(url, body, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def test_server_greedy_over_socket(reference):
    _, sd, prompts, streams = reference
    srv = tserver.InferenceServer(
        model='llama-tiny', port=0, host='127.0.0.1', max_batch_size=2,
        model_overrides=OV, params=sd, param_dtype=torch.float32,
        prefill_chunk=8, page_size=8, device='cpu')
    srv.start()
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = f'http://127.0.0.1:{srv.port}'
    try:
        with urllib.request.urlopen(base + '/health', timeout=10) as r:
            assert r.status == 200
            assert json.loads(r.read()) == {'status': 'ok'}
        # Concurrent clients: one request with all prompts, and the
        # same prompts again one per request from parallel threads.
        code, body = _post(base + '/generate', {
            'prompt_ids': prompts, 'max_new_tokens': NEW,
            'temperature': 0.0})
        assert code == 200 and body['tokens'] == streams
        results = [None] * len(prompts)

        def one(i):
            results[i] = _post(base + '/generate', {
                'prompt_ids': [prompts[i]], 'max_new_tokens': NEW})[1]

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(prompts))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
        assert [r['tokens'][0] for r in results] == streams
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(base + '/generate', {'prompt_ids': [[1] * 60],
                                       'max_new_tokens': NEW})
        assert err.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(base + '/generate', timeout=10)
        assert err.value.code == 405
        assert err.value.headers['Allow'] == 'POST'
    finally:
        srv.shutdown()
        t.join(timeout=10)
    assert not t.is_alive()


def test_server_refuses_random_weights_without_opt_in():
    with pytest.raises(ValueError, match='randomly initialized'):
        tserver.InferenceServer(model='llama-tiny', model_overrides=OV,
                                page_size=8, device='cpu')


def _jax_last_logits(je, prompt):
    """The reference's logits at the prompt's last token (one prefill)."""
    s = len(prompt)
    logits, _ = je._prefill1(  # pylint: disable=protected-access
        je.params, je._fresh_cache1(),  # pylint: disable=protected-access
        jnp.asarray([prompt], jnp.int32),
        jnp.arange(s, dtype=jnp.int32)[None],
        jnp.asarray(np.arange(64) < s)[None], kv_bucket=0)
    return logits[0, s - 1][None]


def test_sampled_first_token_distribution(reference):
    """The first sampled token of a temperature/top-k/top-p request,
    over many request seeds, follows the reference's exact sampling
    distribution: softmax(filter_logits_rows(last logits))."""
    je, sd, prompts, _ = reference
    prompt = prompts[0]
    temp, top_k, top_p = 0.8, 4, 0.9
    target = np.asarray(jax.nn.softmax(jeng.filter_logits_rows(
        _jax_last_logits(je, prompt), jnp.array([temp]),
        jnp.array([top_k]), jnp.array([top_p]), max_k=4, use_top_p=True,
        top_p_in_topk=True)))[0]
    n = 1200
    te = _port_engine(sd, n_slots=16)
    rids = [te.submit(prompt, teng.SamplingConfig(
        temperature=temp, top_k=top_k, top_p=top_p, max_new_tokens=1,
        seed=i)) for i in range(n)]
    te.run_until_idle()
    firsts = [te.wait(r, timeout=1.0)[0] for r in rids]
    freq = np.bincount(firsts, minlength=96) / n
    tv = 0.5 * float(np.abs(freq - target).sum())
    assert tv < 0.05, (tv, np.nonzero(freq)[0], np.nonzero(target)[0])
    # A seeded request is reproducible.
    again = te.generate([prompt], teng.SamplingConfig(
        temperature=temp, top_k=top_k, top_p=top_p, max_new_tokens=1,
        seed=7))
    assert again[0][0] == firsts[7]


@pytest.mark.parametrize('top_k,top_p,in_topk', [
    (0, 1.0, False), (3, 1.0, False), (0, 0.7, False), (5, 0.6, True),
    (5, 0.6, False)])
def test_filter_logits_rows_matches_jax(top_k, top_p, in_topk):
    rng = np.random.RandomState(top_k)
    logits = rng.randn(4, 32).astype(np.float32) * 3
    temps = np.array([0.0, 0.5, 1.0, 1.7], np.float32)
    ks = np.full((4,), top_k, np.int32)
    ps = np.full((4,), top_p, np.float32)
    max_k = jeng.top_k_bucket(top_k, 32)
    assert teng.top_k_bucket(top_k, 32) == max_k
    want = np.asarray(jeng.filter_logits_rows(
        jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(ks),
        jnp.asarray(ps), max_k=max_k, use_top_p=top_p < 1.0,
        top_p_in_topk=in_topk))
    got = teng.filter_logits_rows(
        torch.from_numpy(logits), torch.from_numpy(temps),
        torch.from_numpy(ks), torch.from_numpy(ps), max_k=max_k,
        use_top_p=top_p < 1.0, top_p_in_topk=in_topk)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_sample_logits_rows_distribution():
    v, n = 8, 4000
    logits = np.random.RandomState(3).randn(1, v).astype(np.float32)
    temps = np.array([0.8], np.float32)
    target = np.asarray(jax.nn.softmax(jnp.asarray(logits) / 0.8))[0]
    t_logits = torch.from_numpy(np.repeat(logits, n, axis=0))
    gens = [teng.row_generator(i, 0, torch.device('cpu')) for i in range(n)]
    tok = teng.sample_logits_rows(
        t_logits, gens, torch.full((n,), 0.8), torch.zeros(n, dtype=torch.int64),
        torch.ones(n), max_k=0, use_top_p=False)
    freq = np.bincount(tok.numpy(), minlength=v) / n
    assert 0.5 * float(np.abs(freq - target).sum()) < 0.05
    greedy = teng.sample_logits_rows(
        torch.from_numpy(logits), [None], torch.from_numpy(temps) * 0,
        torch.zeros(1, dtype=torch.int64), torch.ones(1), max_k=0,
        use_top_p=False)
    assert int(greedy[0]) == int(np.argmax(logits))


@pytest.mark.parametrize('decode,prefill,on_cuda,page_size,want', [
    ('auto', 'auto', False, 8, ('xla', 'xla')),
    ('auto', 'auto', True, 8, ('fused', 'fused')),
    ('auto', 'auto', True, 0, ('xla', 'xla')),
    ('xla', 'fused', True, 8, ('xla', 'fused')),
    ('fused', 'auto', False, 8, ('fused', 'xla')),
    ('auto', 'fused', False, 8, ('xla', 'fused')),
    ('fused', 'xla', True, 0, ValueError),
    ('xla', 'fused', False, 0, ValueError),
    ('plain', 'xla', True, 8, ValueError),
    ('bogus', 'xla', True, 8, ValueError),
])
def test_resolve_kernels(decode, prefill, on_cuda, page_size, want):
    if want is ValueError:
        with pytest.raises(ValueError):
            teng.resolve_kernels(decode, prefill, on_cuda=on_cuda,
                                 page_size=page_size)
        return
    got = teng.resolve_kernels(decode, prefill, on_cuda=on_cuda,
                               page_size=page_size)
    assert (got['decode'], got['prefill']) == want


def test_fused_on_cpu_is_refused(reference):
    """'fused' on the CPU is refused where there is no kernel (an
    unpaged cache, as in the reference); on a paged engine it runs the
    kernels' wrappers, which take their plain versions for CPU tensors
    (the reference's interpret mode), and the greedy streams stay the
    reference's."""
    _, sd, prompts, streams = reference
    with pytest.raises(ValueError, match='fused'):
        _port_engine(sd, page_size=0, decode_kernel='fused')
    te = _port_engine(sd, decode_kernel='fused', prefill_kernel='fused')
    assert (te.decode_kernel, te.prefill_kernel) == ('fused', 'fused')
    before = (tpa.launches, trp.launches)
    assert te.generate(prompts[:1], teng.SamplingConfig(
        max_new_tokens=NEW)) == streams[:1]
    assert (tpa.launches, trp.launches) == before


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default device is valid here')
    from skypilot_tpu_torch import models
    with pytest.raises(RuntimeError, match="device='cpu'"):
        teng.ContinuousBatchingEngine(model='llama-tiny',
                                      model_overrides=OV, page_size=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserver.InferenceServer(model='llama-tiny', model_overrides=OV,
                                page_size=8, allow_random_weights=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        models.get_model('llama-tiny', **OV)


def test_allocator_matches_reference():
    """Same operations, same answers: the port's own PageAllocator copy
    against the reference's."""
    ops = [('alloc', 3), ('alloc', 2), ('release', 2), ('alloc', 4),
           ('register', ([1, 2, 3, 4, 5, 6, 7, 8, 9], [1, 3])),
           ('release', 1), ('release', 3), ('lookup', [1, 2, 3, 4, 5, 6]),
           ('alloc', 6), ('alloc', 1)]
    allocs = [jpaging.PageAllocator(9, 4), tpaging.PageAllocator(9, 4)]
    for op, arg in ops:
        outs = []
        for a in allocs:
            if op == 'alloc':
                outs.append(a.alloc(arg))
            elif op == 'release':
                outs.append(a.release(arg))
            elif op == 'register':
                outs.append(a.register_prefix(*arg))
            else:
                outs.append(a.lookup_prefix(arg))
            outs.append((a.free_pages, a.live_pages,
                         a.cannibalized_total, a.leak_report()))
        assert outs[:2] == outs[2:], (op, outs)
    seq = list(range(37))
    assert tpaging.chain_hashes(seq, 8) == jpaging.chain_hashes(seq, 8)


def test_submit_validates(reference):
    _, sd, _, _ = reference
    te = _port_engine(sd)
    with pytest.raises(ValueError, match='exceeds max_seq_len'):
        te.submit([1] * 60, teng.SamplingConfig(max_new_tokens=NEW))
    with pytest.raises(ValueError, match='empty'):
        te.submit([])
    with pytest.raises(ValueError, match='token ids'):
        te.submit([96])
    rid = te.submit([1, 2, 3], teng.SamplingConfig(max_new_tokens=4))
    te.cancel(rid)
    assert not te.step() and te.is_idle()
