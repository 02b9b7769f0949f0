"""The port's unpaged serving, its 'xla' int8 read and its server defaults,
against the JAX package's, on the CPU.

  1. The port's engine at page_size 0 (a contiguous slot cache, the
     reference's default) against the JAX engine at page_size 0, f32
     weights, float and int8 caches: identical greedy streams, and the
     slot rows the insert and the decode steps wrote equal to the JAX
     cache rows wherever the kv_mask reveals them.
  2. The port's 'xla' int8 engine (the reference's int16 x int8 read,
     `quantized_grouped_attention`) against the JAX 'xla' int8 engine,
     paged and unpaged: identical greedy streams.
  3. The defaults: the engine, the server and the CLI serve unpaged
     (page_size 0), with no kernel ('auto' resolves to 'xla').
  4. The server's env knobs SKYTPU_REQUEST_DEADLINE_S and
     SKYTPU_MAX_QUEUE_DEPTH, read when the argument is None, as the
     reference reads them; an argument beats the env.

Tolerances of the cache rows: f32 K/V within 1e-5 of their largest
magnitude (the two packages' f32 matmuls sum in other orders); int8
entries +-1 in under 0.1% of the revealed entries (a value a few f32 ulps
apart can round to the other side of a .5 tie) and their f32 scales
within 1e-6 relative.
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
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.ops import paged_attention as tpa
from skypilot_tpu_torch.ops import ragged_prefill as trp

OV = dict(n_layers=2, n_heads=4, n_kv_heads=2, dim=64, ffn_dim=128,
          vocab_size=96, max_seq_len=64, dtype='float32')
ENGINE_KW = dict(model='llama-tiny', model_overrides=OV, prefill_chunk=8,
                 n_slots=2)
NEW = 12
# Lengths that end mid-chunk and cross chunk (8) boundaries; three
# prompts over two slots, so one slot row is reused.
PROMPT_LENS = (5, 13, 21)


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    """The suite runs these tests beside XLA:CPU tests on the same cores:
    tiny f32 models need no intra-op threads of their own."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def jax_engines():
    """One JAX engine per (page_size, kv_cache_dtype), built on first use
    with the 'xla' kernels: name -> (engine, port state_dict, prompts,
    greedy streams).  Every engine has the same weights (seed 0)."""
    built = {}

    def get(page_size, kv_cache_dtype):
        key = (page_size, kv_cache_dtype)
        if key not in built:
            kw = dict(ENGINE_KW, page_size=page_size) if page_size \
                else dict(ENGINE_KW)
            je = jeng.ContinuousBatchingEngine(
                **kw, async_pipeline=False, param_dtype=jnp.float32,
                decode_kernel='xla', prefill_kernel='xla',
                kv_cache_dtype=kv_cache_dtype)
            sd = bridge.params_from_jax(jax.tree.map(np.asarray, je.params),
                                        je.config)
            rng = np.random.RandomState(0)
            prompts = [rng.randint(0, 96, n).tolist() for n in PROMPT_LENS]
            streams = je.generate(prompts,
                                  jeng.SamplingConfig(max_new_tokens=NEW))
            built[key] = (je, sd, prompts, streams)
        return built[key]
    return get


def _port_engine(sd, **kw):
    return teng.ContinuousBatchingEngine(
        **{**ENGINE_KW, **kw}, params=sd, param_dtype=torch.float32,
        device='cpu')


def _jax_leaves(je):
    """name -> numpy leaf of the JAX engine's cache ([L, ...] scanned)."""
    return {jeng._path_names(p)[-1]: np.asarray(leaf)  # pylint: disable=protected-access
            for p, leaf in jax.tree_util.tree_flatten_with_path(
                je._cache)[0]}  # pylint: disable=protected-access


def _generate_counting(te, prompts):
    before = (tpa.launches, tpa.launches_int8, trp.launches,
              trp.launches_int8)
    got = te.generate(prompts, teng.SamplingConfig(max_new_tokens=NEW))
    assert (tpa.launches, tpa.launches_int8, trp.launches,
            trp.launches_int8) == before
    assert te.allocator_leak_report() is None and te.is_idle()
    return got


@pytest.mark.parametrize('kv_cache_dtype', ['auto', 'int8'])
def test_unpaged_engine_matches_jax(jax_engines, kv_cache_dtype):
    je, sd, prompts, streams = jax_engines(0, kv_cache_dtype)
    te = _port_engine(sd, kv_cache_dtype=kv_cache_dtype)
    assert te.page_size == 0
    assert (te.decode_kernel, te.prefill_kernel) == ('xla', 'xla')
    cache = te._cache  # pylint: disable=protected-access
    assert isinstance(cache, tllama.SlotCache)
    assert _generate_counting(te, prompts) == streams
    # Every slot row the inserts and decode steps wrote, where revealed.
    mask = te._kv_mask.numpy()  # pylint: disable=protected-access
    np.testing.assert_array_equal(
        mask, np.asarray(je._kv_mask))  # pylint: disable=protected-access
    assert mask.sum() >= sum(PROMPT_LENS[1:]) + 2 * NEW - 2
    leaves = _jax_leaves(je)
    for name, mine in (('cached_key', cache.key),
                       ('cached_value', cache.value)):
        # [L, B, kvh, max_len, hd] -> [L, revealed, kvh, hd]
        got = mine.numpy().transpose(0, 1, 3, 2, 4)[:, mask]
        want = leaves[name].transpose(0, 1, 3, 2, 4)[:, mask]
        assert got.shape == want.shape
        if kv_cache_dtype == 'auto':
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
        else:
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1, name
            assert (diff > 0).mean() < 1e-3, (name, (diff > 0).mean())
            assert np.abs(want).max() == 127
    if kv_cache_dtype == 'int8':
        for name, mine in (('cached_key_scale', cache.key_scale),
                           ('cached_value_scale', cache.value_scale)):
            got = mine.numpy().transpose(0, 1, 3, 2, 4)[:, mask]
            want = leaves[name].transpose(0, 1, 3, 2, 4)[:, mask]
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
            assert (want > 0).all()


@pytest.mark.parametrize('page_size', [8, 0], ids=['paged', 'unpaged'])
def test_xla_int8_engine_matches_jax_xla(jax_engines, page_size):
    _, sd, prompts, streams = jax_engines(page_size, 'int8')
    te = _port_engine(sd, page_size=page_size, kv_cache_dtype='int8',
                      decode_kernel='xla', prefill_kernel='xla')
    assert _generate_counting(te, prompts) == streams


def test_default_page_size_is_unpaged():
    import inspect
    for fn in (teng.ContinuousBatchingEngine.__init__,
               tserver.InferenceServer.__init__):
        assert inspect.signature(fn).parameters['page_size'].default == 0
    assert tserver.build_parser().parse_args([]).page_size == 0
    srv = tserver.InferenceServer(model='llama-tiny', model_overrides=OV,
                                  max_batch_size=2,
                                  allow_random_weights=True, device='cpu')
    eng = srv.engine
    assert eng.page_size == 0 and eng.allocator_leak_report() is None
    assert isinstance(eng._cache, tllama.SlotCache)  # pylint: disable=protected-access
    assert (eng.decode_kernel, eng.prefill_kernel) == ('xla', 'xla')
    with pytest.raises(ValueError, match='page_size > 0'):
        teng.ContinuousBatchingEngine(**ENGINE_KW, max_pages=9,
                                      device='cpu')
    with pytest.raises(ValueError, match='power of two'):
        teng.ContinuousBatchingEngine(**ENGINE_KW, page_size=6,
                                      device='cpu')


def _server(**kw):
    return tserver.InferenceServer(model='llama-tiny', model_overrides=OV,
                                   max_batch_size=3,
                                   allow_random_weights=True, device='cpu',
                                   **kw)


def test_server_reads_env_knobs(monkeypatch):
    monkeypatch.delenv('SKYTPU_REQUEST_DEADLINE_S', raising=False)
    monkeypatch.delenv('SKYTPU_MAX_QUEUE_DEPTH', raising=False)
    srv = _server()
    assert (srv.default_deadline_s, srv.max_queue_depth) == (600.0, 24)
    monkeypatch.setenv('SKYTPU_REQUEST_DEADLINE_S', '12.5')
    monkeypatch.setenv('SKYTPU_MAX_QUEUE_DEPTH', '5')
    srv = _server()
    assert (srv.default_deadline_s, srv.max_queue_depth) == (12.5, 5)
    # An argument beats the env.
    srv = _server(default_deadline_s=30, max_queue_depth=7)
    assert (srv.default_deadline_s, srv.max_queue_depth) == (30.0, 7)
    # The queue bound sheds what would pass it.
    with pytest.raises(tserver._Shed):  # pylint: disable=protected-access
        srv._handle_generate({'prompt_ids': [[1]] * 8})  # pylint: disable=protected-access
    monkeypatch.setenv('SKYTPU_MAX_QUEUE_DEPTH', 'many')
    with pytest.raises(ValueError):
        _server()
