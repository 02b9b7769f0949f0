"""The port's int8 KV cache against the JAX package's, on the CPU.

Four levels, the same numpy inputs through both packages:
  1. `quantize_int8_rows` gives bit-identical int8 values and f32 scales
     (random rows, exact .5 ties, all-zero rows, bf16 inputs).
  2. The plain int8 paged decode against the Pallas kernel's quant branch
     (`paged_decode_attention(..., key_scale=, value_scale=,
     interpret=True)`).
  3. The plain int8 ragged prefill against the Pallas kernel's quant
     branch (`ragged_prefill_attention(..., interpret=True)`).
  4. The port's int8 engine with decode_kernel='fused' and
     prefill_kernel='fused' (the kernels' wrappers, which run their plain
     versions for CPU tensors) against a JAX
     ContinuousBatchingEngine(kv_cache_dtype='int8',
     decode_kernel='fused', prefill_kernel='fused') in interpret mode,
     which computes the same function as the kernels: identical greedy
     streams, and the same pools after generation; then the server over
     a real socket and the CLI flag.
  5. `quantized_grouped_attention`, the reference's other int8 read (its
     'xla' path: int16 x int8 dots with int32 accumulation), against the
     JAX function in its MHA, grouped and kvh == 1 branches, and a row
     whose int32 PV sum passes 2^31 and wraps in both.

Tolerances.  Levels 2 and 3 at f32: 1e-5 relative to each element plus
1e-5 of the output's largest magnitude (both sides do f32 dots of at
most a few hundred terms; the Pallas kernel's online softmax and the
plain version's one-pass softmax differ by f32 roundings).  Level 4:
the pools after generation may differ by +-1 in under 0.1% of their
int8 entries (a K/V value a few f32 ulps apart across the two packages
can round to the other side of a .5 tie), the scale pools by 1e-6
relative; the null page 0 is excluded, as it holds garbage by contract
(the JAX insert also scatters a prefill's unused tail into it).

The CUDA int8 kernels run only on the card: tests/test_torch_cuda.py
and chip_smoke.py hold them against these plain versions.
"""
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.infer import engine as jeng
from skypilot_tpu.ops import grouped_attention as jga
from skypilot_tpu.ops import paged_attention as jpa
from skypilot_tpu.ops import ragged_prefill as jrp
from skypilot_tpu_torch import bridge
from skypilot_tpu_torch.infer import engine as teng
from skypilot_tpu_torch.infer import server as tserver
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.ops import grouped_attention as tga
from skypilot_tpu_torch.ops import paged_attention as tpa
from skypilot_tpu_torch.ops import ragged_prefill as trp

OV = dict(n_layers=2, n_heads=4, n_kv_heads=2, dim=64, ffn_dim=128,
          vocab_size=96, max_seq_len=64, dtype='float32')
ENGINE_KW = dict(model='llama-tiny', model_overrides=OV, page_size=8,
                 prefill_chunk=8, n_slots=2)
NEW = 12
# Lengths that end mid-page and cross page (8) and chunk (8) boundaries.
PROMPT_LENS = (5, 13, 21)
_PS = 8
_D = 16
_RTOL = 1e-5


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    """The suite runs these tests beside XLA:CPU tests on the same cores:
    tiny f32 models need no intra-op threads of their own."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_close(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=_RTOL,
                               atol=_RTOL * float(np.abs(want).max()))


# -- 1. quantize_int8_rows ---------------------------------------------------
def _quant_rows(case):
    rng = np.random.RandomState(0)
    if case == 'ties':
        # Scales that are powers of two (absmax 127 * 2^-k), so x / scale
        # lands exactly on .5 ties: half to even on both sides.
        halves = np.arange(-126.5, 127.0, 1.0, dtype=np.float32)[:64]
        rows = [np.concatenate([[127.0], halves[:15]]) * 2.0 ** -k
                for k in range(-2, 3)]
        rows.append(np.concatenate([[-127.0], -halves[20:35]]))
        # Other scales, with entries at (8k + .5) * scale in f32: most
        # still divide to exact ties, and some of them would not through
        # a multiply by 1 / scale.
        for absmax in (0.7, 1.3, 3.7):
            scale = np.float32(absmax) / np.float32(127.0)
            ties = (np.arange(15, dtype=np.float32) * 8 + 0.5) * scale
            rows.append(np.concatenate([[absmax], ties]))
        return np.stack(rows).astype(np.float32).reshape(3, 3, 16)
    if case == 'zeros':
        x = rng.randn(2, 3, 16).astype(np.float32)
        x[0, 1] = 0.0          # the 1e-8 floor: scale 1e-8 / 127
        x[1, 2] = 0.0
        x[1, 0, :15] = 0.0     # one nonzero entry
        return x
    return (rng.randn(4, 5, 32) * np.exp(rng.randn(4, 5, 1))).astype(
        np.float32)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('case', ['random', 'ties', 'zeros'])
def test_quantize_int8_rows_bit_identical(case, dtype):
    x = torch.from_numpy(_quant_rows(case))
    if dtype == 'bfloat16':
        x = x.bfloat16()
    jx = jnp.asarray(x.float().numpy()).astype(getattr(jnp, dtype))
    jq, js = jga.quantize_int8_rows(jx)
    q, s = tga.quantize_int8_rows(x)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert s.shape == x.shape[:-1] + (1,)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    if case == 'ties':
        assert (np.abs(x.float().numpy() / s.numpy() % 1) == 0.5).any()


# -- 2. paged decode ---------------------------------------------------------
def _int8_pool(rng, shape, poison_null):
    """Pools quantized from random rows by the port's quantizer; with
    `poison_null` the null page 0 holds 127 with a large scale, which
    only the mask keeps out."""
    q, s = tga.quantize_int8_rows(
        torch.from_numpy(rng.randn(*shape).astype(np.float32)))
    q, s = q.numpy(), s.numpy()
    if poison_null:
        q[0] = 127
        s[0] = 1e4
    return q, s


def _decode_case(seed, b, h, kvh, n_read, ctxs, *, null_last=(),
                 window=None, d=_D):
    rng = np.random.RandomState(seed)
    read_len = n_read * _PS
    n_pages = b * n_read + 3
    pk, ks = _int8_pool(rng, (n_pages, kvh, _PS, d), True)
    pv, vs = _int8_pool(rng, (n_pages, kvh, _PS, d), True)
    perm = rng.permutation(np.arange(1, n_pages))
    table = perm[:b * n_read].reshape(b, n_read).astype(np.int32)
    mask = np.zeros((b, 1, 1, read_len), bool)
    for i in range(b):
        lo = 0 if window is None else max(0, ctxs[i] - window)
        mask[i, 0, 0, lo:ctxs[i]] = True
        if i in null_last:
            table[i, -1] = 0
            mask[i, :, :, (n_read - 1) * _PS:] = False
    q = rng.randn(b, h, 1, d).astype(np.float32)
    return q, pk, pv, ks, vs, table, mask


# (query heads, KV heads, head dim): at _D, and gemma's head width 256 at
# a group of 1 (gemma-7b's) and of 8 (gemma-2b's).
_HEADS = [(4, 2, _D), (4, 4, _D), (4, 1, _D), (2, 2, 256), (8, 1, 256)]
_HEAD_IDS = ['gqa4:2', 'mha', 'gqa4:1', 'g1_d256', 'g8_d256']


@pytest.mark.parametrize('h,kvh,d', _HEADS, ids=_HEAD_IDS)
@pytest.mark.parametrize('ctxs,null_last,window', [
    ([3, 21, 16], (0, 2), None),
    ([29, 13, 24], (), 6),
], ids=['null_pages', 'window'])
def test_plain_int8_decode_matches_pallas(h, kvh, d, ctxs, null_last,
                                          window):
    q, pk, pv, ks, vs, table, mask = _decode_case(
        h * 10 + kvh, 3, h, kvh, 4, ctxs, null_last=null_last,
        window=window, d=d)
    want = np.asarray(jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(table), jnp.asarray(mask), scale=d ** -0.5,
        probs_dtype=jnp.float32, key_scale=jnp.asarray(ks),
        value_scale=jnp.asarray(vs), interpret=True))
    before = (tpa.launches, tpa.launches_int8)
    got = tpa.paged_decode_attention(
        _t(q), _t(pk), _t(pv), _t(table), _t(mask), scale=d ** -0.5,
        probs_dtype=torch.float32, key_scale=_t(ks), value_scale=_t(vs))
    assert (tpa.launches, tpa.launches_int8) == before
    assert np.isfinite(want).all()
    _assert_close(got.numpy(), want)


# -- 3. ragged prefill -------------------------------------------------------
def _prefill_case(seed, h, kvh, s, base, true_lens, *, L=64, d=_D):
    rng = np.random.RandomState(seed)
    b = len(base)
    base = np.asarray(base, np.int32)
    n_read = -(-(int(base.max()) + s) // _PS)
    k, ks = _int8_pool(rng, (b, kvh, L, d), False)
    v, vs = _int8_pool(rng, (b, kvh, L, d), False)
    kvm = np.zeros((b, L), bool)
    for i, n in enumerate(true_lens):
        kvm[i, :n] = True
    table = np.broadcast_to(np.arange(n_read, dtype=np.int32),
                            (b, n_read)).copy()
    q = rng.randn(b, h, s, d).astype(np.float32)
    return q, k, v, ks, vs, table, base, kvm


@pytest.mark.parametrize('h,kvh,d', _HEADS, ids=_HEAD_IDS)
@pytest.mark.parametrize('base,true_lens,window', [
    ([0, 16], [5, 21], None),
    ([13, 24], [17, 40], None),
    ([24, 9], [30, 14], 5),
], ids=['kv_mask_cuts_chunk', 'mid_page', 'window'])
def test_plain_int8_prefill_matches_pallas(h, kvh, d, base, true_lens,
                                           window):
    q, k, v, ks, vs, table, base, kvm = _prefill_case(
        h * 10 + kvh, h, kvh, 8, base, true_lens, d=d)
    want = np.asarray(jrp.ragged_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(base), jnp.asarray(kvm), scale=d ** -0.5,
        probs_dtype=jnp.float32, page_size=_PS, window=window,
        key_scale=jnp.asarray(ks), value_scale=jnp.asarray(vs),
        interpret=True))
    before = (trp.launches, trp.launches_int8)
    got = trp.ragged_prefill_attention(
        _t(q), _t(k), _t(v), _t(table), _t(base), _t(kvm),
        scale=d ** -0.5, probs_dtype=torch.float32, page_size=_PS,
        window=window, key_scale=_t(ks), value_scale=_t(vs))
    assert (trp.launches, trp.launches_int8) == before
    assert np.isfinite(want).all()
    _assert_close(got.numpy(), want)


def test_wrappers_refuse_bad_scales():
    """Scales are checked before the device dispatch, so a CPU tensor
    raises as a CUDA one does: both or neither, f32 of the pools' shape
    with a last axis of 1, int8 pools."""
    q, pk, pv, ks, vs, table, mask = _decode_case(1, 2, 4, 2, 3, [5, 19])
    args = (_t(q), _t(pk), _t(pv), _t(table), _t(mask))
    kw = dict(scale=0.25, probs_dtype=torch.float32)
    bad = [
        (dict(key_scale=_t(ks)), 'together'),
        (dict(key_scale=_t(ks)[..., 0], value_scale=_t(vs)), 'key_scale'),
        (dict(key_scale=_t(ks), value_scale=_t(vs).double()),
         'value_scale'),
    ]
    for extra, match in bad:
        with pytest.raises(ValueError, match=match):
            tpa.paged_decode_attention(*args, **kw, **extra)
    with pytest.raises(ValueError, match='int8'):
        tpa.paged_decode_attention(
            args[0], args[1].float(), args[2].float(), *args[3:], **kw,
            key_scale=_t(ks), value_scale=_t(vs))
    q, k, v, ks, vs, table, base, kvm = _prefill_case(2, 4, 2, 8, [0],
                                                      [8])
    with pytest.raises(ValueError, match='value_scale'):
        trp.ragged_prefill_attention(
            _t(q), _t(k), _t(v), _t(table), _t(base), _t(kvm), scale=0.25,
            probs_dtype=torch.float32, page_size=_PS, key_scale=_t(ks),
            value_scale=_t(vs)[:, :, :8])


# -- 4. the engine and the server --------------------------------------------
@pytest.fixture(scope='module')
def reference():
    """(JAX int8 engine with its fused kernels in interpret mode, its
    params as a port state_dict, prompts, greedy streams)."""
    je = jeng.ContinuousBatchingEngine(
        **ENGINE_KW, async_pipeline=False, param_dtype=jnp.float32,
        decode_kernel='fused', prefill_kernel='fused',
        kv_cache_dtype='int8')
    assert je.decode_kernel_interpret and je.prefill_kernel_interpret
    sd = bridge.params_from_jax(jax.tree.map(np.asarray, je.params),
                                je.config)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 96, n).tolist() for n in PROMPT_LENS]
    streams = je.generate(prompts, jeng.SamplingConfig(max_new_tokens=NEW))
    return je, sd, prompts, streams


def _port_engine(sd, **kw):
    return teng.ContinuousBatchingEngine(
        **{**ENGINE_KW, **kw}, params=sd, param_dtype=torch.float32,
        kv_cache_dtype='int8', device='cpu')


def _jax_pools(je):
    """name -> numpy [L, n_pages, kvh, ps, d|1] of the JAX engine's
    paged cache."""
    return {jeng._path_names(p)[-1]: np.asarray(leaf)  # pylint: disable=protected-access
            for p, leaf in jax.tree_util.tree_flatten_with_path(
                je._cache)[0]}  # pylint: disable=protected-access


def test_int8_engine_matches_jax_fused(reference):
    je, sd, prompts, streams = reference
    te = _port_engine(sd, decode_kernel='fused', prefill_kernel='fused')
    assert (te.decode_kernel, te.prefill_kernel) == ('fused', 'fused')
    assert te.kv_cache_dtype == 'int8'
    before = (tpa.launches, tpa.launches_int8, trp.launches,
              trp.launches_int8)
    got = te.generate(prompts, teng.SamplingConfig(max_new_tokens=NEW))
    assert got == streams
    assert (tpa.launches, tpa.launches_int8, trp.launches,
            trp.launches_int8) == before
    assert te.allocator_leak_report() is None
    cache = te._cache  # pylint: disable=protected-access
    pools = _jax_pools(je)
    for name, mine in (('page_key', cache.key),
                       ('page_value', cache.value)):
        assert mine.dtype == torch.int8
        want = pools[name][:, 1:].astype(np.int32)
        diff = np.abs(mine[:, 1:].numpy().astype(np.int32) - want)
        assert diff.max() <= 1, name
        assert (diff > 0).mean() < 1e-3, (name, (diff > 0).mean())
        assert np.abs(want).max() == 127
    for name, mine in (('page_key_scale', cache.key_scale),
                       ('page_value_scale', cache.value_scale)):
        assert mine.dtype == torch.float32
        np.testing.assert_allclose(mine[:, 1:].numpy(), pools[name][:, 1:],
                                   rtol=1e-6, atol=0)
        assert (pools[name][:, 1:] > 0).any()


def test_int8_pools_hold_a_byte_an_entry():
    def pools(kv_cache_dtype):
        cfg = tllama.get_config('llama-tiny', **OV, kv_page_size=8,
                                kv_n_pages=17, kv_cache_dtype=kv_cache_dtype)
        return tllama.PagedCache.zeros(cfg, 2, torch.device('cpu'))
    rows = 2 * 17 * 2 * 8           # layers x pages x kv heads x page
    # K and V: f32 entries (this model's dtype), or int8 entries plus an
    # f32 scale a row.
    assert pools('auto').nbytes() == 2 * rows * 16 * 4
    int8 = pools('int8')
    assert int8.nbytes() == 2 * rows * 16 + 2 * rows * 4
    assert int8.key.dtype == torch.int8
    assert int8.key_scale.shape == (2, 17, 2, 8, 1)


def _post(url, body, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def test_int8_server_greedy_over_socket(reference):
    _, sd, prompts, streams = reference
    srv = tserver.InferenceServer(
        model='llama-tiny', port=0, host='127.0.0.1', max_batch_size=2,
        model_overrides=OV, params=sd, param_dtype=torch.float32,
        prefill_chunk=8, page_size=8, kv_cache_dtype='int8',
        decode_kernel='fused', prefill_kernel='fused', device='cpu')
    assert srv.engine.kv_cache_dtype == 'int8'
    srv.start()
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        code, body = _post(f'http://127.0.0.1:{srv.port}/generate', {
            'prompt_ids': prompts, 'max_new_tokens': NEW,
            'temperature': 0.0})
        assert code == 200 and body['tokens'] == streams
    finally:
        srv.shutdown()
        t.join(timeout=10)
    assert not t.is_alive()


def test_kv_cache_dtype_flag_and_validation():
    parser = tserver.build_parser()
    assert parser.parse_args([]).kv_cache_dtype == 'auto'
    assert parser.parse_args(['--kv-cache-dtype', 'int8']).kv_cache_dtype \
        == 'int8'
    with pytest.raises(SystemExit):
        parser.parse_args(['--kv-cache-dtype', 'fp8'])
    with pytest.raises(ValueError, match='kv_cache_dtype'):
        teng.ContinuousBatchingEngine(**ENGINE_KW, kv_cache_dtype='fp8',
                                      device='cpu')
    with pytest.raises(ValueError, match='kv_cache_dtype'):
        tserver.InferenceServer(model='llama-tiny', model_overrides=OV,
                                page_size=8, allow_random_weights=True,
                                kv_cache_dtype='fp8', device='cpu')
    with pytest.raises(ValueError, match='kv_cache_dtype'):
        tllama.get_config('llama-tiny', kv_cache_dtype='fp8')


# -- 5. the reference's XLA int8 read ----------------------------------------
_QGA_TOL = 1e-4


def _qga_case(seed, b, h, kvh, sq, sk, masked):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, sq, _D).astype(np.float32)
    k, ks = _int8_pool(rng, (b, kvh, sk, _D), False)
    v, vs = _int8_pool(rng, (b, kvh, sk, _D), False)
    mask = None
    if masked:
        # Causal over the last sq of sk positions, with a padded prefix
        # hidden in one row; [B, 1, Sq, Sk] as run_cached_attention builds.
        cols = np.arange(sk)[None, :]
        rows = (sk - sq + np.arange(sq))[:, None]
        mask = np.broadcast_to(cols <= rows, (b, 1, sq, sk)).copy()
        mask[0, :, :, :3] = False
    return q, k, ks, v, vs, mask


@pytest.mark.parametrize('h,kvh', [(4, 4), (4, 2), (4, 1)],
                         ids=['mha', 'grouped', 'latent'])
@pytest.mark.parametrize('sq,masked', [(1, False), (5, True)],
                         ids=['decode', 'masked_chunk'])
def test_quantized_grouped_attention_matches_jax(h, kvh, sq, masked):
    """At f32, within 1e-4 of the output's largest magnitude: both sides
    take exact integer dots, but a probability a few f32 ulps apart
    across the two packages (their softmaxes sum in other orders) can
    requantize to the neighbouring int16, one step of 1/32767 of its
    row's largest weight."""
    q, k, ks, v, vs, mask = _qga_case(h * 10 + kvh + sq, 2, h, kvh, sq, 24,
                                      masked)
    jm = None if mask is None else jnp.asarray(mask)
    want = np.asarray(jga.quantized_grouped_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(ks), jnp.asarray(v),
        jnp.asarray(vs), jm, scale=_D ** -0.5, probs_dtype=jnp.float32))
    got = tga.quantized_grouped_attention(
        _t(q), _t(k), _t(ks), _t(v), _t(vs),
        None if mask is None else _t(mask), scale=_D ** -0.5,
        probs_dtype=torch.float32)
    assert got.shape == want.shape == (2, sq, h, _D)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=_QGA_TOL * float(np.abs(want).max()))
    # The kernels' int8 formulation is another function, about 1e-3 off.
    other = tga.int8_grouped_attention(
        _t(q), _t(k), _t(v), _t(ks), _t(vs),
        None if mask is None else _t(mask), scale=_D ** -0.5,
        probs_dtype=torch.float32)
    assert not torch.equal(other, got)


def test_quantized_grouped_attention_wraps_like_jax():
    """A uniform row over 600 positions of int8 values 127: every int16
    probability is 32767, so the PV sum 600 x 32767 x 127 passes 2^31
    and the reference's int32 dot wraps to a negative output.  The port
    reproduces the wrap exactly; the kernels' formulation gives 127."""
    n = 600
    q = np.zeros((1, 2, 1, _D), np.float32)
    k = np.ones((1, 1, n, _D), np.int8)
    v = np.full((1, 1, n, _D), 127, np.int8)
    v[..., 1] = -7          # a column that stays far from the wrap
    s = np.ones((1, 1, n, 1), np.float32)
    want = np.asarray(jga.quantized_grouped_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(s), jnp.asarray(v),
        jnp.asarray(s), None, scale=1.0, probs_dtype=jnp.float32))
    got = tga.quantized_grouped_attention(
        _t(q), _t(k), _t(s), _t(v), _t(s), None, scale=1.0,
        probs_dtype=torch.float32)
    wrapped = (n * 32767 * 127 - 2 ** 32) / (32767 * n)
    np.testing.assert_allclose(want[..., 0], wrapped, rtol=1e-6)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(got[..., 1].numpy(), -7.0, rtol=1e-6)
    kernels = tga.int8_grouped_attention(
        _t(q), _t(k), _t(v), _t(s), _t(s), None, scale=1.0,
        probs_dtype=torch.float32)
    np.testing.assert_allclose(kernels[..., 0].numpy(), 127.0, rtol=1e-6)
