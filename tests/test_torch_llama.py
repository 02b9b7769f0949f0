"""The port's Llama against the JAX package's, on the CPU, at f32.

One tiny JAX Llama (2 layers, 4 heads over 2 KV heads, dim 64) gives its
params to the port through `bridge.params_from_jax`, in both layer
layouts (scanned `layers` stack and unscanned `layer_i`).  Then the same
tokens go through both models: two prefill chunks (the second at a
cursor base > 0) and one paged decode step over a shuffled page pool.
Logits must agree to 1e-4 absolute (f32, logits of magnitude ~1, summed
over a few hundred terms per layer).
"""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.infer import engine as jeng
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.parallel import sharding
from skypilot_tpu_torch import bridge
from skypilot_tpu_torch.infer import engine as teng
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.ops import paged_attention as tpa
from skypilot_tpu_torch.ops import ragged_prefill as trp

OV = dict(n_layers=2, n_heads=4, n_kv_heads=2, dim=64, ffn_dim=128,
          vocab_size=96, max_seq_len=64, dtype='float32')
PS = 8
N_PAGES = 2 * (64 // PS) + 1
TOL = 1e-4


def _models(scan: bool):
    jcfg = jllama.get_config('llama-tiny', **OV, scan_layers=scan,
                             decode=True, remat=False, kv_page_size=PS,
                             kv_n_pages=N_PAGES)
    jmodel = jllama.Llama(jcfg)
    params = sharding.unbox(jmodel.init(
        jax.random.PRNGKey(3), jnp.zeros((1, 1), jnp.int32))['params'])
    tcfg = tllama.get_config('llama-tiny', **OV, param_dtype='float32',
                             kv_page_size=PS, kv_n_pages=N_PAGES)
    tmodel = tllama.Llama(tcfg, torch.device('cpu'))
    tmodel.load_state_dict(bridge.params_from_jax(
        jax.tree.map(np.asarray, params), tcfg))
    return jmodel, params, tmodel, tcfg


@pytest.fixture(scope='module', params=[True, False],
                ids=['scanned', 'unscanned'])
def models(request):
    return _models(request.param)


def _jax_prefill(jmodel, params, cache1, tokens, start, mask_row):
    s = tokens.shape[1]
    positions = jnp.arange(start, start + s, dtype=jnp.int32)[None]
    with jllama.prefill_kernel('xla'):
        logits, mutated = jmodel.apply(
            {'params': params, 'cache': cache1}, jnp.asarray(tokens),
            positions, jnp.asarray(mask_row)[None], mutable=['cache'])
    return np.asarray(logits), mutated['cache']


def _prefill_both(jmodel, params, tmodel, tcfg, prompt, pad, chunk):
    """Chunked prefill of `prompt` (padded to `pad`) through both models;
    returns per-chunk logits of each and both prefill caches."""
    cache1 = jax.tree.map(
        jnp.zeros_like,
        jax.eval_shape(lambda: jmodel.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 1), jnp.int32)))['cache'])
    tcache = tllama.PrefillCache.zeros(tcfg, 1, torch.device('cpu'))
    tokens = np.zeros((1, pad), np.int32)
    tokens[0, :len(prompt)] = prompt
    mask_row = np.zeros((64,), bool)
    mask_row[:len(prompt)] = True
    outs = []
    for start in range(0, pad, chunk):
        tok = tokens[:, start:start + chunk]
        want, cache1 = _jax_prefill(jmodel, params, cache1, tok, start,
                                    mask_row)
        got = tmodel(torch.from_numpy(tok).long(),
                     torch.arange(start, start + tok.shape[1])[None],
                     tcache, torch.from_numpy(mask_row)[None],
                     kernel='xla')
        outs.append((got.numpy(), want))
    return outs, cache1, tcache


def test_bridge_fills_every_parameter(models):
    _, params, tmodel, tcfg = models
    sd = bridge.params_from_jax(jax.tree.map(np.asarray, params), tcfg)
    assert set(sd) == set(dict(tmodel.named_parameters()))
    for name, p in tmodel.named_parameters():
        assert tuple(sd[name].shape) == tuple(p.shape), name


def test_prefill_chunk_logits_match(models):
    jmodel, params, tmodel, tcfg = models
    prompt = np.random.RandomState(0).randint(0, 96, 13).tolist()
    outs, _, _ = _prefill_both(jmodel, params, tmodel, tcfg, prompt,
                               pad=16, chunk=8)
    assert len(outs) == 2          # base 0, then base 8
    for got, want in outs:
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_paged_decode_step_logits_match(models):
    jmodel, params, tmodel, tcfg = models
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 96, 13).tolist(), rng.randint(0, 96, 6)
               .tolist()]
    pads = [16, 8]
    pps = 64 // PS
    # Shuffled physical pages; slot 0 holds 3 pages, slot 1 holds 2.
    pages = rng.permutation(np.arange(1, N_PAGES))
    tables = [np.zeros((pps,), np.int32) for _ in prompts]
    tables[0][:3] = pages[:3]
    tables[1][:2] = pages[3:5]
    # Slot-mode JAX cache, filled through the reference's paged insert.
    kv0 = jnp.zeros((2, 64), bool)
    with jllama.slot_mode():
        jcache = jax.tree.map(jnp.zeros_like, jax.eval_shape(
            lambda: jmodel.init(jax.random.PRNGKey(0),
                                jnp.zeros((2, 1), jnp.int32), None,
                                kv0))['cache'])
    insert = jeng.make_paged_insert_fn(PS, pps)
    last = jnp.zeros((2, 96), jnp.float32)
    kv_mask = kv0
    tcache = tllama.PagedCache.zeros(tcfg, 2, torch.device('cpu'))
    for slot, (prompt, pad) in enumerate(zip(prompts, pads)):
        _, cache1, tcache1 = _prefill_both(jmodel, params, tmodel, tcfg,
                                           prompt, pad, chunk=8)
        mask_row = np.zeros((64,), bool)
        mask_row[:len(prompt)] = True
        jcache, last, kv_mask = insert(
            jcache, last, kv_mask, cache1, last[0], jnp.asarray(mask_row),
            jnp.asarray(tables[slot]), jnp.int32(slot), jnp.int32(0))
        teng.paged_insert(tcache, tcache1, tables[slot], slot)
    # Decode: reveal each row's cursor slot, one token at its rope position.
    cursors = np.array(pads)
    rope = np.array([len(p) for p in prompts])
    kv = np.array(kv_mask)
    kv[np.arange(2), cursors] = True
    tok = np.array([[5], [77]], np.int32)
    with jllama.slot_mode(), jllama.kv_read_bucket(32), \
            jllama.decode_kernel('xla'):
        want, _ = jmodel.apply({'params': params, 'cache': jcache},
                               jnp.asarray(tok), jnp.asarray(rope)[:, None],
                               jnp.asarray(kv), mutable=['cache'])
    got = tmodel(torch.from_numpy(tok).long(),
                 torch.from_numpy(rope)[:, None], tcache,
                 torch.from_numpy(kv), kernel='xla', read_len=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    # The step's K/V landed in the pool pages the tables name.
    for slot in range(2):
        page = tables[slot][cursors[slot] // PS]
        assert tcache.key[:, page, :, cursors[slot] % PS].abs().sum() > 0


@pytest.mark.parametrize('device,want', [('cuda', 'fused'), ('cpu', 'xla')])
def test_default_kernel_follows_the_device(device, want):
    for fn in (tllama.Llama.forward, tllama.Llama.hidden):
        assert inspect.signature(fn).parameters['kernel'].default == 'auto'
    dev = torch.device(device)
    assert tllama.resolve_kernel('auto', dev) == want
    assert tllama.resolve_kernel('auto', dev, paged=False) == 'xla'
    for kernel in ('fused', 'plain', 'xla'):
        assert tllama.resolve_kernel(kernel, dev) == kernel
    for kernel in ('fused', 'plain'):
        with pytest.raises(ValueError, match='paged'):
            tllama.resolve_kernel(kernel, dev, paged=False)


def test_fused_kernel_on_cpu_tensors_raises(models):
    """kernel='fused' raises where there is no kernel (an unpaged
    model); on CPU tensors of a paged one the wrappers run their plain
    versions (launch counts unmoved), the same function as 'xla'."""
    _, _, tmodel, tcfg = models
    cpu = torch.device('cpu')
    tok, pos = torch.arange(8)[None], torch.arange(8)[None]
    unpaged = tllama.Llama(dataclasses.replace(tcfg, kv_page_size=0,
                                               kv_n_pages=0), cpu)
    with pytest.raises(ValueError, match='paged'):
        unpaged(tok, pos, tllama.PrefillCache.zeros(unpaged.cfg, 1, cpu),
                None, kernel='fused')
    before = (tpa.launches, trp.launches)
    got = tmodel(tok, pos, tllama.PrefillCache.zeros(tcfg, 1, cpu), None,
                 kernel='fused')
    want = tmodel(tok, pos, tllama.PrefillCache.zeros(tcfg, 1, cpu), None,
                  kernel='xla')
    assert (tpa.launches, trp.launches) == before
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=0)


def test_rope_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 5, 16).astype(np.float32)
    pos = rng.randint(0, 4000, (2, 5)).astype(np.int32)
    want = np.asarray(jllama.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                        500000.0))
    got = tllama.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            500000.0)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize('name', sorted(tllama.CONFIGS))
def test_configs_and_param_counts_match(name):
    jcfg = jllama.get_config(name)
    tcfg = tllama.get_config(name)
    for field in ('vocab_size', 'dim', 'n_layers', 'n_heads', 'n_kv_heads',
                  'ffn_dim', 'max_seq_len', 'rope_theta', 'norm_eps',
                  'sliding_window', 'head_dim'):
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    assert tllama.num_params(tcfg) == jllama.num_params(jcfg)
