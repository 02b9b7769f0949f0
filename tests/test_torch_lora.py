"""LoRA adapters, `train_only` and `remat_policy='save_attn'` in the port
against the JAX package, on the CPU, at f32.

The JAX side is a tiny Llama with `lora_rank` 4 on one CPU device; its
params reach the port through `bridge.params_from_jax` (adapters
included, scanned and unscanned), with the adapters' `b` either as
initialised (zeros: a fresh adapter adds nothing) or perturbed, so the
delta is live.  Then the same tokens go through both:
  - the training forward's logits (1e-4 absolute, as
    tests/test_torch_train.py);
  - the cached forwards: two prefill chunks and one paged decode step
    (1e-4 absolute, as tests/test_torch_llama.py), and the engines'
    greedy streams, paged, unpaged and with int8 weights (whose adapters
    stay float in both packages), token for token;
  - three `Trainer` steps with `train_only='lora'`: loss 1e-5 relative,
    grad_norm 1e-4 relative, adapters 2e-6 absolute, and every base
    parameter bit for bit unchanged on both sides; once plain, once with
    the recipe's `remat_policy='save_attn'` and `loss_chunk`; the same
    two for gemma-tiny at head width 256 with final_logit_softcap=30.0
    (the tied head frozen with the base);
  - a step under 'save_attn' equals the 'nothing' step (the kernels'
    plain versions), and the flash forward runs once a layer under
    'save_attn' against twice under 'nothing'.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.infer import engine as jeng
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.parallel import mesh as jmesh
from skypilot_tpu.parallel import sharding
from skypilot_tpu.train import data as jdata
from skypilot_tpu.train import trainer as jtrainer
from skypilot_tpu_torch import bridge
from skypilot_tpu_torch.infer import engine as teng
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.ops import flash_attention as tfa
from skypilot_tpu_torch.train import data as tdata
from skypilot_tpu_torch.train import trainer as ttrainer

SEQ = 32
RANK = 4
OV = dict(n_heads=4, n_kv_heads=2, max_seq_len=SEQ, dtype='float32',
          lora_rank=RANK)
# The serving tests' widths (tests/test_torch_llama.py).
SOV = dict(n_layers=2, n_heads=4, n_kv_heads=2, dim=64, ffn_dim=128,
           vocab_size=96, max_seq_len=64, dtype='float32', lora_rank=RANK)
PS = 8
CPU = torch.device('cpu')
ATTN = {'q_proj_lora', 'k_proj_lora', 'v_proj_lora', 'o_proj_lora'}


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    """The suite runs these tests beside XLA:CPU tests on the same cores:
    tiny f32 models need no intra-op threads of their own."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _perturbed(params, seed=0, scale=0.05):
    """The params with every adapter's b drawn normal(scale): a live
    delta (a fresh adapter's b is zeros)."""
    rng = np.random.RandomState(seed)

    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if path[-1] == 'b' and path[-2].endswith('_lora'):
            return jnp.asarray(rng.normal(0, scale, tree.shape)
                               .astype(np.float32))
        return tree

    return walk(params)


@pytest.fixture(scope='module')
def jax_params():
    built = {}

    def params(scan=True, **extra):
        key = (scan, tuple(sorted(extra.items())))
        if key not in built:
            cfg = jllama.get_config('llama-tiny', **OV, scan_layers=scan,
                                    **extra)
            built[key] = sharding.unbox(jllama.Llama(cfg).init(
                jax.random.PRNGKey(5),
                jnp.zeros((1, SEQ), jnp.int32))['params'])
        return built[key]

    return params


def _tokens(seed=0, b=2):
    return np.random.RandomState(seed).randint(0, 512, (b, SEQ)).astype(
        np.int32)


def test_adapter_names_and_targets():
    """The adapters are additive siblings named as the reference's
    (`<proj>_lora`), the base names unchanged; the MLP's are opt-in."""
    base = dict(tllama.Llama(tllama.get_config('llama-tiny'), CPU)
                .named_parameters())
    lora = dict(tllama.Llama(tllama.get_config('llama-tiny', lora_rank=RANK),
                             CPU).named_parameters())
    added = set(lora) - set(base)
    assert set(base) <= set(lora)
    assert {n.split('.')[-2] for n in added} == ATTN
    assert all(tllama.is_lora(n) for n in added)
    q = lora['layers.0.attention.q_proj_lora.a']
    assert q.shape == (256, RANK)
    assert lora['layers.0.attention.k_proj_lora.b'].shape == (RANK, 128)
    mlp = tllama.get_config('llama-tiny', lora_rank=RANK,
                            lora_targets=['gate_proj', 'down_proj'])
    names = {n.split('.')[-2] for n in
             dict(tllama.Llama(mlp, CPU).named_parameters()) if '_lora' in n}
    assert names == {'gate_proj_lora', 'down_proj_lora'}


def test_fresh_adapters_are_the_identity():
    """Same seed, with and without adapters: the same base weights, b at
    zeros, a at normal(1 / rank), and the same logits bit for bit."""
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    base = tllama.Llama(tllama.get_config('llama-tiny', dtype='float32'),
                        CPU)
    base.init_weights(gen())
    lora = tllama.Llama(tllama.get_config('llama-tiny', dtype='float32',
                                          lora_rank=RANK), CPU)
    lora.init_weights(gen())
    sd = lora.state_dict()
    for name, t in base.state_dict().items():
        assert torch.equal(sd[name], t), name
    a = torch.cat([t.flatten() for n, t in sd.items()
                   if n.endswith('_lora.a')])
    assert abs(float(a.std()) - 1.0 / RANK) < 0.02
    assert all(not t.any() for n, t in sd.items() if n.endswith('_lora.b'))
    tok = torch.from_numpy(_tokens(1))
    with torch.no_grad():
        assert torch.equal(lora.train_forward(tok), base.train_forward(tok))


@pytest.mark.parametrize('scan,live', [(True, False), (True, True),
                                       (False, True)],
                         ids=['scanned-b-zero', 'scanned-b-perturbed',
                              'unscanned-b-perturbed'])
def test_lora_training_forward_logits_match(jax_params, scan, live):
    params = jax_params(scan)
    if live:
        params = _perturbed(params)
    jmodel = jllama.Llama(jllama.get_config('llama-tiny', **OV,
                                            scan_layers=scan))
    cfg = tllama.get_config('llama-tiny', **OV)
    tmodel = tllama.Llama(cfg, CPU)
    sd = bridge.params_from_jax(_np(params), cfg)
    assert set(sd) == set(dict(tmodel.named_parameters()))
    tmodel.load_state_dict(sd)
    tok = _tokens()
    want = np.asarray(jmodel.apply({'params': params}, jnp.asarray(tok)))
    with torch.no_grad():
        got = tmodel.train_forward(torch.from_numpy(tok))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def _serving_models(scan):
    jcfg = jllama.get_config('llama-tiny', **SOV, scan_layers=scan,
                             decode=True, remat=False, kv_page_size=PS,
                             kv_n_pages=2 * (64 // PS) + 1)
    jmodel = jllama.Llama(jcfg)
    params = _perturbed(sharding.unbox(jmodel.init(
        jax.random.PRNGKey(3), jnp.zeros((1, 1), jnp.int32))['params']))
    tcfg = tllama.get_config('llama-tiny', **SOV, param_dtype='float32',
                             kv_page_size=PS, kv_n_pages=jcfg.kv_n_pages)
    tmodel = tllama.Llama(tcfg, CPU)
    tmodel.load_state_dict(bridge.params_from_jax(_np(params), tcfg))
    return jmodel, params, tmodel, tcfg


@pytest.mark.parametrize('scan', [True, False],
                         ids=['scanned', 'unscanned'])
def test_lora_cached_forward_matches_jax(scan):
    """Two prefill chunks (the second at base 8), then one paged decode
    step over shuffled pages, adapters live, against the JAX model."""
    jmodel, params, tmodel, tcfg = _serving_models(scan)
    prompt = np.random.RandomState(0).randint(0, 96, 13)
    tokens = np.zeros((1, 16), np.int32)
    tokens[0, :13] = prompt
    mask_row = np.zeros((64,), bool)
    mask_row[:13] = True
    cache1 = jax.tree.map(jnp.zeros_like, jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 1), jnp.int32)))['cache'])
    tcache1 = tllama.PrefillCache.zeros(tcfg, 1, CPU)
    for start in (0, 8):
        tok = tokens[:, start:start + 8]
        with jllama.prefill_kernel('xla'):
            want, mutated = jmodel.apply(
                {'params': params, 'cache': cache1}, jnp.asarray(tok),
                jnp.arange(start, start + 8, dtype=jnp.int32)[None],
                jnp.asarray(mask_row)[None], mutable=['cache'])
        cache1 = mutated['cache']
        with torch.no_grad():
            got = tmodel(torch.from_numpy(tok).long(),
                         torch.arange(start, start + 8)[None], tcache1,
                         torch.from_numpy(mask_row)[None], kernel='xla')
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)
    # The paged decode step: slot 0 holds the prompt in pages 5, 2 and
    # writes the step at position 16, in page 7.
    pps = 64 // PS
    table = np.zeros((pps,), np.int32)
    table[:3] = (5, 2, 7)
    kv0 = jnp.zeros((2, 64), bool)
    with jllama.slot_mode():
        jcache = jax.tree.map(jnp.zeros_like, jax.eval_shape(
            lambda: jmodel.init(jax.random.PRNGKey(0),
                                jnp.zeros((2, 1), jnp.int32), None,
                                kv0))['cache'])
    last = jnp.zeros((2, 96), jnp.float32)
    jcache, last, kv_mask = jeng.make_paged_insert_fn(PS, pps)(
        jcache, last, kv0, cache1, last[0], jnp.asarray(mask_row),
        jnp.asarray(table), jnp.int32(0), jnp.int32(0))
    tcache = tllama.PagedCache.zeros(tcfg, 2, CPU)
    teng.paged_insert(tcache, tcache1, table, 0)
    kv = np.array(kv_mask)
    kv[0, 16] = True
    tok = np.array([[7], [0]], np.int32)
    rope = np.array([[13], [0]])
    with jllama.slot_mode(), jllama.kv_read_bucket(32), \
            jllama.decode_kernel('xla'):
        want, _ = jmodel.apply({'params': params, 'cache': jcache},
                               jnp.asarray(tok), jnp.asarray(rope),
                               jnp.asarray(kv), mutable=['cache'])
    with torch.no_grad():
        got = tmodel(torch.from_numpy(tok).long(), torch.from_numpy(rope),
                     tcache, torch.from_numpy(kv), kernel='xla', read_len=32)
    np.testing.assert_allclose(got.numpy()[0], np.asarray(want)[0],
                               atol=1e-4, rtol=0)


@pytest.fixture(scope='module')
def serving_tree():
    """Unscanned JAX params at the serving widths, adapters perturbed."""
    model = jllama.Llama(jllama.get_config('llama-tiny', **SOV,
                                           scan_layers=False))
    return _perturbed(sharding.unbox(model.init(
        jax.random.PRNGKey(4), jnp.zeros((1, 8), jnp.int32))['params']))


@pytest.mark.parametrize('kw', [dict(page_size=8, prefill_chunk=8),
                                dict(page_size=0),
                                dict(page_size=8, quantize='int8')],
                         ids=['paged', 'unpaged', 'int8-weights'])
def test_lora_engine_streams_equal_jax(serving_tree, kw):
    """Greedy streams of the engines on the same float weights with live
    adapters; int8 weights quantize the base (both packages, from the
    same values) and leave the adapters float."""
    je = jeng.ContinuousBatchingEngine(
        'llama-tiny', model_overrides=dict(SOV, scan_layers=False),
        params=serving_tree, n_slots=2, async_pipeline=False,
        param_dtype=jnp.float32, decode_kernel='xla', prefill_kernel='xla',
        **kw)
    cfg = tllama.get_config('llama-tiny', **SOV)
    te = teng.ContinuousBatchingEngine(
        'llama-tiny', model_overrides=SOV, n_slots=2,
        params=bridge.params_from_jax(_np(serving_tree), cfg),
        param_dtype=torch.float32, async_pipeline=False, device='cpu', **kw)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, 96, n).tolist() for n in (5, 13, 21)]
    got = te.generate(prompts, teng.SamplingConfig(max_new_tokens=10))
    assert got == je.generate(prompts, jeng.SamplingConfig(max_new_tokens=10))
    params = dict(te.model.named_parameters())
    adapters = [p for n, p in params.items() if tllama.is_lora(n)]
    assert len(adapters) == 2 * 4 * 2
    assert all(p.dtype == torch.float32 for p in adapters)
    if kw.get('quantize'):
        assert params['layers.0.attention.q_proj'].dtype == torch.int8
        assert 'layers.0.attention.q_proj_lora.a_scale' not in params


def _mesh1():
    return jmesh.make_mesh(jmesh.MeshConfig(), devices=jax.devices()[:1])


def _train_config(cls, extra=None, model='llama-tiny', **kw):
    base = OV if model == 'llama-tiny' else GEMMA
    return cls(model=model, global_batch_size=2, seq_len=SEQ,
               warmup_steps=2, total_steps=10, train_only='lora',
               model_overrides=dict(base, max_seq_len=SEQ, **(extra or {})),
               **kw)


# gemma-tiny at head width 256 (2 heads over 1), softcapped.
GEMMA = dict(head_dim=256, n_heads=2, n_kv_heads=1, dim=128, n_layers=2,
             final_logit_softcap=30.0, dtype='float32', lora_rank=RANK)


@pytest.mark.parametrize('extra,kw,model', [
    ({}, {}, 'llama-tiny'),
    ({'remat_policy': 'save_attn'}, {'loss_chunk': 8}, 'llama-tiny'),
    ({}, {}, 'gemma-tiny'),
    ({'remat_policy': 'save_attn'}, {'loss_chunk': 8}, 'gemma-tiny'),
], ids=['lora', 'lora-save_attn-loss_chunk', 'gemma-d256-softcap-lora',
        'gemma-d256-softcap-lora-save_attn-loss_chunk'])
def test_train_only_lora_three_steps_match_jax(extra, kw, model):
    # The reference's gemma config has no remat_policy: its blocks rerun
    # whole ('nothing'), which moves what is kept, not the math.
    jextra = {k: v for k, v in extra.items()
              if model == 'llama-tiny' or k != 'remat_policy'}
    jt = jtrainer.Trainer(_train_config(jtrainer.TrainConfig, jextra,
                                        model, **kw), mesh=_mesh1())
    jt.init_state()
    tt = ttrainer.Trainer(_train_config(ttrainer.TrainConfig, extra, model,
                                        **kw), device='cpu')
    init = bridge.params_from_jax(_np(jt.state.params), tt.model_config)
    tt.init_state(init)
    trainable = set(tt.trainable_params())
    assert trainable and all(tllama.is_lora(n) for n in trainable)
    assert set(tt.opt_state.mu) == trainable
    jit = jdata.synthetic_data(jt.mesh, global_batch_size=2, seq_len=SEQ,
                               vocab_size=512)
    tit = tdata.synthetic_data(2, SEQ, 512, device='cpu')
    for _ in range(3):
        jm = jt.step(next(jit))
        tm = tt.step(next(tit))
        np.testing.assert_allclose(float(tm['loss']), float(jm['loss']),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm['grad_norm']),
                                   float(jm['grad_norm']), rtol=1e-4)
    want = bridge.params_from_jax(_np(jt.state.params), tt.model_config)
    for name, p in tt.model.named_parameters():
        if name in trainable:
            np.testing.assert_allclose(p.detach().numpy(),
                                       want[name].numpy(), atol=2e-6,
                                       rtol=0, err_msg=name)
        else:
            assert torch.equal(p.detach(), init[name]), name
            assert torch.equal(want[name], init[name]), name
    # The adapters trained: every b moved off zero.
    assert all(p.detach().abs().max() > 0
               for n, p in tt.model.named_parameters()
               if n.endswith('_lora.b'))


def test_save_attn_step_matches_nothing_and_jax(jax_params):
    """One step's loss and every adapter gradient under 'save_attn'
    equal the 'nothing' step's (the kernels' plain versions) and the JAX
    save_attn model's; the flash forward runs once a layer under
    'save_attn', twice under 'nothing', and the backward pair once."""
    params = _perturbed(jax_params())
    batch = {'inputs': _tokens(2), 'targets': _tokens(3),
             'mask': np.ones((2, SEQ), np.float32)}
    jcfg = jllama.get_config('llama-tiny', **OV, remat_policy='save_attn')
    jmodel = jllama.Llama(jcfg)
    lora_mask = jtrainer._trainable_mask(params, 'lora')

    def jloss(p):
        mixed = jax.tree.map(lambda x, t: x if t else jax.lax.stop_gradient(x),
                             p, lora_mask)
        return jtrainer.loss_fn(
            mixed, lambda v, tok: (jmodel.apply(v, tok),
                                   jnp.zeros((), jnp.float32)),
            jax.tree.map(jnp.asarray, batch))

    (jl, _), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    jg = bridge.params_from_jax(_np(jgrads), tllama.get_config(
        'llama-tiny', **OV))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = {}
    for policy in ('nothing', 'save_attn'):
        cfg = tllama.get_config('llama-tiny', **OV, remat_policy=policy)
        model = tllama.Llama(cfg, CPU)
        model.load_state_dict(bridge.params_from_jax(_np(params), cfg))
        for name, p in model.named_parameters():
            p.requires_grad_(tllama.is_lora(name))
        calls = {'fwd': 0, 'bwd': 0}
        fwd, bwd = tfa.flash_fwd_plain, tfa.flash_bwd_plain

        def count_fwd(*a, **k):
            calls['fwd'] += 1
            return fwd(*a, **k)

        def count_bwd(*a, **k):
            calls['bwd'] += 1
            return bwd(*a, **k)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tfa, 'flash_fwd_plain', count_fwd)
            mp.setattr(tfa, 'flash_bwd_plain', count_bwd)
            m = ttrainer.compute_grads(model, tbatch)
        assert calls == {'fwd': (1 if policy == 'save_attn' else 2) * 2,
                         'bwd': 2}, policy
        got[policy] = (float(m['loss']),
                       {n: p.grad.clone() for n, p in model.named_parameters()
                        if p.requires_grad})
    (l0, g0), (l1, g1) = got['nothing'], got['save_attn']
    np.testing.assert_allclose(l1, l0, rtol=1e-5)
    np.testing.assert_allclose(l1, float(jl), rtol=1e-5)
    assert set(g1) == set(g0) and all(tllama.is_lora(n) for n in g1)
    for name, g in g1.items():
        np.testing.assert_allclose(g.numpy(), g0[name].numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=name)
        np.testing.assert_allclose(g.numpy(), jg[name].numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=name)


def test_lora_rank_validated():
    with pytest.raises(ValueError, match='lora_rank'):
        tllama.get_config('llama-tiny', lora_rank=-1)
    cfg = tllama.get_config('llama-tiny', lora_targets=['q_proj'])
    assert cfg.lora_targets == ('q_proj',)
    assert dataclasses.replace(cfg, lora_rank=2).lora_rank == 2
