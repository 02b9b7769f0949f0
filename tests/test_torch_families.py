"""The port's gpt2, qwen and Mixtral families against the JAX package's,
on the CPU, at f32.

  1. The registry: every config name of the reference's gpt2, qwen and
     moe families builds the port's model (on the meta device: shapes,
     no storage), whose parameters add up to the reference's
     `num_params`; `num_params` and `active_params` equal the
     reference's (the gemma family's too: tests/test_torch_gemma.py holds
     its forwards); deepseek-* raises and names what it waits for.
  2. `train_forward` logits against the reference's `model.apply` on the
     same params (through `bridge.params_from_jax`): gpt2-tiny (MHA,
     learned positions, tied head), qwen-tiny (q/k/v biases, tied head),
     qwen-tiny untied at 7 query heads over 1 KV head (a group of 7), and
     mixtral-tiny with each `moe_dispatch`; the scanned layout, and the
     unscanned one in the Mixtral 'sparse' case.
  3. Greedy streams of the paged engine (chunked prefill, the kernels'
     plain versions) equal to the JAX `ContinuousBatchingEngine`'s for
     gpt2-tiny, qwen-tiny and its group-of-7 variant; gpt2 with int8
     weights (the fused 4-D qkv kernel quantized per output column) equal
     to the JAX engine's with quantize='int8'; an engine whose
     max_seq_len exceeds gpt2's pos_embed rows raises.
  4. The blocks under each remat policy give the same step (qwen,
     Mixtral).  Three trainer steps of gpt2-tiny with `loss_chunk` (the chunked loss
     over the tied head) against the JAX `Trainer`; the JAX trainer's
     Orbax checkpoint, converted by scripts/orbax_to_torch.py, resumes in
     the port and is served by name.

Mixtral's engine, trainer and int8 cases are in tests/test_torch_moe.py.
Tolerances are tests/test_torch_train.py's: logits 1e-4 absolute, loss
1e-5 relative, grad_norm 1e-4 relative, params after three steps 2e-6
absolute.
"""
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu import models as jmodels
from skypilot_tpu.infer import engine as jeng
from skypilot_tpu.models import gemma as jgemma
from skypilot_tpu.models import gpt2 as jgpt2
from skypilot_tpu.models import moe as jmoe
from skypilot_tpu.models import qwen as jqwen
from skypilot_tpu.parallel import mesh as jmesh
from skypilot_tpu.parallel import sharding
from skypilot_tpu.train import checkpoint as jckpt
from skypilot_tpu.train import data as jdata
from skypilot_tpu.train import trainer as jtrainer
from skypilot_tpu_torch import bridge
from skypilot_tpu_torch import models as tmodels
from skypilot_tpu_torch.infer import engine as teng
from skypilot_tpu_torch.train import checkpoint as ckpt
from skypilot_tpu_torch.train import data as tdata
from skypilot_tpu_torch.train import trainer as ttrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ = 32
G7 = dict(n_heads=7, n_kv_heads=1, head_dim=16, dim=112,
          tie_embeddings=False)
NEW = 10
PROMPT_LENS = (5, 13, 21)


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


@pytest.mark.parametrize('family', [jgpt2, jqwen, jmoe, jgemma],
                         ids=['gpt2', 'qwen', 'moe', 'gemma'])
def test_every_config_builds_with_the_reference_counts(family):
    for name in family.CONFIGS:
        jcfg = jmodels.get_model(name)[1]
        model, cfg = tmodels.get_model(name, device='meta')
        assert type(cfg).__name__ == type(jcfg).__name__, name
        assert tmodels.num_params(cfg) == jmodels.num_params(jcfg), name
        assert tmodels.active_params(cfg) == jmodels.active_params(jcfg)
        assert tmodels.flops_per_token(cfg, 100) == \
            jmodels.flops_per_token(jcfg, 100), name
        assert sum(p.numel() for p in model.parameters()) == \
            tmodels.num_params(cfg), name
    with pytest.raises(ValueError, match='The other families'):
        tmodels.get_model('deepseek-v3', device='cpu')
    assert set(family.CONFIGS) <= set(tmodels.available_models())


FORWARD_CASES = {
    'gpt2': ('gpt2-tiny', {}, True),
    'qwen_tied': ('qwen-tiny', {}, True),
    'qwen_g7_untied': ('qwen-tiny', G7, True),
    'mixtral_dense': ('mixtral-tiny', {'moe_dispatch': 'dense'}, True),
    'mixtral_sparse_unscanned': ('mixtral-tiny', {'moe_dispatch': 'sparse'},
                                 False),
}


@pytest.mark.parametrize('case', list(FORWARD_CASES))
def test_training_forward_logits_match(case):
    name, extra, scan = FORWARD_CASES[case]
    ov = dict(extra, dtype='float32', max_seq_len=SEQ)
    jmodel, _ = jmodels.get_model(name, scan_layers=scan, **ov)
    params = sharding.unbox(jmodel.init(
        jax.random.PRNGKey(3), jnp.zeros((1, SEQ), jnp.int32))['params'])
    tmodel, cfg = tmodels.get_model(name, device='cpu', **ov)
    tmodel.load_state_dict(bridge.params_from_jax(_np(params), cfg))
    tok = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, SEQ))
    want, state = jmodel.apply({'params': params}, jnp.asarray(tok),
                               mutable=['intermediates'])
    got, aux = tmodel.train_forward(torch.from_numpy(tok), return_aux=True)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(aux),
                               float(jtrainer.sum_aux_losses(state)),
                               rtol=1e-5, atol=1e-7)
    assert (float(aux) > 0) == name.startswith('mixtral')
    hidden = tmodel.train_forward(torch.from_numpy(tok), return_hidden=True)
    torch.testing.assert_close(tmodel.head(hidden), got)


ENGINE_CASES = {
    'gpt2': ('gpt2-tiny', dict(max_seq_len=64)),
    'qwen_tied': ('qwen-tiny', dict(max_seq_len=64)),
    'qwen_g7': ('qwen-tiny', dict(G7, max_seq_len=64)),
}


def _prompts(vocab):
    rng = np.random.RandomState(0)
    return [rng.randint(0, vocab, n).tolist() for n in PROMPT_LENS]


@pytest.mark.parametrize('case', list(ENGINE_CASES))
def test_paged_engine_greedy_streams_match_jax(case):
    name, ov = ENGINE_CASES[case]
    kw = dict(model=name, model_overrides=dict(ov, dtype='float32'),
              page_size=8, prefill_chunk=8, n_slots=2)
    je = jeng.ContinuousBatchingEngine(
        **kw, async_pipeline=False, param_dtype=jnp.float32,
        decode_kernel='xla', prefill_kernel='xla')
    prompts = _prompts(je.config.vocab_size)
    want = je.generate(prompts, jeng.SamplingConfig(max_new_tokens=NEW))
    te = teng.ContinuousBatchingEngine(
        **kw, params=bridge.params_from_jax(_np(je.params), je.config),
        param_dtype=torch.float32, device='cpu')
    assert te.generate(prompts,
                       teng.SamplingConfig(max_new_tokens=NEW)) == want
    assert te.allocator_leak_report() is None


def test_gpt2_int8_weights_stream_matches_jax():
    ov = dict(max_seq_len=64, dtype='float32')
    jmodel, _ = jmodels.get_model('gpt2-tiny', scan_layers=False, **ov)
    tree = _np(sharding.unbox(jmodel.init(
        jax.random.PRNGKey(4), jnp.zeros((1, 8), jnp.int32))['params']))
    kw = dict(model='gpt2-tiny', model_overrides=ov, n_slots=2,
              prefill_chunk=8, page_size=8)
    je = jeng.ContinuousBatchingEngine(
        **kw, params=tree, quantize='int8', async_pipeline=False,
        param_dtype=jnp.float32, decode_kernel='xla', prefill_kernel='xla')
    prompts = _prompts(512)
    want = je.generate(prompts, jeng.SamplingConfig(max_new_tokens=NEW))
    cfg = tmodels.get_config('gpt2-tiny', **ov)
    te = teng.ContinuousBatchingEngine(
        **kw, params=bridge.params_from_jax(tree, cfg), quantize='int8',
        param_dtype=torch.float32, device='cpu')
    attn = te.model.layers[0].attention
    assert attn.qkv_proj.dtype == torch.int8
    assert attn.qkv_proj_scale.shape == (3 * 128, 1)
    assert attn.qkv_proj_bias.dtype == torch.float32
    assert te.model.pos_embed.dtype == torch.float32
    assert te.model.tok_embed.dtype == torch.int8
    # The JAX engine's own quantized tree reads into the same weights.
    qsd = bridge.params_from_jax(_np(je.params), cfg)
    for key, w in te.model.state_dict().items():
        assert torch.equal(qsd[key], w), key
    assert te.generate(prompts,
                       teng.SamplingConfig(max_new_tokens=NEW)) == want


def test_gpt2_max_seq_len_past_pos_embed_raises():
    model, cfg = tmodels.get_model('gpt2-tiny', device='cpu')
    model.init_weights(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match='pos_embed'):
        teng.ContinuousBatchingEngine(
            model='gpt2-tiny', params=model.state_dict(), max_seq_len=512,
            page_size=8, n_slots=1, param_dtype=torch.float32,
            device='cpu')


@pytest.mark.parametrize('name,extra', [
    ('qwen-tiny', {}), ('mixtral-tiny', dict(dim=64, ffn_dim=128)),
], ids=['qwen', 'mixtral'])
def test_remat_policies_give_the_same_step(name, extra):
    """The families' blocks under remat 'nothing', 'save_attn' and no
    remat: the same loss, aux loss and gradients (the reruns recompute
    the same routes and values)."""
    got = {}
    for ov in (dict(remat=False), dict(remat_policy='nothing'),
               dict(remat_policy='save_attn')):
        tt = ttrainer.Trainer(_train_config(ttrainer.TrainConfig, name,
                                            dict(extra, **ov)), device='cpu')
        tt.init_state()
        batch = next(tdata.synthetic_data(2, SEQ, tt.model_config.vocab_size,
                                          device='cpu'))
        metrics = ttrainer.compute_grads(tt.model, batch)
        got[str(ov)] = (float(metrics['loss']), float(metrics['aux_loss']),
                        {k: p.grad for k, p in tt.model.named_parameters()})
    (loss, aux, grads), *others = got.values()
    assert (aux > 0) == name.startswith('mixtral')
    for other_loss, other_aux, other_grads in others:
        assert (other_loss, other_aux) == (loss, aux)
        for k, g in grads.items():
            torch.testing.assert_close(other_grads[k], g, atol=1e-6,
                                       rtol=1e-5, msg=k)


def _mesh1():
    return jmesh.make_mesh(jmesh.MeshConfig(), devices=jax.devices()[:1])


def _orbax_to_torch():
    spec = importlib.util.spec_from_file_location(
        'orbax_to_torch', os.path.join(ROOT, 'scripts', 'orbax_to_torch.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _train_config(cls, model, ov, **kw):
    return cls(model=model, global_batch_size=2, seq_len=SEQ,
               warmup_steps=2, total_steps=10,
               model_overrides=dict(ov, max_seq_len=SEQ, dtype='float32'),
               **kw)


def three_steps_match(model, ov, tmp_path, **kw):
    """Three trainer steps of the port against the JAX Trainer on the
    same params and batches; then the JAX trainer's Orbax checkpoint,
    converted by scripts/orbax_to_torch.py, resumes in a fresh port
    trainer (its next step the JAX trainer's next step) and serves by
    name.  Returns the port's last metrics."""
    jt = jtrainer.Trainer(_train_config(jtrainer.TrainConfig, model, ov,
                                        **kw), mesh=_mesh1())
    jt.init_state()
    tt = ttrainer.Trainer(_train_config(ttrainer.TrainConfig, model, ov,
                                        **kw), device='cpu')
    tt.init_state(bridge.params_from_jax(_np(jt.state.params),
                                         tt.model_config))
    vocab = tt.model_config.vocab_size
    jit = jdata.synthetic_data(jt.mesh, global_batch_size=2, seq_len=SEQ,
                               vocab_size=vocab)
    tit = tdata.synthetic_data(2, SEQ, vocab, device='cpu')
    for _ in range(3):
        jm = jt.step(next(jit))
        tm = tt.step(next(tit))
        for key in ('loss', 'aux_loss'):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5, atol=1e-8, err_msg=key)
        np.testing.assert_allclose(float(tm['grad_norm']),
                                   float(jm['grad_norm']), rtol=1e-4)
    want = bridge.params_from_jax(_np(jt.state.params), tt.model_config)
    for name, p in tt.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=2e-6, rtol=0, err_msg=name)

    manager = jckpt.make_manager(str(tmp_path / 'orbax'))
    jckpt.save(manager, jt.state, wait=True)
    manager.close()
    overrides = json.dumps(dict(ov, max_seq_len=SEQ, dtype='float32'))
    assert _orbax_to_torch().main([
        '--src', str(tmp_path / 'orbax'), '--dst', str(tmp_path / 'port'),
        '--model', model, '--model-overrides', overrides]) == 3
    resumed = ttrainer.Trainer(_train_config(ttrainer.TrainConfig, model, ov,
                                             **kw), device='cpu')
    assert ckpt.restore_or_init(ckpt.make_manager(str(tmp_path / 'port')),
                                resumed) == 3
    for name, p in resumed.model.named_parameters():
        assert torch.equal(p.detach(), want[name]), name
    jm = jt.step(next(jit))
    rm = resumed.step(next(tdata.synthetic_data(2, SEQ, vocab, start_step=3,
                                                device='cpu')))
    np.testing.assert_allclose(float(rm['loss']), float(jm['loss']),
                               rtol=1e-5)
    serve = dict(model=model, model_overrides=json.loads(overrides),
                 page_size=8, n_slots=2, prefill_chunk=8,
                 param_dtype=torch.float32, device='cpu')
    prompts = _prompts(vocab)
    sampling = teng.SamplingConfig(max_new_tokens=6)
    assert teng.ContinuousBatchingEngine(
        checkpoint_dir=str(tmp_path / 'port'), **serve).generate(
            prompts, sampling) == teng.ContinuousBatchingEngine(
                params=want, **serve).generate(prompts, sampling)
    return tm


def test_gpt2_trainer_steps_with_loss_chunk_match_jax(tmp_path):
    metrics = three_steps_match('gpt2-tiny', {}, tmp_path, loss_chunk=8)
    assert float(metrics['aux_loss']) == 0.0
