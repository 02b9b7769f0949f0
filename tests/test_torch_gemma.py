"""The port's Gemma family against the JAX package's, on the CPU, at f32.

gemma-tiny (2 query heads over 1 KV head at head_dim 64) and a variant
at head_dim 256 (2 heads over 1, dim 128, 2 layers: the width kernels 4
and 5 take for gemma-2b and gemma-7b on the card), the same params
through both packages (`bridge.params_from_jax`):
  1. `train_forward` logits against the reference's `Gemma.apply`, with
     and without final_logit_softcap=30.0, scanned and unscanned trees,
     within 1e-4 absolute (tests/test_torch_train.py's tolerance).
  2. Greedy streams of the paged engine (chunked prefill, the kernels'
     plain versions) equal to the JAX `ContinuousBatchingEngine`'s: f32
     pools at both widths; the int8 cache at d 256 (the JAX engine's
     Pallas int8 branches in interpret mode); weight-only int8 with the
     tied tok_embed quantized; softcap 30.0; and a speculating engine
     whose draft is a second gemma-tiny (the target's weights, so
     multi-token commits run), against the JAX plain stream.
     The request-level engine (the server's --no-continuous) against the
     JAX `InferenceEngine`: float and int8 weights, softcapped, d 256.
  3. A JAX gemma-tiny Orbax checkpoint converted by
     scripts/orbax_to_torch.py (--params-only) and served by name gives
     the same stream.
  4. Three `Trainer` steps at d 256 with final_logit_softcap=30.0, the
     whole head and `loss_chunk` 8 (the softcap per chunk, as the
     reference's `_chunked_ce_sums`), and under remat_policy='save_attn'
     (the reference's gemma has no such field: the policy moves what is
     kept, not the math), against the JAX `Trainer` on a one-device mesh:
     loss 1e-5 relative, grad_norm 1e-4 relative, every parameter after
     the steps 2e-6 absolute (tests/test_torch_train.py's tolerances);
     the CLI trains gemma-tiny at d 256 on the CPU.
"""
import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu import models as jmodels
from skypilot_tpu.infer import engine as jeng
from skypilot_tpu.parallel import mesh as jmesh
from skypilot_tpu.parallel import sharding
from skypilot_tpu.train import checkpoint as jckpt
from skypilot_tpu.train import data as jdata
from skypilot_tpu.train import trainer as jtrainer
from skypilot_tpu_torch import bridge
from skypilot_tpu_torch import models as tmodels
from skypilot_tpu_torch.infer import engine as teng
from skypilot_tpu_torch.infer import server as tserver
from skypilot_tpu_torch.train import __main__ as tmain
from skypilot_tpu_torch.train import data as tdata
from skypilot_tpu_torch.train import trainer as ttrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ = 32
D256 = dict(head_dim=256, n_heads=2, n_kv_heads=1, dim=128, n_layers=2)
CAP = dict(final_logit_softcap=30.0)
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


@pytest.mark.parametrize('extra,scan', [
    ({}, True), (CAP, True), (dict(D256, **CAP), False),
], ids=['tiny', 'tiny_softcap', 'd256_softcap_unscanned'])
def test_training_forward_logits_match(extra, scan):
    ov = dict(extra, dtype='float32', max_seq_len=SEQ)
    jmodel, _ = jmodels.get_model('gemma-tiny', scan_layers=scan, **ov)
    params = sharding.unbox(jmodel.init(
        jax.random.PRNGKey(3), jnp.zeros((1, SEQ), jnp.int32))['params'])
    tmodel, cfg = tmodels.get_model('gemma-tiny', device='cpu', **ov)
    sd = bridge.params_from_jax(_np(params), cfg)
    assert 'lm_head' not in sd
    tmodel.load_state_dict(sd)
    tok = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, SEQ))
    want = jmodel.apply({'params': params}, jnp.asarray(tok))
    got = tmodel.train_forward(torch.from_numpy(tok))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=0)
    if extra.get('final_logit_softcap'):
        assert float(got.abs().max()) < 30.0


def _prompts(vocab):
    rng = np.random.RandomState(0)
    return [rng.randint(0, vocab, n).tolist() for n in PROMPT_LENS]


def _engines(extra, *, jax_kw=None, port_kw=None):
    """(JAX engine, port engine) on the JAX engine's weights: paged (page
    8), chunked prefill (8), 2 slots, f32.  An int8 cache runs the JAX
    Pallas kernels in interpret mode (the function the port's kernels
    compute), else the JAX 'xla' path."""
    jax_kw, port_kw = dict(jax_kw or {}), dict(port_kw or {})
    kern = 'fused' if jax_kw.get('kv_cache_dtype') == 'int8' else 'xla'
    kw = dict(model='gemma-tiny',
              model_overrides=dict(extra, dtype='float32', max_seq_len=64),
              page_size=8, prefill_chunk=8, n_slots=2)
    je = jeng.ContinuousBatchingEngine(
        **kw, **jax_kw, async_pipeline=False, param_dtype=jnp.float32,
        decode_kernel=kern, prefill_kernel=kern)
    params = port_kw.pop('params', None)
    if params is None:
        params = bridge.params_from_jax(_np(je.params), je.config)
    te = teng.ContinuousBatchingEngine(**kw, **port_kw, params=params,
                                       param_dtype=torch.float32,
                                       device='cpu')
    return je, te


ENGINE_CASES = {
    'f32_pools': ({}, {}, {}),
    'd256_f32_pools': (D256, {}, {}),
    'd256_int8_cache': (D256, dict(kv_cache_dtype='int8'),
                        dict(kv_cache_dtype='int8')),
    'softcap': (CAP, {}, {}),
}


def _first_decode_logits(te, prompt):
    """The logits [V] of `prompt`'s first decode step on engine `te`."""
    te.submit(prompt, teng.SamplingConfig(max_new_tokens=4))
    slots = te._slots  # pylint: disable=protected-access
    while all(s is None for s in slots):
        te._schedule_front()  # pylint: disable=protected-access
    row = next(i for i, s in enumerate(slots) if s is not None)
    return te.decode_logits('fused')[row]


@pytest.mark.parametrize('case', list(ENGINE_CASES))
def test_paged_engine_greedy_streams_match_jax(case):
    extra, jax_kw, port_kw = ENGINE_CASES[case]
    je, te = _engines(extra, jax_kw=jax_kw, port_kw=port_kw)
    prompts = _prompts(je.config.vocab_size)
    want = je.generate(prompts, jeng.SamplingConfig(max_new_tokens=NEW))
    assert te.generate(prompts,
                       teng.SamplingConfig(max_new_tokens=NEW)) == want
    assert te.allocator_leak_report() is None
    if case == 'softcap':
        # A softcap never moves an argmax: the decode step's logits are
        # cap * tanh(logits / cap) of the same engine's without it.
        _, plain = _engines({}, port_kw=dict(
            params=te.model.state_dict()))
        got = _first_decode_logits(te, prompts[2])
        free = _first_decode_logits(plain, prompts[2])
        torch.testing.assert_close(got, 30.0 * torch.tanh(free / 30.0),
                                   atol=1e-5, rtol=0)
        assert not torch.equal(got, free)


def test_int8_weights_stream_matches_jax():
    """Weight-only int8: the tied tok_embed quantized over its vocab axis
    as the reference's (one scale a model column), dequantized for the
    lookup and for the head."""
    ov = dict(D256, dtype='float32', max_seq_len=64)
    jmodel, _ = jmodels.get_model('gemma-tiny', scan_layers=False, **ov)
    tree = _np(sharding.unbox(jmodel.init(
        jax.random.PRNGKey(4), jnp.zeros((1, 8), jnp.int32))['params']))
    cfg = tmodels.get_config('gemma-tiny', **ov)
    je, te = _engines(D256, jax_kw=dict(params=tree, quantize='int8'),
                      port_kw=dict(params=bridge.params_from_jax(tree, cfg),
                                   quantize='int8'))
    assert te.model.tok_embed.dtype == torch.int8
    assert te.model.tok_embed_scale.shape == (1, cfg.dim)
    assert te.model.final_norm.weight.dtype == torch.float32
    # The JAX engine's own quantized tree reads into the same weights.
    qsd = bridge.params_from_jax(_np(je.params), cfg)
    for key, w in te.model.state_dict().items():
        assert torch.equal(qsd[key], w), key
    prompts = _prompts(cfg.vocab_size)
    want = je.generate(prompts, jeng.SamplingConfig(max_new_tokens=NEW))
    assert te.generate(prompts,
                       teng.SamplingConfig(max_new_tokens=NEW)) == want


@pytest.mark.parametrize('quantize', [None, 'int8'])
def test_static_engine_matches_jax(quantize):
    ov = dict(D256, **CAP, dtype='float32', max_seq_len=64)
    jmodel, _ = jmodels.get_model('gemma-tiny', **ov)
    tree = _np(sharding.unbox(jmodel.init(
        jax.random.PRNGKey(6), jnp.zeros((1, 8), jnp.int32))['params']))
    kw = dict(model='gemma-tiny', max_batch_size=3, model_overrides=ov,
              quantize=quantize)
    je = jeng.InferenceEngine(**kw, params=tree, param_dtype=jnp.float32)
    prompts = _prompts(je.config.vocab_size)
    want = je.generate(prompts, jeng.SamplingConfig(max_new_tokens=NEW))
    srv = tserver.InferenceServer(
        **kw, continuous=False, param_dtype=torch.float32,
        params=bridge.params_from_jax(tree, je.config), device='cpu')
    assert isinstance(srv.engine, teng.InferenceEngine)
    got = srv._handle_generate(dict(prompt_ids=prompts,  # pylint: disable=protected-access
                                    max_new_tokens=NEW))['tokens']
    assert got == want


def test_draft_model_speculation_matches_jax_plain_stream():
    """A softcapped target with a second gemma-tiny (softcapped, the
    target's weights) as its draft: the committed stream is the JAX
    plain engine's, with multi-token commits."""
    je = jeng.ContinuousBatchingEngine(
        model='gemma-tiny',
        model_overrides=dict(CAP, dtype='float32', max_seq_len=64),
        page_size=8, prefill_chunk=8, n_slots=2, async_pipeline=False,
        param_dtype=jnp.float32, decode_kernel='xla', prefill_kernel='xla')
    sd = bridge.params_from_jax(_np(je.params), je.config)
    ov = dict(CAP, dtype='float32', max_seq_len=64)
    te = teng.ContinuousBatchingEngine(
        model='gemma-tiny', model_overrides=ov, page_size=8, prefill_chunk=8,
        n_slots=2, params=sd, param_dtype=torch.float32, device='cpu',
        spec_k=3, draft_model='gemma-tiny', draft_overrides=ov,
        draft_params=sd)
    prompts = _prompts(je.config.vocab_size)
    want = je.generate(prompts, jeng.SamplingConfig(max_new_tokens=NEW))
    assert te.generate(prompts,
                       teng.SamplingConfig(max_new_tokens=NEW)) == want
    info = te.speculation_info()
    assert info['mode'] == 'draft' and info['accepted_tokens'] > 0
    assert te.allocator_leak_report() is None


def _orbax_to_torch():
    spec = importlib.util.spec_from_file_location(
        'orbax_to_torch', os.path.join(ROOT, 'scripts', 'orbax_to_torch.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_orbax_checkpoint_converted_and_served_by_name(tmp_path):
    """A JAX gemma-tiny Orbax checkpoint (the trainer's layout), converted
    with --params-only, is served by name and gives the JAX engine's
    stream on the same weights."""
    ov = dict(D256, dtype='float32', max_seq_len=64)
    jmodel, _ = jmodels.get_model('gemma-tiny', **ov)
    params = sharding.unbox(jmodel.init(
        jax.random.PRNGKey(5), jnp.zeros((1, 8), jnp.int32))['params'])
    # The trainer's split layout (params, opt_state, step); only the
    # params are read.
    state = types.SimpleNamespace(step=jnp.asarray(0, jnp.int32),
                                  params=params,
                                  opt_state={'count': jnp.zeros((), jnp.int32)})
    manager = jckpt.make_manager(str(tmp_path / 'orbax'))
    jckpt.save(manager, state, wait=True)
    manager.close()
    assert _orbax_to_torch().main([
        '--src', str(tmp_path / 'orbax'), '--dst', str(tmp_path / 'port'),
        '--model', 'gemma-tiny', '--params-only', '--model-overrides',
        '{"head_dim": 256, "n_heads": 2, "n_kv_heads": 1, "dim": 128, '
        '"n_layers": 2, "dtype": "float32", "max_seq_len": 64}']) == 0
    kw = dict(model='gemma-tiny', model_overrides=ov, page_size=8,
              prefill_chunk=8, n_slots=2)
    je = jeng.ContinuousBatchingEngine(
        **kw, params=_np(params), async_pipeline=False,
        param_dtype=jnp.float32, decode_kernel='xla', prefill_kernel='xla')
    te = teng.ContinuousBatchingEngine(
        **kw, checkpoint_dir=str(tmp_path / 'port'),
        param_dtype=torch.float32, device='cpu')
    prompts = _prompts(512)
    sampling = dict(max_new_tokens=NEW)
    assert te.generate(prompts, teng.SamplingConfig(**sampling)) == \
        je.generate(prompts, jeng.SamplingConfig(**sampling))


def _train_config(cls, overrides, **kw):
    return cls(model='gemma-tiny', global_batch_size=2, seq_len=SEQ,
               warmup_steps=2, total_steps=10,
               model_overrides=dict(overrides, dtype='float32',
                                    max_seq_len=SEQ), **kw)


@pytest.mark.parametrize('policy,kw', [
    ('nothing', {}), ('nothing', {'loss_chunk': 8}),
    ('save_attn', {'loss_chunk': 16}),
], ids=['d256_softcap', 'd256_softcap_loss_chunk',
        'd256_softcap_save_attn_loss_chunk'])
def test_three_trainer_steps_match_jax(policy, kw):
    extra = dict(D256, **CAP)
    jt = jtrainer.Trainer(_train_config(jtrainer.TrainConfig, extra, **kw),
                          mesh=jmesh.make_mesh(jmesh.MeshConfig(),
                                               devices=jax.devices()[:1]))
    jt.init_state()
    tt = ttrainer.Trainer(_train_config(
        ttrainer.TrainConfig, dict(extra, remat_policy=policy), **kw),
        device='cpu')
    init = bridge.params_from_jax(_np(jt.state.params), tt.model_config)
    assert 'lm_head' not in init
    tt.init_state(init)
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
    assert tt.step_count == int(jt.state.step) == 3
    want = bridge.params_from_jax(_np(jt.state.params), tt.model_config)
    for name, p in tt.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=2e-6, rtol=0, err_msg=name)
    assert max(float((want[k] - init[k]).abs().max()) for k in want) > 1e-5


def test_cli_trains_gemma_on_the_cpu():
    out = tmain.main(['--device', 'cpu', '--model', 'gemma-tiny',
                      '--model-overrides',
                      '{"head_dim": 256, "n_heads": 2, "n_kv_heads": 1, '
                      '"dim": 128, "n_layers": 2, '
                      '"final_logit_softcap": 30.0}',
                      '--global-batch-size', '2', '--seq-len', '16',
                      '--loss-chunk', '8', '--steps', '2',
                      '--log-every', '1'])
    assert out['step'] == 2 and len(out['history']) == 2
    for rec in out['history']:
        assert np.isfinite(rec['loss']) and np.isfinite(rec['grad_norm'])
