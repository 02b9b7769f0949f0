"""The port's training path against the JAX package's, on the CPU, at f32.

A tiny Llama (llama-tiny widths, 4 query heads over 2 KV heads, dtype
f32 on both sides) gives its JAX params to the port through
`bridge.params_from_jax`.  Then the same tokens (from the same
synthetic stream) go through both: the cacheless training forward, the
loss and every parameter's gradient, the optimizer's schedule and
clipping, and three whole `Trainer` steps.  The JAX trainer runs on a
one-device mesh; its attention is the reference's XLA path, the port's
the plain versions of the flash kernels (the kernels run on the card:
tests/test_torch_cuda.py, chip_smoke.py).

Tolerances (f32 on both sides, sums in other orders):
  logits        1e-4 absolute (magnitude ~1, a few hundred terms a layer)
  loss          1e-5 relative
  gradients     1e-5 absolute + 1e-4 relative (entries span 1e-6..1e-1)
  grad_norm     1e-4 relative
  schedule      1e-6 relative (optax computes in f32, the port in f64)
  params after  2e-6 absolute (each step moves an entry by at most
  3 steps       ~lr = 3e-4; Adam divides gradient noise by its own scale)
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from skypilot_tpu.models import llama as jllama
from skypilot_tpu.parallel import mesh as jmesh
from skypilot_tpu.parallel import sharding
from skypilot_tpu.train import data as jdata
from skypilot_tpu.train import trainer as jtrainer
from skypilot_tpu_torch import bridge
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.ops import flash_attention as tfa
from skypilot_tpu_torch.train import __main__ as tmain
from skypilot_tpu_torch.train import data as tdata
from skypilot_tpu_torch.train import trainer as ttrainer

OV = dict(n_heads=4, n_kv_heads=2, max_seq_len=32, dtype='float32')
SEQ = 32
CPU = torch.device('cpu')


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    """The suite runs these tests beside XLA:CPU tests on the same cores:
    tiny f32 models need no intra-op threads of their own."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def jax_params():
    """JAX llama-tiny params by layout, each initialised once a module
    (attention_impl and sliding_window do not change them)."""
    built = {}

    def params(scan=True):
        if scan not in built:
            built[scan] = sharding.unbox(_jax_model(scan).init(
                jax.random.PRNGKey(5),
                jnp.zeros((1, SEQ), jnp.int32))['params'])
        return built[scan]

    return params


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_model(scan=True, **extra):
    return jllama.Llama(jllama.get_config('llama-tiny', **OV,
                                          scan_layers=scan, **extra))


def _port_model(params, **extra):
    cfg = tllama.get_config('llama-tiny', **OV, **extra)
    model = tllama.Llama(cfg, CPU)
    model.load_state_dict(bridge.params_from_jax(_np(params), cfg))
    return model, cfg


def _tokens(seed=0, b=2):
    return np.random.RandomState(seed).randint(0, 512, (b, SEQ)).astype(
        np.int32)


def _mesh1():
    return jmesh.make_mesh(jmesh.MeshConfig(), devices=jax.devices()[:1])


@pytest.mark.parametrize('extra,scan', [
    ({}, True), ({}, False), ({'sliding_window': 8}, True),
    ({'attention_impl': 'reference'}, True),
], ids=['flash-scanned', 'flash-unscanned', 'window-scanned',
        'reference-scanned'])
def test_training_forward_logits_match(jax_params, extra, scan):
    jmodel = _jax_model(scan, **extra)
    params = jax_params(scan)
    tmodel, _ = _port_model(params, **extra)
    tok = _tokens()
    want = np.asarray(jmodel.apply({'params': params}, jnp.asarray(tok)))
    got = tmodel.train_forward(torch.from_numpy(tok))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-4,
                               rtol=0)
    hidden = tmodel.train_forward(torch.from_numpy(tok), return_hidden=True)
    assert hidden.shape == (2, SEQ, 256)
    torch.testing.assert_close(tmodel.head(hidden), got)


def _batch(tok, targets):
    return {'inputs': tok, 'targets': targets,
            'mask': np.ones(tok.shape, np.float32)}


def test_loss_and_every_gradient_match(jax_params):
    jmodel = _jax_model()
    params = jax_params()
    tmodel, cfg = _port_model(params)
    tmodel.requires_grad_(True)
    rng = np.random.RandomState(1)
    batch = _batch(_tokens(1), rng.randint(1, 512, (2, SEQ)).astype(
        np.int32))
    batch['mask'][1, 20:] = 0.0         # a masked tail counts for nothing

    def apply_fn(variables, tokens):
        return jmodel.apply(variables, tokens), jnp.zeros((), jnp.float32)

    (jloss, jmetrics), jgrads = jax.value_and_grad(
        jtrainer.loss_fn, has_aux=True)(
            params, apply_fn, jax.tree.map(jnp.asarray, batch))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    metrics = ttrainer.compute_grads(tmodel, tbatch)
    np.testing.assert_allclose(float(metrics['loss']), float(jloss),
                               rtol=1e-5)
    np.testing.assert_allclose(float(metrics['accuracy']),
                               float(jmetrics['accuracy']), atol=1e-7)
    want = bridge.params_from_jax(_np(jgrads), cfg)
    grads = {k: p.grad for k, p in tmodel.named_parameters()}
    assert set(grads) == set(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=name)


def test_schedule_matches_optax():
    config = ttrainer.TrainConfig(learning_rate=3e-4, warmup_steps=3,
                                  total_steps=10)
    opt = ttrainer.make_optimizer(config)
    want = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=3e-4, warmup_steps=3, decay_steps=10,
        end_value=3e-5)
    for step in range(14):
        np.testing.assert_allclose(opt.schedule(step), float(want(step)),
                                   rtol=1e-6, atol=1e-12)
    assert opt.schedule(0) == 0.0     # the first update moves nothing


@pytest.mark.parametrize('max_norm', [0.5, 100.0], ids=['clips', 'keeps'])
def test_clipping_matches_optax(max_norm):
    rng = np.random.RandomState(2)
    grads = {'a': rng.randn(3, 5).astype(np.float32),
             'b': rng.randn(7).astype(np.float32)}
    want, _ = optax.clip_by_global_norm(max_norm).update(
        {k: jnp.asarray(v) for k, v in grads.items()}, optax.EmptyState())
    tgrads = {k: torch.from_numpy(v) for k, v in grads.items()}
    norm = ttrainer.global_norm(tgrads)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)),
                               rtol=1e-6)
    for k, g in tgrads.items():
        np.testing.assert_allclose(
            ttrainer.clip_to_global_norm(g, norm, max_norm).numpy(),
            np.asarray(want[k]), rtol=1e-6)


def test_synthetic_data_matches_jax():
    jit = jdata.synthetic_data(_mesh1(), global_batch_size=4, seq_len=SEQ,
                               vocab_size=512, seed=7, start_step=3)
    tit = tdata.synthetic_data(4, SEQ, 512, seed=7, start_step=3,
                               device='cpu')
    for _ in range(2):
        want, got = next(jit), next(tit)
        for key in ('inputs', 'targets', 'mask'):
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))
        assert got['inputs'].dtype == torch.int32


def _train_config(cls, **kw):
    return cls(model='llama-tiny', global_batch_size=2, seq_len=SEQ,
               warmup_steps=2, total_steps=10,
               model_overrides=dict(OV, max_seq_len=SEQ), **kw)


def test_three_trainer_steps_match_jax():
    jt = jtrainer.Trainer(_train_config(jtrainer.TrainConfig), mesh=_mesh1())
    jt.init_state()
    tt = ttrainer.Trainer(_train_config(ttrainer.TrainConfig), device='cpu')
    tt.init_state(bridge.params_from_jax(_np(jt.state.params),
                                         tt.model_config))
    init = bridge.params_from_jax(_np(jt.state.params), tt.model_config)
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
    # The steps did move the weights (lr > 0 after the first update).
    assert max(float((want[k] - init[k]).abs().max()) for k in want) > 1e-5


def test_grad_accum_matches_one_full_batch():
    full = ttrainer.Trainer(_train_config(ttrainer.TrainConfig),
                            device='cpu')
    accum = ttrainer.Trainer(_train_config(ttrainer.TrainConfig,
                                           grad_accum_steps=2), device='cpu')
    full.init_state()       # the same seed: the same weights
    accum.init_state()
    batch = next(tdata.synthetic_data(2, SEQ, 512, device='cpu'))
    m1 = ttrainer.compute_grads(full.model, batch)
    m2 = ttrainer.compute_grads(accum.model, batch, grad_accum_steps=2)
    np.testing.assert_allclose(float(m2['loss']), float(m1['loss']),
                               rtol=1e-5)
    g2 = dict(accum.model.named_parameters())
    for name, p in full.model.named_parameters():
        np.testing.assert_allclose(g2[name].grad.numpy(), p.grad.numpy(),
                                   atol=1e-6, rtol=1e-5, err_msg=name)


def test_cli_trains_on_the_cpu(capsys):
    out = tmain.main(['--device', 'cpu', '--model', 'llama-tiny',
                      '--model-overrides', '{"n_heads": 4, "n_kv_heads": 2}',
                      '--global-batch-size', '2', '--seq-len', '16',
                      '--steps', '2', '--log-every', '1', '--json-metrics'])
    assert out['step'] == 2 and len(out['history']) == 2
    for rec in out['history']:
        assert np.isfinite(rec['loss']) and np.isfinite(rec['grad_norm'])
    assert 'SKYTPU_METRICS {' in capsys.readouterr().out


@pytest.mark.parametrize('field', [
    dict(mesh=ttrainer.MeshConfig(tensor=2)),
    dict(pipeline_microbatches=4),
    dict(compilation_cache_dir='/nonexistent'),
], ids=['mesh', 'pipeline', 'compilation_cache'])
def test_unported_fields_raise(field):
    with pytest.raises(ValueError, match='ROADMAP'):
        ttrainer.Trainer(ttrainer.TrainConfig(**field), device='cpu')


def test_unported_model_options_raise():
    tok = torch.zeros((1, 8), dtype=torch.int32)
    for extra, err in (({'attention_impl': 'ring'}, NotImplementedError),
                       ({'remat_policy': 'bogus'}, ValueError)):
        cfg = tllama.get_config('llama-tiny', **extra)
        with pytest.raises(err):
            tllama.Llama(cfg, CPU).train_forward(tok)
    # kernel='fused' on CPU tensors runs the flash wrappers, which take
    # their plain versions there and launch nothing.
    model = tllama.Llama(tllama.get_config('llama-tiny'), CPU)
    model.init_weights(torch.Generator().manual_seed(0))
    before = (tfa.fwd_launches, tfa.dq_launches, tfa.dkv_launches)
    with torch.no_grad():
        got = model.train_forward(tok, kernel='fused')
        want = model.train_forward(tok, kernel='xla')
    assert (tfa.fwd_launches, tfa.dq_launches, tfa.dkv_launches) == before
    assert torch.equal(got, want)


def test_training_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default device is valid here')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrainer.Trainer(ttrainer.TrainConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(tdata.synthetic_data(2, 8, 512))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmain.main(['--steps', '1'])
