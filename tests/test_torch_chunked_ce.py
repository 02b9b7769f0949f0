"""The port's chunked cross entropy (`loss_chunk`) against the JAX
package's `loss_fn_chunked`, and against its own unchunked loss, on the
CPU, at f32.

The same tiny Llama (llama-tiny widths, 4 query heads over 2 KV heads,
params through `bridge.params_from_jax`) and the same batch, its second
row's tail masked, go through both packages: the loss, the accuracy and
every parameter's gradient must agree at the tolerances of
tests/test_torch_train.py (loss 1e-5 relative; gradients 1e-5 absolute
+ 1e-4 relative); so must gemma-tiny at head width 256, whose tied head
is softcapped (final_logit_softcap=30.0) chunk by chunk.  Against the port's own unchunked loss, which differs
only in summation order, the same tolerances hold.  The head runs on
[B, chunk] hidden states only, twice a chunk under autograd (the
forward, then its rerun in the backward pass), so at most [B, chunk, V]
f32 logits are live.  A chunk that does not divide the sequence raises
the reference's error.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu import models as jmodels
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.parallel import mesh as jmesh
from skypilot_tpu.parallel import sharding
from skypilot_tpu.train import trainer as jtrainer
from skypilot_tpu_torch import bridge
from skypilot_tpu_torch import models as tmodels
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.train import trainer as ttrainer

SEQ = 32
OV = dict(n_heads=4, n_kv_heads=2, max_seq_len=SEQ, dtype='float32')
# gemma-tiny at head width 256, its tied head softcapped at 30.
GEMMA_OV = dict(head_dim=256, n_heads=2, n_kv_heads=1, dim=128, n_layers=2,
                final_logit_softcap=30.0, max_seq_len=SEQ, dtype='float32')
CPU = torch.device('cpu')


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    """The suite runs these tests beside XLA:CPU tests on the same cores:
    tiny f32 models need no intra-op threads of their own."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch():
    rng = np.random.RandomState(4)
    batch = {'inputs': rng.randint(0, 512, (2, SEQ)).astype(np.int32),
             'targets': rng.randint(1, 512, (2, SEQ)).astype(np.int32),
             'mask': np.ones((2, SEQ), np.float32)}
    batch['mask'][1, 21:] = 0.0
    return batch


@pytest.fixture(scope='module')
def reference():
    """(JAX model, its params, a batch with a masked tail)."""
    jmodel = jllama.Llama(jllama.get_config('llama-tiny', **OV))
    params = sharding.unbox(jmodel.init(
        jax.random.PRNGKey(7), jnp.zeros((1, SEQ), jnp.int32))['params'])
    return jmodel, params, _batch()


@pytest.fixture(scope='module')
def gemma_reference():
    """The same for gemma-tiny at d 256, softcapped: (JAX model, its
    config, its params, the batch)."""
    jmodel, jcfg = jmodels.get_model('gemma-tiny', **GEMMA_OV)
    params = sharding.unbox(jmodel.init(
        jax.random.PRNGKey(7), jnp.zeros((1, SEQ), jnp.int32))['params'])
    return jmodel, jcfg, params, _batch()


def _port(params, model='llama-tiny'):
    if model == 'gemma-tiny':
        model, cfg = tmodels.get_model('gemma-tiny', device=CPU, **GEMMA_OV)
        model.load_state_dict(bridge.params_from_jax(
            jax.tree.map(np.asarray, params), cfg))
        model.requires_grad_(True)
        return model, cfg
    cfg = tllama.get_config('llama-tiny', **OV)
    model = tllama.Llama(cfg, CPU)
    model.load_state_dict(bridge.params_from_jax(
        jax.tree.map(np.asarray, params), cfg))
    model.requires_grad_(True)
    return model, cfg


def _grads(model):
    return {k: p.grad.clone() for k, p in model.named_parameters()}


def _close(got, want, msg=''):
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4,
                               err_msg=msg)


@pytest.mark.parametrize('model,chunk', [
    ('llama-tiny', 8), ('llama-tiny', 16), ('llama-tiny', 32),
    ('gemma-tiny', 8), ('gemma-tiny', 32),
], ids=['8', '16', '32', 'gemma_d256_softcap-8', 'gemma_d256_softcap-32'])
def test_chunked_loss_and_every_gradient_match_jax(request, model, chunk):
    """gemma's tied head (no lm_head: tok_embed's gradient sums the
    lookup's and the head's) is softcapped chunk by chunk on both
    sides."""
    jcfg = None
    if model == 'gemma-tiny':
        jmodel, jcfg, params, batch = request.getfixturevalue(
            'gemma_reference')
    else:
        jmodel, params, batch = request.getfixturevalue('reference')

    def apply_fn(variables, tokens, return_hidden=False):
        return (jmodel.apply(variables, tokens, return_hidden=return_hidden),
                jnp.zeros((), jnp.float32))

    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jtrainer.loss_fn_chunked(
            p, apply_fn, jax.tree.map(jnp.asarray, batch), chunk=chunk,
            model_config=jcfg),
        has_aux=True)(params)
    model, cfg = _port(params, model)
    m = ttrainer.compute_grads(
        model, {k: torch.from_numpy(v) for k, v in batch.items()},
        loss_chunk=chunk)
    np.testing.assert_allclose(float(m['loss']), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(m['accuracy']), float(jm['accuracy']),
                               atol=1e-7)
    assert float(m['tokens']) == float(jm['tokens']) == 2 * SEQ - 11
    want = bridge.params_from_jax(jax.tree.map(np.asarray, jgrads), cfg)
    grads = _grads(model)
    assert set(grads) == set(want)
    for name, g in grads.items():
        _close(g.numpy(), want[name].numpy(), name)


@pytest.mark.parametrize('chunk', [4, 16])
def test_chunked_equals_unchunked(reference, chunk):
    """The port's chunked loss against its own unchunked one; the head
    sees [B, chunk] hidden states only, each chunk twice (the forward and
    its rerun in the backward pass)."""
    _, params, batch = reference
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    model, _ = _port(params)
    m0 = ttrainer.compute_grads(model, tbatch)
    g0 = _grads(model)
    shapes = []
    head = model.head

    def recording_head(x):
        shapes.append(tuple(x.shape))
        return head(x)

    model.head = recording_head
    m1 = ttrainer.compute_grads(model, tbatch, loss_chunk=chunk)
    assert shapes == [(2, chunk, 256)] * (2 * SEQ // chunk)
    np.testing.assert_allclose(float(m1['loss']), float(m0['loss']),
                               rtol=1e-5)
    assert float(m1['accuracy']) == float(m0['accuracy'])
    for name, g in _grads(model).items():
        _close(g.numpy(), g0[name].numpy(), name)
    with torch.no_grad():
        loss, _ = ttrainer.loss_fn_chunked(model, tbatch, chunk=chunk)
    np.testing.assert_allclose(float(loss), float(m0['loss']), rtol=1e-5)


def test_loss_chunk_must_divide_seq_len():
    kw = dict(model='llama-tiny', global_batch_size=2, seq_len=SEQ,
              loss_chunk=5, model_overrides=dict(OV))
    msg = f'loss_chunk=5 must divide seq_len={SEQ}'
    with pytest.raises(ValueError, match=msg):
        jtrainer.Trainer(jtrainer.TrainConfig(**kw), mesh=jmesh.make_mesh(
            jmesh.MeshConfig(), devices=jax.devices()[:1]))
    with pytest.raises(ValueError, match=msg):
        ttrainer.Trainer(ttrainer.TrainConfig(**kw), device='cpu')
    hidden = torch.zeros((1, SEQ, 8))
    with pytest.raises(ValueError, match=msg):
        ttrainer.chunked_ce_sums(lambda h: h, hidden,
                                 torch.zeros((1, SEQ), dtype=torch.int32),
                                 torch.ones((1, SEQ)), 5)
