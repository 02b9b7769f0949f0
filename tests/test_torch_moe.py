"""The port's Mixtral (MoE) family against the JAX package's, on the CPU,
at f32.

  1. `MoEMLP` output and aux loss against the reference's `MoEMLP` on the
     same params and input, for both `moe_dispatch` values, with ample
     capacity and with capacity_factor 0.3 (so that (token, choice)
     pairs overflow and are dropped).
  2. Greedy streams of the paged engine equal to the JAX
     `ContinuousBatchingEngine`'s on mixtral-tiny with 4 slots and
     capacity_factor 0.5: capacity is counted over the T tokens of each
     call, so the idle rows of a decode step and a chunk's padded
     positions compete with live tokens, and a decode step drops routes
     (asserted); one prompt shares another's prefix pages.  The same with n-gram speculation (spec_k 3: verify
     windows of 4 queries a row), against the JAX engine with spec_k 3;
     and with int8 weights (the router quantized, the expert stacks
     float) against the JAX engine with quantize='int8'; the server with
     --no-continuous (the request-level engine) against the JAX
     `InferenceEngine`.
  3. Three trainer steps against the JAX `Trainer`: the loss includes
     the router aux loss, which the metrics report; the JAX trainer's
     Orbax checkpoint (the router kernel, the expert stacks and their
     Adam moments) converted, resumed and served by name.

Tolerances are tests/test_torch_train.py's; outputs 1e-5 absolute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu import models as jmodels
from skypilot_tpu.infer import engine as jeng
from skypilot_tpu.models import moe as jmoe
from skypilot_tpu.parallel import sharding
from skypilot_tpu_torch import bridge
from skypilot_tpu_torch import models as tmodels
from skypilot_tpu_torch.infer import engine as teng
from skypilot_tpu_torch.infer import server as tserver
from skypilot_tpu_torch.models import moe as tmoe

from test_torch_families import three_steps_match

ENGINE_OV = dict(capacity_factor=0.5, max_seq_len=64, dim=64, ffn_dim=128,
                 dtype='float32')
# Repetitive prompts, so that n-gram self-drafting proposes; the last
# shares the first's two full pages (a prefix hit: only the rest is
# prefilled, in chunks of other sizes than a cold prefill's).
PROMPTS = [[3, 7, 11] * 5 + [5], [9, 4] * 4, list(range(20, 33)),
           [50, 51] * 3, [3, 7, 11] * 5 + [5, 9, 9, 2]]
NEW = 12


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


@pytest.mark.parametrize('capacity_factor', [4.0, 0.3],
                         ids=['ample', 'drops'])
@pytest.mark.parametrize('dispatch', ['dense', 'sparse'])
def test_moe_mlp_matches_reference(dispatch, capacity_factor):
    ov = dict(capacity_factor=capacity_factor, moe_dispatch=dispatch,
              dtype='float32')
    layer = jmoe.MoEMLP(jmoe.get_config('mixtral-tiny', **ov))
    x = np.random.RandomState(1).randn(2, 8, 256).astype(np.float32) * 0.5
    params = sharding.unbox(layer.init(jax.random.PRNGKey(0),
                                       jnp.asarray(x))['params'])
    want, state = layer.apply({'params': params}, jnp.asarray(x),
                              mutable=['intermediates'])
    cfg = tmoe.get_config('mixtral-tiny', **ov)
    mlp = tmoe.MoEMLP(cfg, torch.device('cpu'))
    p = _np(params)
    mlp.load_state_dict({
        'router': torch.from_numpy(p['router']['kernel'].T.copy()),
        **{n: torch.from_numpy(p[n].copy())
           for n in ('gate_proj', 'up_proj', 'down_proj')}})
    got, aux = mlp(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    want_aux = float(state['intermediates']['aux_loss'][0])
    np.testing.assert_allclose(float(aux), want_aux, rtol=1e-5)
    cap = tmoe.capacity(cfg, 16)
    logits = torch.from_numpy(x.reshape(16, 256)) @ mlp.router.t()
    rows = tmoe.dispatch_slots(tmoe.route(cfg, logits)[1], cap, 4)
    assert bool((rows == 4 * cap).any()) == (capacity_factor < 1)


def _spy_drops(monkeypatch):
    """Record (tokens of the call, routes dropped) of every MoE layer."""
    calls = []
    orig = tmoe.dispatch_slots

    def spy(experts, cap, n_experts):
        rows = orig(experts, cap, n_experts)
        calls.append((experts.shape[0], int((rows == n_experts * cap).sum())))
        return rows

    monkeypatch.setattr(tmoe, 'dispatch_slots', spy)
    return calls


@pytest.mark.parametrize('spec_k', [0, 3], ids=['plain', 'ngram'])
def test_paged_engine_streams_match_jax_under_drops(monkeypatch, spec_k):
    kw = dict(model='mixtral-tiny', model_overrides=ENGINE_OV, page_size=8,
              prefill_chunk=8, n_slots=4, spec_k=spec_k)
    je = jeng.ContinuousBatchingEngine(
        **kw, async_pipeline=False, param_dtype=jnp.float32,
        decode_kernel='xla', prefill_kernel='xla')
    want = je.generate(PROMPTS, jeng.SamplingConfig(max_new_tokens=NEW))
    calls = _spy_drops(monkeypatch)
    te = teng.ContinuousBatchingEngine(
        **kw, params=bridge.params_from_jax(_np(je.params), je.config),
        param_dtype=torch.float32, device='cpu')
    assert te.generate(PROMPTS,
                       teng.SamplingConfig(max_new_tokens=NEW)) == want
    step_tokens = 4 * (spec_k + 1)        # a decode or verify step's T
    assert any(t == step_tokens and dropped for t, dropped in calls)
    assert te.prefix_hit_pages > 0
    assert te.spec_steps > 0 if spec_k else te.spec_steps == 0


def test_int8_weights_stream_matches_jax():
    ov = dict(ENGINE_OV, capacity_factor=4.0)
    jmodel, _ = jmodels.get_model('mixtral-tiny', scan_layers=False, **ov)
    tree = _np(sharding.unbox(jmodel.init(
        jax.random.PRNGKey(4), jnp.zeros((1, 8), jnp.int32))['params']))
    kw = dict(model='mixtral-tiny', model_overrides=ov, n_slots=2,
              prefill_chunk=8, page_size=8)
    je = jeng.ContinuousBatchingEngine(
        **kw, params=tree, quantize='int8', async_pipeline=False,
        param_dtype=jnp.float32, decode_kernel='xla', prefill_kernel='xla')
    want = je.generate(PROMPTS, jeng.SamplingConfig(max_new_tokens=NEW))
    cfg = tmodels.get_config('mixtral-tiny', **ov)
    te = teng.ContinuousBatchingEngine(
        **kw, params=bridge.params_from_jax(tree, cfg), quantize='int8',
        param_dtype=torch.float32, device='cpu')
    mlp = te.model.layers[0].moe_mlp
    assert mlp.router.dtype == torch.int8
    assert mlp.router_scale.shape == (cfg.n_experts, 1)
    assert mlp.gate_proj.dtype == torch.float32
    qsd = bridge.params_from_jax(_np(je.params), cfg)
    for key, w in te.model.state_dict().items():
        assert torch.equal(qsd[key], w), key
    assert te.generate(PROMPTS,
                       teng.SamplingConfig(max_new_tokens=NEW)) == want


def test_static_server_stream_matches_jax():
    """--no-continuous (the request-level InferenceEngine): right-padded
    prompts prefilled as one batch, so the pads compete for capacity."""
    jmodel, _ = jmodels.get_model('mixtral-tiny', **ENGINE_OV)
    tree = _np(sharding.unbox(jmodel.init(
        jax.random.PRNGKey(4), jnp.zeros((1, 8), jnp.int32))['params']))
    je = jeng.InferenceEngine(model='mixtral-tiny', params=tree,
                              max_batch_size=2, model_overrides=ENGINE_OV,
                              param_dtype=jnp.float32)
    want = je.generate(PROMPTS[:2], jeng.SamplingConfig(max_new_tokens=NEW))
    srv = tserver.InferenceServer(
        model='mixtral-tiny', continuous=False, max_batch_size=2,
        model_overrides=ENGINE_OV, param_dtype=torch.float32,
        params=bridge.params_from_jax(
            tree, tmodels.get_config('mixtral-tiny', **ENGINE_OV)),
        device='cpu')
    assert isinstance(srv.engine, teng.InferenceEngine)
    assert srv._handle_generate(dict(  # pylint: disable=protected-access
        prompt_ids=PROMPTS[:2], max_new_tokens=NEW))['tokens'] == want


def test_trainer_steps_with_aux_loss_match_jax(tmp_path):
    metrics = three_steps_match('mixtral-tiny', dict(dim=64, ffn_dim=128),
                                tmp_path)
    assert float(metrics['aux_loss']) > 0
