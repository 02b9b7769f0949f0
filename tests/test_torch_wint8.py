"""The port's weight-only int8 serving against the JAX package's, on the CPU.

  1. `quantize_params_int8` on the port's state_dict gives the int8
     weights and f32 scales of the reference's `quantize_params_int8` on
     the flax tree, bit for bit, leaf by leaf (tok_embed and lm_head
     included), for f32 and bf16 parameters; `bridge.params_from_jax`
     reads the reference's quantized tree, unscanned and with its layers
     stacked, into the same state_dict.
  2. `ContinuousBatchingEngine(quantize='int8')` against the JAX engine
     with quantize='int8' on the same float weights: identical greedy
     streams, paged with the int8 KV cache through the kernels' wrappers
     (their plain versions on the CPU; the JAX side runs its Pallas
     kernels in interpret mode) and unpaged ('xla').
  3. Validation: quantize other than None/'int8' raises in both engines,
     and the server's flag takes only 'int8'.

The weights are dequantized as the reference dequantizes them, so the
streams are compared exactly; the quantized tensors bit for bit.
"""
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
from skypilot_tpu_torch.infer import server as tserver

OV = dict(n_layers=2, n_heads=4, n_kv_heads=2, dim=64, ffn_dim=128,
          vocab_size=96, max_seq_len=64, dtype='float32')
PROMPTS = [[5, 17, 3, 42, 8, 60, 2, 11, 9, 33, 21], [9, 1, 77]]
NEW = 8


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    """The suite runs these tests beside XLA:CPU tests on the same cores:
    tiny f32 models need no intra-op threads of their own."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def float_tree():
    """Unscanned JAX llama-tiny params (numpy), one output column of a
    kernel zeroed so that the 1e-8 scale floor is reached."""
    model = jllama.Llama(jllama.get_config('llama-tiny', **OV,
                                           scan_layers=False))
    params = sharding.unbox(model.init(jax.random.PRNGKey(3),
                                       jnp.zeros((1, 8), jnp.int32))['params'])
    tree = jax.tree.map(np.array, params)
    tree['layer_1']['mlp']['up_proj']['kernel'][:, 7] = 0.0
    return tree


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_quantize_params_int8_bit_identical(float_tree, dtype):
    cfg = jllama.get_config('llama-tiny', **OV)
    cast = jax.tree.map(lambda x: jnp.asarray(x, getattr(jnp, dtype)),
                        float_tree)
    want = bridge.params_from_jax(
        jax.tree.map(np.asarray, jeng.quantize_params_int8(cast)), cfg)
    # The bridge widens bf16 to f32 exactly: narrow it back.
    sd = {k: v.to(getattr(torch, dtype))
          for k, v in bridge.params_from_jax(cast, cfg).items()}
    got = teng.quantize_params_int8(sd)
    assert sorted(got) == sorted(want)
    assert got['tok_embed_scale'].shape == (1, OV['dim'])
    assert got['lm_head_scale'].shape == (OV['vocab_size'], 1)
    assert got['layers.1.mlp.up_proj_scale'][7, 0] == np.float32(
        jnp.asarray(1e-8, getattr(jnp, dtype)))
    for key, w in want.items():
        if key.endswith('_scale'):
            assert got[key].dtype == w.dtype == torch.float32, key
        elif w.dim() >= 2:
            assert got[key].dtype == w.dtype == torch.int8, key
            assert w.abs().max() == 127, key
        else:     # a norm: float, as it was (the bridge widens bf16)
            w, got[key] = w.float(), got[key].float()
        assert torch.equal(got[key], w), key
    # The same quantized tree with its layers stacked (the scanned
    # layout) reads the same.
    qtree = jax.tree.map(np.asarray, jeng.quantize_params_int8(cast))
    layers = [qtree.pop(f'layer_{i}') for i in range(OV['n_layers'])]
    qtree['layers'] = jax.tree.map(lambda *x: np.stack(x), *layers)
    stacked = bridge.params_from_jax(qtree, cfg)
    assert all(torch.equal(stacked[k], w) for k, w in want.items())


@pytest.mark.parametrize('paged', [True, False], ids=['paged_int8_kv',
                                                      'unpaged'])
def test_wint8_engine_greedy_matches_jax(float_tree, paged):
    cfg = jllama.get_config('llama-tiny', **OV)
    kw = dict(model='llama-tiny', model_overrides=OV, n_slots=2,
              prefill_chunk=8)
    if paged:
        kw.update(page_size=8, kv_cache_dtype='int8')
    kern = 'fused' if paged else 'xla'
    je = jeng.ContinuousBatchingEngine(
        **kw, params=float_tree, quantize='int8', async_pipeline=False,
        param_dtype=jnp.float32, decode_kernel=kern, prefill_kernel=kern)
    want = je.generate(PROMPTS, jeng.SamplingConfig(max_new_tokens=NEW))
    te = teng.ContinuousBatchingEngine(
        **kw, params=bridge.params_from_jax(float_tree, cfg),
        quantize='int8', param_dtype=torch.float32, decode_kernel=kern,
        prefill_kernel=kern, device='cpu')
    assert te.model.layers[0].attention.q_proj.dtype == torch.int8
    assert te.model.tok_embed.dtype == torch.int8
    assert te.model.lm_head.dtype == torch.int8
    assert te.generate(PROMPTS, teng.SamplingConfig(max_new_tokens=NEW)) \
        == want


def test_quantize_validation():
    for cls in (teng.ContinuousBatchingEngine, teng.InferenceEngine):
        with pytest.raises(ValueError, match='quantize'):
            cls(model='llama-tiny', model_overrides=OV, quantize='fp4',
                device='cpu')
    args = tserver.build_parser().parse_args(['--quantize', 'int8'])
    assert args.quantize == 'int8'
    with pytest.raises(SystemExit):
        tserver.build_parser().parse_args(['--quantize', 'fp4'])
