"""The port's request-level engine (`InferenceEngine`, the server's
--no-continuous) against the JAX package's, on the CPU.

  1. Two prompts of different lengths through the port's InferenceEngine,
     built by `InferenceServer(continuous=False)` and driven through its
     /generate handler (no socket), and through the JAX
     `InferenceEngine.generate` on the same weights: identical greedy
     streams, with float weights and with quantize='int8', and with an
     eos that stops one row early.
  2. page_size > 0 raises the reference's RuntimeError at generate.
  3. --no-continuous with a continuous-only flag (--decode-kernel,
     --prefill-kernel, --page-size) is refused at startup with a
     ValueError, before any model is built; --prefill-chunk is accepted
     and unused, as by the reference's server.
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
    model = jllama.Llama(jllama.get_config('llama-tiny', **OV))
    return jax.tree.map(np.asarray, sharding.unbox(model.init(
        jax.random.PRNGKey(4), jnp.zeros((1, 8), jnp.int32))['params']))


@pytest.mark.parametrize('quantize', [None, 'int8'])
def test_static_engine_matches_jax(float_tree, quantize):
    je = jeng.InferenceEngine(
        model='llama-tiny', params=float_tree, max_batch_size=2,
        model_overrides=OV, param_dtype=jnp.float32, quantize=quantize)
    want = je.generate(PROMPTS, jeng.SamplingConfig(max_new_tokens=NEW))
    srv = tserver.InferenceServer(
        model='llama-tiny', continuous=False, max_batch_size=2,
        model_overrides=OV, param_dtype=torch.float32, quantize=quantize,
        params=bridge.params_from_jax(float_tree, je.config), device='cpu')
    assert isinstance(srv.engine, teng.InferenceEngine)
    got = srv._handle_generate(dict(prompt_ids=PROMPTS,  # pylint: disable=protected-access
                                    max_new_tokens=NEW))['tokens']
    assert got == want
    # An eos that one row emits mid-stream stops that row there only.
    eos = want[0][3]
    cfg = dict(max_new_tokens=NEW, eos_id=eos)
    want_eos = je.generate(PROMPTS, jeng.SamplingConfig(**cfg))
    assert want_eos[0] == want[0][:want[0].index(eos) + 1]
    assert srv.engine.generate(PROMPTS, teng.SamplingConfig(**cfg)) == \
        want_eos


def test_static_engine_refuses_pages():
    eng = teng.InferenceEngine(model='llama-tiny', model_overrides=OV,
                               max_batch_size=2, page_size=8,
                               prefill_bucket=8, device='cpu')
    with pytest.raises(RuntimeError, match='ContinuousBatchingEngine'):
        eng.generate(PROMPTS)


def test_no_continuous_refuses_continuous_flags():
    for flag, kw in (('--decode-kernel', dict(decode_kernel='fused')),
                     ('--prefill-kernel', dict(prefill_kernel='xla')),
                     ('--page-size', dict(page_size=8))):
        with pytest.raises(ValueError, match=f'^{flag} requires continuous'):
            # model='missing' would fail if an engine were built.
            tserver.InferenceServer(model='missing', continuous=False,
                                    allow_random_weights=True, device='cpu',
                                    **kw)
    srv = tserver.InferenceServer(model='llama-tiny', continuous=False,
                                  model_overrides=OV, prefill_chunk=8,
                                  allow_random_weights=True, device='cpu')
    assert isinstance(srv.engine, teng.InferenceEngine)
    args = tserver.build_parser().parse_args(['--no-continuous'])
    assert args.continuous is False
