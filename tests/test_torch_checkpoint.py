"""The port's checkpoints (train/checkpoint.py), on the CPU, at f32, all
in pytest's tmp_path.

  - save, a fresh Trainer, `restore_or_init` and two more steps equal
    four uninterrupted steps bit for bit (losses, parameters, AdamW
    moments), full and LoRA `train_only` training, llama-tiny and
    gemma-tiny at head width 256 (softcapped, the tied head);
  - a base checkpoint without adapters opened by a LoRA `train_only`
    trainer loads through the params-only partial restore, as the
    reference's tests/unit_tests/test_lora.py:128-169 holds: base params
    equal to the saved ones, every adapter b zero, step 0, the first
    logits the base model's bit for bit, and it trains;
  - a restore of a mismatched tree without `train_only` raises (and
    leaves the checkpoints), `max_to_keep` keeps the newest steps;
  - `python -m skypilot_tpu_torch.train --checkpoint-dir` resumes
    token-exact at the restored step (`start_step`);
  - engines and the server given `checkpoint_dir` serve the greedy
    streams of the same params given in memory, a LoRA checkpoint
    included;
  - scripts/orbax_to_torch.py converts a checkpoint that the reference's
    own `checkpoint.save` wrote: the port's logits are the JAX model's
    (1e-4 absolute), and the converted AdamW state resumes the JAX run
    (one more step: loss 1e-5 relative, params 2e-6 absolute, as
    tests/test_torch_train.py); the same for a JAX gemma-tiny run at
    head width 256 (full training: the tied tok_embed's Adam moments
    too).
"""
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.parallel import mesh as jmesh
from skypilot_tpu.train import checkpoint as jckpt
from skypilot_tpu.train import data as jdata
from skypilot_tpu.train import trainer as jtrainer
from skypilot_tpu_torch import bridge
from skypilot_tpu_torch import models as tmodels
from skypilot_tpu_torch.infer import engine as teng
from skypilot_tpu_torch.infer import server as tserver
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.train import __main__ as tmain
from skypilot_tpu_torch.train import checkpoint as ckpt
from skypilot_tpu_torch.train import data as tdata
from skypilot_tpu_torch.train import trainer as ttrainer

SEQ = 16
OV = dict(n_heads=4, n_kv_heads=2, max_seq_len=SEQ, dtype='float32')
LORA = dict(lora_rank=4, remat_policy='save_attn')
# gemma-tiny at head width 256 (2 heads over 1), softcapped.
GEMMA_OV = dict(head_dim=256, n_heads=2, n_kv_heads=1, dim=128, n_layers=2,
                final_logit_softcap=30.0, max_seq_len=SEQ, dtype='float32')
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    """The suite runs these tests beside XLA:CPU tests on the same cores:
    tiny f32 models need no intra-op threads of their own."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(lora=False, model='llama-tiny', **kw):
    ov = dict(OV if model == 'llama-tiny' else GEMMA_OV,
              **(LORA if lora else {}))
    return ttrainer.TrainConfig(
        model=model, global_batch_size=2, seq_len=SEQ, warmup_steps=1,
        total_steps=10, model_overrides=ov,
        train_only='lora' if lora else None, **kw)


def _trainer(lora=False, model='llama-tiny', **kw):
    return ttrainer.Trainer(_config(lora=lora, model=model, **kw),
                            device='cpu')


def _stream(start=0):
    return tdata.synthetic_data(2, SEQ, 512, start_step=start, device='cpu')


def _equal_state(a, b):
    for name, t in a.model.state_dict().items():
        assert torch.equal(t, b.model.state_dict()[name]), name
    assert a.opt_state.count == b.opt_state.count
    for moment in ('mu', 'nu'):
        got, want = getattr(a.opt_state, moment), getattr(b.opt_state,
                                                           moment)
        assert set(got) == set(want)
        for name, t in got.items():
            assert torch.equal(t, want[name]), (moment, name)


@pytest.mark.parametrize('lora,model', [
    (False, 'llama-tiny'), (True, 'llama-tiny'), (False, 'gemma-tiny'),
    (True, 'gemma-tiny'),
], ids=['full', 'lora', 'gemma-d256-full', 'gemma-d256-lora'])
def test_resume_equals_uninterrupted(tmp_path, lora, model):
    whole = _trainer(lora, model)
    whole.init_state()
    it = _stream()
    want = [float(whole.step(next(it))['loss']) for _ in range(4)]

    first = _trainer(lora, model)
    first.init_state()
    it = _stream()
    got = [float(first.step(next(it))['loss']) for _ in range(2)]
    manager = ckpt.make_manager(str(tmp_path))
    assert ckpt.save(manager, first, wait=True) == 2
    assert manager.all_steps() == [2]
    assert {n for n in os.listdir(tmp_path / '2')} == {
        'params.pt', 'opt_state.pt', 'step.pt'}

    resumed = _trainer(lora, model)
    assert ckpt.restore_or_init(ckpt.make_manager(str(tmp_path)),
                                resumed) == 2
    it = _stream(resumed.step_count)
    got += [float(resumed.step(next(it))['loss']) for _ in range(2)]
    assert got == want
    _equal_state(resumed, whole)
    if lora:
        assert set(resumed.opt_state.mu) == set(resumed.trainable_params())
        assert all(tllama.is_lora(n) for n in resumed.opt_state.mu)


@pytest.mark.parametrize('params_only', [False, True],
                         ids=['trainer-checkpoint', 'params-only'])
def test_base_checkpoint_into_lora(tmp_path, params_only):
    base = _trainer()
    base.init_state()
    base.step(next(_stream()))
    manager = ckpt.make_manager(str(tmp_path))
    if params_only:
        ckpt.save_params(manager, base.model.state_dict(), step=7)
    else:
        ckpt.save(manager, base)
    saved = {k: v.clone() for k, v in base.model.state_dict().items()}

    fresh = _trainer(lora=True)
    fresh.init_state()
    lora = _trainer(lora=True)
    assert ckpt.restore_or_init(manager, lora) == 0
    assert lora.step_count == 0
    sd = lora.model.state_dict()
    for name, t in saved.items():
        assert torch.equal(sd[name], t), name
    adapters = {n: t for n, t in sd.items() if tllama.is_lora(n)}
    assert adapters and set(adapters) == set(sd) - set(saved)
    for name, t in adapters.items():
        if name.endswith('.b'):
            assert not t.any(), name
        else:                     # a keeps its init
            assert torch.equal(t, fresh.model.state_dict()[name]), name
    assert set(lora.opt_state.mu) == set(adapters)
    tok = next(_stream())['inputs']
    with torch.no_grad():
        assert torch.equal(lora.model.train_forward(tok),
                           base.model.train_forward(tok))
    m = lora.step(next(_stream()))
    assert np.isfinite(float(m['loss'])) and lora.step_count == 1
    for name, t in saved.items():
        assert torch.equal(lora.model.state_dict()[name], t), name


def test_mismatched_restore_raises(tmp_path):
    lora = _trainer(lora=True)
    lora.init_state()
    manager = ckpt.make_manager(str(tmp_path))
    ckpt.save(manager, lora)
    plain = _trainer()
    with pytest.raises(ValueError, match='does not match the live tree'):
        ckpt.restore_or_init(manager, plain)
    assert manager.all_steps() == [0]
    # A params-only checkpoint cannot resume a trainer without train_only.
    only = ckpt.make_manager(str(tmp_path / 'params'))
    ckpt.save_params(only, plain.model.state_dict())
    with pytest.raises(FileNotFoundError, match='opt_state'):
        ckpt.restore_or_init(only, _trainer())
    assert ckpt.restore(ckpt.make_manager(str(tmp_path / 'none')),
                        plain) is None


def test_max_to_keep_and_periodic_saves(tmp_path):
    t = _trainer(lora=True)
    t.init_state()
    os.makedirs(tmp_path / '.tmp-9')        # a save cut short
    manager = ckpt.make_manager(str(tmp_path), max_to_keep=2)
    t.train(_stream(), num_steps=5, log_every=5, checkpoint_manager=manager,
            checkpoint_every=2)
    assert manager.all_steps() == [2, 4]
    assert ckpt.save(manager, t) == 5
    assert manager.all_steps() == [4, 5] and manager.latest_step() == 5
    assert not manager.save(5, {'step': torch.tensor(5)})
    assert int(manager.load(5, ckpt.STEP)) == 5


def _cli(*extra):
    return tmain.main(['--device', 'cpu', '--model', 'llama-tiny',
                       '--model-overrides',
                       '{"n_heads": 4, "n_kv_heads": 2, "lora_rank": 4, '
                       '"remat_policy": "save_attn"}',
                       '--train-only', 'lora', '--loss-chunk', '8',
                       '--global-batch-size', '2', '--seq-len', str(SEQ),
                       '--log-every', '1', *extra])


def test_cli_resume_is_token_exact(tmp_path):
    whole = _cli('--steps', '4', '--checkpoint-dir', str(tmp_path / 'a'))
    first = _cli('--steps', '2', '--checkpoint-dir', str(tmp_path / 'b'),
                 '--checkpoint-every', '1')
    assert first['start_step'] == 0
    assert ckpt.make_manager(str(tmp_path / 'b')).all_steps() == [1, 2]
    rest = _cli('--steps', '4', '--checkpoint-dir', str(tmp_path / 'b'))
    assert rest['start_step'] == 2 and rest['step'] == 4
    losses = [r['loss'] for r in first['history'] + rest['history']]
    assert losses == [r['loss'] for r in whole['history']]
    a = ckpt.load_params_for_serving(ckpt.make_manager(str(tmp_path / 'a')))
    b = ckpt.load_params_for_serving(ckpt.make_manager(str(tmp_path / 'b')))
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    # Nothing is left to run: the resumed run only saves.
    again = _cli('--steps', '4', '--checkpoint-dir', str(tmp_path / 'b'))
    assert again['start_step'] == 4 and again['history'] == []


SERVE_OV = dict(n_layers=2, n_heads=4, n_kv_heads=2, dim=64, ffn_dim=128,
                vocab_size=96, max_seq_len=64, dtype='float32', lora_rank=4)
PROMPTS = [[5, 17, 3, 42, 8, 60, 2, 11, 9, 33, 21], [9, 1, 77]]


def test_engines_serve_a_checkpoint(tmp_path):
    """A trained LoRA checkpoint (adapters moved off zero) through the
    paged engine, the request-level engine and the CLI's server."""
    t = ttrainer.Trainer(ttrainer.TrainConfig(
        model='llama-tiny', global_batch_size=2, seq_len=SEQ,
        warmup_steps=1, learning_rate=1e-2, train_only='lora',
        model_overrides=dict(SERVE_OV, max_seq_len=SEQ)), device='cpu')
    t.init_state()
    stream = tdata.synthetic_data(2, SEQ, 96, device='cpu')
    for _ in range(3):
        t.step(next(stream))
    sd = {k: v.detach().clone() for k, v in t.model.state_dict().items()}
    assert all(sd[n].any() for n in sd if n.endswith('_lora.b'))
    ckpt.save(ckpt.make_manager(str(tmp_path)), t)
    sampling = teng.SamplingConfig(max_new_tokens=8)
    kw = dict(model_overrides=SERVE_OV, param_dtype=torch.float32,
              device='cpu')
    paged = dict(n_slots=2, page_size=8, prefill_chunk=8,
                 async_pipeline=False)
    want = teng.ContinuousBatchingEngine(params=sd, **paged, **kw).generate(
        PROMPTS, sampling)
    eng = teng.ContinuousBatchingEngine(checkpoint_dir=str(tmp_path),
                                        **paged, **kw)
    assert eng.loaded_real_weights
    assert eng.generate(PROMPTS, sampling) == want
    static = teng.InferenceEngine(params=sd, **kw).generate(PROMPTS,
                                                            sampling)
    assert teng.InferenceEngine(checkpoint_dir=str(tmp_path),
                                **kw).generate(PROMPTS, sampling) == static
    srv = tserver.server_from_args([
        '--device', 'cpu', '--no-continuous', '--checkpoint-dir',
        str(tmp_path), '--model-overrides', '{"n_layers": 2, "n_heads": 4, '
        '"n_kv_heads": 2, "dim": 64, "ffn_dim": 128, "vocab_size": 96, '
        '"max_seq_len": 64, "dtype": "float32", "param_dtype": "float32", '
        '"lora_rank": 4}'])
    assert srv._handle_generate({'prompt_ids': PROMPTS,
                                 'max_new_tokens': 8}) == {'tokens': static}
    with pytest.raises(ValueError, match='does not match model'):
        teng.ContinuousBatchingEngine(
            checkpoint_dir=str(tmp_path), **paged,
            **dict(kw, model_overrides=dict(SERVE_OV, lora_rank=0)))
    with pytest.raises(FileNotFoundError):
        teng.InferenceEngine(checkpoint_dir=str(tmp_path / 'none'), **kw)
    with pytest.raises(ValueError, match='randomly initialized'):
        tserver.InferenceServer(model_overrides=SERVE_OV, device='cpu')


def _orbax_to_torch():
    spec = importlib.util.spec_from_file_location(
        'orbax_to_torch', os.path.join(ROOT, 'scripts', 'orbax_to_torch.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_orbax_checkpoint_converts(tmp_path):
    """A JAX LoRA trainer's checkpoint, written by the reference's own
    `checkpoint.save`, converted by scripts/orbax_to_torch.py: the
    params give the JAX model's logits, and the whole checkpoint resumes
    the JAX run in the port."""
    _orbax_converts_and_resumes(tmp_path, 'llama-tiny',
                                dict(OV, lora_rank=4), 'lora')


def test_orbax_gemma_checkpoint_converts(tmp_path):
    """The same for a JAX gemma-tiny run at head width 256, softcapped,
    every parameter trained (no lm_head: the tied tok_embed and its Adam
    moments convert once)."""
    _orbax_converts_and_resumes(tmp_path, 'gemma-tiny', GEMMA_OV, None)


def _orbax_converts_and_resumes(tmp_path, model_name, ov, train_only):
    mesh = jmesh.make_mesh(jmesh.MeshConfig(), devices=jax.devices()[:1])
    jt = jtrainer.Trainer(jtrainer.TrainConfig(
        model=model_name, global_batch_size=2, seq_len=SEQ, warmup_steps=1,
        total_steps=10, model_overrides=ov, train_only=train_only),
        mesh=mesh)
    jt.init_state()
    jit = jdata.synthetic_data(jt.mesh, global_batch_size=2, seq_len=SEQ,
                               vocab_size=512)
    for _ in range(2):
        jt.step(next(jit))
    manager = jckpt.make_manager(str(tmp_path / 'orbax'))
    jckpt.save(manager, jt.state, wait=True)
    manager.close()
    script = _orbax_to_torch()
    overrides = json.dumps(ov)
    named = ['--model', model_name]
    assert script.main(['--src', str(tmp_path / 'orbax'), '--dst',
                        str(tmp_path / 'port'), '--model-overrides',
                        overrides, *named]) == 2
    assert script.main(['--src', str(tmp_path / 'orbax'), '--dst',
                        str(tmp_path / 'serve'), '--model-overrides',
                        overrides, '--params-only', *named]) == 0
    model, cfg = tmodels.get_model(model_name, device='cpu', **ov)
    model.load_state_dict(ckpt.load_params_for_serving(
        ckpt.make_manager(str(tmp_path / 'serve'))))
    tok = np.random.RandomState(0).randint(0, 512, (2, SEQ)).astype(
        np.int32)
    want = np.asarray(jt.model.apply({'params': jt.state.params},
                                     jnp.asarray(tok)))
    with torch.no_grad():
        got = model.train_forward(torch.from_numpy(tok))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    # Resume: the port's next step is the JAX trainer's next step.
    tt = ttrainer.Trainer(ttrainer.TrainConfig(
        model=model_name, global_batch_size=2, seq_len=SEQ, warmup_steps=1,
        total_steps=10, model_overrides=ov, train_only=train_only),
        device='cpu')
    assert ckpt.restore_or_init(ckpt.make_manager(str(tmp_path / 'port')),
                                tt) == 2
    jm = jt.step(next(jit))
    tm = tt.step(next(tdata.synthetic_data(2, SEQ, 512, start_step=2,
                                           device='cpu')))
    np.testing.assert_allclose(float(tm['loss']), float(jm['loss']),
                               rtol=1e-5)
    want_sd = bridge.params_from_jax(jax.tree.map(np.asarray,
                                                  jt.state.params), cfg)
    for name, p in tt.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_sd[name].numpy(),
                                   atol=2e-6, rtol=0, err_msg=name)
