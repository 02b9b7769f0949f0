"""Speculative decoding in the port against the JAX package, on the CPU.

The same weights (`bridge.params_from_jax`) and prompts through both
packages, at f32 on tiny widths (2 layers, 4 heads over 2 KV heads,
dim 64, vocab 96):
  - `ngram_propose` and the greedy acceptance (out, counts) equal the
    reference's exactly;
  - sampled acceptance keeps the filtered target's distribution: the
    first committed token's frequency over 4000 rows, each with its own
    generator, within total variation 0.05 of softmax(filter_logits_rows)
    (the reference's own limit; sampling noise at n = 4000 over 8 tokens
    is about 0.02), with both the accept and the leftover branch taken
    and the leftover never the rejected token;
  - one S = 5 paged slot forward (rows at different bases, one whose
    window passes max_len, one whose window reaches table entries that
    point at the null page) gives the reference's logits within 1e-5
    absolute and the same K/V in every real page;
  - the port's speculating engines (n-gram and a same-config draft
    model, paged and contiguous, and an int8 cache through the kernels'
    plain versions) give the JAX plain engine's greedy streams token for
    token (the int8 cache: the JAX engine running its Pallas kernels in
    interpret mode), with no page leaked;
  - an eos inside an accepted run ends the request there, and
    max_new_tokens=1 runs no verify;
  - a draft of another vocabulary, and the flags speculation cannot
    take, are refused; a draft loads from a port checkpoint.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.infer import engine as jeng
from skypilot_tpu.infer import speculative as jspec
from skypilot_tpu.models import llama as jllama
from skypilot_tpu.parallel import sharding
from skypilot_tpu_torch import bridge
from skypilot_tpu_torch.infer import engine as teng
from skypilot_tpu_torch.infer import server as tserver
from skypilot_tpu_torch.infer import speculative as tspec
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.train import checkpoint as tckpt

PS = 8
K = 4
OV = dict(n_layers=2, n_heads=4, n_kv_heads=2, dim=64, ffn_dim=128,
          vocab_size=96, max_seq_len=128, dtype='float32')
# Repetitive prompts, so that n-gram self-drafting proposes.
PROMPTS = [[5, 17, 3, 42, 5, 17, 3, 9, 5, 17, 3], [9, 1, 4, 9, 1, 4]]
NEW = 12


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    """The suite runs these tests beside XLA:CPU tests on the same cores:
    tiny f32 models need no intra-op threads of their own."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_engine(**kw):
    kern = 'fused' if kw.get('kv_cache_dtype') == 'int8' else 'xla'
    return jeng.ContinuousBatchingEngine(
        'llama-tiny', model_overrides=OV, n_slots=2, prefill_bucket=PS,
        async_pipeline=False, param_dtype=jnp.float32, decode_kernel=kern,
        prefill_kernel=kern, **kw)


@pytest.fixture(scope='module')
def reference():
    """The JAX plain engine's weights (as a port state_dict) and its
    greedy streams of PROMPTS."""
    je = _jax_engine()
    sd = bridge.params_from_jax(jax.tree.map(np.asarray, je.params),
                                je.config)
    return sd, je.generate(PROMPTS, jeng.SamplingConfig(max_new_tokens=NEW))


def _port(sd, mode, **kw):
    """A speculating port engine on the reference's weights; 'draft'
    drafts with a model of the target's config and weights, so that it
    accepts and multi-token commits run."""
    if mode == 'draft':
        kw.update(draft_model='llama-tiny', draft_overrides=OV,
                  draft_params=sd)
    return teng.ContinuousBatchingEngine(
        'llama-tiny', model_overrides=OV, n_slots=2, prefill_bucket=PS,
        params=sd, param_dtype=torch.float32, spec_k=K, device='cpu', **kw)


@pytest.mark.parametrize('context', [
    [7, 8, 9, 1, 5, 7, 8], [2, 5, 2, 6, 2, 7, 2], [1, 2, 3, 4, 1, 2, 3, 4, 1],
], ids=['longest_suffix', 'most_recent', 'periodic'])
def test_ngram_propose_matches_jax(context):
    for k in (0, 1, 2, 4):
        for n in range(len(context) + 1):
            assert tspec.ngram_propose(context[:n], k) == \
                jspec.ngram_propose(context[:n], k)


def test_greedy_acceptance_matches_jax():
    v, b = 16, 5
    logits = np.random.RandomState(0).randn(b, K + 1, v).astype(
        np.float32) * 2
    am = logits.argmax(-1)
    # Row i breaks the argmax chain at proposal i (row K keeps it whole);
    # the last row has only 2 real proposals.
    drafts = np.array(am[:, :K])
    for i in range(K):
        drafts[i, i] = (drafts[i, i] + 1) % v
    n_prop = np.array([K] * (b - 1) + [2])
    zeros = np.zeros((b,), np.int32)
    want = jspec.accept_draft_rows(
        jnp.asarray(logits), jnp.asarray(drafts, jnp.int32),
        jnp.asarray(n_prop, jnp.int32), zeros, zeros,
        jnp.zeros((b,), jnp.float32), zeros, jnp.ones((b,), jnp.float32),
        max_k=0, use_top_p=False)
    got = tspec.accept_draft_rows(
        torch.from_numpy(logits), torch.from_numpy(drafts).long(),
        torch.from_numpy(n_prop), [None] * b, torch.zeros(b),
        torch.zeros(b, dtype=torch.long), torch.ones(b), max_k=0,
        use_top_p=False)
    assert got[1].tolist() == np.asarray(want[1]).tolist() == [1, 2, 3, 4,
                                                                 3]
    assert got[0].tolist() == np.asarray(want[0]).tolist()


def test_sampled_acceptance_keeps_the_target_distribution():
    v, k, n = 8, 3, 4000
    logits = torch.from_numpy(
        np.random.RandomState(3).randn(1, k + 1, v).astype(np.float32) * 2)
    temps, top_ks, top_ps = (torch.full((n,), 0.8), torch.zeros(n).long(),
                             torch.ones(n))
    target = torch.softmax(teng.filter_logits_rows(
        logits[:, 0], temps[:1], top_ks[:1], top_ps[:1], max_k=0,
        use_top_p=False), dim=-1)[0].numpy()
    drafts = torch.tensor([[2, 5, 1]]).expand(n, k)
    out, counts = tspec.accept_draft_rows(
        logits.expand(n, k + 1, v), drafts, torch.full((n,), k),
        [tspec.verify_generator(seed, 0, torch.device('cpu'))
         for seed in range(n)], temps, top_ks, top_ps, max_k=0,
        use_top_p=False)
    freq = np.bincount(out[:, 0].numpy(), minlength=v) / n
    tv = 0.5 * np.abs(freq - target).sum()
    assert tv < 0.05, (tv, freq, target)
    accepted = counts.numpy() - 1
    assert accepted.max() > 0 and accepted.min() < k
    # A row that rejected its first proposal never resamples it.
    rejected = accepted == 0
    assert rejected.any() and (out[rejected, 0] != 2).all()


def _paged_models():
    n_pages = 2 * (64 // PS) + 1
    ov = dict(OV, max_seq_len=64)
    jcfg = jllama.get_config('llama-tiny', **ov, scan_layers=False,
                             decode=True, remat=False, kv_page_size=PS,
                             kv_n_pages=n_pages)
    jmodel = jllama.Llama(jcfg)
    params = sharding.unbox(jmodel.init(
        jax.random.PRNGKey(3), jnp.zeros((1, 1), jnp.int32))['params'])
    tcfg = tllama.get_config('llama-tiny', **ov, param_dtype='float32',
                             kv_page_size=PS, kv_n_pages=n_pages)
    tmodel = tllama.Llama(tcfg, torch.device('cpu'))
    tmodel.load_state_dict(bridge.params_from_jax(
        jax.tree.map(np.asarray, params), tcfg))
    return jmodel, params, tmodel, tcfg


def test_verify_forward_matches_jax():
    """S = 5 queries a row: row 0 at base 20; row 1 at base 61, whose
    queries 3 and 4 sit past max_len (64) and must go to the null page,
    not wrap into its last page; row 2 at base 14 with pages for [0, 16)
    only, so that queries 2-4 write and read table entries that point at
    the null page.  Rows 1 and 2 both write null-page offsets 0 and 1,
    and which write lands last is undefined (in both packages), so row
    2's queries 2-4, which read them, are not compared."""
    jmodel, params, tmodel, tcfg = _paged_models()
    rng = np.random.RandomState(5)
    b, s, pps = 3, K + 1, 64 // PS
    bases = np.array([20, 61, 14])
    pages = rng.permutation(np.arange(1, tcfg.kv_n_pages))
    table = np.zeros((b, pps), np.int32)
    table[0, :4] = pages[:4]
    table[1, :] = pages[4:12]
    table[2, :2] = pages[12:14]
    kv_mask = np.arange(64)[None, :] <= bases[:, None]
    tokens = rng.randint(0, 96, (b, s))
    positions = bases[:, None] + np.arange(s)
    pools = {name: rng.randn(tcfg.n_layers, tcfg.kv_n_pages, 2, PS, 16
                             ).astype(np.float32)
             for name in ('page_key', 'page_value')}
    jcache = {f'layer_{i}': {'attention': {
        'block_table': jnp.asarray(table), 'cache_index': jnp.int32(0),
        **{name: jnp.asarray(x[i]) for name, x in pools.items()}}}
        for i in range(tcfg.n_layers)}
    with jllama.slot_mode(), jllama.kv_read_bucket(64), \
            jllama.decode_kernel('xla'):
        want, mutated = jmodel.apply(
            {'params': params, 'cache': jcache}, jnp.asarray(tokens),
            jnp.asarray(positions), jnp.asarray(kv_mask), mutable=['cache'])
    tcache = tllama.PagedCache(
        torch.from_numpy(pools['page_key'].copy()),
        torch.from_numpy(pools['page_value'].copy()),
        torch.from_numpy(table))
    defined = np.ones((b, s), bool)
    defined[2, 2:] = False
    for kernel in ('fused', 'xla'):
        got = tmodel(torch.from_numpy(tokens), torch.from_numpy(positions),
                     tcache, torch.from_numpy(kv_mask), kernel=kernel)
        np.testing.assert_allclose(got.numpy()[defined],
                                   np.asarray(want)[defined], atol=1e-5,
                                   rtol=0)
    # Every real page holds what the reference wrote, to f32 rounding
    # of the projections (the null page's contents are whatever write
    # landed last).
    for i in range(tcfg.n_layers):
        att = mutated['cache'][f'layer_{i}']['attention']
        for got, name in ((tcache.key, 'page_key'),
                          (tcache.value, 'page_value')):
            np.testing.assert_allclose(got[i, 1:].numpy(),
                                       np.asarray(att[name])[1:],
                                       atol=1e-5, rtol=0)


@pytest.mark.parametrize('page_size', [0, PS], ids=['contiguous', 'paged'])
def test_spec_streams_equal_jax_plain(reference, page_size):
    sd, want = reference
    for mode in ('ngram', 'draft'):
        eng = _port(sd, mode, page_size=page_size)
        assert eng.generate(
            PROMPTS, teng.SamplingConfig(max_new_tokens=NEW)) == want, mode
        info = eng.speculation_info()
        assert info['mode'] == mode and info['proposed_tokens'] > 0
        if mode == 'draft':
            # Multi-token commits ran: far fewer verifies than tokens.
            assert info['acceptance_rate'] > 0.9
            assert info['steps'] < sum(len(w) for w in want) / 2
        assert eng.allocator_leak_report() is None


def test_spec_int8_cache_equals_jax_fused():
    je = _jax_engine(kv_cache_dtype='int8', page_size=PS)
    want = je.generate(PROMPTS, jeng.SamplingConfig(max_new_tokens=NEW))
    sd = bridge.params_from_jax(jax.tree.map(np.asarray, je.params),
                                je.config)
    for mode in ('ngram', 'draft'):
        eng = _port(sd, mode, page_size=PS, kv_cache_dtype='int8',
                    decode_kernel='fused', prefill_kernel='fused')
        assert eng.generate(
            PROMPTS, teng.SamplingConfig(max_new_tokens=NEW)) == want, mode
        assert eng.allocator_leak_report() is None


def test_eos_inside_accepted_run_and_one_token_budget(reference):
    sd, want = reference
    eng = _port(sd, 'draft', page_size=PS)
    je = _jax_engine()
    eos = want[0][len(want[0]) // 2]
    cfg = dict(max_new_tokens=NEW, eos_id=eos)
    got = eng.generate(PROMPTS[:1], teng.SamplingConfig(**cfg))
    assert got == je.generate(PROMPTS[:1], jeng.SamplingConfig(**cfg))
    assert got[0][-1] == eos and len(got[0]) < NEW
    # The first token, sampled at prefill end, is the whole request.
    steps = eng.speculation_info()['steps']
    assert eng.generate(PROMPTS, teng.SamplingConfig(max_new_tokens=1)) \
        == [w[:1] for w in want]
    assert eng.speculation_info()['steps'] == steps
    assert eng.allocator_leak_report() is None


def test_spec_arguments_refused(reference, tmp_path):
    sd, _ = reference
    with pytest.raises(ValueError, match='tokenizer family'):
        _port(sd, 'ngram', draft_model='llama-tiny',
              draft_overrides=dict(OV, vocab_size=48))
    with pytest.raises(ValueError, match='spec_k'):
        teng.ContinuousBatchingEngine(
            'llama-tiny', model_overrides=OV, params=sd,
            param_dtype=torch.float32, draft_model='llama-tiny',
            device='cpu')
    for flags in (dict(spec_k=2), dict(prefill_mix_budget=8)):
        with pytest.raises(ValueError, match='--no-continuous'):
            tserver.InferenceServer(
                model='llama-tiny', model_overrides=OV, params=sd,
                continuous=False, device='cpu', **flags)
    # A draft loads its weights from a port checkpoint.
    tckpt.save_params(tckpt.make_manager(str(tmp_path)), sd)
    srv = tserver.InferenceServer(
        model='llama-tiny', model_overrides=OV, params=sd, spec_k=2,
        draft_model='llama-tiny', draft_overrides=OV,
        draft_checkpoint_dir=str(tmp_path), param_dtype=torch.float32,
        device='cpu')
    draft = srv.engine._draft.model.state_dict()
    assert set(draft) == set(sd)
    assert all(torch.equal(draft[k], sd[k]) for k in sd)
    with pytest.raises(ValueError, match='--no-continuous'):
        tserver.InferenceServer(
            model='llama-tiny', model_overrides=OV, params=sd,
            draft_checkpoint_dir=str(tmp_path), continuous=False,
            device='cpu')
    with pytest.raises(SystemExit):
        tserver.check_args(tserver.build_parser(), tserver.build_parser(
        ).parse_args(['--draft-model', 'llama-tiny']))
