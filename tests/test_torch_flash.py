"""The port's flash attention against the JAX package's, on the CPU.

The same numpy inputs go through the JAX Pallas kernels in interpret
mode (`_flash_fwd`, `_flash_bwd_pallas`; both pass interpret=True off a
TPU, so no process-wide switch is touched) and through the port's
wrappers, which on CPU tensors take their plain PyTorch versions.  The
JAX side runs 128-row blocks over S = 256, so its grid walks several q
and kv blocks, with the causal/window block skipping in play.

f32 throughout.  Tolerances, as the reference's own tests use them
(tests/unit_tests/test_ops.py): 1e-5 absolute for the forward (out and
lse: scores summed over d terms, scaled by d^-1/2, and softmax sums over
<= 256 columns, both sides in f32) and 1e-4 for the backward (dq/dk/dv
sum up to G * 256 products of O(1) terms in another order than the
blockwise kernel).  The d 256 cases (gemma's head width, G 1 and G 8)
hold the same tolerances.  The CUDA kernels themselves run only on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.ops import flash_attention as jfa
from skypilot_tpu_torch.ops import flash_attention as tfa

FWD_TOL = 1e-5
BWD_TOL = 1e-4
BLOCK = 128


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    """The suite runs these tests beside XLA:CPU tests on the same cores:
    inputs this small need no intra-op threads of their own."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CASES = [
    # b, h, kvh, s, d, causal, window, offset
    (1, 4, 4, 256, 16, True, None, 0),
    (2, 4, 2, 256, 32, True, None, 0),
    (1, 4, 1, 256, 16, False, None, 0),
    (1, 4, 2, 256, 32, True, 100, 0),
    (1, 4, 2, 256, 16, True, None, 64),
    (1, 4, 2, 256, 16, True, 96, 32),
    # Head width 256 (gemma): a group of 1 (gemma-7b's), a group of 8
    # (gemma-2b's), and a window.
    (1, 2, 2, 256, 256, True, None, 0),
    (1, 8, 1, 256, 256, True, None, 0),
    (1, 8, 1, 256, 256, True, 100, 0),
]
IDS = ['mha', 'gqa2_b2_d32', 'mqa_noncausal', 'window', 'offset',
       'window_offset', 'd256_g1', 'd256_g8', 'd256_g8_window']


def _inputs(seed, b, h, kvh, s, d):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, s, d).astype(np.float32)
    k = rng.randn(b, kvh, s, d).astype(np.float32)
    v = rng.randn(b, kvh, s, d).astype(np.float32)
    do = rng.randn(b, h, s, d).astype(np.float32)
    return q, k, v, do


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize('b,h,kvh,s,d,causal,window,offset', CASES, ids=IDS)
def test_forward_matches_pallas(b, h, kvh, s, d, causal, window, offset):
    q, k, v, _ = _inputs(0, b, h, kvh, s, d)
    scale = d ** -0.5
    want_out, want_lse = jfa._flash_fwd(  # pylint: disable=protected-access
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale,
        causal=causal, window=window, offset=offset, block_q=BLOCK,
        block_kv=BLOCK)
    before = tfa.fwd_launches
    out, lse = tfa.flash_fwd(_t(q), _t(k), _t(v), scale=scale, causal=causal,
                             window=window, offset=offset)
    assert tfa.fwd_launches == before      # CPU tensors: the plain version
    assert out.shape == (b, h, s, d) and lse.shape == (b, h, s)
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               atol=FWD_TOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               atol=FWD_TOL, rtol=0)


@pytest.mark.parametrize('b,h,kvh,s,d,causal,window,offset', CASES, ids=IDS)
def test_backward_matches_pallas(b, h, kvh, s, d, causal, window, offset):
    q, k, v, do = _inputs(1, b, h, kvh, s, d)
    scale = d ** -0.5
    out, lse = jfa._mha_fwd_xla(  # pylint: disable=protected-access
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale,
        causal=causal, window=window, offset=offset)
    out = np.asarray(out)
    lse = np.asarray(lse)
    delta = (do * out).sum(-1)
    want = jfa._flash_bwd_pallas(  # pylint: disable=protected-access
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(do),
        jnp.asarray(lse), jnp.asarray(delta), scale=scale, causal=causal,
        window=window, offset=offset, block_q=BLOCK, block_kv=BLOCK)
    args = [_t(x) for x in (q, k, v, do, lse, delta)]
    kw = dict(scale=scale, causal=causal, window=window, offset=offset)
    dq = tfa.flash_bwd_dq(*args, **kw)
    dk, dv = tfa.flash_bwd_dkv(*args, **kw)
    assert dk.shape == dv.shape == (b, kvh, s, d)
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=BWD_TOL, rtol=0)


@pytest.mark.parametrize('h,kvh,window', [(4, 4, None), (4, 2, None),
                                          (4, 1, 40), (8, 2, 200)],
                         ids=['mha', 'gqa2', 'mqa_window', 'gqa4_window_full'])
def test_autograd_matches_reference_autograd(h, kvh, window):
    """flash_attention's custom backward against torch.autograd through
    the plain mha_reference, for the same upstream gradient."""
    q, k, v, do = _inputs(2, 2, h, kvh, 96, 16)
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    out = tfa.flash_attention(*leaves, window=window)
    out.backward(_t(do))
    got = [out.detach()] + [x.grad for x in leaves]
    ref_leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    ref = tfa.mha_reference(*ref_leaves, window=window)
    ref.backward(_t(do))
    want = [ref.detach()] + [x.grad for x in ref_leaves]
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(),
                               atol=FWD_TOL, rtol=0)
    for g, w in zip(got[1:], want[1:]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=BWD_TOL,
                                   rtol=0)


def test_window_normalization_and_checks():
    q, k, v, _ = _inputs(3, 1, 4, 2, 64, 16)
    q, k, v = _t(q), _t(k), _t(v)
    # A window covering the whole sequence is full causal attention.
    torch.testing.assert_close(tfa.flash_attention(q, k, v, window=64),
                               tfa.flash_attention(q, k, v), atol=0, rtol=0)
    with pytest.raises(ValueError, match='causal'):
        tfa.flash_attention(q, k, v, causal=False, window=8)
    with pytest.raises(ValueError, match='seq_q == seq_kv'):
        tfa.flash_attention(q, k[:, :, :32], v[:, :, :32], window=8)
    # The plain path refuses what the kernels refuse, so its forward and
    # backward see the kernels' one causal mask.
    with pytest.raises(ValueError, match='seq_q == seq_kv'):
        tfa.flash_attention(q, k[:, :, :32], v[:, :, :32], plain=True)
    with pytest.raises(ValueError, match='divisible'):
        tfa.flash_fwd(q[:, :3], k, v, scale=0.25, causal=True)
    with pytest.raises(ValueError, match='offset'):
        tfa.flash_fwd(q, k, v, scale=0.25, causal=True, offset=-1)


def test_plain_versions_run_where_the_tensors_are_cpu_only():
    """CPU tensors never count a kernel launch: the plain versions run,
    and the counts stay for the card's runs to read."""
    q, k, v, do = _inputs(4, 1, 4, 2, 32, 16)
    counts = (tfa.fwd_launches, tfa.dq_launches, tfa.dkv_launches)
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    tfa.flash_attention(*leaves).backward(_t(do))
    assert (tfa.fwd_launches, tfa.dq_launches, tfa.dkv_launches) == counts
    assert all(torch.isfinite(x.grad).all() for x in leaves)


def test_rounding_bounds_pass_rounding_and_catch_planted_faults():
    """The per-element bounds the card's checks hold the 16-bit kernels
    to: the output rounded to bf16 stays within them, and each planted
    fault (emulated with the plain versions) breaks them."""
    b, h, kvh, s, d = 1, 4, 2, 128, 32
    q, k, v, do = (_t(x).bfloat16() for x in _inputs(5, b, h, kvh, s, d))
    f32 = [x.float() for x in (q, k, v, do)]
    kw = dict(scale=d ** -0.5, causal=True)
    out, lse = tfa.flash_fwd_plain(*f32[:3], **kw)
    delta = (f32[3] * out).sum(-1)
    tol = tfa.rounding_bounds(q, k, v, do, lse, delta, **kw)
    assert set(tol) == {'out', 'lse', 'dq', 'dk', 'dv'}
    assert ((out.bfloat16().float() - out).abs() <= tol['out']).all()
    dq, dk, dv = tfa.flash_bwd_plain(*f32, lse, delta, **kw)

    def exceeds(name, got, want):
        return bool(((got - want).abs() > tol[name]).any())

    # dq without the delta term.
    bad_dq = tfa.flash_bwd_plain(*f32, lse, torch.zeros_like(delta), **kw)[0]
    assert exceeds('dq', bad_dq, dq)
    # dk/dv summed over all but one member of each group.
    q_miss, do_miss = f32[0].clone(), f32[3].clone()
    q_miss[:, 1::2] = 0.0
    do_miss[:, 1::2] = 0.0
    _, bad_dk, bad_dv = tfa.flash_bwd_plain(q_miss, f32[1], f32[2], do_miss,
                                            lse, delta, **kw)
    assert exceeds('dk', bad_dk, dk) and exceeds('dv', bad_dv, dv)
    # The forward's scale 1% high.
    bad_out, bad_lse = tfa.flash_fwd_plain(*f32[:3], scale=kw['scale'] * 1.01,
                                           causal=True)
    assert exceeds('lse', bad_lse, lse) and exceeds('out', bad_out, out)
