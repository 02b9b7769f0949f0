"""The port's attention ops against the JAX package's, on the CPU.

Same inputs, made with numpy from a seed, go through the JAX Pallas
kernels in interpret mode (`_paged_decode_attention_impl`,
`_ragged_prefill_impl`) and through the port's wrappers, which on CPU
tensors take their plain PyTorch versions.  f32 throughout; tolerance
1e-5 absolute (both sides accumulate scores in f32 over at most a few
hundred terms of unit-variance data).  The CUDA kernels themselves run
only on the card: tests/test_torch_cuda.py and chip_smoke.py hold them
against these plain versions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.ops import grouped_attention as jga
from skypilot_tpu.ops import paged_attention as jpa
from skypilot_tpu.ops import ragged_prefill as jrp
from skypilot_tpu_torch.ops import grouped_attention as tga
from skypilot_tpu_torch.ops import paged_attention as tpa
from skypilot_tpu_torch.ops import ragged_prefill as trp

_PS = 8
_D = 16
_TOL = 1e-5
# (query heads, KV heads, head dim): the GQA cases at _D, and gemma's
# head width 256 at a group of 1 (gemma-7b's) and of 8 (gemma-2b's).
_HEADS = [(4, 2, _D), (4, 1, _D), (2, 2, 256), (8, 1, 256)]


def _t(x):
    return torch.from_numpy(np.array(x))


def _decode_case(seed, b, h, kvh, n_read, ctxs, *, null_last=(),
                 window=None, poison=0.0, d=_D):
    """Pools + shuffled block table + [B, 1, 1, read_len] mask for one
    decode step.  Row i sees its first ctxs[i] slots (a sliding window
    keeps only the last `window` of them); rows in `null_last` leave
    their last table entry at the null page 0, which `poison` fills with
    garbage that must never reach the output."""
    rng = np.random.RandomState(seed)
    read_len = n_read * _PS
    n_pages = b * n_read + 3
    pk = rng.randn(n_pages, kvh, _PS, d).astype(np.float32)
    pv = rng.randn(n_pages, kvh, _PS, d).astype(np.float32)
    if poison:
        pk[0] = poison
        pv[0] = poison
    perm = rng.permutation(np.arange(1, n_pages))
    table = perm[:b * n_read].reshape(b, n_read).astype(np.int32)
    mask = np.zeros((b, 1, 1, read_len), bool)
    for i in range(b):
        lo = 0 if window is None else max(0, ctxs[i] - window)
        mask[i, 0, 0, lo:ctxs[i]] = True
        if i in null_last:
            table[i, -1] = 0
            mask[i, :, :, (n_read - 1) * _PS:] = False
    q = rng.randn(b, h, 1, d).astype(np.float32)
    return q, pk, pv, table, mask


def _assert_decode_parity(case):
    q, pk, pv, table, mask = case
    scale = q.shape[-1] ** -0.5
    want = np.asarray(jpa._paged_decode_attention_impl(  # pylint: disable=protected-access
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(table), jnp.asarray(mask), scale=scale,
        probs_dtype=jnp.float32, interpret=True))
    got = tpa.paged_decode_attention(
        _t(q), _t(pk), _t(pv), _t(table), _t(mask), scale=scale,
        probs_dtype=torch.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=_TOL, rtol=0)


class TestPagedDecode:

    @pytest.mark.parametrize('h,kvh,d', _HEADS,
                             ids=['gqa4:2', 'gqa4:1', 'g1_d256', 'g8_d256'])
    @pytest.mark.parametrize('ctxs', [[3, 21], [8, 24], [17, 9]],
                             ids=['mid_page', 'page_edge', 'mixed'])
    def test_matches_pallas(self, h, kvh, d, ctxs):
        _assert_decode_parity(_decode_case(1, 2, h, kvh, 3, ctxs, d=d))

    def test_null_page_entries_never_leak(self):
        case = _decode_case(7, 3, 4, 2, 3, [_PS, 2 * _PS, _PS + 3],
                            null_last=(0, 2), poison=1e4)
        _assert_decode_parity(case)

    @pytest.mark.parametrize('h,kvh,d', _HEADS,
                             ids=['4-2', '4-1', 'g1_d256', 'g8_d256'])
    def test_sliding_window(self, h, kvh, d):
        _assert_decode_parity(_decode_case(3, 2, h, kvh, 4, [29, 13],
                                           window=6, d=d))


def _prefill_case(seed, b, h, kvh, s, base, *, L=64, true_lens=None, d=_D):
    """One chunk over a contiguous cache: row i's queries sit at
    base[i]..base[i]+s-1; kv_mask reveals [0, true_lens[i]) (prompt
    padding past it is hidden); the identity table walks the pages
    under the read window."""
    rng = np.random.RandomState(seed)
    base = np.asarray(base, np.int32)
    n_read = -(-(int(base.max()) + s) // _PS)
    k = rng.randn(b, kvh, L, d).astype(np.float32)
    v = rng.randn(b, kvh, L, d).astype(np.float32)
    kvm = np.zeros((b, L), bool)
    for i in range(b):
        end = true_lens[i] if true_lens is not None else base[i] + s
        kvm[i, :end] = True
    table = np.broadcast_to(np.arange(n_read, dtype=np.int32),
                            (b, n_read)).copy()
    q = rng.randn(b, h, s, d).astype(np.float32)
    return q, k, v, table, base, kvm


def _assert_prefill_parity(case, window=None):
    q, k, v, table, base, kvm = case
    scale = q.shape[-1] ** -0.5
    want = np.asarray(jrp._ragged_prefill_impl(  # pylint: disable=protected-access
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        jnp.asarray(base), jnp.asarray(kvm), scale=scale,
        probs_dtype=jnp.float32, page_size=_PS, window=window,
        interpret=True))
    got = trp.ragged_prefill_attention(
        _t(q), _t(k), _t(v), _t(table), _t(base), _t(kvm),
        scale=scale, probs_dtype=torch.float32, page_size=_PS,
        window=window)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=_TOL, rtol=0)


class TestRaggedPrefill:

    @pytest.mark.parametrize('h,kvh,d', _HEADS,
                             ids=['gqa4:2', 'gqa4:1', 'g1_d256', 'g8_d256'])
    @pytest.mark.parametrize('base', [[0], [13], [16, 5]],
                             ids=['base0', 'base_mid_page', 'ragged'])
    def test_matches_pallas(self, h, kvh, d, base):
        case = _prefill_case(2, len(base), h, kvh, 8, base, d=d)
        _assert_prefill_parity(case)

    def test_padding_hidden_by_kv_mask(self):
        # Chunk runs past the prompt's true end (pad queries): columns
        # past true_len are masked for every query.
        case = _prefill_case(4, 2, 4, 2, 8, [8, 0], true_lens=[11, 5])
        _assert_prefill_parity(case)

    @pytest.mark.parametrize('h,kvh,d', _HEADS,
                             ids=['4-2', '4-1', 'g1_d256', 'g8_d256'])
    def test_sliding_window(self, h, kvh, d):
        case = _prefill_case(5, 2, h, kvh, 8, [24, 9], d=d)
        _assert_prefill_parity(case, window=5)

    def test_base_scalar_broadcasts(self):
        q, k, v, table, base, kvm = _prefill_case(6, 2, 4, 2, 8, [12, 12])
        want = trp.ragged_prefill_attention(
            _t(q), _t(k), _t(v), _t(table), _t(base), _t(kvm),
            scale=0.25, probs_dtype=torch.float32, page_size=_PS)
        got = trp.ragged_prefill_attention(
            _t(q), _t(k), _t(v), _t(table), 12, _t(kvm), scale=0.25,
            probs_dtype=torch.float32, page_size=_PS)
        assert torch.equal(got, want)


class TestGroupedPieces:

    @pytest.mark.parametrize('h,kvh', [(4, 4), (4, 2), (4, 1)],
                             ids=['mha', 'grouped', 'kvh1'])
    def test_grouped_attention_matches_jax(self, h, kvh):
        rng = np.random.RandomState(h * 10 + kvh)
        q = rng.randn(2, h, 3, _D).astype(np.float32)
        k = rng.randn(2, kvh, 11, _D).astype(np.float32)
        v = rng.randn(2, kvh, 11, _D).astype(np.float32)
        mask = rng.rand(2, 1, 3, 11) > 0.3
        want = np.asarray(jga.grouped_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(mask), scale=0.3, probs_dtype=jnp.float32))
        got = tga.grouped_attention(_t(q), _t(k), _t(v), _t(mask),
                                    scale=0.3, probs_dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), want, atol=_TOL, rtol=0)

    def test_gather_pages_matches_jax(self):
        rng = np.random.RandomState(0)
        pool = rng.randn(7, 2, _PS, _D).astype(np.float32)
        table = rng.randint(0, 7, (3, 4)).astype(np.int32)
        want = np.asarray(jga.gather_pages(jnp.asarray(pool),
                                           jnp.asarray(table)))
        got = tga.gather_pages(_t(pool), _t(table))
        np.testing.assert_array_equal(got.numpy(), want)


class TestWrappersStayOnTheirDevice:

    def test_plain_version_only_for_cpu_tensors(self):
        # On a CPU tensor the wrapper computes exactly the plain version
        # and launches nothing.
        q, pk, pv, table, mask = _decode_case(9, 2, 4, 2, 3, [5, 19])
        before = tpa.launches
        got = tpa.paged_decode_attention(
            _t(q), _t(pk), _t(pv), _t(table), _t(mask), scale=0.25,
            probs_dtype=torch.float32)
        want = tpa.paged_decode_attention_plain(
            _t(q), _t(pk), _t(pv), _t(table), _t(mask), scale=0.25,
            probs_dtype=torch.float32)
        assert torch.equal(got, want)
        assert tpa.launches == before

    def test_prefill_rejects_overlong_walk(self):
        q, k, v, table, base, kvm = _prefill_case(1, 1, 4, 2, 8, [0], L=8)
        with pytest.raises(ValueError, match='beyond the cache length'):
            trp.ragged_prefill_attention(
                _t(q), _t(k), _t(v), _t(np.zeros((1, 2), np.int32)),
                _t(base), _t(kvm), scale=0.25, probs_dtype=torch.float32,
                page_size=_PS)
