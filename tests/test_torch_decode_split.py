"""The paged-decode kernel's split page walk, on the CPU.

The kernel (csrc/paged_decode.cu) runs only on the card, where
tests/test_torch_cuda.py and chip_smoke.py hold it to its plain version.
Here, with the same numpy inputs for both packages:
  - `decode_split`, the wrapper's choice of chunk length, keeps its rules
    at every batch of 1-8 and every read window up to 4096 positions;
  - the kernel's algorithm, written out below in plain PyTorch
    (`_split_walk`: the row's pages cut into chunks, pages no query sees
    skipped, a row that sees nothing walked in full, each chunk's (m, l,
    acc) merged in chunk order with the kernel's formula, base 2), equals
    the plain version at chunks of 1, 2 and 3 pages, and the plain
    version equals the JAX package's Pallas kernel in interpret mode, on
    the cases the split can get wrong: a row that sees nothing, rows
    shorter than a chunk, a row over many chunks, S 4 masks under a
    window (chunks that see nothing), poisoned null pages, both branches;
  - the wrappers take the plain versions for CPU tensors and launch
    nothing, and the launch paths refuse tensors off the card.
f32 throughout; tolerance 1e-5 absolute (scores of unit-variance data
summed in f32 over at most a hundred terms, in other orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.ops import paged_attention as jpa
from skypilot_tpu_torch.ops import flash_attention as tfa
from skypilot_tpu_torch.ops import grouped_attention as tga
from skypilot_tpu_torch.ops import paged_attention as tpa

_TOL = 1e-5
_NEG_INF = -1e30
_LOG2E = 1.4426950408889634
_SCALE = 0.25


@pytest.mark.parametrize('page_size', [8, 16, 32])
def test_decode_split_rules(page_size):
    for batch in range(1, 9):
        # llama3-8b decode: kvh 8, one group of 4 query rows a kv head.
        units = batch * 8
        assert tpa.decode_split(0, page_size, units) == (1, 1)
        for n_read in range(1, 4096 // page_size + 1):
            chunk, n_split = tpa.decode_split(n_read, page_size, units)
            # every chunk holds a page of the walk, the last the rest
            assert chunk >= 1
            assert (n_split - 1) * chunk < n_read <= n_split * chunk
            # no block walks more than SPLIT_POSITIONS positions
            assert chunk * page_size <= max(tpa.SPLIT_POSITIONS, page_size)
            # two blocks an SM wherever one page a chunk gets there
            assert units * n_split >= min(2 * tpa.H100_SMS, units * n_read)


def _split_walk(q, pk, pv, table, mask, chunk, ks=None, vs=None):
    """What the kernel computes, chunk by chunk, in f32 and base 2."""
    b, h, s, d = q.shape
    kvh, ps = pk.shape[1], pk.shape[2]
    g = h // kvh
    n_read = table.shape[1]
    n_split = max(1, -(-n_read // chunk))
    mask3 = mask[:, 0].expand(b, s, n_read * ps)
    out = torch.zeros(b, s, h, d)
    for bi in range(b):
        dead = ~mask3[bi].any(-1)                      # [S]
        for hi in range(kvh):
            qr = q[bi, hi * g:(hi + 1) * g] * (_SCALE * _LOG2E)
            qr = qr.reshape(g * s, d)                  # row = g * S + s
            srow = torch.arange(g * s) % s
            parts = []
            for c in range(n_split):
                pages = [j for j in range(c * chunk,
                                          min(n_read, (c + 1) * chunk))
                         if bool(dead.any())
                         or bool(mask3[bi, :, j * ps:(j + 1) * ps].any())]
                if not pages:
                    continue                           # an empty partial
                m = torch.full((g * s,), _NEG_INF)
                l = torch.zeros(g * s)
                acc = torch.zeros(g * s, d)
                for j in pages:
                    page = int(table[bi, j])
                    sc = qr @ pk[page, hi].float().T   # [rows, ps]
                    if ks is not None:
                        sc = sc * ks[page, hi, :, 0][None]
                    keep = mask3[bi, :, j * ps:(j + 1) * ps][srow]
                    sc = torch.where(keep, sc, torch.tensor(_NEG_INF))
                    mx = torch.maximum(m, sc.max(1).values)
                    corr = torch.exp2(m - mx)
                    p = torch.exp2(sc - mx[:, None])
                    l = l * corr + p.sum(1)
                    if vs is not None:                 # in PV only
                        p = p * vs[page, hi, :, 0][None]
                    acc = acc * corr[:, None] + p @ pv[page, hi].float()
                    m = mx
                parts.append((m, l, acc))
            mx = torch.full((g * s,), _NEG_INF)
            for m, _, _ in parts:
                mx = torch.maximum(mx, m)
            lt = torch.zeros(g * s)
            a = torch.zeros(g * s, d)
            for m, l, acc in parts:
                f = torch.exp2(m - mx)
                use = (f != 0) & (l != 0)
                lt = lt + torch.where(use, f * l, torch.zeros(()))
                a = a + torch.where(use[:, None], f[:, None] * acc,
                                    torch.zeros(()))
            o = a / torch.where(lt == 0, torch.ones(()), lt)[:, None]
            out[bi, :, hi * g:(hi + 1) * g] = o.reshape(g, s, d).transpose(
                0, 1)
    return out


def _case(seed, ctxs, *, s=1, window=None, quant=False, h=4, kvh=2, d=16,
          ps=8):
    """Pools, a shuffled table and [B, 1, S, read_len] masks: query s of
    a row sees its first ctx + s positions (with a window, the last
    `window` of them), table entries past the row's pages point at the
    null page 0, which is poisoned; a context of 0 is a row that sees
    nothing and keeps a full table.  f32, or int8 pools with f32 scales
    (`quant`)."""
    rng = np.random.RandomState(seed)
    b = len(ctxs)
    n_read = max(3, -(-(max(ctxs) + s - 1) // ps))
    n_pages = b * n_read + 3
    pk = rng.randn(n_pages, kvh, ps, d).astype(np.float32)
    pv = rng.randn(n_pages, kvh, ps, d).astype(np.float32)
    table = (rng.permutation(n_pages - 1)[:b * n_read] + 1).reshape(
        b, n_read).astype(np.int32)
    mask = np.zeros((b, 1, s, n_read * ps), bool)
    for i, c in enumerate(ctxs):
        if c == 0:
            continue
        for qi in range(s):
            lo = 0 if window is None else max(0, c + qi - window)
            mask[i, 0, qi, lo:c + qi] = True
        table[i, -(-(c + s - 1) // ps):] = 0
    q = rng.randn(b, h, s, d).astype(np.float32)
    t = [torch.from_numpy(x) for x in (q, pk, pv, table, mask)]
    scales = {}
    if quant:
        t[1], ksc = tga.quantize_int8_rows(t[1])
        t[2], vsc = tga.quantize_int8_rows(t[2])
        t[1][0] = t[2][0] = 127
        ksc[0] = vsc[0] = 1e4
        scales = dict(key_scale=ksc, value_scale=vsc)
    else:
        t[1][0] = t[2][0] = 1e4
    return t, scales


# (contexts, S, window): a row that sees nothing, rows shorter than a
# chunk, a row over eight pages; S 4 verify masks under a window of 9,
# whose first chunks see nothing, beside a row that sees nothing.
_EDGES = {
    'short_rows_and_a_dead_row': ((0, 5, 61, 1), 1, None),
    's4_window': ((40, 2, 0), 4, 9),
}


@pytest.mark.parametrize('quant', [False, True], ids=['float', 'int8'])
@pytest.mark.parametrize('name', list(_EDGES))
def test_split_walk_matches_plain_and_pallas(name, quant):
    ctxs, s, window = _EDGES[name]
    (q, pk, pv, table, mask), scales = _case(3, ctxs, s=s, window=window,
                                             quant=quant)
    want = tpa.paged_decode_attention_plain(
        q, pk, pv, table, mask, scale=_SCALE, probs_dtype=torch.float32,
        **scales)
    for chunk in (1, 2, 3):
        got = _split_walk(q, pk, pv, table, mask, chunk,
                          ks=scales.get('key_scale'),
                          vs=scales.get('value_scale'))
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=_TOL,
                                   rtol=0, err_msg=f'chunk {chunk}')
    jkw = {k: jnp.asarray(v.numpy()) for k, v in scales.items()}
    ref = np.asarray(jpa._paged_decode_attention_impl(  # pylint: disable=protected-access
        *(jnp.asarray(x.numpy()) for x in (q, pk, pv, table, mask)),
        scale=_SCALE, probs_dtype=jnp.float32, interpret=True, **jkw))
    np.testing.assert_allclose(want.numpy(), ref, atol=_TOL, rtol=0)


def _dq_inputs():
    rng = np.random.RandomState(7)
    return [torch.from_numpy(rng.randn(*shape).astype(np.float32))
            for shape in ((1, 4, 24, 16), (1, 2, 24, 16), (1, 2, 24, 16),
                          (1, 4, 24, 16))]


@pytest.mark.parametrize('kernel', ['decode_float', 'decode_int8', 'dq'])
def test_wrapper_takes_the_plain_version_on_the_cpu(kernel):
    if kernel == 'dq':
        q, k, v, do = _dq_inputs()
        kw = dict(scale=_SCALE, causal=True, window=9)
        out, lse = tfa.flash_fwd(q, k, v, **kw)
        delta = (do * out).sum(-1)
        before = tfa.dq_launches
        got = tfa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
        want = tfa.flash_bwd_plain(q, k, v, do, lse, delta, **kw)[0]
        assert tfa.dq_launches == before
        with pytest.raises(ValueError, match='CUDA device'):
            tfa._check_cuda('flash_bwd_dq', (('q', q),), q)  # pylint: disable=protected-access
    else:
        quant = kernel == 'decode_int8'
        (q, pk, pv, table, mask), scales = _case(5, (9, 20), quant=quant)
        kw = dict(scale=_SCALE, probs_dtype=torch.float32)
        before = (tpa.launches, tpa.launches_int8)
        got = tpa.paged_decode_attention(q, pk, pv, table, mask, **kw,
                                         **scales)
        want = tpa.paged_decode_attention_plain(q, pk, pv, table, mask,
                                                **kw, **scales)
        assert (tpa.launches, tpa.launches_int8) == before
        with pytest.raises(ValueError, match='CUDA device'):
            tpa._launch(q, pk, pv, table, mask, **kw,  # pylint: disable=protected-access
                        scales=((scales['key_scale'], scales['value_scale'])
                                if quant else None))
    assert torch.equal(got, want)
