"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips where there is no NVIDIA card (decided
inside the fixture, never at import).  Run them on a machine with one:

    python -m pytest tests/test_torch_cuda.py -q

Small shapes that reach the kernels' edges: GQA groups of 1 to 8 (more
query rows than one decode block holds), contexts ending mid-page,
poisoned null-page entries, sliding windows, multi-query decode masks,
prefill at ragged bases with kv_mask cutting into the chunk, and each
supported head dim and page size.  The decode kernel's split page walk:
rows shorter than a chunk, a long row beside 1-position rows, rows that
see nothing, S 4 masks under a window, f32/bf16/f16 q, chunks of 1 and
3 pages, and calls back to back (its merge counters must be back at 0);
at llama3-8b's heads, the serving path's multi-query widths: a
speculative verify (S 5, also under a window), a mixed step (S 64), and
a verify's pad queries reading table entries that point at the null
page (which then holds other rows' pad writes: finite garbage).
The dq pass: its 128-row blocks, 64-column ring (32-column at d 256) and
the tiles a consumer skips or masks.  Flash kernels 1-3 at head width
256 (gemma): G 1 and G 8, causal, windowed, ragged, at an offset; and a
dk or dv with a dropped column half (the d 256 dk/dv pass splits each
16 kv rows' columns between two warps) or a dq missing its last kv tile
must fail the same check.  f16 outputs hold to the bf16 bounds with u = 2^-11.
Prefix sharing and int8 weights on the serving path: the paged decode
kernel over tables whose leading pages are shared by every row (float
and int8 pools, within the bounds below); hydrate then insert with
copy_start_page (float and int8 pools: the shared pages bit-unchanged,
the others holding the prefill cache's rows); and a tiny bf16 model with
int8 weights served on the card against the same model on the CPU: the
dequantized weights bit for bit, the prefill and first decode step
logits within 6% of max |logit| (chip_smoke.py's serving bound: the
kernels against the plain versions, bf16 roundings in other orders).

The S = 1 paged decode forward replayed from CUDA graphs (a tiny bf16
model, bf16 and int8 caches): replayed logits equal to the eager
forward's bit for bit at two read buckets, each replay adding its
graph's kernel-4 launches to the wrapper's counts; a planted graph whose
static kv mask is never overwritten fails that check; and the pipelined
engine with graphs gives the synchronous eager engine's greedy streams;
a mixtral-tiny engine whose decode steps drop routes at capacity replays
its MoE decode forward equal to eager bit for bit.  The other families'
heads: gpt2's (12 over 12, a group of 1, d 64) and qwen2-7b's (28 over
4, a group of 7) through kernels 4 (S 1 and 5, both branches), 5 and
1-3.

Tolerances, per element.  f32 (paged decode only; the prefill kernel
takes 16-bit types): 1e-4 absolute against the plain version at f32.
bf16: against the plain version run at f32 on the same values, the
kernel's rounding bound, with u = 2^-8 the bf16 unit roundoff and
A = attention of |V| (the same plain version on |values|):
  paged decode   u * |plain| + 2^-12 * A     (one rounding of the output;
                                              the probabilities stay f32)
  ragged prefill u * (|plain| + A) + 2^-12 * A  (the probabilities are
                                              rounded to bf16 before PV:
                                              |sum (p' - p) v| / l <= u * A)
2^-12 * A covers the f32 sums taken in other orders.  The int8 branches
(int8 pools quantized from random rows, f32 scales, q and out in bf16 or
f32) hold to the same bounds against the plain int8 versions: the
decode kernel converts int8 to f32 and rounds only its output; the
prefill kernel stages int8 as bf16 (exact, |x| <= 127) and rounds
p * value_scale to bf16 before PV, so |sum (p vs)' v - p vs v| / l <=
u * A with A the attention of |V| at its scales.

Flash attention (forward, dq, dk/dv; bf16/f16 only): against the plain
versions run at f32 on the same values (the backward on the kernel's
lse and delta), within `flash_attention.rounding_bounds`, the per-element
rounding bound derived in its docstring (16-bit rounding of the output,
of P and of dS for their products, the score error of an f32 dot, and
f32 sums).  The autograd op end to end: each gradient, rounded to the
input type, within 2u |plain| + 2^-7 max |plain| of the plain versions'
gradients at f32 (the wrapper's wiring, not its rounding, is the point).
"""
import numpy as np
import pytest
import torch

from skypilot_tpu_torch.infer import engine as teng
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.ops import flash_attention as fa
from skypilot_tpu_torch.ops import grouped_attention as ga
from skypilot_tpu_torch.ops import paged_attention as pa
from skypilot_tpu_torch.ops import ragged_prefill as rp

pytestmark = pytest.mark.cuda

U_BF16 = 2.0 ** -8
F32_SLACK = 2.0 ** -12


def _assert_within_rounding(got, plain, args, kw, *, probs_rounded,
                            u=U_BF16):
    """`got` (a bf16 kernel output; f16 with u = 2^-11) against `plain`
    run at f32 on the same values: within the kernel's rounding bound
    (module docstring).  args[2] is the values tensor."""
    args32 = [a.float() if a.is_floating_point() else a for a in args]
    kw32 = dict(kw, probs_dtype=torch.float32)
    want = plain(*args32, **kw32).float()
    absv = plain(*args32[:2], args32[2].abs(), *args32[3:], **kw32).float()
    tol = u * want.abs() + F32_SLACK * absv
    if probs_rounded:
        tol += u * absv
    err = (got.float() - want).abs()
    assert torch.isfinite(got).all()
    # An element with no bound (an exact zero, e.g. a query that sees one
    # int8 column holding 0) must be exact.
    ratio = torch.where(tol > 0, err / tol,
                        torch.where(err > 0, float('inf'), 0.0))
    worst = ratio.max().item()
    assert worst <= 1.0, (f'max |err| {err.max().item():.3e}, '
                          f'{worst:.2f} x its bound')


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (CUDA kernel, no CPU build)')
    return torch.device('cuda')


def _decode_case(dev, dtype, *, b, h, kvh, d, ps, ctxs, s=1, window=None,
                 null_last=(), seed=0):
    g = torch.Generator().manual_seed(seed)
    n_read = -(-(max(ctxs) + s) // ps)
    read_len = n_read * ps
    n_pages = b * n_read + 2
    pk = torch.randn(n_pages, kvh, ps, d, generator=g)
    pv = torch.randn(n_pages, kvh, ps, d, generator=g)
    pk[0] = 1e4          # the null page is garbage the mask must hide
    pv[0] = 1e4
    perm = torch.randperm(n_pages - 1, generator=g) + 1
    table = perm[:b * n_read].reshape(b, n_read).to(torch.int32)
    mask = torch.zeros(b, 1, s, read_len, dtype=torch.bool)
    for i in range(b):
        for q in range(s):
            hi = ctxs[i] + q + 1
            lo = 0 if window is None else max(0, hi - window)
            mask[i, 0, q, lo:hi] = True
        if i in null_last:
            table[i, -1] = 0
            mask[i, :, :, (n_read - 1) * ps:] = False
    q = torch.randn(b, h, s, d, generator=g)
    return [t.to(dev) if t.dtype in (torch.int32, torch.bool)
            else t.to(dev, dtype) for t in (q, pk, pv, table, mask)]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('h,kvh,d,ps,ctxs,s,window,null_last', [
    (4, 2, 128, 16, [5, 37], 1, None, ()),
    (4, 1, 64, 8, [16, 3], 1, None, ()),
    (8, 1, 128, 16, [100, 250, 31], 1, None, ()),
    (32, 8, 128, 16, [700, 1], 1, None, ()),
    (4, 2, 128, 32, [40, 64], 1, 9, ()),
    (4, 2, 64, 16, [16, 33, 20], 1, None, (0, 2)),
    (4, 2, 128, 8, [12, 30], 4, None, ()),
    # gpt2 (MHA: a group of 1 at d 64, 3 idle rows a 4-row block) and
    # qwen2-7b (28 heads over 4: a group of 7, so 4-row blocks straddle
    # query heads; at S 5, 35 rows in 9 blocks), decode and verify.
    (12, 12, 64, 16, [300, 17], 1, None, ()),
    (12, 12, 64, 16, [90, 17], 5, None, ()),
    (28, 4, 128, 16, [300, 17], 1, None, ()),
    (28, 4, 128, 16, [90, 17], 5, None, ()),
    # gemma at head width 256: gemma-7b's 16 over 16 (a group of 1) and
    # gemma-2b's 8 over 1 (a group of 8), at S 1, 5 and 64, with a null
    # page and a window.
    (16, 16, 256, 16, [300, 17], 1, None, (1,)),
    (16, 16, 256, 16, [90, 17], 5, 40, ()),
    (16, 16, 256, 16, [200, 3], 64, None, ()),
    (8, 1, 256, 16, [700, 31, 2], 1, None, (2,)),
    (8, 1, 256, 16, [90, 17], 5, None, ()),
    (8, 1, 256, 8, [130, 64], 64, 100, ()),
], ids=['gqa2', 'mqa_d64_ps8', 'g8_rows_over_block', 'llama3_8b',
        'window_ps32', 'null_pages', 'multi_query', 'gpt2_g1_d64',
        'gpt2_g1_d64_s5', 'qwen2_7b_g7', 'qwen2_7b_g7_s5', 'g1_d256_null',
        'g1_d256_s5_window', 'g1_d256_s64', 'g8_d256_null', 'g8_d256_s5',
        'g8_d256_s64_window_ps8'])
def test_paged_decode_kernel_matches_plain(dev, dtype, h, kvh, d, ps, ctxs,
                                           s, window, null_last):
    q, pk, pv, table, mask = _decode_case(
        dev, dtype, b=len(ctxs), h=h, kvh=kvh, d=d, ps=ps, ctxs=ctxs, s=s,
        window=window, null_last=null_last)
    before = pa.launches
    got = pa.paged_decode_attention(q, pk, pv, table, mask,
                                    scale=d ** -0.5, probs_dtype=dtype)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    want = pa.paged_decode_attention_plain(q, pk, pv, table, mask,
                                           scale=d ** -0.5,
                                           probs_dtype=dtype)
    assert got.shape == want.shape and got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    else:
        _assert_within_rounding(
            got, pa.paged_decode_attention_plain, (q, pk, pv, table, mask),
            dict(scale=d ** -0.5), probs_rounded=False)


def _quantized(pool, poison_null):
    """int8 pool and f32 scales from a float pool; with `poison_null` the
    null page 0 holds 127 at a scale of 1e4, which the mask must hide."""
    q8, sc = ga.quantize_int8_rows(pool)
    if poison_null:
        q8[0] = 127
        sc[0] = 1e4
    return q8, sc


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('h,kvh,d,ps,ctxs,window,null_last,s', [
    (4, 2, 128, 16, [5, 37], None, (), 1),
    (4, 1, 64, 8, [16, 3], None, (), 1),
    (32, 8, 128, 16, [700, 1], None, (), 1),
    (4, 2, 128, 32, [40, 64], 9, (), 1),
    (4, 2, 64, 16, [16, 33, 20], None, (0, 2), 1),
    (12, 12, 64, 16, [300, 17], None, (), 1),
    (28, 4, 128, 16, [300, 17], None, (), 1),
    (16, 16, 256, 16, [300, 17], None, (1,), 1),
    (16, 16, 256, 32, [400, 90], 50, (), 5),
    (8, 1, 256, 16, [700, 31, 2], None, (2,), 1),
    (8, 1, 256, 16, [200, 3], None, (), 64),
], ids=['gqa2', 'mqa_d64_ps8', 'llama3_8b', 'window_ps32', 'null_pages',
        'gpt2_g1_d64', 'qwen2_7b_g7', 'g1_d256_null',
        'g1_d256_s5_window_ps32', 'g8_d256_null', 'g8_d256_s64'])
def test_paged_decode_int8_kernel_matches_plain(dev, dtype, h, kvh, d, ps,
                                                ctxs, window, null_last, s):
    q, pk, pv, table, mask = _decode_case(
        dev, torch.float32, b=len(ctxs), h=h, kvh=kvh, d=d, ps=ps,
        ctxs=ctxs, s=s, window=window, null_last=null_last)
    q = q.to(dtype)
    pk, ks = _quantized(pk, True)
    pv, vs = _quantized(pv, True)
    kw = dict(scale=d ** -0.5, key_scale=ks, value_scale=vs)
    before = (pa.launches, pa.launches_int8)
    got = pa.paged_decode_attention(q, pk, pv, table, mask,
                                    probs_dtype=dtype, **kw)
    torch.cuda.synchronize()
    assert (pa.launches, pa.launches_int8) == (before[0], before[1] + 1)
    assert got.shape == (len(ctxs), s, h, d) and got.dtype == dtype
    if dtype == torch.float32:
        want = pa.paged_decode_attention_plain(q, pk, pv, table, mask,
                                               probs_dtype=dtype, **kw)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    else:
        _assert_within_rounding(
            got, pa.paged_decode_attention_plain, (q, pk, pv, table, mask),
            kw, probs_rounded=False)


def _split_case(dev, dtype, *, ctxs, s, d, ps, h, kvh, quant, seed,
                window=None):
    """Inputs that reach the decode kernel's split walk: query s of a row
    sees its first ctx + s positions (with a window, only the last
    `window` of them), table entries past its pages point at the poisoned
    null page, and a context of 0 is a row that sees nothing (its table
    full of real pages: its output is the mean of V over the read window,
    as in the reference)."""
    g = torch.Generator().manual_seed(seed)
    b = len(ctxs)
    n_read = max(3, -(-(max(ctxs) + s - 1) // ps))
    n_pages = b * n_read + 5
    pk = torch.randn(n_pages, kvh, ps, d, generator=g)
    pv = torch.randn(n_pages, kvh, ps, d, generator=g)
    table = (torch.randperm(n_pages - 1, generator=g)[:b * n_read] + 1
             ).reshape(b, n_read).to(torch.int32)
    mask = torch.zeros(b, 1, s, n_read * ps, dtype=torch.bool)
    for i, c in enumerate(ctxs):
        if c == 0:
            continue
        for qi in range(s):
            lo = 0 if window is None else max(0, c + qi - window)
            mask[i, 0, qi, lo:c + qi] = True
        table[i, -(-(c + s - 1) // ps):] = 0
    q = torch.randn(b, h, s, d, generator=g)
    kw = {}
    if quant:
        pk, ks = _quantized(pk, True)
        pv, vs = _quantized(pv, True)
        kw = dict(key_scale=ks.to(dev), value_scale=vs.to(dev))
    else:
        pk[0] = pv[0] = 1e4
        pk, pv = pk.to(dtype), pv.to(dtype)
    return [q.to(dev, dtype), pk.to(dev), pv.to(dev), table.to(dev),
            mask.to(dev)], kw


# (contexts, S, d, page size, H, kvh, window)
SPLIT_EDGES = {
    'row_shorter_than_a_chunk': ([5, 700], 1, 128, 16, 8, 2, None),
    'long_row_beside_1_position_rows': ([1000, 1, 1], 1, 128, 16, 8, 2,
                                        None),
    'row_sees_nothing': ([0, 300, 2], 1, 64, 8, 4, 2, None),
    'all_rows_see_nothing': ([0, 0], 1, 128, 16, 4, 1, None),
    's4_masks': ([200, 3, 0], 4, 128, 16, 4, 2, None),
    's4_window': ([900, 40], 4, 128, 8, 8, 2, 100),
    'ps32_d64': ([500, 31], 1, 64, 32, 8, 2, None),
    'g8_two_row_groups': ([400, 77], 1, 128, 16, 16, 2, None),
    'd256_g1_row_sees_nothing': ([0, 600, 3], 1, 256, 16, 16, 16, None),
    'd256_g8_long_row_s5': ([1000, 1], 5, 256, 16, 8, 1, None),
    'd256_g8_s4_window': ([700, 40], 4, 256, 8, 8, 1, 100),
}


def _check_decode(got, args, kw, dtype):
    if dtype == torch.float32:
        want = pa.paged_decode_attention_plain(*args, scale=kw['scale'],
                                               probs_dtype=dtype,
                                               **{k: v for k, v in kw.items()
                                                  if k != 'scale'})
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    else:
        _assert_within_rounding(got, pa.paged_decode_attention_plain,
                                tuple(args), kw, probs_rounded=False,
                                u=2.0 ** -11 if dtype == torch.float16
                                else U_BF16)


@pytest.mark.parametrize('chunk', [None, 1, 3], ids=['auto', 'chunk1',
                                                      'chunk3'])
@pytest.mark.parametrize('quant', [False, True], ids=['float', 'int8'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16,
                                   torch.float16], ids=['f32', 'bf16', 'f16'])
@pytest.mark.parametrize('name', list(SPLIT_EDGES))
def test_paged_decode_split_edge_cases(dev, name, dtype, quant, chunk):
    """The split page walk at the decode_split chunk and at chunks of 1
    and 3 pages (many partials to merge, ragged last chunks, chunks a
    window leaves with nothing to see)."""
    ctxs, s, d, ps, h, kvh, window = SPLIT_EDGES[name]
    args, scales = _split_case(dev, dtype, ctxs=ctxs, s=s, d=d, ps=ps, h=h,
                               kvh=kvh, quant=quant, seed=3, window=window)
    kw = dict(scale=d ** -0.5, **scales)
    before = (pa.launches, pa.launches_int8)
    if chunk is None:
        got = pa.paged_decode_attention(*args, probs_dtype=dtype, **kw)
    else:
        got = pa._launch(  # pylint: disable=protected-access
            *args, scale=kw['scale'], probs_dtype=dtype,
            scales=(scales['key_scale'], scales['value_scale'])
            if quant else None, chunk_pages=chunk)
    torch.cuda.synchronize()
    assert (pa.launches, pa.launches_int8) == (
        before[0] + (not quant), before[1] + quant)
    assert got.shape == (len(ctxs), s, h, d) and got.dtype == dtype
    _check_decode(got, args, kw, dtype)


# (contexts, S, window) at llama3-8b's heads (H 32, kvh 8, d 128, page 16).
MULTI_QUERY = {
    's5_verify': ([100, 700, 17, 2000], 5, None),
    's64_mixed': ([64, 1000, 300, 1], 64, None),
    's5_window': ([900, 40, 300], 5, 128),
}


@pytest.mark.parametrize('quant', [False, True], ids=['float', 'int8'])
@pytest.mark.parametrize('name', list(MULTI_QUERY) + ['s5_pad_null'])
def test_paged_decode_multi_query_serving_widths(dev, name, quant):
    """Kernel 4 at the widths speculation and mixed batches give it.  In
    's5_pad_null' each row's pages end at context + 2 (16 and 48), so its
    queries 3 and 4 see positions whose table entries are the null page,
    holding finite values."""
    if name == 's5_pad_null':
        g = torch.Generator().manual_seed(9)
        ctxs, s = [14, 46], 5
        n_read = 4
        n_pages = len(ctxs) * n_read + 1
        pk = torch.randn(n_pages, 8, 16, 128, generator=g)
        pv = torch.randn(n_pages, 8, 16, 128, generator=g)
        table = (torch.randperm(n_pages - 1, generator=g) + 1).reshape(
            len(ctxs), n_read).to(torch.int32)
        mask = torch.zeros(len(ctxs), 1, s, n_read * 16, dtype=torch.bool)
        for i, c in enumerate(ctxs):
            table[i, (c + 2) // 16:] = 0
            for qi in range(s):
                mask[i, 0, qi, :c + qi] = True
        q = torch.randn(len(ctxs), 32, s, 128, generator=g)
        scales = {}
        if quant:
            pk, ks = _quantized(pk, False)
            pv, vs = _quantized(pv, False)
            scales = dict(key_scale=ks.to(dev), value_scale=vs.to(dev))
        else:
            pk, pv = pk.bfloat16(), pv.bfloat16()
        args = [q.to(dev, torch.bfloat16), pk.to(dev), pv.to(dev),
                table.to(dev), mask.to(dev)]
    else:
        ctxs, s, window = MULTI_QUERY[name]
        args, scales = _split_case(dev, torch.bfloat16, ctxs=ctxs, s=s,
                                   d=128, ps=16, h=32, kvh=8, quant=quant,
                                   seed=11, window=window)
    kw = dict(scale=128 ** -0.5, **scales)
    before = dict(pa.launches_int8_by_s if quant else pa.launches_by_s)
    got = pa.paged_decode_attention(*args, probs_dtype=torch.bfloat16, **kw)
    torch.cuda.synchronize()
    after = pa.launches_int8_by_s if quant else pa.launches_by_s
    assert after.get(s, 0) == before.get(s, 0) + 1
    assert got.shape == (len(ctxs), s, 32, 128)
    _check_decode(got, args, kw, torch.bfloat16)


@pytest.mark.parametrize('quant', [False, True], ids=['float', 'int8'])
def test_paged_decode_twice_in_a_row(dev, quant):
    """Calls on different inputs, shapes and splits, back to back, checked
    after the last: each merge counter must be back at 0 for the next
    call, or a later call's rows never merge."""
    runs = []
    for seed, (name, chunk) in enumerate((
            ('row_shorter_than_a_chunk', None),
            ('row_shorter_than_a_chunk', None),
            ('g8_two_row_groups', 2), ('row_shorter_than_a_chunk', 1),
            ('row_shorter_than_a_chunk', None))):
        ctxs, s, d, ps, h, kvh, window = SPLIT_EDGES[name]
        args, scales = _split_case(dev, torch.bfloat16, ctxs=ctxs, s=s, d=d,
                                   ps=ps, h=h, kvh=kvh, quant=quant,
                                   seed=10 + seed, window=window)
        got = pa._launch(  # pylint: disable=protected-access
            *args, scale=d ** -0.5, probs_dtype=torch.bfloat16,
            scales=(scales['key_scale'], scales['value_scale'])
            if quant else None, chunk_pages=chunk)
        runs.append((got, args, dict(scale=d ** -0.5, **scales)))
    torch.cuda.synchronize()
    for got, args, kw in runs:
        _check_decode(got, args, kw, torch.bfloat16)


def _prefill_case(dev, dtype, *, bases, s, h, kvh, d, ps, L, true_lens,
                  seed=0):
    g = torch.Generator().manual_seed(seed)
    b = len(bases)
    n_read = -(-(max(bases) + s) // ps)
    k = torch.randn(b, kvh, L, d, generator=g)
    v = torch.randn(b, kvh, L, d, generator=g)
    kvm = torch.zeros(b, L, dtype=torch.bool)
    for i, n in enumerate(true_lens):
        kvm[i, :n] = True
    table = torch.arange(n_read, dtype=torch.int32).expand(b, n_read)
    q = torch.randn(b, h, s, d, generator=g)
    return (q.to(dev, dtype), k.to(dev, dtype), v.to(dev, dtype),
            table.contiguous().to(dev),
            torch.tensor(bases, dtype=torch.int32, device=dev),
            kvm.to(dev))


@pytest.mark.parametrize('bases,s,h,kvh,d,ps,true_lens,window', [
    ([0], 64, 4, 2, 128, 16, [64], None),
    ([13], 40, 4, 1, 64, 8, [50], None),
    ([96, 7], 33, 8, 2, 128, 16, [120, 30], None),
    ([200], 70, 4, 2, 128, 32, [300], 48),
    ([1536], 512, 32, 8, 128, 16, [3000], None),
    ([2560], 512, 32, 8, 128, 16, [3000], None),
    ([512], 512, 12, 12, 64, 16, [900], None),
    ([1536], 512, 28, 4, 128, 16, [3000], None),
    ([96, 7], 33, 2, 2, 256, 16, [120, 30], None),
    ([200], 70, 8, 1, 256, 32, [300], 48),
    ([1536], 512, 16, 16, 256, 16, [3000], None),
    ([2560], 512, 8, 1, 256, 16, [3000], None),
], ids=['base0', 'mqa_d64', 'ragged_pad', 'window', 'llama3_8b',
        'llama3_8b_last_chunk', 'gpt2_g1_d64', 'qwen2_7b_g7',
        'g1_d256_ragged_pad', 'g8_d256_window', 'gemma_7b_d256',
        'gemma_2b_d256_last_chunk'])
def test_ragged_prefill_kernel_matches_plain(dev, bases, s, h, kvh, d, ps,
                                             true_lens, window):
    dtype = torch.bfloat16
    case = _prefill_case(dev, dtype, bases=bases, s=s, h=h, kvh=kvh, d=d,
                         ps=ps, L=4096 if s == 512 else 512,
                         true_lens=true_lens)
    kw = dict(scale=d ** -0.5, page_size=ps, window=window)
    before = rp.launches
    got = rp.ragged_prefill_attention(*case, probs_dtype=dtype, **kw)
    torch.cuda.synchronize()
    assert rp.launches == before + 1
    assert got.shape == (len(bases), s, h, d) and got.dtype == dtype
    _assert_within_rounding(got, rp.ragged_prefill_attention_plain, case,
                            kw, probs_rounded=True)


@pytest.mark.parametrize('bases,s,h,kvh,d,ps,true_lens,window', [
    ([0], 64, 4, 2, 128, 16, [64], None),
    ([13], 40, 4, 1, 64, 8, [50], None),
    ([96, 7], 33, 8, 2, 128, 16, [120, 30], None),
    ([200], 70, 4, 2, 128, 32, [300], 48),
    ([2560], 512, 32, 8, 128, 16, [3000], None),
    ([512], 512, 12, 12, 64, 16, [900], None),
    ([1536], 512, 28, 4, 128, 16, [3000], None),
    ([96, 7], 33, 2, 2, 256, 16, [120, 30], None),
    ([200], 70, 8, 1, 256, 32, [300], 48),
    ([1536], 512, 16, 16, 256, 16, [3000], None),
    ([2560], 512, 8, 1, 256, 16, [3000], None),
], ids=['base0', 'mqa_d64', 'ragged_pad', 'window',
        'llama3_8b_last_chunk', 'gpt2_g1_d64', 'qwen2_7b_g7',
        'g1_d256_ragged_pad', 'g8_d256_window', 'gemma_7b_d256',
        'gemma_2b_d256_last_chunk'])
def test_ragged_prefill_int8_kernel_matches_plain(dev, bases, s, h, kvh, d,
                                                  ps, true_lens, window):
    dtype = torch.bfloat16
    q, k, v, table, base, kvm = _prefill_case(
        dev, torch.float32, bases=bases, s=s, h=h, kvh=kvh, d=d, ps=ps,
        L=4096 if s == 512 else 512, true_lens=true_lens)
    k, ks = _quantized(k, False)
    v, vs = _quantized(v, False)
    case = (q.to(dtype), k, v, table, base, kvm)
    kw = dict(scale=d ** -0.5, page_size=ps, window=window, key_scale=ks,
              value_scale=vs)
    before = (rp.launches, rp.launches_int8)
    got = rp.ragged_prefill_attention(*case, probs_dtype=dtype, **kw)
    torch.cuda.synchronize()
    assert (rp.launches, rp.launches_int8) == (before[0], before[1] + 1)
    assert got.shape == (len(bases), s, h, d) and got.dtype == dtype
    _assert_within_rounding(got, rp.ragged_prefill_attention_plain, case,
                            kw, probs_rounded=True)


# Cases the prefill kernel's tiling can get wrong: (bases, S, H, kvh, d,
# page size, kv_mask true lengths, window, dtype, permuted table, first
# visible position).  A permuted table walks the cache's pages out of
# order (visibility follows the physical positions, as in the plain
# version); `visible_from` hides every position below it, so the rows
# before it see no column at all and must average V over the whole walk.
PREFILL_EDGES = {
    's200': ([300], 200, 8, 2, 128, 16, [480], None, 'bf16', False, 0),
    'window1024': ([1536], 512, 32, 8, 128, 16, [3000], 1024, 'bf16', False,
                   0),
    'permuted_table': ([37], 100, 8, 2, 128, 16, [512], None, 'bf16', True,
                       0),
    'd64': ([64], 128, 8, 8, 64, 16, [192], None, 'bf16', False, 0),
    'f16': ([96, 7], 130, 8, 2, 128, 16, [300, 200], None, 'f16', False, 0),
    'ps8': ([40], 96, 8, 2, 128, 8, [150], None, 'bf16', False, 0),
    'ps32': ([64], 96, 8, 2, 128, 32, [400], 70, 'bf16', False, 0),
    'no_visible_column': ([0], 64, 4, 2, 128, 16, [512], None, 'bf16', False,
                          40),
    'base_mid_page': ([1541], 77, 8, 2, 128, 16, [2000], None, 'f16', True,
                      0),
    # Head width 256 (two warps a 16-row slice, each its half of the
    # output columns): rows that see nothing, a permuted f16 walk.
    'd256_no_visible_column': ([0], 64, 8, 1, 256, 16, [512], None, 'bf16',
                               False, 40),
    'd256_permuted_f16': ([37], 100, 4, 4, 256, 16, [512], 60, 'f16', True,
                          0),
}


def _prefill_edge(dev, name, quant):
    (bases, s, h, kvh, d, ps, true_lens, window, dt, permute,
     visible_from) = PREFILL_EDGES[name]
    dtype = torch.float16 if dt == 'f16' else torch.bfloat16
    L = 4096 if s == 512 else 512
    q, k, v, table, base, kvm = _prefill_case(
        dev, torch.float32, bases=bases, s=s, h=h, kvh=kvh, d=d, ps=ps, L=L,
        true_lens=true_lens, seed=len(name))
    # Read the whole cache, so the walk reaches past every row's last
    # visible column and the kernel skips tiles.
    n_read = L // ps
    g = torch.Generator().manual_seed(7)
    walk = (torch.randperm(n_read, generator=g) if permute
            else torch.arange(n_read))
    table = walk.to(torch.int32).expand(len(bases), n_read).contiguous()
    kvm[:, :visible_from] = False
    scales = {}
    if quant:
        k, ks = _quantized(k, False)
        v, vs = _quantized(v, False)
        scales = dict(key_scale=ks, value_scale=vs)
    else:
        k, v = k.to(dtype), v.to(dtype)
    case = (q.to(dtype), k, v, table.to(dev), base, kvm)
    return case, dtype, dict(scale=d ** -0.5, page_size=ps, window=window,
                             **scales)


@pytest.mark.parametrize('quant', [False, True], ids=['float', 'int8'])
@pytest.mark.parametrize('name', list(PREFILL_EDGES))
def test_ragged_prefill_kernel_edge_cases(dev, name, quant):
    case, dtype, kw = _prefill_edge(dev, name, quant)
    before = (rp.launches, rp.launches_int8)
    got = rp.ragged_prefill_attention(*case, probs_dtype=dtype, **kw)
    torch.cuda.synchronize()
    assert (rp.launches, rp.launches_int8) == (
        before[0] + (not quant), before[1] + quant)
    b, _, s, d = case[0].shape
    assert got.shape == (b, s, case[0].shape[1], d) and got.dtype == dtype
    _assert_within_rounding(got, rp.ragged_prefill_attention_plain, case,
                            kw, probs_rounded=True,
                            u=2.0 ** -11 if dtype == torch.float16
                            else U_BF16)


def test_int8_wrappers_raise_instead_of_falling_back(dev):
    """An int8 CUDA cache the kernels cannot take raises ValueError and is
    never handed to the plain version: a wrong scale shape, a wrong scale
    dtype, an f32 query for the tensor-core prefill kernel."""
    q, pk, pv, table, mask = _decode_case(
        dev, torch.float32, b=1, h=4, kvh=2, d=64, ps=16, ctxs=[5])
    pk, ks = _quantized(pk, True)
    pv, vs = _quantized(pv, True)
    counts = (pa.launches, pa.launches_int8)
    for kw, match in ((dict(key_scale=ks[..., 0], value_scale=vs),
                       'key_scale'),
                      (dict(key_scale=ks, value_scale=vs.half()),
                       'value_scale')):
        with pytest.raises(ValueError, match=match):
            pa.paged_decode_attention(q, pk, pv, table, mask, scale=0.1,
                                      probs_dtype=torch.float32, **kw)
    with pytest.raises(ValueError, match='device'):
        pa.paged_decode_attention(q, pk, pv, table, mask, scale=0.1,
                                  probs_dtype=torch.float32, key_scale=ks,
                                  value_scale=vs.cpu())
    assert (pa.launches, pa.launches_int8) == counts
    q, k, v, table, base, kvm = _prefill_case(
        dev, torch.float32, bases=[0], s=16, h=4, kvh=2, d=64, ps=16, L=64,
        true_lens=[16])
    k, ks = _quantized(k, False)
    v, vs = _quantized(v, False)
    counts = (rp.launches, rp.launches_int8)
    for qq, kw, match in (
            (q.bfloat16(), dict(key_scale=ks[:, :, :32], value_scale=vs),
             'key_scale'),
            (q.bfloat16(), dict(key_scale=ks, value_scale=vs.double()),
             'value_scale'),
            (q, dict(key_scale=ks, value_scale=vs), 'bfloat16 or float16')):
        with pytest.raises(ValueError, match=match):
            rp.ragged_prefill_attention(qq, k, v, table, base, kvm,
                                        scale=0.1, probs_dtype=qq.dtype,
                                        page_size=16, **kw)
    assert (rp.launches, rp.launches_int8) == counts


def test_wrappers_raise_instead_of_falling_back(dev):
    q, pk, pv, table, mask = _decode_case(
        dev, torch.float32, b=1, h=4, kvh=2, d=48, ps=16, ctxs=[5])
    with pytest.raises(ValueError, match='head_dim'):
        pa.paged_decode_attention(q, pk, pv, table, mask, scale=0.1,
                                  probs_dtype=torch.float32)
    q, pk, pv, table, mask = _decode_case(
        dev, torch.float32, b=1, h=4, kvh=2, d=64, ps=16, ctxs=[5])
    with pytest.raises(ValueError, match='one dtype'):
        pa.paged_decode_attention(q, pk, pv, table, mask, scale=0.1,
                                  probs_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='device'):
        pa.paged_decode_attention(q, pk.cpu(), pv, table, mask, scale=0.1,
                                  probs_dtype=torch.float32)
    case = _prefill_case(dev, torch.float32, bases=[0], s=16, h=4, kvh=2,
                         d=64, ps=16, L=64, true_lens=[16])
    with pytest.raises(ValueError, match='bfloat16 or float16'):
        rp.ragged_prefill_attention(*case, scale=0.1,
                                    probs_dtype=torch.float32, page_size=16)


def _flash_case(dev, dtype, b, h, kvh, s, d, seed=0):
    g = torch.Generator().manual_seed(seed)
    shapes = ((b, h, s, d), (b, kvh, s, d), (b, kvh, s, d), (b, h, s, d))
    return [torch.randn(*shape, generator=g).to(dev, dtype)
            for shape in shapes]


def _assert_within(name, got, want, tol):
    err = (got.float() - want.float()).abs()
    ratio = torch.where(tol > 0, err / tol,
                        torch.where(err > 0, float('inf'), 0.0))
    assert torch.isfinite(got).all(), name
    worst = ratio.max().item()
    assert worst <= 1.0, (f'{name}: max |err| {err.max().item():.3e}, '
                          f'{worst:.2f} x its bound')


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16],
                         ids=['bf16', 'f16'])
@pytest.mark.parametrize('b,h,kvh,s,d,causal,window,offset', [
    (1, 4, 4, 128, 64, True, None, 0),
    (2, 8, 2, 192, 128, True, None, 0),
    (1, 8, 2, 200, 128, True, None, 0),
    (1, 4, 1, 130, 64, False, None, 0),
    (1, 8, 2, 256, 128, True, 70, 0),
    (1, 4, 2, 128, 64, True, None, 40),
    (1, 32, 8, 1000, 128, True, None, 0),
    # The forward's 128-row q tiles and 128-column kv ring, the dk/dv
    # stream of (head, 64-row q tile) items: one row past a q tile; odd
    # and even counts of kv tiles (each mbarrier phase flips both ways);
    # a window below a tile; an offset past a tile; a GQA group of 8
    # whose stream crosses heads mid-ring.
    (1, 8, 2, 129, 128, True, None, 0),
    (1, 4, 2, 640, 128, True, None, 0),
    (1, 4, 2, 768, 128, True, None, 0),
    (1, 8, 2, 300, 128, True, 17, 0),
    (1, 4, 2, 256, 128, True, None, 130),
    (1, 16, 2, 320, 128, True, None, 0),
    # gpt2's heads (12 over 12 at d 64) and qwen2-7b's (28 over 4: the
    # dk/dv group sum over 7 heads).
    (2, 12, 12, 300, 64, True, None, 0),
    (1, 28, 4, 320, 128, True, None, 0),
    # Head width 256 (gemma): gemma-7b's group of 1 and gemma-2b's of 8
    # (the dk/dv group sum over 8 heads), causal, windowed, ragged, at an
    # offset and not causal; the forward's 64-column kv tiles and the dq
    # pass's 32-column ones in odd and even counts.
    (2, 4, 4, 256, 256, True, None, 0),
    (1, 8, 1, 320, 256, True, None, 0),
    (1, 8, 1, 300, 256, True, 70, 0),
    (1, 4, 4, 200, 256, True, 17, 0),
    (1, 4, 2, 129, 256, True, None, 0),
    (1, 8, 1, 256, 256, True, None, 130),
    (1, 4, 1, 130, 256, False, None, 0),
], ids=['g1_d64', 'g4_b2', 'ragged', 'mqa_noncausal_ragged', 'window',
        'offset', 'llama3_8b_heads', 's129', 's640_odd_tiles',
        's768_even_tiles', 'window17', 'offset130', 'g8_s320',
        'gpt2_g1_d64', 'qwen2_7b_g7', 'd256_g1_b2', 'd256_g8',
        'd256_g8_window70', 'd256_g1_window17', 'd256_s129',
        'd256_g8_offset130', 'd256_noncausal_ragged'])
def test_flash_kernels_match_plain(dev, dtype, b, h, kvh, s, d, causal,
                                   window, offset):
    q, k, v, do = _flash_case(dev, dtype, b, h, kvh, s, d)
    kw = dict(scale=d ** -0.5, causal=causal, window=window, offset=offset)
    before = (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)
    out, lse = fa.flash_fwd(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert (fa.fwd_launches, fa.dq_launches, fa.dkv_launches) == tuple(
        c + 1 for c in before)
    assert out.dtype == dtype and lse.dtype == dq.dtype == torch.float32
    assert dk.shape == dv.shape == (b, kvh, s, d)
    tol = fa.rounding_bounds(q, k, v, do, lse, delta, **kw)
    f32 = [x.float() for x in (q, k, v, do)]
    out32, lse32 = fa.flash_fwd_plain(*f32[:3], **kw)
    grads32 = fa.flash_bwd_plain(*f32, lse, delta, **kw)
    for name, got, want in zip(('out', 'lse', 'dq', 'dk', 'dv'),
                               (out, lse, dq, dk, dv),
                               (out32, lse32) + tuple(grads32)):
        _assert_within(name, got, want, tol[name])


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16],
                         ids=['bf16', 'f16'])
@pytest.mark.parametrize('b,h,kvh,s,d,causal,window,offset', [
    (1, 4, 2, 65, 128, True, None, 0),
    (1, 4, 2, 191, 64, True, None, 0),
    (1, 8, 2, 384, 128, True, 100, 0),
    (1, 4, 2, 320, 128, True, 64, 0),
    (1, 4, 4, 200, 64, False, None, 0),
    (2, 4, 1, 256, 128, True, None, 70),
    (1, 4, 2, 576, 128, True, None, 0),
    (1, 4, 2, 1024, 64, True, None, 0),
    (1, 4, 2, 96, 256, True, None, 0),
    (1, 4, 1, 352, 256, True, 32, 0),
    (1, 4, 4, 161, 256, True, None, 37),
], ids=['s65', 'ragged_d64', 'window100', 'window64', 'noncausal_d64',
        'offset70', 's576_odd_tiles', 's1024_d64_even_tiles',
        'd256_s96_odd_tiles', 'd256_window32', 'd256_ragged_offset37'])
def test_flash_dq_kernel_matches_plain(dev, dtype, b, h, kvh, s, d, causal,
                                       window, offset):
    """The dq pass's 128-row blocks, K/V ring (64-column tiles, 32 at d
    256) and the tiles a consumer warpgroup skips or masks: rows past a
    tile, windows below and at a tile, a ragged non-causal tile, an
    offset diagonal, odd and even counts of ring tiles."""
    q, k, v, do = _flash_case(dev, dtype, b, h, kvh, s, d, seed=2)
    kw = dict(scale=d ** -0.5, causal=causal, window=window, offset=offset)
    out, lse = fa.flash_fwd(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(-1)
    before = fa.dq_launches
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert fa.dq_launches == before + 1
    assert dq.dtype == torch.float32 and dq.shape == q.shape
    tol = fa.rounding_bounds(q, k, v, do, lse, delta, **kw)
    f32 = [x.float() for x in (q, k, v, do)]
    _assert_within('dq', dq, fa.flash_bwd_plain(*f32, lse, delta, **kw)[0],
                   tol['dq'])


@pytest.mark.parametrize('h,kvh,window', [(8, 1, None), (4, 4, 100)],
                         ids=['g8', 'g1_window100'])
def test_flash_d256_check_catches_a_dropped_column_half(dev, h, kvh, window):
    """At d 256 two warps share each 16 kv rows of the dk/dv pass, each
    with half of dk's and dv's columns.  The kernels hold their bounds;
    and the same check fails a dk or dv whose second column half was
    dropped (left at 0, as a warp that never wrote it), and a dq whose
    last 32-column kv tile was left out."""
    q, k, v, do = _flash_case(dev, torch.bfloat16, 1, h, kvh, 192, 256,
                              seed=3)
    kw = dict(scale=256 ** -0.5, causal=True, window=window)
    out, lse = fa.flash_fwd(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    tol = fa.rounding_bounds(q, k, v, do, lse, delta, **kw)
    f32 = [x.float() for x in (q, k, v, do)]
    want = dict(zip(('dq', 'dk', 'dv'),
                    fa.flash_bwd_plain(*f32, lse, delta, **kw)))
    for name, got in (('dq', dq), ('dk', dk), ('dv', dv)):
        _assert_within(name, got, want[name], tol[name])
    for name, got in (('dk', dk), ('dv', dv)):
        bad = got.clone()
        bad[..., 128:] = 0.0
        with pytest.raises(AssertionError, match='its bound'):
            _assert_within(name, bad, want[name], tol[name])
    # dq without the last 32 kv columns each query row sees.
    keep = torch.ones(192, device=dev)
    keep[160:] = 0.0
    short = fa.flash_bwd_plain(q.float(), k.float() * keep[:, None],
                               v.float(), do.float(), lse, delta, **kw)[0]
    with pytest.raises(AssertionError, match='its bound'):
        _assert_within('dq', short, want['dq'], tol['dq'])


@pytest.mark.parametrize('h,kvh,s,window', [(8, 2, 192, None),
                                            (4, 4, 130, 50)],
                         ids=['gqa4', 'mha_window_ragged'])
def test_flash_attention_autograd_matches_plain(dev, h, kvh, s, window):
    q, k, v, do = _flash_case(dev, torch.bfloat16, 2, h, kvh, s, 128,
                              seed=1)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)
    fa.flash_attention(*leaves, window=window).backward(do)
    torch.cuda.synchronize()
    assert (fa.fwd_launches, fa.dq_launches, fa.dkv_launches) == tuple(
        c + 1 for c in before)
    ref = [x.float().requires_grad_() for x in (q, k, v)]
    fa.flash_attention(*ref, window=window, plain=True).backward(do.float())
    u = 2.0 ** -8
    for got, want in zip(leaves, ref):
        assert got.grad.dtype == torch.bfloat16
        err = (got.grad.float() - want.grad).abs()
        tol = 2 * u * want.grad.abs() + 2.0 ** -7 * want.grad.abs().max()
        assert (err <= tol).all(), err.max().item()


def test_flash_wrappers_raise_instead_of_falling_back(dev):
    q, k, v, do = _flash_case(dev, torch.bfloat16, 1, 4, 2, 64, 64)
    kw = dict(scale=0.125, causal=True)
    with pytest.raises(ValueError, match='bfloat16 or float16'):
        fa.flash_fwd(q.float(), k.float(), v.float(), **kw)
    q48, k48, v48, _ = _flash_case(dev, torch.bfloat16, 1, 4, 2, 64, 48)
    with pytest.raises(ValueError, match='head_dim'):
        fa.flash_fwd(q48, k48, v48, **kw)
    q96, k96, v96, do96 = _flash_case(dev, torch.bfloat16, 1, 4, 2, 64, 96)
    lse96 = torch.zeros(1, 4, 64, device=dev)
    with pytest.raises(ValueError, match=r'head_dim in \(64, 128, 256\)'):
        fa.flash_bwd_dq(q96, k96, v96, do96, lse96, lse96, **kw)
    with pytest.raises(ValueError, match='head_dim'):
        fa.flash_bwd_dkv(q96, k96, v96, do96, lse96, lse96, **kw)
    with pytest.raises(ValueError, match='device'):
        fa.flash_fwd(q, k.cpu(), v, **kw)
    with pytest.raises(ValueError, match='contiguous'):
        fa.flash_fwd(q.transpose(2, 3), k, v, scale=0.125, causal=False)
    lse = torch.zeros(1, 4, 64, device=dev)
    with pytest.raises(ValueError, match='float32'):
        fa.flash_bwd_dq(q, k, v, do, lse.bfloat16(), lse, **kw)


# -- prefix sharing and int8 weights on the serving path ---------------------
_TINY = dict(n_layers=2, n_heads=4, n_kv_heads=2, dim=256, ffn_dim=512,
             vocab_size=512, max_seq_len=256)
SERVE_LOGITS_REL_TOL = 0.06


@pytest.mark.parametrize('quant', [False, True], ids=['float', 'int8'])
def test_paged_decode_over_shared_leading_pages(dev, quant):
    b, h, kvh, d, ps, n_shared = 4, 8, 2, 128, 16, 3
    ctxs = [100, 49, 64, 250]
    g = torch.Generator().manual_seed(7)
    n_read = -(-(max(ctxs) + 1) // ps)
    n_pages = 1 + n_shared + b * n_read
    pk = torch.randn(n_pages, kvh, ps, d, generator=g)
    pv = torch.randn(n_pages, kvh, ps, d, generator=g)
    pk[0] = pv[0] = 1e4          # the null page: garbage the mask must hide
    fresh = (torch.randperm(n_pages - 1 - n_shared, generator=g)
             + 1 + n_shared).tolist()
    table = torch.zeros(b, n_read, dtype=torch.int32)
    mask = torch.zeros(b, 1, 1, n_read * ps, dtype=torch.bool)
    for i, c in enumerate(ctxs):
        need = -(-c // ps)
        table[i, :n_shared] = torch.arange(1, 1 + n_shared)
        table[i, n_shared:need] = torch.tensor(fresh[:need - n_shared])
        del fresh[:need - n_shared]
        mask[i, 0, 0, :c] = True
    q = torch.randn(b, h, 1, d, generator=g)
    scales = {}
    if quant:
        pk, ks = _quantized(pk, True)
        pv, vs = _quantized(pv, True)
        scales = dict(key_scale=ks.to(dev), value_scale=vs.to(dev))
    else:
        pk, pv = pk.bfloat16(), pv.bfloat16()
    args = (q.bfloat16().to(dev), pk.to(dev), pv.to(dev), table.to(dev),
            mask.to(dev))
    kw = dict(scale=d ** -0.5, **scales)
    before = pa.launches_int8 if quant else pa.launches
    got = pa.paged_decode_attention(*args, probs_dtype=torch.bfloat16, **kw)
    torch.cuda.synchronize()
    assert (pa.launches_int8 if quant else pa.launches) == before + 1
    _assert_within_rounding(got, pa.paged_decode_attention_plain, args, kw,
                            probs_rounded=False)


@pytest.mark.parametrize('quant', [False, True], ids=['float', 'int8'])
def test_hydrate_then_insert_leaves_shared_pages(dev, quant):
    ps, n_shared = 16, 3
    cfg = tllama.get_config(
        'llama-tiny', **_TINY, dtype='bfloat16', kv_page_size=ps,
        kv_n_pages=40, kv_cache_dtype='int8' if quant else 'auto')
    cache = tllama.PagedCache.zeros(cfg, 2, dev)
    cache1 = tllama.PrefillCache.zeros(cfg, 1, dev)
    g = torch.Generator(device=dev).manual_seed(3)

    def fill(t):
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=g,
                                  device=dev, dtype=torch.int8))
        else:
            t.copy_(torch.rand(t.shape, generator=g, device=dev) + 0.5)

    pairs = teng._kv_pairs(cache, cache1)  # pylint: disable=protected-access
    for pool, _ in pairs:
        fill(pool)
    old = [pool.clone() for pool, _ in pairs]
    table_row = np.zeros((cfg.max_seq_len // ps,), np.int32)
    pages = [7, 3, 12, 20, 21, 22]
    table_row[:len(pages)] = pages
    n = n_shared * ps
    teng.hydrate(cache1, cache, table_row, n_shared, n)
    assert cache1.cursor == n
    for pool, dst in pairs:
        L, _, kvh, _, d = dst.shape
        want = pool[:, pages[:n_shared]].transpose(1, 2).reshape(L, kvh, n,
                                                                  d)
        assert torch.equal(dst[:, 0, :, :n], want)
        # The suffix prefill writes past the prefix; rows below it change
        # too here, so that a write of the shared pages would show.
        fill(dst)
    teng.paged_insert(cache, cache1, table_row, 1, copy_start_page=n_shared)
    torch.cuda.synchronize()
    for (pool, dst), before in zip(pairs, old):
        L, _, kvh, s, d = dst.shape
        rows = dst[:, 0].reshape(L, kvh, s // ps, ps, d).transpose(1, 2)
        assert torch.equal(pool[:, pages[:n_shared]],
                           before[:, pages[:n_shared]])
        assert torch.equal(pool[:, pages[n_shared:]],
                           rows[:, n_shared:len(pages)].to(pool.dtype))
        untouched = [p for p in range(cfg.kv_n_pages) if p not in pages]
        assert torch.equal(pool[:, untouched], before[:, untouched])
    assert cache.table[1].tolist() == table_row.tolist()


def test_int8_weight_forward_matches_cpu(dev):
    kw = dict(model='llama-tiny', model_overrides=_TINY, n_slots=2,
              page_size=16, prefill_chunk=64, quantize='int8',
              param_dtype=torch.bfloat16)
    cpu = teng.ContinuousBatchingEngine(**kw, device='cpu')
    sd = cpu.model.state_dict()
    assert sd['layers.0.mlp.down_proj'].dtype == torch.int8
    card = teng.ContinuousBatchingEngine(**kw, params=sd, device=dev)
    assert card.decode_kernel == card.prefill_kernel == 'fused'
    for key, w in card.model.state_dict().items():
        assert torch.equal(w.cpu(), sd[key]), key
    q8, scale = sd['lm_head'], sd['lm_head_scale']
    assert torch.equal(
        tllama.dequantize_int8(q8.to(dev), scale.to(dev),
                               torch.bfloat16).cpu(),
        tllama.dequantize_int8(q8, scale, torch.bfloat16))
    prompt = [(7 * i + 3) % 512 for i in range(150)]
    got = []
    for eng in (cpu, card):
        eng.submit(prompt, teng.SamplingConfig(max_new_tokens=4))
        while all(s is None for s in eng._slots):  # pylint: disable=protected-access
            eng._schedule_front()  # pylint: disable=protected-access
        got.append([eng._last[0].float().cpu(),  # pylint: disable=protected-access
                    eng.decode_logits(eng.decode_kernel)[0].float().cpu()])
    for want, logits in zip(*got):
        assert torch.isfinite(logits).all()
        gap = (logits - want).abs().max() / want.abs().max()
        assert gap <= SERVE_LOGITS_REL_TOL, gap


# -- the S = 1 decode forward replayed from CUDA graphs -----------------------
def _graph_engine(dev, kv_cache_dtype, **kw):
    """A tiny bf16 paged engine on the card whose read buckets are 64
    positions (prompts padded to 64 tokens)."""
    return teng.ContinuousBatchingEngine(
        model='llama-tiny', model_overrides=_TINY, n_slots=2, page_size=16,
        kv_read_bucket=64, kv_cache_dtype=kv_cache_dtype, device=dev, **kw)


def _go_live(eng, prompt):
    eng.submit(prompt, teng.SamplingConfig(max_new_tokens=8))
    n = sum(s is not None for s in eng._slots)  # pylint: disable=protected-access
    while sum(s is not None for s in eng._slots) == n:  # pylint: disable=protected-access
        eng._schedule_front()  # pylint: disable=protected-access


def _replay_gap(eng):
    """The next decode step's logits replayed from its graph against the
    eager forward's, over the occupied rows: max |diff| / max |logit|."""
    rows = [i for i, s in enumerate(eng._slots) if s is not None]  # pylint: disable=protected-access
    eager = eng.decode_logits('fused')[rows]
    replay = eng.decode_logits('fused', graph=True)[rows]
    assert torch.isfinite(eager).all()
    return ((replay - eager).abs().max() / eager.abs().max()).item()


@pytest.mark.parametrize('kv_cache_dtype', ['auto', 'int8'],
                         ids=['bf16', 'int8'])
def test_decode_graph_replay_equals_eager(dev, kv_cache_dtype):
    """Two read buckets (a 30-token prompt, padded to 64, reads 128
    positions; a 100-token one, padded to 128, 192), bf16 and int8
    caches: the replayed logits equal the eager forward's bit for bit
    (the same kernels in the same order on the same inputs), and each
    replay adds its graph's kernel-4 launches (one a layer) to the
    wrapper's counts."""
    eng = _graph_engine(dev, kv_cache_dtype)
    count = 'launches_int8' if kv_cache_dtype == 'int8' else 'launches'
    for prompt_len, buckets in ((30, [128]), (100, [128, 192])):
        _go_live(eng, [(7 * i + 3) % 512 for i in range(prompt_len)])
        assert _replay_gap(eng) == 0.0
        assert eng.graph_info()['buckets'] == buckets
        before = getattr(pa, count)
        eng.decode_logits('fused', graph=True)
        assert getattr(pa, count) == before + _TINY['n_layers']


def test_decode_graph_stale_mask_is_caught(dev):
    """A graph whose static kv mask is never overwritten (a planted
    fault) reads a stale mask: the check above (replay equal to eager)
    fails."""
    eng = _graph_engine(dev, 'auto')
    eng._graphs.copied = ('feed', 'positions', 'last_pos')  # pylint: disable=protected-access
    _go_live(eng, [(7 * i + 3) % 512 for i in range(30)])
    assert _replay_gap(eng) > 0.0


@pytest.mark.parametrize('kv_cache_dtype', ['auto', 'int8'],
                         ids=['bf16', 'int8'])
def test_async_graph_streams_equal_sync_eager(dev, kv_cache_dtype):
    """The pipelined engine replaying its decode graphs gives the greedy
    streams of the synchronous engine running the eager forward: three
    prompts (padded to 64) through two slots, 70 new tokens each, so the
    reads cross from 128 to 192 positions."""
    prompts = [[(5 * i + j) % 512 for i in range(n)]
               for j, n in enumerate((30, 40, 20))]
    sync = _graph_engine(dev, kv_cache_dtype, async_pipeline=False)
    sync._graphs = None  # pylint: disable=protected-access
    want = sync.generate(prompts, teng.SamplingConfig(max_new_tokens=70))
    eng = _graph_engine(dev, kv_cache_dtype)
    assert eng.generate(
        prompts, teng.SamplingConfig(max_new_tokens=70)) == want
    info = eng.graph_info()
    assert info['replays'] > 0 and len(info['buckets']) >= 2
    assert eng.pipeline_info()['depth'] == 0
    assert eng.allocator_leak_report() is None


def test_mixtral_decode_graph_replay_equals_eager(dev):
    """A mixtral-tiny engine (bf16, 4 slots, capacity_factor 0.5, so a
    decode step drops routes): the S = 1 decode forward, the MoE layers'
    routing, dispatch and combine inside it, replayed from its CUDA graph
    equals the eager forward bit for bit."""
    eng = teng.ContinuousBatchingEngine(
        model='mixtral-tiny', model_overrides=dict(_TINY, capacity_factor=0.5),
        n_slots=4, page_size=16, kv_read_bucket=64, device=dev)
    for j, n in enumerate((30, 45, 20)):
        _go_live(eng, [(7 * i + 3 * j) % 512 for i in range(n)])
    assert _replay_gap(eng) == 0.0
    assert eng.graph_info()['buckets']
