"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests build the kernels from ``csrc/`` and launch them, so they carry
the ``gpu`` marker and skip where no CUDA device exists.  They import no JAX,
so on the card they run without the JAX conftest:
``python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest -q``.
Float32 with TF32 off; atol = rtol = 1e-4 for K1 and K3 (summation order),
1e-3 for K2 (the additive -10000 key bias leaves masked logits only 2**-10
apart in float32).  K1b's gradients are held to 1e-4 of each gradient's
max |ref|: they are sums over T*B rows, split-K partials on the card against
cuBLAS in the plain version, and dx chains back through every step.  K6a
is held as K2 (1e-3, the same attention stage), K6b as K3 (1e-4).  The int8
GEMM's int32 products must equal exact float64 sums, and its dequant + bias
epilogue the plain version's bits.  K4's hidden int8 codes may differ from
the plain version's in at most 1e-3 of places (a value one float32 step from
a rounding edge); each output row is held to 1e-4 plus, per flipped code in
it, twice the largest move one code can make (``_k4_row_bound``).  The bf16
instances (K1f, K1b, K2, K3, K4, K6a, K6b) are held to 2e-2 of max |ref|
against their bf16 plain versions, those of the flash kernels (K5f, K5b,
K5dq, K5dkv) to 1e-2 and to a cosine of 0.99999 against the float32
kernel; those of K8 as the flash ones, of K7f, K7b, K9f and K9b to 2e-2
and a cosine of 0.999 against the float32 kernel (K9b beyond its relu-kink
allowance).  K7f and
K9f are held to 1e-4 absolute, K7b and K9b to 1e-4 of each output's max
|ref| (sums over T*N or R rows in another order), K9b beyond what entries
of its hidden pre-activation within 1e-4 of relu's kink may move it
(``relu_kink_bound``: either side of the kink is a valid derivative), and
K7b and K9b reruns must give the same bits (no float atomics).  K5f is
held to 1e-4 absolute (out and lse), K5dq, K5dkv and K5b (the fused flash
backward) to 1e-4 of each gradient's max |ref| (their products run on the
tensor cores in 3xTF32, float32-accurate); every flash
kernel's reruns must give the same bits too, and each call moves its launch
counter by exactly one.
"""

import numpy as np
import pytest
import torch

from multimodal_transformer_robustness_tpu_torch.models import bert as tbert
from multimodal_transformer_robustness_tpu_torch.models.mult import to_device
from multimodal_transformer_robustness_tpu_torch.ops import attention_cuda, bert_attn_cuda
from multimodal_transformer_robustness_tpu_torch.ops import bert_ffn_cuda, bigru_cuda
from multimodal_transformer_robustness_tpu_torch.ops import encoder as tenc
from multimodal_transformer_robustness_tpu_torch.ops import gru as tgru
from multimodal_transformer_robustness_tpu_torch.ops import gru_cuda, trunk_block_cuda


def gru_torch_layout(rng, in_dim, hidden):
    """One GRU direction's torch-layout weights, torch's default init range."""
    k = 1.0 / np.sqrt(hidden)

    def u(*shape):
        return torch.from_numpy(rng.uniform(-k, k, shape).astype(np.float32))

    return {d: {"w_ih": u(3 * hidden, in_dim), "w_hh": u(3 * hidden, hidden),
                "b_ih": u(3 * hidden), "b_hh": u(3 * hidden)} for d in ("fwd", "bwd")}


def attn_inputs(rng, B, L, h):
    x = rng.standard_normal((B, L, h)).astype(np.float32)
    ws = [(rng.standard_normal((h, h)) * 0.1).astype(np.float32) for _ in range(4)]
    bs = [(rng.standard_normal(h) * 0.05).astype(np.float32) for _ in range(4)]
    ln_g = (rng.standard_normal(h) * 0.2 + 1.0).astype(np.float32)
    ln_b = (rng.standard_normal(h) * 0.1).astype(np.float32)
    mask = np.ones((B, L), np.float32)
    for i in range(B):
        mask[i, rng.integers(1, L + 1):] = 0
    mask[0, :] = 0          # one fully masked item (zero-fill missing text)
    return x, ws, bs, ln_g, ln_b, mask


def attn_torch_args(x, ws, bs, ln_g, ln_b, mask):
    args = [torch.from_numpy(x), torch.from_numpy(mask)]
    for w, b in zip(ws, bs):
        args += [torch.from_numpy(np.ascontiguousarray(w.T)), torch.from_numpy(b)]
    return args + [torch.from_numpy(ln_g), torch.from_numpy(ln_b)]


def ffn_inputs(rng, rows, h, ffn):
    x = rng.standard_normal((rows, h)).astype(np.float32)
    w1 = (rng.standard_normal((ffn, h)) * 0.1).astype(np.float32)
    b1 = (rng.standard_normal(ffn) * 0.05).astype(np.float32)
    w2 = (rng.standard_normal((h, ffn)) * 0.1).astype(np.float32)
    b2 = (rng.standard_normal(h) * 0.05).astype(np.float32)
    g = (rng.standard_normal(h) * 0.2 + 1.0).astype(np.float32)
    b = (rng.standard_normal(h) * 0.1).astype(np.float32)
    return x, w1, b1, w2, b2, g, b


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,I,H", [(1, 8, 768, 100), (8, 37, 200, 100), (3, 5, 7, 12)])
def test_gru_dir_kernel_matches_plain(cuda, B, T, I, H):
    rng = np.random.default_rng(3)
    tp = gru_torch_layout(rng, I, H)
    x = torch.from_numpy(rng.standard_normal((T, B, I)).astype(np.float32)).to(cuda)
    for d, rev in (("fwd", False), ("bwd", True)):
        ops = {k: v.to(cuda) for k, v in bigru_cuda.dir_operands(tp[d]).items()}
        n0 = bigru_cuda.gru_dir.launches
        out = bigru_cuda.gru_dir(x, ops["wp"], ops["wt"], ops["bc"], ops["bhn"], rev)
        torch.cuda.synchronize()
        assert bigru_cuda.gru_dir.launches == n0 + 1
        ref = bigru_cuda.gru_dir_plain(x, ops["wp"], ops["wt"], ops["bc"], ops["bhn"], rev)
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,I,H", [(1, 50, 768, 100), (31, 50, 768, 100),
                                     (33, 50, 768, 100), (4095, 50, 768, 100),
                                     (1, 1, 768, 100), (600, 1, 200, 100), (3, 5, 7, 12),
                                     (700, 6, 20, 13)])
def test_gru_dir_kernel_plan_edges(cuda, B, T, I, H):
    """K1f across its launch plans: the small recurrence form (B <= 528)
    and the tiled one with a ragged last block (B = 33, 600, 700, 4095),
    T = 1, 4-byte projection copies (in=7) and padded gate columns (H=13),
    both directions; a rerun gives the same bits."""
    rng = np.random.default_rng(12)
    tp = gru_torch_layout(rng, I, H)
    x = torch.from_numpy(rng.standard_normal((T, B, I)).astype(np.float32)).to(cuda)
    for d, rev in (("fwd", False), ("bwd", True)):
        ops = {k: v.to(cuda) for k, v in bigru_cuda.dir_operands(tp[d]).items()}
        args = (x, ops["wp"], ops["wt"], ops["bc"], ops["bhn"], rev)
        out = bigru_cuda.gru_dir(*args)
        again = bigru_cuda.gru_dir(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, bigru_cuda.gru_dir_plain(*args), atol=1e-4, rtol=1e-4)
        assert torch.equal(out, again)


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,heads,h", [(1, 8, 12, 768), (2, 200, 12, 768), (3, 13, 2, 16),
                                         (300, 31, 12, 768)])
def test_attention_block_kernel_matches_plain(cuda, B, L, heads, h):
    """K2 across its plan: split-K mma.sync products with the LayerNorm
    adding the o-projection's planes (B=1 L=8), the unsplit q/k/v product
    (L=200), 4-wide heads (h=16), and both products on the wgmma tiles with
    a ragged last row tile (9,300 rows); a rerun gives the same bits."""
    rng = np.random.default_rng(4)
    args = [a.to(cuda) for a in attn_torch_args(*attn_inputs(rng, B, L, h))]
    out = bert_attn_cuda.attention_block_fused(*args, n_heads=heads, eps=1e-12)
    again = bert_attn_cuda.attention_block_fused(*args, n_heads=heads, eps=1e-12)
    torch.cuda.synchronize()
    ref = bert_attn_cuda.attention_block_plain(*args, n_heads=heads, eps=1e-12)
    torch.testing.assert_close(out, ref, atol=1e-3, rtol=1e-3)
    assert torch.equal(out, again)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,h,ffn", [(8, 768, 3072), (300, 768, 3072), (7, 32, 128),
                                        (9001, 768, 3072)])
def test_ffn_ln_kernel_matches_plain(cuda, rows, h, ffn):
    """K3 across its plan: split-K mma.sync tiles with the LayerNorm adding
    fc2's planes (8 rows), unsplit mma.sync tiles (300, 7), and both
    products on the wgmma tiles with a ragged last row tile (9001); a rerun
    gives the same bits."""
    rng = np.random.default_rng(5)
    x, w1, b1, w2, b2, g, b = ffn_inputs(rng, rows, h, ffn)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in (x, w1.T, b1, w2.T, b2, g, b)]
    n0 = bert_ffn_cuda.ffn_ln_block.launches
    out = bert_ffn_cuda.ffn_ln_block(*args, eps=1e-12)
    again = bert_ffn_cuda.ffn_ln_block(*args, eps=1e-12)
    torch.cuda.synchronize()
    assert bert_ffn_cuda.ffn_ln_block.launches == n0 + 2
    ref = bert_ffn_cuda.ffn_ln_block_plain(*args, eps=1e-12)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    assert torch.equal(out, again)


@pytest.mark.gpu
@pytest.mark.parametrize("need_dx", [True, False])
@pytest.mark.parametrize("B,T,I,H", [(1, 8, 768, 100), (67, 50, 200, 100), (3, 5, 7, 12),
                                     (4096, 8, 768, 100), (4096, 8, 200, 100),
                                     (64, 5, 512, 100), (5, 6, 20, 13)])
def test_gru_dir_bwd_kernel_matches_plain(cuda, B, T, I, H, need_dx):
    """K1b across its plan: 4-row blocks (B <= 528) and the one-wave 32-row
    form (B=4096), dx on the mma.sync or the wgmma tiles, 4-byte copies in
    the reductions (in=7, H=13), both directions; reruns give the same
    bits."""
    rng = np.random.default_rng(6)
    tp = gru_torch_layout(rng, I, H)
    x = torch.from_numpy(rng.standard_normal((T, B, I)).astype(np.float32)).to(cuda)
    dhs = torch.from_numpy(rng.standard_normal((T, B, H)).astype(np.float32)).to(cuda)
    for d, rev in (("fwd", False), ("bwd", True)):
        ops = {k: v.to(cuda) for k, v in bigru_cuda.dir_operands(tp[d]).items()}
        args = (x, ops["wp"], ops["wt"], ops["bc"], ops["bhn"])
        hs, gates = bigru_cuda._launch_fwd(*args, rev)
        n0 = bigru_cuda.gru_dir_bwd.launches
        got = bigru_cuda.gru_dir_bwd(*args, hs, gates, dhs, rev, need_dx)
        torch.cuda.synchronize()
        assert bigru_cuda.gru_dir_bwd.launches == n0 + 1
        assert (got[0] is None) == (not need_dx)
        ref = bigru_cuda.gru_dir_bwd_plain(*args, hs, gates, dhs, rev, need_dx)
        again = bigru_cuda.gru_dir_bwd(*args, hs, gates, dhs, rev, need_dx)
        for a, r, b in zip(got, ref, again):
            if r is None:
                continue
            scale = r.abs().max().item()
            torch.testing.assert_close(a, r, atol=1e-4 * scale, rtol=0)
            assert torch.equal(a, b)           # no float atomics: the same bits


@pytest.mark.gpu
def test_gru_dir_autograd_on_card_matches_cpu(cuda):
    """``GruDir`` (K1 forward, K1b backward) against the same function on
    the CPU (the plain versions), values and every gradient."""
    rng = np.random.default_rng(7)
    tp = gru_torch_layout(rng, 20, 16)
    x = torch.from_numpy(rng.standard_normal((9, 5, 20)).astype(np.float32))
    out = {}
    for dev in ("cpu", cuda):
        p = {d: {k: v.clone().to(dev).requires_grad_(True) for k, v in w.items()}
             for d, w in tp.items()}
        xd = x.clone().to(dev).requires_grad_(True)
        y = bigru_cuda.bigru_level_tmajor(p, xd, need_dx=True)
        y.square().sum().backward()
        out[str(dev)] = [y, xd.grad] + [p[d][k].grad for d in p for k in p[d]]
    for a, b in zip(out["cpu"], out[str(cuda)]):
        torch.testing.assert_close(b.cpu(), a, atol=1e-4, rtol=1e-4)


def _k4_row_bound(x, codes, scales, w2, b2, ln_g, flips_per_row):
    """1e-4 plus, per flipped hidden code, twice one code's largest move
    (sg * max|w2| in y, through the LayerNorm: * max|ln_g| / the row's std)."""
    s = x + bert_ffn_cuda.qdot_plain(codes, scales, w2, b2)
    w2max = (w2["q"].float() * w2["s"][:, None]).abs().max()
    step = scales[:, 0] * w2max * ln_g.abs().max() / s.std(dim=-1, unbiased=False)
    return 1e-4 + 2.0 * flips_per_row * step


@pytest.mark.gpu
@pytest.mark.parametrize("rows,h,ffn", [(8, 768, 3072), (300, 768, 3072), (7, 32, 128),
                                        (33, 40, 100), (9001, 768, 3072)])
def test_ffn_ln_q_kernel_matches_plain(cuda, rows, h, ffn):
    """K4; (33, 40, 100) has no dimension a multiple of the 64-wide tiles or
    of the 16-byte loads; 9,001 rows take the wgmma tiles (a ragged last row
    tile) and GEMM1's row maxima."""
    rng = np.random.default_rng(8)
    x, w1, b1, w2, b2, g, b = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
                               for a in ffn_inputs(rng, rows, h, ffn)]
    w1q, w2q = tbert._quantize(w1), tbert._quantize(w2)
    args = (x, w1q, b1, w2q, b2, g, b)
    n0 = bert_ffn_cuda.ffn_ln_block_q.launches
    out, codes, scales = bert_ffn_cuda.ffn_ln_block_q(*args, eps=1e-12, return_codes=True)
    torch.cuda.synchronize()
    assert bert_ffn_cuda.ffn_ln_block_q.launches == n0 + 1
    ref, ref_codes, ref_scales = bert_ffn_cuda.ffn_ln_block_q_plain(*args, eps=1e-12,
                                                                    return_codes=True)
    flipped = codes != ref_codes
    assert flipped.float().mean().item() <= 1e-3
    limit = _k4_row_bound(x, ref_codes, ref_scales, w2q, b2, g, flipped.sum(-1))
    assert ((out - ref).abs().amax(-1) <= limit).all()
    xq, _ = bert_ffn_cuda.qrows(x)
    for a, w in ((xq, w1q), (ref_codes, w2q)):
        exact = bert_ffn_cuda.int8_matmul_plain(a, w["q"]).to(torch.int32)
        assert torch.equal(bert_ffn_cuda.int8_matmul(a, w["q"]), exact)


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,K", [(8, 768, 768), (1000, 300, 768), (5, 7, 37), (70, 64, 3072),
                                   (9001, 768, 768), (20000, 300, 3072)])
def test_int8_gemm_exact(cuda, M, N, K):
    """int32 products equal exact sums (the K=3072 cases at the extreme
    codes, |sum| = 127^2 * 3072); the dequant + bias epilogue is
    bit-identical.  The last two take the wgmma tiles (ragged row and column
    tiles)."""
    rng = np.random.default_rng(9)
    a = torch.from_numpy(rng.integers(-127, 128, (M, K)).astype(np.int8)).to(cuda)
    w = torch.from_numpy(rng.integers(-127, 128, (N, K)).astype(np.int8)).to(cuda)
    if K == 3072:
        a[0], w[0], w[1] = 127, 127, -127
    acc = bert_ffn_cuda.int8_matmul(a, w)
    exact = a.cpu().long() @ w.cpu().long().t()
    assert torch.equal(acc.cpu().long(), exact)
    sx = torch.from_numpy(rng.random((M, 1)).astype(np.float32) * 0.01).to(cuda)
    wq = {"q": w, "s": torch.from_numpy(rng.random(N).astype(np.float32) * 0.01).to(cuda)}
    bias = torch.from_numpy(rng.standard_normal(N).astype(np.float32)).to(cuda)
    assert torch.equal(bert_ffn_cuda.qdot(a, sx, wq, bias),
                       bert_ffn_cuda.qdot_plain(a, sx, wq, bias))
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(cuda)
    for got, ref in zip(bert_ffn_cuda.qrows(x), bert_ffn_cuda.qrows_plain(x)):
        assert torch.equal(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,heads,h", [(1, 8, 12, 768), (2, 200, 12, 768), (3, 13, 2, 16)])
def test_dense_attention_kernel_matches_plain(cuda, B, L, heads, h):
    rng = np.random.default_rng(10)
    mask = torch.from_numpy(attn_inputs(rng, B, L, h)[-1]).to(cuda)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, L, heads, h // heads))
                                .astype(np.float32)).to(cuda) for _ in range(3))
    out = bert_attn_cuda.dense_attention_blockdiag(q, k, v, mask)
    torch.cuda.synchronize()
    ref = bert_attn_cuda.dense_attention_plain(q, k, v, mask)
    torch.testing.assert_close(out, ref, atol=1e-3, rtol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [8, 64])
@pytest.mark.parametrize("L", [1, 31, 33, 64, 65, 512])
def test_dense_attention_kernel_plan_edges(cuda, L, dh):
    """K6a across its launch plans: the unit path (L <= 64, 32 or 64 key
    rows) and the tiled path (L > 64, a ragged last key tile), head_dim 8
    and 64, item 0 fully masked (finite, as HF's bias leaves it); a rerun
    gives the same bits."""
    rng = np.random.default_rng(13)
    B, heads = 3, (12 if dh == 64 else 2)
    mask = torch.from_numpy(attn_inputs(rng, B, L, heads * dh)[-1]).to(cuda)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, L, heads, dh))
                                .astype(np.float32)).to(cuda) for _ in range(3))
    out = bert_attn_cuda.dense_attention_blockdiag(q, k, v, mask)
    again = bert_attn_cuda.dense_attention_blockdiag(q, k, v, mask)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    ref = bert_attn_cuda.dense_attention_plain(q, k, v, mask)
    torch.testing.assert_close(out, ref, atol=1e-3, rtol=1e-3)
    assert torch.equal(out, again)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,h", [(8, 768), (300, 768), (7, 32), (9001, 768),
                                    (131072, 768), (8, 13), (9001, 13)])
def test_proj_ln_kernel_matches_plain(cuda, rows, h):
    """K6b across its plan (K2's o-projection + LN): split-K mma.sync tiles
    with the LayerNorm adding the planes (8 rows), unsplit mma.sync tiles
    (300, 7), the wgmma tiles with a ragged last row tile (9,001) and at the
    training rows (131,072), and h = 13 on 4-byte copies; a rerun gives the
    same bits."""
    rng = np.random.default_rng(11)
    resid, a = (rng.standard_normal((rows, h)).astype(np.float32) for _ in range(2))
    w_t = (rng.standard_normal((h, h)) * 0.05).astype(np.float32)
    b, bb = ((rng.standard_normal(h) * 0.05).astype(np.float32) for _ in range(2))
    g = (1.0 + 0.2 * rng.standard_normal(h)).astype(np.float32)
    args = [torch.from_numpy(t).to(cuda) for t in (resid, a, w_t, b, g, bb)]
    n0 = bert_ffn_cuda.proj_ln_block.launches
    out = bert_ffn_cuda.proj_ln_block(*args, eps=1e-12)
    again = bert_ffn_cuda.proj_ln_block(*args, eps=1e-12)
    torch.cuda.synchronize()
    assert bert_ffn_cuda.proj_ln_block.launches == n0 + 2
    ref = bert_ffn_cuda.proj_ln_block_plain(*args, eps=1e-12)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    assert torch.equal(out, again)


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["auto", "fused", "dense", "xla"])
@pytest.mark.parametrize("int8", ["float", "ffn", "full"])
def test_bert_variants_on_card_match_cpu(cuda, impl, int8, monkeypatch):
    """A small BERT under each ATTN_IMPL and int8 mode, the card (kernels)
    against the CPU (plain versions): float at 1e-4; int8 with at most one
    row in ten beyond 1e-4 (a flipped code) and none beyond 3e-3 (one step,
    as in tests/test_torch_bert_variants.py)."""
    monkeypatch.setattr(tbert, "ATTN_IMPL", impl)
    cfg = tbert.BertConfig(vocab_size=50, hidden_size=64, num_layers=2, num_heads=2,
                           intermediate_size=256, max_position=32)
    params = tbert.prepare_bert(tbert.init_bert(torch.Generator().manual_seed(0), cfg))
    if int8 != "float":
        params = tbert.quantize_bert_params(params, attn=int8 == "full")
    rng = np.random.default_rng(12)
    ids = torch.from_numpy(rng.integers(0, 50, (3, 9)))
    mask = torch.ones(3, 9)
    mask[1, 5:] = 0
    types = torch.zeros(3, 9, dtype=torch.long)
    out = tbert.bert_apply(to_device(params, cuda), ids.to(cuda), mask.to(cuda),
                           types.to(cuda), cfg).cpu()
    ref = tbert.bert_apply(params, ids, mask, types, cfg)
    if int8 == "float":
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    else:
        diff = (out - ref).abs()
        assert (diff > 1e-4 + 1e-4 * ref.abs()).any(-1).float().mean() <= 0.1
        assert diff.max() <= 3e-3


# (b, h, tq, tk, d, causal, rate, offset): the MOSEI self and cross
# (offset 19) shapes at small batch, several tiles, a D above 64, and a
# narrow D; then the edges of K5f's and K5dkv's plans: one row and key, the
# largest unit slice, the first tiled shapes (65 x 65, one query over 130
# keys), D = 1, D = 128 on both K5f paths (the tiled one with 64 query
# rows); then offsets below the default 1 + |Tk - Tq| on the tiled path,
# under which whole 64-key tiles are seen by no query (K5dkv writes zeros
# there without walking a query tile); last, 129 query rows against 300
# keys, which K5dq's 64-row blocks cut one row past a block's edge.
# offset None: the default.
_FLASH_CASES = [(2, 8, 50, 50, 25, True, 0.0, None), (2, 8, 50, 32, 25, True, 0.1, None),
                (1, 2, 130, 70, 64, True, 0.1, None), (2, 2, 7, 200, 128, False, 0.3, None),
                (1, 1, 300, 300, 8, True, 0.0, None), (1, 2, 1, 1, 25, True, 0.1, None),
                (2, 2, 64, 64, 25, True, 0.3, None), (1, 2, 65, 65, 25, True, 0.1, None),
                (1, 2, 1, 130, 25, True, 0.0, None), (2, 3, 17, 9, 1, True, 0.1, None),
                (1, 2, 40, 64, 128, True, 0.1, None), (1, 2, 150, 150, 128, True, 0.0, None),
                (1, 2, 1, 130, 25, True, 0.0, 1), (1, 2, 65, 200, 25, True, 0.1, 1),
                (2, 2, 130, 300, 64, True, 0.3, 40), (1, 2, 129, 300, 25, True, 0.1, None)]


def _flash_inputs(cuda, b, h, tq, tk, d, rate, seed=13):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, t, d)).astype(np.float32)).to(cuda)
               for t in (tq, tk, tk))
    seeds = rates = None
    if rate:
        seeds = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, b * h).astype(np.int32)).to(cuda)
        rates = torch.full((b * h,), rate, device=cuda)
    return q, k, v, seeds, rates


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,tq,tk,d,causal,rate,offset", _FLASH_CASES)
def test_flash_fwd_kernel_matches_plain(cuda, b, h, tq, tk, d, causal, rate, offset):
    q, k, v, seeds, rates = _flash_inputs(cuda, b, h, tq, tk, d, rate)
    n0 = attention_cuda.flash_fwd.launches
    out, lse = attention_cuda.flash_fwd(q, k, v, seeds, rates, causal, offset)
    torch.cuda.synchronize()
    assert attention_cuda.flash_fwd.launches == n0 + 1
    ref, ref_lse = attention_cuda.flash_attention_plain(q, k, v, causal, offset, seeds, rates)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
    again = attention_cuda.flash_fwd(q, k, v, seeds, rates, causal, offset)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])   # the same bits


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,tq,tk,d,causal,rate,offset", _FLASH_CASES)
def test_flash_bwd_kernels_match_plain(cuda, b, h, tq, tk, d, causal, rate, offset):
    """K5dq and K5dkv from the plain forward's out and lse, against autograd
    through the plain version; a rerun gives the same bits.  Each gradient
    is held to 1e-4 of its max |ref|; where every query sees one key (Tk =
    1, or one query under offset 1) dq and dk are zero in exact arithmetic,
    so they are held to 1e-4 of dv's max |ref|, as in the fused backward's
    test."""
    q, k, v, seeds, rates = _flash_inputs(cuda, b, h, tq, tk, d, rate)
    dout = torch.from_numpy(np.random.default_rng(14).standard_normal(q.shape)
                            .astype(np.float32)).to(cuda)
    out, lse = attention_cuda.flash_attention_plain(q, k, v, causal, offset, seeds, rates)
    delta = (dout * out).sum(-1).reshape(b * h, tq)
    args = (q, k, v, dout, lse, delta, seeds, rates, causal, offset)
    n0 = (attention_cuda.flash_bwd_dq.launches, attention_cuda.flash_bwd_dkv.launches)
    got = (attention_cuda.flash_bwd_dq(*args),) + attention_cuda.flash_bwd_dkv(*args)
    torch.cuda.synchronize()
    assert (attention_cuda.flash_bwd_dq.launches,
            attention_cuda.flash_bwd_dkv.launches) == (n0[0] + 1, n0[1] + 1)
    ref = attention_cuda.flash_attention_bwd_plain(q, k, v, dout, causal, offset, seeds, rates)
    again = (attention_cuda.flash_bwd_dq(*args),) + attention_cuda.flash_bwd_dkv(*args)
    scale_dv = ref[2].abs().max().item()
    one_key = tk == 1 or (causal and tq == 1 and offset == 1)
    for a, r, b_ in zip(got, ref, again):
        scale = scale_dv if one_key else r.abs().max().item()
        torch.testing.assert_close(a, r, atol=1e-4 * scale, rtol=0)
        assert torch.equal(a, b_)              # no float atomics: the same bits


# K5b at the edges of its plan: one row and key, a ragged cross shape, the
# MOSEI cross and self shapes, the largest slice it takes
_FUSED_BWD_SHAPES = [(1, 1), (7, 20), (50, 32), (50, 50), (64, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("tq,tk", _FUSED_BWD_SHAPES)
@pytest.mark.parametrize("d", [8, 25, 64])
@pytest.mark.parametrize("causal,rate", [(True, 0.0), (True, 0.3), (False, 0.0), (False, 0.3)])
def test_flash_bwd_fused_kernel_matches_plain(cuda, tq, tk, d, causal, rate):
    """K5b (``flash_bwd`` at Tq, Tk <= 64, delta inside) from the plain
    forward's out and lse, against autograd through the plain version; one
    launch a call, none of K5dq / K5dkv; a rerun gives the same bits.  Each
    gradient is held to 1e-4 of its max |ref|; at Tk = 1 the softmax has one
    key, so dq and dk are zero in exact arithmetic and both sides leave only
    rounding: they are held to 1e-4 of dv's max |ref| there."""
    b, h = 2, 3
    q, k, v, seeds, rates = _flash_inputs(cuda, b, h, tq, tk, d, rate)
    dout = torch.from_numpy(np.random.default_rng(14).standard_normal(q.shape)
                            .astype(np.float32)).to(cuda)
    out, lse = attention_cuda.flash_attention_plain(q, k, v, causal, None, seeds, rates)
    args = (q, k, v, dout, out, lse, seeds, rates, causal)
    n0 = (attention_cuda.flash_bwd.launches, attention_cuda.flash_bwd_dq.launches,
          attention_cuda.flash_bwd_dkv.launches)
    got = attention_cuda.flash_bwd(*args)
    torch.cuda.synchronize()
    assert (attention_cuda.flash_bwd.launches, attention_cuda.flash_bwd_dq.launches,
            attention_cuda.flash_bwd_dkv.launches) == (n0[0] + 1, n0[1], n0[2])
    ref = attention_cuda.flash_attention_bwd_plain(q, k, v, dout, causal, None, seeds, rates)
    again = attention_cuda.flash_bwd(*args)
    scale_dv = ref[2].abs().max().item()
    for a, r, b_ in zip(got, ref, again):
        scale = scale_dv if tk == 1 else r.abs().max().item()
        torch.testing.assert_close(a, r, atol=1e-4 * scale, rtol=0)
        assert torch.equal(a, b_)              # no float atomics: the same bits


@pytest.mark.gpu
def test_flash_bwd_takes_the_pair_past_64(cuda):
    """Past 64 rows or keys ``flash_bwd`` runs the delta op, K5dq and K5dkv
    (one launch each), equal to those entries called directly."""
    q, k, v, seeds, rates = _flash_inputs(cuda, 1, 2, 64, 65, 25, 0.1)
    dout = torch.from_numpy(np.random.default_rng(14).standard_normal(q.shape)
                            .astype(np.float32)).to(cuda)
    out, lse = attention_cuda.flash_fwd(q, k, v, seeds, rates, True)
    n0 = (attention_cuda.flash_bwd.launches, attention_cuda.flash_bwd_dq.launches,
          attention_cuda.flash_bwd_dkv.launches)
    got = attention_cuda.flash_bwd(q, k, v, dout, out, lse, seeds, rates, True)
    assert (attention_cuda.flash_bwd.launches, attention_cuda.flash_bwd_dq.launches,
            attention_cuda.flash_bwd_dkv.launches) == (n0[0], n0[1] + 1, n0[2] + 1)
    delta = (dout * out).sum(-1).reshape(2, 64)
    pair_args = (q, k, v, dout, lse, delta, seeds, rates, True)
    pair = (attention_cuda.flash_bwd_dq(*pair_args),) + attention_cuda.flash_bwd_dkv(*pair_args)
    for a, b_ in zip(got, pair):
        assert torch.equal(a, b_)


@pytest.mark.gpu
def test_flash_autograd_on_card_matches_cpu(cuda):
    """``flash_attention`` (K5f forward, ``flash_bwd`` backward: K5b here,
    Tq=40 Tk=57) against the same function on the CPU (the plain version
    under autograd), there in float64: these inputs are not pre-scaled
    (logits of std 5, dq up to 16), where float32 on the CPU rounds
    differently from one process to another by up to ~1e-4 in dq, so a
    float32 reference would decide the result by its own rounding."""
    q, k, v, seeds, rates = _flash_inputs("cpu", 2, 3, 40, 57, 25, 0.2)
    out = {}
    for dev, dtype in (("cpu", torch.float64), (cuda, torch.float32)):
        leaves = [t.to(dev, dtype).requires_grad_(True) for t in (q, k, v)]
        y = attention_cuda.flash_attention(*leaves, True, None, seeds.to(dev), rates.to(dev))
        y.sin().sum().backward()
        out[str(dev)] = [y] + [t.grad for t in leaves]
    for a, b in zip(out["cpu"], out[str(cuda)]):
        torch.testing.assert_close(b.cpu(), a.float(), atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,t,d", [(1, 12, 8, 64), (3, 12, 32, 64), (2, 2, 100, 25),
                                     (1, 12, 512, 64), (3, 2, (9, 40), 25),
                                     (3, 12, (64, 33), 64), (4, 3, (50, 32), 25),
                                     (3, 2, (100, 70), 25), (2, 12, (1, 129), 64)])
def test_flash_masked_kernel_matches_plain(cuda, b, h, t, d):
    """K8 with ragged masks, a mask with holes and an all-zero row (the
    rewrite inside the kernel); ``t`` is T or (Tq, Tk).  Tq, Tk <= 64 run
    K6a's unit kernel, longer ones its tiled kernel.  One launch a call; a
    rerun gives the same bits."""
    tq, tk = t if isinstance(t, tuple) else (t, t)
    rng = np.random.default_rng(15)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)

    q, k, v = randn(b, h, tq, d), randn(b, h, tk, d), randn(b, h, tk, d)
    mask = np.ones((b, tk), np.int32)
    for i in range(b):
        mask[i, rng.integers(1, tk + 1):] = 0
    mask[0] = 0
    if b > 2:
        mask[2, ::3] = 0
    mask = torch.from_numpy(mask).to(cuda)
    n0 = attention_cuda.flash_attention_masked.launches
    out = attention_cuda.flash_attention_masked(q, k, v, mask)
    torch.cuda.synchronize()
    assert attention_cuda.flash_attention_masked.launches == n0 + 1
    ref = attention_cuda.flash_attention_masked_plain(q, k, v, mask)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    assert torch.equal(out, attention_cuda.flash_attention_masked(q, k, v, mask))


@pytest.mark.gpu
def test_flash_masked_refuses_grad(cuda):
    q = torch.zeros(1, 2, 8, 16, device=cuda, requires_grad=True)
    with pytest.raises(ValueError, match="no backward"):
        attention_cuda.flash_attention_masked(q, q.detach(), q.detach(),
                                              torch.ones(1, 8, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["self", "cross"])
def test_flash_encoder_on_card_matches_cpu(cuda, mode):
    """A flash encoder stack in train mode, every dropout 0: outputs and
    every gradient on the card against the CPU."""
    E, H, Dh, L = 40, 4, 10, 2
    hp = tenc.EncoderHParams(embed_dim_in=E, num_heads=H, head_dim=Dh, layers=L,
                             attn_mask=True, attn_impl="flash")
    params = tenc.init_encoder(torch.Generator().manual_seed(0), hp)
    rng = np.random.default_rng(16)
    x = torch.from_numpy(rng.standard_normal((3, 50, E)).astype(np.float32))
    kv = (torch.from_numpy(rng.standard_normal((3, 32, E)).astype(np.float32))
          if mode == "cross" else None)
    out = {}
    for dev in ("cpu", cuda):
        p = to_device(params, dev)
        leaves = [t.requires_grad_(True) for lp in p["layers"] for blk in lp.values()
                  for t in blk.values()]
        m = tenc.EncoderMasks(*(torch.ones(n, device=dev) for n in (L, H, Dh, 4 * H * Dh)))
        y = tenc.encoder_forward(p, x.to(dev), None if kv is None else kv.to(dev), hp=hp,
                                 masks=m, attn_rate=0.0, train=True,
                                 generator=torch.Generator(device=dev).manual_seed(0))
        y.square().sum().backward()
        out[str(dev)] = [y] + [t.grad for t in leaves]
    for a, b in zip(out["cpu"], out[str(cuda)]):
        torch.testing.assert_close(b.cpu(), a, atol=1e-4 * max(a.abs().max().item(), 1.0),
                                   rtol=0)


def _rec_inputs(rng, G, T, N, H, dev):
    """gi_r, gi_z, gi_n [G, T, N, H], w_r/z/n [G, H, H] (torch's init range),
    b_r/z/n [G, H] and a cotangent dhs, float32 on ``dev``."""
    k = 1.0 / np.sqrt(H)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    gates = [t(rng.standard_normal((G, T, N, H))) for _ in range(3)]
    weights = [t(rng.uniform(-k, k, (G, H, H))) for _ in range(3)]
    biases = [t(rng.uniform(-k, k, (G, H))) for _ in range(3)]
    return gates, weights, biases, t(rng.standard_normal((G, T, N, H)))


@pytest.mark.gpu
@pytest.mark.parametrize("G,T,N,H", [(2, 50, 300, 100), (2, 64, 1, 100), (3, 7, 5, 12),
                                     (2, 50, 4096, 100), (3, 12, 45, 99), (2, 30, 70, 101),
                                     (3, 11, 40, 13)])
def test_gru_recurrence_kernels_match_plain(cuda, G, T, N, H):
    """K7f on K1f's two recurrence forms: tiled (N=300, 4096; odd H=99, 101
    with N not a multiple of the block's rows) and small (G*N <= 132: N=1,
    G=3 with H=12 and odd H=13); K7b held to its plain version and rerun
    for the same bits."""
    gates, weights, biases, dhs = _rec_inputs(np.random.default_rng(17), G, T, N, H, cuda)
    args = (*gates, *weights, *biases)
    n0 = gru_cuda.gru_recurrence_cuda.launches
    hs = gru_cuda.gru_recurrence_cuda(*args)
    torch.cuda.synchronize()
    assert gru_cuda.gru_recurrence_cuda.launches == n0 + 1
    torch.testing.assert_close(hs, gru_cuda.gru_recurrence_plain(*args), atol=1e-4, rtol=0)
    bwd_args = (*gates, hs, dhs, *weights, *biases)
    got = gru_cuda.gru_recurrence_bwd_cuda(*bwd_args)
    torch.cuda.synchronize()
    ref = gru_cuda.gru_recurrence_bwd_plain(*bwd_args)
    again = gru_cuda.gru_recurrence_bwd_cuda(*bwd_args)
    for a, r, b in zip(got, ref, again):
        torch.testing.assert_close(a, r, atol=1e-4 * r.abs().max().item(), rtol=0)
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("G,T,N,H", [(2, 8, 4096, 100), (2, 64, 1, 100), (3, 9, 300, 13),
                                     (3, 9, 40, 13), (2, 6, 265, 100), (2, 6, 264, 100)])
def test_gru_recurrence_bwd_kernel_matches_plain(cuda, G, T, N, H):
    """K7b by its plan: K1b's tiled backward recurrence over G groups (two
    waves at G=2 N=4096; H=13 at N=300; just past the row form's four waves
    at G*N=530) and a block a row (N=1, G=3 N=40, G*N=528); four [G, T, N,
    H] views of one
    [G, T*N, 4H] output, held to the plain version at 1e-4 of max |ref|;
    a rerun gives the same bits."""
    gates, weights, biases, dhs = _rec_inputs(np.random.default_rng(20), G, T, N, H, cuda)
    hs = gru_cuda.gru_recurrence_plain(*gates, *weights, *biases)
    bwd_args = (*gates, hs, dhs, *weights, *biases)
    n0 = gru_cuda.gru_recurrence_bwd_cuda.launches
    got = gru_cuda.gru_recurrence_bwd_cuda(*bwd_args)
    again = gru_cuda.gru_recurrence_bwd_cuda(*bwd_args)
    torch.cuda.synchronize()
    assert gru_cuda.gru_recurrence_bwd_cuda.launches == n0 + 2
    ref = gru_cuda.gru_recurrence_bwd_plain(*bwd_args)
    for a, r, b in zip(got, ref, again):
        assert a.shape == (G, T, N, H)
        torch.testing.assert_close(a, r, atol=1e-4 * r.abs().max().item(), rtol=0)
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_bigru_forward_on_card_matches_cpu(cuda):
    """bigru_forward through K7f / K7b: outputs and every gradient."""
    rng = np.random.default_rng(18)
    params = gru_torch_layout(rng, 20, 16)
    x = torch.from_numpy(rng.standard_normal((6, 11, 20)).astype(np.float32))
    out = {}
    for dev in ("cpu", cuda):
        p = {d: {k: v.to(dev, copy=True).requires_grad_(True) for k, v in params[d].items()}
             for d in ("fwd", "bwd")}
        xd = x.to(dev, copy=True).requires_grad_(True)
        y, fin = tgru.bigru_forward(p, xd)
        (y.sin().sum() + fin.sum()).backward()
        out[str(dev)] = [y, fin, xd.grad] + [v.grad for d in ("fwd", "bwd")
                                              for v in p[d].values()]
    for a, b in zip(out["cpu"], out[str(cuda)]):
        torch.testing.assert_close(b.cpu(), a, atol=1e-4 * max(a.abs().max().item(), 1.0),
                                   rtol=0)


def _block_inputs(rng, R, E, F, dev, masked):
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    x, src, dout = (t(rng.standard_normal((R, E))) for _ in range(3))
    params = [t(rng.standard_normal((F, E)) / np.sqrt(E)), t(rng.standard_normal(F) * 0.1),
              t(rng.standard_normal((E, F)) / np.sqrt(F)), t(rng.standard_normal(E) * 0.1),
              t(1 + 0.1 * rng.standard_normal(E)), t(0.1 * rng.standard_normal(E))]
    masks = [t((np.arange(n) < (n * 3) // 4) if masked else np.ones(n)) for n in (E, F, E)]
    return x, src, dout, params, masks


@pytest.mark.gpu
@pytest.mark.parametrize("R,E,F,act,rep,masked", [
    (4096, 200, 200, "id", 25, False), (4096, 1000, 800, "relu", 1, True),
    (1, 200, 800, "relu", 1, False), (13, 16, 24, "id", 4, True),
    # K9's plan branches: split-K at few rows, a ragged last row tile (the
    # hash sees the global row), 4-byte copies (E, F1 not multiples of 4)
    (8, 1000, 800, "relu", 1, True), (4095, 1000, 800, "relu", 1, True),
    (13, 30, 50, "relu", 5, True)])
def test_trunk_block_kernels_match_plain(cuda, R, E, F, act, rep, masked):
    x, src, dout, params, masks = _block_inputs(np.random.default_rng(19), R, E, F, cuda,
                                                masked)
    cfg = trunk_block_cuda.BlockConfig(act, rep, 0.1, 0.3, 11, -7, True, True)
    n0 = trunk_block_cuda.trunk_block_fwd.launches
    out = trunk_block_cuda.trunk_block_fwd(x, src, *params, *masks, cfg)
    torch.cuda.synchronize()
    assert trunk_block_cuda.trunk_block_fwd.launches == n0 + 1
    ref = trunk_block_cuda.fused_residual_block_reference(x, src, *params, *masks, cfg)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    bargs = (x, src, dout, *params, *masks, cfg)
    n0 = trunk_block_cuda.trunk_block_bwd.launches
    got = trunk_block_cuda.trunk_block_bwd(*bargs)
    torch.cuda.synchronize()
    assert trunk_block_cuda.trunk_block_bwd.launches == n0 + 1
    ref = trunk_block_cuda.trunk_block_bwd_plain(*bargs)
    again = trunk_block_cuda.trunk_block_bwd(*bargs)
    assert trunk_block_cuda.trunk_block_bwd.launches == n0 + 2
    _, slack = trunk_block_cuda.relu_kink_bound(*bargs)
    for a, r, b, s in zip(got, ref, again, slack):
        # beyond what entries at relu's kink may move it, 1e-4 of max |ref|
        assert ((a - r).abs() - s).max().item() <= 1e-4 * max(r.abs().max().item(), 1e-30)
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_fused_residual_block_on_card_matches_cpu(cuda):
    """The public op in self mode, dropout on: the position hash makes the
    two devices' masks identical, so outputs and gradients agree."""
    x, _, dout, params, masks = _block_inputs(np.random.default_rng(20), 37, 40, 96, "cpu",
                                              True)
    kw = dict(act="relu", rate_mid=0.1, rate_res=0.3, seed_mid=3, seed_res=4,
              use_drop_mid=True, use_drop_res=True)
    out = {}
    for dev in ("cpu", cuda):
        leaves = [a.to(dev, copy=True).requires_grad_(True) for a in [x] + params]
        y = trunk_block_cuda.fused_residual_block(leaves[0], leaves[0], *leaves[1:],
                                                  *(m.to(dev) for m in masks), **kw)
        (y * dout.to(dev)).sum().backward()
        out[str(dev)] = [y] + [a.grad for a in leaves]
    for a, b in zip(out["cpu"], out[str(cuda)]):
        torch.testing.assert_close(b.cpu(), a, atol=1e-4 * max(a.abs().max().item(), 1.0),
                                   rtol=0)


# ---------------------------------------------------------------- bf16
# The bf16 instances of K1f, K1b, K2 and K3 against their bf16 plain
# versions (the same rounding points, products as float32 matmuls of the
# upcast operands): max |out - ref| <= 2e-2 of max |ref| (a result one
# bf16 step apart where a float32 sum in another order lands across a
# rounding edge, and what that step moves downstream); reruns give the
# same bits.  The share of elements that differ is printed.
BF16_TOL = 2e-2


def bf16_close(out, ref, what=""):
    assert out.dtype == ref.dtype
    a, r = out.float(), ref.float()
    scale = r.abs().max().item()
    err = (a - r).abs().max().item()
    share = (a != r).float().mean().item()
    print(f"{what}: max |d| {err:.3e} of max |ref| {scale:.3e}, {share:.2%} differ")
    assert err <= BF16_TOL * scale


def _bf(t, dev):
    return t.to(device=dev, dtype=torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,I,H", [(1, 8, 768, 100), (8, 37, 200, 100), (3, 5, 7, 12),
                                     (600, 6, 20, 13), (4096, 8, 768, 100),
                                     (133, 50, 768, 100), (4095, 8, 768, 100),
                                     (4096, 1, 768, 100), (300, 9, 7, 12)])
def test_gru_dir_bf16_kernel_matches_plain(cuda, B, T, I, H):
    """K1f's bf16 instance: the small recurrence form (B <= 132) and the
    mma form past it (16- and 32-row blocks, a ragged last row group, T =
    1, H = 12 and 13: padded n tiles, odd H's 2-byte stores and 4-byte gate
    copies), split and unsplit projections, 1- and 2-element copies (in=7,
    H=13)."""
    assert bigru_cuda._plan_recurrence_bf16(B, H)["rec_mma"] == int(B > 132)
    rng = np.random.default_rng(21)
    tp = gru_torch_layout(rng, I, H)
    x = _bf(torch.from_numpy(rng.standard_normal((T, B, I)).astype(np.float32)), cuda)
    for d, rev in (("fwd", False), ("bwd", True)):
        ops = {k: _bf(v, cuda) for k, v in bigru_cuda.dir_operands(tp[d]).items()}
        args = (x, ops["wp"], ops["wt"], ops["bc"], ops["bhn"], rev)
        n0 = bigru_cuda.gru_dir.launches_bf16
        out = bigru_cuda.gru_dir(*args)
        again = bigru_cuda.gru_dir(*args)
        torch.cuda.synchronize()
        assert bigru_cuda.gru_dir.launches_bf16 == n0 + 2
        bf16_close(out, bigru_cuda.gru_dir_plain(*args), f"K1f bf16 {B} {T} {I} {H} {d}")
        assert torch.equal(out, again)


@pytest.mark.gpu
@pytest.mark.parametrize("need_dx", [True, False])
@pytest.mark.parametrize("B,T,I,H", [(1, 8, 768, 100), (67, 50, 200, 100), (3, 5, 7, 12),
                                     (4096, 8, 768, 100), (5, 6, 20, 13)])
def test_gru_dir_bwd_bf16_kernel_matches_plain(cuda, B, T, I, H, need_dx):
    """K1b's bf16 instance against the bf16 plain backward (dx, dW, db
    rounded to bf16), both directions; reruns give the same bits."""
    rng = np.random.default_rng(22)
    tp = gru_torch_layout(rng, I, H)
    x = _bf(torch.from_numpy(rng.standard_normal((T, B, I)).astype(np.float32)), cuda)
    dhs = _bf(torch.from_numpy(rng.standard_normal((T, B, H)).astype(np.float32)), cuda)
    for d, rev in (("fwd", False), ("bwd", True)):
        ops = {k: _bf(v, cuda) for k, v in bigru_cuda.dir_operands(tp[d]).items()}
        args = (x, ops["wp"], ops["wt"], ops["bc"], ops["bhn"])
        hs, gates = bigru_cuda._launch_fwd(*args, rev)
        n0 = bigru_cuda.gru_dir_bwd.launches_bf16
        got = bigru_cuda.gru_dir_bwd(*args, hs, gates, dhs, rev, need_dx)
        again = bigru_cuda.gru_dir_bwd(*args, hs, gates, dhs, rev, need_dx)
        torch.cuda.synchronize()
        assert bigru_cuda.gru_dir_bwd.launches_bf16 == n0 + 2
        ref = bigru_cuda.gru_dir_bwd_plain(*args, hs, gates, dhs, rev, need_dx)
        for name, a, r, b in zip(("dx", "dwp", "dwt", "dbc", "dbhn"), got, ref, again):
            if r is None:
                assert a is None
                continue
            bf16_close(a, r, f"K1b bf16 {name} {B} {T} {I} {H} {d}")
            assert torch.equal(a, b)


def _path(units, L):
    """The bf16 attention's path (``_plan_attention_bf16``): at L <= 64 the
    unit walk (3) from ``_WALK_MIN_UNITS`` units, else a unit a block (0);
    the row kernel (2) to L = 512; the three-pass tiled kernel (1) beyond."""
    if L <= 64:
        return 3 if units >= bert_attn_cuda._WALK_MIN_UNITS else 0
    return 2 if L <= 512 else 1


@pytest.mark.gpu
@pytest.mark.parametrize("softmax", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,heads,h", [(1, 8, 12, 768), (3, 13, 2, 16), (300, 31, 12, 768),
                                         (5, 64, 12, 768), (2, 65, 12, 768), (3, 100, 2, 16),
                                         (1, 512, 12, 768), (2, 127, 12, 768), (3, 128, 2, 16),
                                         (3, 129, 12, 768), (2, 300, 2, 16), (1, 511, 12, 768),
                                         (2, 513, 12, 768), (2, 600, 2, 16)])
def test_attention_block_bf16_kernel_matches_plain(cuda, B, L, heads, h, softmax):
    """K2's bf16 instance, both softmax tails, on the four attention paths
    (at L <= 64 a unit a block, or the unit walk where the units reach
    ``_WALK_MIN_UNITS``; the whole row's logits in a block's registers to L
    = 512, one to four key groups; 64-key tiles in three passes beyond),
    head_dim 64 and 8, item 0 fully masked."""
    path = _path(B * heads, L)
    assert bert_attn_cuda._plan_attention_bf16(B, L, heads, h // heads)["path"] == path
    rng = np.random.default_rng(23)
    args = [a.to(cuda) for a in attn_torch_args(*attn_inputs(rng, B, L, h))]
    args = [a if i == 1 else a.to(torch.bfloat16) for i, a in enumerate(args)]
    kw = dict(n_heads=heads, eps=1e-12, softmax_dtype=softmax)
    n0 = bert_attn_cuda.attention_block_fused.launches_bf16
    out = bert_attn_cuda.attention_block_fused(*args, **kw)
    again = bert_attn_cuda.attention_block_fused(*args, **kw)
    torch.cuda.synchronize()
    assert bert_attn_cuda.attention_block_fused.launches_bf16 == n0 + 2
    bf16_close(out, bert_attn_cuda.attention_block_plain(*args, **kw),
               f"K2 bf16 {B} {L} {h} {softmax}")
    assert torch.equal(out, again)


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,heads,h", [(3, 32, 12, 768), (2, 80, 2, 16), (1, 512, 12, 768),
                                         (4, 64, 4, 32), (2, 127, 12, 768), (3, 128, 2, 16),
                                         (2, 129, 12, 768), (2, 300, 2, 16), (1, 511, 12, 768),
                                         (2, 513, 12, 768), (1, 600, 2, 16)])
def test_dense_attention_bf16_kernel_matches_plain(cuda, B, L, heads, h):
    """K6a's bf16 instance on the attention paths (the block-a-unit, row
    and three-pass tiled kernels), head_dim 64 and 8, one item fully
    masked."""
    path = _path(B * heads, L)
    assert bert_attn_cuda._plan_attention_bf16(B, L, heads, h // heads)["path"] == path
    rng = np.random.default_rng(27)
    *_, mask = attn_inputs(rng, B, L, h)
    q, k, v = (_bf(torch.from_numpy(rng.standard_normal((B, L, heads, h // heads))
                                    .astype(np.float32)), cuda) for _ in range(3))
    mask = torch.from_numpy(mask).to(cuda)
    n0 = bert_attn_cuda.dense_attention_blockdiag.launches_bf16
    out = bert_attn_cuda.dense_attention_blockdiag(q, k, v, mask)
    again = bert_attn_cuda.dense_attention_blockdiag(q, k, v, mask)
    torch.cuda.synchronize()
    assert bert_attn_cuda.dense_attention_blockdiag.launches_bf16 == n0 + 2
    assert out.dtype == torch.bfloat16 and out.shape == (B, L, h)
    bf16_close(out, bert_attn_cuda.dense_attention_plain(q, k, v, mask), f"K6a bf16 {B} {L}")
    assert torch.equal(out, again)


def _with_walk(walk: bool, fn):
    """``fn()`` under the bf16 attention plans with the unit walk at every
    unit count (``walk``) or at none (the block-a-unit kernel, path 0),
    synchronized."""
    caches = (bert_attn_cuda._cached_plan_bf16, bert_attn_cuda._cached_block_plan_bf16)
    old = bert_attn_cuda._WALK_MIN_UNITS
    bert_attn_cuda._WALK_MIN_UNITS = 1 if walk else 1 << 40
    for c in caches:
        c.cache_clear()
    try:
        out = fn()
        torch.cuda.synchronize()
        return out
    finally:
        bert_attn_cuda._WALK_MIN_UNITS = old
        for c in caches:
            c.cache_clear()


def _walk_mask(rng, B, L):
    """Padded keys (a random prefix kept a row) and item 0 fully masked."""
    mask = np.ones((B, L), np.float32)
    for i in range(B):
        mask[i, rng.integers(1, L + 1):] = 0
    mask[0] = 0
    return mask


_WALK_L = [1, 8, 17, 31, 32, 33, 48, 64]
_WALK_B = [1, 3, 300, 4096]


@pytest.mark.gpu
@pytest.mark.parametrize("heads,h", [(12, 768), (2, 16)])
@pytest.mark.parametrize("L", _WALK_L)
@pytest.mark.parametrize("B", _WALK_B)
def test_dense_attention_bf16_walk_is_bit_identical(cuda, B, L, heads, h):
    """K6a.bf16 on the unit walk gives the block-a-unit kernel's bits (the
    same MMA sequence and sums a row), reruns its own bits, and holds to
    its bf16 plain version; head_dim 64 and 8 (1 / sqrt(dh) exact and not),
    padded keys, item 0 fully masked."""
    rng = np.random.default_rng(31)
    q, k, v = (_bf(torch.from_numpy(rng.standard_normal((B, L, heads, h // heads))
                                    .astype(np.float32)), cuda) for _ in range(3))
    mask = torch.from_numpy(_walk_mask(rng, B, L)).to(cuda)

    def fn():
        return bert_attn_cuda.dense_attention_blockdiag(q, k, v, mask)

    assert _with_walk(True, lambda: bert_attn_cuda._plan_attention_bf16(
        B, L, heads, h // heads)["path"]) == 3
    walk, again, unit = _with_walk(True, fn), _with_walk(True, fn), _with_walk(False, fn)
    assert torch.equal(walk, unit) and torch.equal(walk, again)
    bf16_close(walk, bert_attn_cuda.dense_attention_plain(q, k, v, mask), f"K6a walk {B} {L}")


@pytest.mark.gpu
@pytest.mark.parametrize("softmax", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", _WALK_L)
@pytest.mark.parametrize("B", _WALK_B)
def test_attention_block_bf16_walk_is_bit_identical(cuda, B, L, softmax):
    """K2.bf16 with its attention stage on the unit walk gives the
    block-a-unit kernel's bits under both softmax rules, reruns its own,
    and holds to its bf16 plain version (HF-scale weights, padded keys,
    item 0 fully masked)."""
    rng = np.random.default_rng(32)
    h, heads = 768, 12
    x = _bf(torch.from_numpy(rng.standard_normal((B, L, h)).astype(np.float32)), cuda)
    w = [_bf(torch.from_numpy((rng.standard_normal((h, h)) * 0.02).astype(np.float32)), cuda)
         for _ in range(4)]
    b = [_bf(torch.from_numpy((rng.standard_normal(h) * 0.02).astype(np.float32)), cuda)
         for _ in range(4)]
    w[:3], b[:3] = torch.stack(w[:3]).unbind(0), torch.cat(b[:3]).split(h)
    g = _bf(torch.from_numpy((1.0 + 0.1 * rng.standard_normal(h)).astype(np.float32)), cuda)
    beta = _bf(torch.from_numpy((0.1 * rng.standard_normal(h)).astype(np.float32)), cuda)
    mask = torch.from_numpy(_walk_mask(rng, B, L)).to(cuda)
    args = (x, mask, w[0], b[0], w[1], b[1], w[2], b[2], w[3], b[3], g, beta)
    kw = dict(n_heads=heads, eps=1e-12, softmax_dtype=softmax)

    def fn():
        return bert_attn_cuda.attention_block_fused(*args, **kw)

    walk, again, unit = _with_walk(True, fn), _with_walk(True, fn), _with_walk(False, fn)
    assert torch.equal(walk, unit) and torch.equal(walk, again)
    bf16_close(walk, bert_attn_cuda.attention_block_plain(*args, **kw),
               f"K2 walk {B} {L} {softmax}")


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,tq,tk,d", [(4096, 12, 32, 32, 64), (4096, 12, 50, 32, 64),
                                         (3, 12, 32, 32, 64), (5, 12, 64, 64, 64),
                                         (2, 12, 33, 64, 64), (2, 3, 1, 17, 8),
                                         (3, 2, 9, 40, 24), (4, 12, 50, 32, 25),
                                         (3, 12, 32, 32, 25)])
def test_flash_masked_bf16_walk_matches_plain(cuda, b, h, tq, tk, d):
    """K8.bf16 on the unit walk (D a multiple of 8: S and P V on the bf16
    tensor cores, p as three bf16 terms) and, at D = 25, on the float32
    plan's kernels: 1e-2 of max |ref| against the bf16 plain version, a
    cosine of 0.99999 against the float32 kernel, reruns bit-identical, one
    launch a call; row 0's all-zero mask attends to every key, as the plain
    version's rewrite says."""
    walk = d % 8 == 0
    assert (bert_attn_cuda._plan_attention_masked_bf16(b, tq, tk, h, d, True) is not None) == walk
    rng = np.random.default_rng(33)
    q = _bf(torch.from_numpy((rng.standard_normal((b, h, tq, d)) / np.sqrt(d))
                             .astype(np.float32)), cuda)
    k, v = (_bf(torch.from_numpy(rng.standard_normal((b, h, tk, d)).astype(np.float32)), cuda)
            for _ in range(2))
    mask = np.ones((b, tk), np.int32)
    for i in range(b):
        mask[i, rng.integers(1, tk + 1):] = 0
    mask[0] = 0
    mask = torch.from_numpy(mask).to(cuda)
    fn = attention_cuda.flash_attention_masked
    n0 = fn.launches_bf16
    out, again = fn(q, k, v, mask), fn(q, k, v, mask)
    torch.cuda.synchronize()
    assert fn.launches_bf16 == n0 + 2 and out.dtype == torch.bfloat16
    assert torch.equal(out, again)
    ref = attention_cuda.flash_attention_masked_plain(q, k, v, mask).float()
    assert (out.float() - ref).abs().max().item() <= 1e-2 * ref.abs().max().item()
    all_keys = attention_cuda.flash_attention_masked_plain(
        q[:1], k[:1], v[:1], torch.ones_like(mask[:1])).float()
    assert (out[:1].float() - all_keys).abs().max().item() <= 1e-2 * all_keys.abs().max().item()
    assert _cos(out, fn(q.float(), k.float(), v.float(), mask)) >= 0.99999


@pytest.mark.gpu
@pytest.mark.parametrize("rows,h", [(8, 768), (9001, 768), (131072, 768), (7, 32)])
def test_proj_ln_bf16_kernel_matches_plain(cuda, rows, h):
    """K6b's bf16 instance: split-K and wgmma products."""
    rng = np.random.default_rng(28)
    resid, a = (_bf(torch.from_numpy(rng.standard_normal((rows, h)).astype(np.float32)), cuda)
                for _ in range(2))
    w_t = _bf(torch.from_numpy((rng.standard_normal((h, h)) * 0.05).astype(np.float32)), cuda)
    b, bb = (_bf(torch.from_numpy((rng.standard_normal(h) * 0.05).astype(np.float32)), cuda)
             for _ in range(2))
    g = _bf(torch.from_numpy((1.0 + 0.2 * rng.standard_normal(h)).astype(np.float32)), cuda)
    args = (resid, a, w_t, b, g, bb)
    n0 = bert_ffn_cuda.proj_ln_block.launches_bf16
    out = bert_ffn_cuda.proj_ln_block(*args, eps=1e-12)
    again = bert_ffn_cuda.proj_ln_block(*args, eps=1e-12)
    torch.cuda.synchronize()
    assert bert_ffn_cuda.proj_ln_block.launches_bf16 == n0 + 2
    bf16_close(out, bert_ffn_cuda.proj_ln_block_plain(*args, eps=1e-12), f"K6b bf16 {rows}")
    assert torch.equal(out, again)


# K2.bf16 and K6b.bf16 on the persistent kernel (bert_attn_cuda.
# _plan_attn_block_bf16, bert_ffn_cuda._plan_proj_ln_bf16): the training rows
# (4096 x 32) and a ragged last row tile (4095 x 32), the rows around the
# q/k/v product's edge (1,792 / 1,824: mma.sync below, the persistent
# kernel above) and the o-projection's (5,504 / 5,536), L = 8 and 64 at
# B = 2048.
_PERSISTENT_ATTN_ROWS = [(4096, 32), (4095, 32), (56, 32), (57, 32), (172, 32), (173, 32),
                         (2048, 8), (2048, 64)]


def _cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()).clamp_min(1e-300))


@pytest.mark.gpu
@pytest.mark.parametrize("softmax", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L", _PERSISTENT_ATTN_ROWS)
def test_attention_block_bf16_persistent_kernel_matches_plain(cuda, B, L, softmax):
    """K2.bf16 at BERT-base width where its products leave the first port's
    tiles for the persistent kernel (the q/k/v product reading the stacked
    [3, h, h] weights in place, as models.bert.prepare_bert makes them),
    both softmax tails, keys padded by a random length per item and item 0
    fully masked, HF-scale weights (0.02, as chip_smoke.py's): within 2e-2
    of max |ref| of the bf16 plain version, a cosine of 0.999 against the
    float32 kernel on the same bf16 values, reruns bit-identical."""
    h, heads = 768, 12
    plan = bert_attn_cuda._plan_attn_block_bf16(B, L, h, heads)
    assert plan["qkv"]["wgmma"] == (2 if B * L >= 1793 else 0)
    assert plan["o"]["wgmma"] == (2 if B * L >= 5505 else 0)
    rng = np.random.default_rng(26)
    x, ws, bs, ln_g, ln_b, mask = attn_inputs(rng, B, L, h)
    args = [a.to(cuda) for a in attn_torch_args(x, [w * 0.2 for w in ws], bs, ln_g, ln_b, mask)]
    args = [a if i == 1 else a.to(torch.bfloat16) for i, a in enumerate(args)]
    wqkv = torch.stack([args[2], args[4], args[6]])      # one [3, h, h]: read in place
    args[2], args[4], args[6] = wqkv.unbind(0)
    kw = dict(n_heads=heads, eps=1e-12, softmax_dtype=softmax)
    n0 = bert_attn_cuda.attention_block_fused.launches_bf16
    out = bert_attn_cuda.attention_block_fused(*args, **kw)
    again = bert_attn_cuda.attention_block_fused(*args, **kw)
    torch.cuda.synchronize()
    assert bert_attn_cuda.attention_block_fused.launches_bf16 == n0 + 2
    bf16_close(out, bert_attn_cuda.attention_block_plain(*args, **kw),
               f"K2 bf16 persistent {B} {L} {softmax}")
    assert torch.equal(out, again)
    f32 = bert_attn_cuda.attention_block_fused(
        *(a.float() for a in args), n_heads=heads, eps=1e-12)
    assert _cosine(out.float(), f32) >= 0.999


@pytest.mark.gpu
@pytest.mark.parametrize("B,L", _PERSISTENT_ATTN_ROWS)
def test_proj_ln_bf16_persistent_kernel_matches_plain(cuda, B, L):
    """K6b.bf16 (K2.bf16's tail, by its o-projection's plan) at the same
    rows: the persistent product and the warp-row LayerNorm from 5,505
    rows, the first port's plan below; 2e-2 of max |ref| of the bf16 plain
    version, a cosine of 0.999 against the float32 kernel, reruns
    bit-identical."""
    rows, h = B * L, 768
    assert bert_ffn_cuda._plan_proj_ln_bf16(rows, h)["wgmma"] == (2 if rows >= 5505 else 0)
    rng = np.random.default_rng(30)
    resid, a = (_bf(torch.from_numpy(rng.standard_normal((B, L, h)).astype(np.float32)), cuda)
                for _ in range(2))
    w_t = _bf(torch.from_numpy((rng.standard_normal((h, h)) * 0.02).astype(np.float32)), cuda)
    b, bb = (_bf(torch.from_numpy((rng.standard_normal(h) * 0.05).astype(np.float32)), cuda)
             for _ in range(2))
    g = _bf(torch.from_numpy((1.0 + 0.2 * rng.standard_normal(h)).astype(np.float32)), cuda)
    args = (resid, a, w_t, b, g, bb)
    n0 = bert_ffn_cuda.proj_ln_block.launches_bf16
    out = bert_ffn_cuda.proj_ln_block(*args, eps=1e-12)
    again = bert_ffn_cuda.proj_ln_block(*args, eps=1e-12)
    torch.cuda.synchronize()
    assert bert_ffn_cuda.proj_ln_block.launches_bf16 == n0 + 2
    bf16_close(out, bert_ffn_cuda.proj_ln_block_plain(*args, eps=1e-12),
               f"K6b bf16 persistent {B} {L}")
    assert torch.equal(out, again)
    f32 = bert_ffn_cuda.proj_ln_block(*(t.float() for t in args), eps=1e-12)
    assert _cosine(out.float(), f32) >= 0.999


def _bf16_int8(w):
    """A float32 weight quantized, its scale then rounded to bf16 (the int8
    BERT under the bf16 policy)."""
    q = tbert._quantize(w)
    return {"q": q["q"], "s": q["s"].to(torch.bfloat16)}


@pytest.mark.gpu
@pytest.mark.parametrize("rows,h,ffn", [(8, 768, 3072), (7, 32, 128), (33, 40, 100),
                                        (9001, 768, 3072)])
def test_ffn_ln_q_bf16_kernel_matches_plain(cuda, rows, h, ffn):
    """K4's bf16 instance: its hidden codes as the plain version's (at most
    1e-3 flipped), its int32 products exact, its output within the bf16
    tolerance; the int8 GEMM with its bf16 dequant (qdot) the plain
    version's bits."""
    rng = np.random.default_rng(29)
    x, w1, b1, w2, b2, g, b = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
                               for a in ffn_inputs(rng, rows, h, ffn)]
    w1q, w2q = _bf16_int8(w1), _bf16_int8(w2)
    args = (_bf(x, cuda), w1q, _bf(b1, cuda), w2q, _bf(b2, cuda), _bf(g, cuda), _bf(b, cuda))
    n0 = bert_ffn_cuda.ffn_ln_block_q.launches_bf16
    out, codes, scales = bert_ffn_cuda.ffn_ln_block_q(*args, eps=1e-12, return_codes=True)
    torch.cuda.synchronize()
    assert bert_ffn_cuda.ffn_ln_block_q.launches_bf16 == n0 + 1
    ref, ref_codes, _ = bert_ffn_cuda.ffn_ln_block_q_plain(*args, eps=1e-12, return_codes=True)
    assert (codes != ref_codes).float().mean().item() <= 1e-3
    bf16_close(out, ref, f"K4 bf16 {rows} {h} {ffn}")
    xq, sx = bert_ffn_cuda.qrows(args[0])
    pxq, psx = bert_ffn_cuda.qrows_plain(args[0])
    assert torch.equal(xq, pxq) and torch.equal(sx, psx)
    for a, w in ((xq, w1q), (ref_codes, w2q)):
        exact = bert_ffn_cuda.int8_matmul_plain(a, w["q"]).to(torch.int32)
        assert torch.equal(bert_ffn_cuda.int8_matmul(a, w["q"]), exact)
    y = bert_ffn_cuda.qdot(xq, sx, w1q, args[2])
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, bert_ffn_cuda.qdot_plain(xq, sx, w1q, args[2]))


@pytest.mark.gpu
@pytest.mark.parametrize("rows,h,ffn", [(8, 768, 3072), (300, 768, 3072), (7, 32, 128),
                                        (9001, 768, 3072)])
def test_ffn_ln_bf16_kernel_matches_plain(cuda, rows, h, ffn):
    """K3's bf16 instance: split and unsplit products, a ragged last tile."""
    rng = np.random.default_rng(24)
    x, w1, b1, w2, b2, g, b = ffn_inputs(rng, rows, h, ffn)
    args = [_bf(torch.from_numpy(np.ascontiguousarray(a)), cuda)
            for a in (x, w1.T, b1, w2.T, b2, g, b)]
    n0 = bert_ffn_cuda.ffn_ln_block.launches_bf16
    out = bert_ffn_cuda.ffn_ln_block(*args, eps=1e-12)
    again = bert_ffn_cuda.ffn_ln_block(*args, eps=1e-12)
    torch.cuda.synchronize()
    assert bert_ffn_cuda.ffn_ln_block.launches_bf16 == n0 + 2
    bf16_close(out, bert_ffn_cuda.ffn_ln_block_plain(*args, eps=1e-12),
               f"K3 bf16 {rows} {h} {ffn}")
    assert torch.equal(out, again)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [16511, 131072, 1280, 1281, 5504, 5505])
def test_ffn_ln_bf16_persistent_kernel_matches_plain(cuda, rows):
    """K3.bf16 at BERT-base width on the persistent kernel: 16,511 rows
    (1,548 tiles of fc1, not a multiple of 132; a ragged last row tile),
    the training rows, and the edges where fc1 (1,281 rows) and fc2 (5,505)
    leave the mma.sync tiles for it; within 2e-2 of max |ref| of the bf16
    plain version, a cosine of 0.999 against the float32 kernel on the same
    bf16 values, reruns bit-identical."""
    h, ffn = 768, 3072
    plan = bert_ffn_cuda._plan_ffn_bf16(rows, h, ffn)
    assert (plan["fc1"]["wgmma"] == 2) == (rows >= 1281)
    assert (plan["fc2"]["wgmma"] == 2) == (rows >= 5505)
    rng = np.random.default_rng(25)
    x, w1, b1, w2, b2, g, b = ffn_inputs(rng, rows, h, ffn)
    args = [_bf(torch.from_numpy(np.ascontiguousarray(a)), cuda)
            for a in (x, w1.T * 0.2, b1, w2.T * 0.2, b2, g, b)]
    n0 = bert_ffn_cuda.ffn_ln_block.launches_bf16
    out = bert_ffn_cuda.ffn_ln_block(*args, eps=1e-12)
    again = bert_ffn_cuda.ffn_ln_block(*args, eps=1e-12)
    torch.cuda.synchronize()
    assert bert_ffn_cuda.ffn_ln_block.launches_bf16 == n0 + 2
    bf16_close(out, bert_ffn_cuda.ffn_ln_block_plain(*args, eps=1e-12), f"K3 bf16 {rows}")
    assert torch.equal(out, again)
    f32 = bert_ffn_cuda.ffn_ln_block(*(a.float() for a in args), eps=1e-12)
    assert _cosine(out.float(), f32) >= 0.999


@pytest.mark.gpu
@pytest.mark.parametrize("need_dx", [True, False])
@pytest.mark.parametrize("B,T,I,H", [(133, 1, 768, 100), (133, 50, 200, 100),
                                     (4095, 50, 768, 100), (4096, 1, 512, 100),
                                     (4096, 50, 200, 100), (4096, 8, 48, 12),
                                     (4096, 8, 48, 13), (300, 8, 64, 104), (300, 8, 64, 105)])
def test_gru_dir_bwd_bf16_mma_recurrence_matches_plain(cuda, B, T, I, H, need_dx):
    """K1b.bf16 on the mma-form recurrence (B past 132, H <= 104; the tiled
    form at H = 105) and, where x and dg take 16-byte rows, dwp and dwt on
    the wgmma reduction: a ragged last row group (4095), T = 1, H = 12 and 13
    (padded n tiles; element copies at H off a multiple of 4), both
    directions, with and without dx; each gradient within 2e-2 of max
    |ref| of the bf16 plain version and a cosine of 0.999 against the
    float32 kernel on the same bf16 values, reruns bit-identical."""
    plan = bigru_cuda._plan_gru_bwd_bf16(T, B, I, H, need_dx)
    assert plan["rec_mma"] == int(H <= 104)
    assert plan["dwp_wgmma"] == (3 if I % 8 == 0 and H % 2 == 0 else 0)
    assert plan["dwt_wgmma"] == (3 if H <= 104 and H % 2 == 0 else 0)
    rng = np.random.default_rng(26)
    tp = gru_torch_layout(rng, I, H)
    x = _bf(torch.from_numpy(rng.standard_normal((T, B, I)).astype(np.float32)), cuda)
    dhs = _bf(torch.from_numpy(rng.standard_normal((T, B, H)).astype(np.float32)), cuda)
    for d, rev in (("fwd", False), ("bwd", True)):
        ops = {k: _bf(v, cuda) for k, v in bigru_cuda.dir_operands(tp[d]).items()}
        args = (x, ops["wp"], ops["wt"], ops["bc"], ops["bhn"])
        hs, gates = bigru_cuda._launch_fwd(*args, rev)
        got = bigru_cuda.gru_dir_bwd(*args, hs, gates, dhs, rev, need_dx)
        again = bigru_cuda.gru_dir_bwd(*args, hs, gates, dhs, rev, need_dx)
        ref = bigru_cuda.gru_dir_bwd_plain(*args, hs, gates, dhs, rev, need_dx)
        a32 = tuple(a.float() for a in args)
        hs32, gates32 = bigru_cuda._launch_fwd(*a32, rev)
        f32 = bigru_cuda.gru_dir_bwd(*a32, hs32, gates32, dhs.float(), rev, need_dx)
        torch.cuda.synchronize()
        for name, a, r, b, f in zip(("dx", "dwp", "dwt", "dbc", "dbhn"), got, ref, again, f32):
            if r is None:
                assert a is None
                continue
            bf16_close(a, r, f"K1b bf16 {name} {B} {T} {I} {H} {d}")
            assert torch.equal(a, b)
            if f.abs().max() == 0:   # dwt at T = 1: h_prev is the zero start
                assert a.abs().max() == 0, name
            else:
                assert _cosine(a.float(), f) >= 0.999, name


# The bf16 instances of K5f, K5dq, K5dkv and K5b against their bf16 plain
# versions (the JAX kernels' formulas: float32 between bf16 operands and one
# rounding of each output): out, dq, dk and dv within 1e-2 of max |ref| (a
# bf16 step where a float32 sum in another order lands across a rounding
# edge), lse within 1e-4 absolute (float32, as the float32 instance); each
# output's cosine against the float32 kernel on the same bf16-valued
# operands at least 0.99999; reruns give the same bits.  The cases add odd
# T at D = 25, where a bf16 row starts on a 2-byte boundary.
FLASH_BF16_TOL, FLASH_BF16_COS = 1e-2, 0.99999
_FLASH_BF16_CASES = _FLASH_CASES + [(3, 2, 7, 7, 25, True, 0.1, None),
                                    (3, 2, 9, 7, 25, True, 0.0, None),
                                    (3, 2, 9, 9, 25, False, 0.3, None),
                                    (3, 2, 7, 131, 25, True, 0.1, None),
                                    (3, 2, 131, 67, 25, True, 0.1, None)]


def _flash_bf16_inputs(cuda, b, h, tq, tk, d, rate):
    q, k, v, seeds, rates = _flash_inputs(cuda, b, h, tq, tk, d, rate)
    dout = torch.from_numpy(np.random.default_rng(14).standard_normal(q.shape)
                            .astype(np.float32)).to(cuda)
    return tuple(_bf(t, cuda) for t in (q, k, v, dout)) + (seeds, rates)


def _flash_bf16_close(got, ref, f32, what):
    assert got.dtype == torch.bfloat16
    bf16_close(got, ref, what)
    a, b = got.double().flatten(), f32.double().flatten()
    cos = float(a @ b / (a.norm() * b.norm()).clamp_min(1e-300))
    assert cos >= FLASH_BF16_COS, (what, cos)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,tq,tk,d,causal,rate,offset", _FLASH_BF16_CASES)
def test_flash_fwd_bf16_kernel_matches_plain(cuda, b, h, tq, tk, d, causal, rate, offset):
    q, k, v, _, seeds, rates = _flash_bf16_inputs(cuda, b, h, tq, tk, d, rate)
    n0 = (attention_cuda.flash_fwd.launches, attention_cuda.flash_fwd.launches_bf16)
    out, lse = attention_cuda.flash_fwd(q, k, v, seeds, rates, causal, offset)
    again = attention_cuda.flash_fwd(q, k, v, seeds, rates, causal, offset)
    torch.cuda.synchronize()
    assert (attention_cuda.flash_fwd.launches,
            attention_cuda.flash_fwd.launches_bf16) == (n0[0] + 2, n0[1] + 2)
    assert lse.dtype == torch.float32
    ref, ref_lse = attention_cuda.flash_attention_plain(q, k, v, causal, offset, seeds, rates)
    f32, f32_lse = attention_cuda.flash_fwd(q.float(), k.float(), v.float(), seeds, rates,
                                            causal, offset)
    _flash_bf16_close(out, ref, f32, f"K5f bf16 {b} {h} {tq} {tk} {d}")
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
    torch.testing.assert_close(lse, f32_lse, atol=1e-4, rtol=0)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,tq,tk,d,causal,rate,offset", _FLASH_BF16_CASES)
def test_flash_bwd_bf16_kernels_match_plain(cuda, b, h, tq, tk, d, causal, rate, offset):
    """K5dq and K5dkv's bf16 instances from the plain forward's bf16 out and
    float32 lse, delta from the rounded out (float32); where every query
    sees one key, dq and dk are held against dv's max |ref| (as the float32
    test does) and their cosine is not asked."""
    q, k, v, dout, seeds, rates = _flash_bf16_inputs(cuda, b, h, tq, tk, d, rate)
    out, lse = attention_cuda.flash_attention_plain(q, k, v, causal, offset, seeds, rates)
    delta = attention_cuda._delta(dout, out)
    args = (q, k, v, dout, lse, delta, seeds, rates, causal, offset)
    n0 = (attention_cuda.flash_bwd_dq.launches_bf16, attention_cuda.flash_bwd_dkv.launches_bf16)
    got = (attention_cuda.flash_bwd_dq(*args),) + attention_cuda.flash_bwd_dkv(*args)
    again = (attention_cuda.flash_bwd_dq(*args),) + attention_cuda.flash_bwd_dkv(*args)
    torch.cuda.synchronize()
    assert (attention_cuda.flash_bwd_dq.launches_bf16,
            attention_cuda.flash_bwd_dkv.launches_bf16) == (n0[0] + 2, n0[1] + 2)
    ref = attention_cuda.flash_bwd_plain(q, k, v, dout, lse, delta, causal, offset, seeds, rates)
    f32_args = tuple(t.float() for t in args[:4]) + args[4:]
    f32 = (attention_cuda.flash_bwd_dq(*f32_args),) + attention_cuda.flash_bwd_dkv(*f32_args)
    one_key = tk == 1 or (causal and tq == 1 and offset == 1)
    for name, a, r, f, a2 in zip(("dq", "dk", "dv"), got, ref, f32, again):
        what = f"K5 bwd bf16 {name} {b} {h} {tq} {tk} {d}"
        if one_key and name != "dv":
            assert (a.float() - r.float()).abs().max() <= FLASH_BF16_TOL * ref[2].abs().max()
        else:
            _flash_bf16_close(a, r, f, what)
        assert torch.equal(a, a2)


@pytest.mark.gpu
@pytest.mark.parametrize("tq,tk", _FUSED_BWD_SHAPES + [(7, 7), (9, 7), (9, 9)])
@pytest.mark.parametrize("d", [8, 25, 64])
@pytest.mark.parametrize("causal,rate", [(True, 0.0), (True, 0.3), (False, 0.3)])
def test_flash_bwd_fused_bf16_kernel_matches_plain(cuda, tq, tk, d, causal, rate):
    """K5b's bf16 instance (delta from the bf16 out it reads, summed in
    float32): one launch, its bf16 counter moved; at Tk = 1 dq and dk are
    held against dv's max |ref|."""
    b, h = 3, 2
    q, k, v, dout, seeds, rates = _flash_bf16_inputs(cuda, b, h, tq, tk, d, rate)
    out, lse = attention_cuda.flash_attention_plain(q, k, v, causal, None, seeds, rates)
    args = (q, k, v, dout, out, lse, seeds, rates, causal)
    n0 = (attention_cuda.flash_bwd.launches_bf16, attention_cuda.flash_bwd_dq.launches)
    got = attention_cuda.flash_bwd(*args)
    again = attention_cuda.flash_bwd(*args)
    torch.cuda.synchronize()
    assert (attention_cuda.flash_bwd.launches_bf16,
            attention_cuda.flash_bwd_dq.launches) == (n0[0] + 2, n0[1])
    ref = attention_cuda.flash_bwd_plain(q, k, v, dout, lse, attention_cuda._delta(dout, out),
                                         causal, None, seeds, rates)
    f32 = attention_cuda.flash_bwd(*(t.float() for t in args[:5]), *args[5:])
    for name, a, r, f, a2 in zip(("dq", "dk", "dv"), got, ref, f32, again):
        if tk == 1 and name != "dv":
            assert (a.float() - r.float()).abs().max() <= FLASH_BF16_TOL * ref[2].abs().max()
        else:
            _flash_bf16_close(a, r, f, f"K5b bf16 {name} {tq} {tk} {d} {causal} {rate}")
        assert torch.equal(a, a2)


@pytest.mark.gpu
@pytest.mark.parametrize("tq,tk", [(40, 57), (96, 96)])
def test_flash_bf16_autograd_on_card_matches_cpu(cuda, tq, tk):
    """``flash_attention`` on bf16 operands (K5f, then K5b or K5dq + K5dkv)
    against the same function on the CPU (the plain versions): the output and
    the gradients bf16, within 1e-2 of max |ref|."""
    q, k, v, dout, seeds, rates = _flash_bf16_inputs(cuda, 2, 3, tq, tk, 25, 0.2)
    out = {}
    for dev in ("cpu", cuda):
        leaves = [t.to(dev).requires_grad_(True) for t in (q, k, v)]
        y = attention_cuda.flash_attention(*leaves, True, None, seeds.to(dev), rates.to(dev))
        y.backward(dout.to(dev))
        out[str(dev)] = [y] + [t.grad for t in leaves]
    for a, b_ in zip(out["cpu"], out[str(cuda)]):
        assert b_.dtype == torch.bfloat16
        bf16_close(b_.cpu(), a, "flash bf16 card vs cpu")


# The bf16 instances of K8, K7f / K7b and K9f / K9b: against their bf16
# plain versions (K8 within 1e-2 of max |ref|, as the flash rows; K7 and K9
# within 2e-2), a cosine of 0.999 against the float32 kernel on the same
# bf16-valued operands, reruns bit-identical, one bf16 launch a call.
BF16_COS = 0.999


def _cos(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()).clamp_min(1e-300))


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,t,d", [(1, 12, 8, 64), (4, 12, 32, 64), (1, 12, 512, 64),
                                     (2, 2, 100, 25), (3, 2, (9, 40), 25),
                                     (3, 12, (64, 33), 64), (2, 12, (1, 129), 64)])
def test_flash_masked_bf16_kernel_matches_plain(cuda, b, h, t, d):
    """K8's bf16 instance (D = 25: the float32 plan's kernels, rows on
    2-byte boundaries staged element by element; D = 64 at Tq, Tk <= 64:
    the bf16 unit walk; longer: the float32 tiled kernel, four elements a
    read), ragged masks and an all-zero row."""
    tq, tk = t if isinstance(t, tuple) else (t, t)
    rng = np.random.default_rng(21)
    q, k, v = (_bf(torch.from_numpy(rng.standard_normal(s).astype(np.float32)), cuda)
               for s in ((b, h, tq, d), (b, h, tk, d), (b, h, tk, d)))
    mask = np.ones((b, tk), np.int32)
    for i in range(b):
        mask[i, rng.integers(1, tk + 1):] = 0
    mask[0] = 0
    mask = torch.from_numpy(mask).to(cuda)
    fn = attention_cuda.flash_attention_masked
    n0 = (fn.launches, fn.launches_bf16)
    out = fn(q, k, v, mask)
    again = fn(q, k, v, mask)
    torch.cuda.synchronize()
    assert (fn.launches, fn.launches_bf16) == (n0[0] + 2, n0[1] + 2)
    assert out.dtype == torch.bfloat16 and torch.equal(out, again)
    ref = attention_cuda.flash_attention_masked_plain(q, k, v, mask)
    f32 = fn(q.float(), k.float(), v.float(), mask)
    a, r = out.float(), ref.float()
    assert (a - r).abs().max().item() <= 1e-2 * r.abs().max().item()
    assert _cos(out, f32) >= 0.99999


@pytest.mark.gpu
@pytest.mark.parametrize("G,T,N,H", [(2, 50, 4096, 100), (2, 64, 1, 100), (3, 7, 5, 12),
                                     (3, 12, 45, 99), (2, 6, 265, 100), (3, 9, 40, 13)])
def test_gru_recurrence_bf16_kernels_match_plain(cuda, G, T, N, H):
    """K7f's bf16 instance on both recurrence forms (tiled: N=4096, 45, 265;
    small: G*N <= 132) and K7b's on both backward forms (tiled, and a block
    a row while G*N <= 528), against their bf16 plain versions and the
    float32 kernels on the same bf16-valued operands."""
    gates, weights, biases, dhs = _rec_inputs(np.random.default_rng(22), G, T, N, H, cuda)
    args = tuple(_bf(a, cuda) for a in (*gates, *weights, *biases))
    dhs = _bf(dhs, cuda)
    fwd, bwd = gru_cuda.gru_recurrence_cuda, gru_cuda.gru_recurrence_bwd_cuda
    n0 = (fwd.launches_bf16, bwd.launches_bf16)
    hs = fwd(*args)
    torch.cuda.synchronize()
    assert hs.dtype == torch.bfloat16 and torch.equal(hs, fwd(*args))
    bf16_close(hs, gru_cuda.gru_recurrence_plain(*args), f"K7f bf16 {G} {T} {N} {H}")
    assert _cos(hs, fwd(*(a.float() for a in args))) >= BF16_COS
    bwd_args = (*args[:3], hs, dhs, *args[3:])
    got = bwd(*bwd_args)
    again = bwd(*bwd_args)
    torch.cuda.synchronize()
    assert (fwd.launches_bf16, bwd.launches_bf16) == (n0[0] + 2, n0[1] + 2)
    ref = gru_cuda.gru_recurrence_bwd_plain(*bwd_args)
    f32 = bwd(*(a.float() for a in bwd_args))
    for name, a, r, f, b_ in zip(("da_r", "da_z", "da_n", "dghn"), got, ref, f32, again):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b_)
        bf16_close(a, r, f"K7b bf16 {name} {G} {T} {N} {H}")
        assert _cos(a, f) >= BF16_COS


@pytest.mark.gpu
def test_bigru_forward_bf16_on_card_matches_cpu(cuda):
    """``bigru_forward`` at bf16 through K7f / K7b: outputs and every
    gradient, card against the CPU's plain versions."""
    rng = np.random.default_rng(23)
    params = gru_torch_layout(rng, 20, 16)
    x = torch.from_numpy(rng.standard_normal((6, 11, 20)).astype(np.float32)).to(torch.bfloat16)
    out = {}
    for dev in ("cpu", cuda):
        p = {d: {k: v.to(dev, torch.bfloat16).requires_grad_(True) for k, v in params[d].items()}
             for d in ("fwd", "bwd")}
        xd = x.to(dev, copy=True).requires_grad_(True)
        y, fin = tgru.bigru_forward(p, xd)
        (y.float().sin().sum() + fin.float().sum()).backward()
        out[str(dev)] = [y, fin, xd.grad] + [v.grad for d in ("fwd", "bwd")
                                              for v in p[d].values()]
    for a, b_ in zip(out["cpu"], out[str(cuda)]):
        assert b_.dtype == torch.bfloat16
        bf16_close(b_.cpu(), a, "bigru bf16 card vs cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("R,E,F,act,rep,masked,params_bf16", [
    (4096, 200, 200, "id", 25, False, False), (4096, 1000, 800, "relu", 1, True, False),
    (1, 200, 800, "relu", 1, False, True), (13, 16, 24, "id", 4, True, True),
    (8, 1000, 800, "relu", 1, True, False), (4095, 1000, 200, "id", 25, True, True),
    (13, 30, 50, "relu", 5, True, False)])
def test_trunk_block_bf16_kernels_match_plain(cuda, R, E, F, act, rep, masked, params_bf16):
    """K9f / K9b's bf16 instances at bf16 x and src, float32 or bf16
    parameters: the plans' paths (split-K at few rows, a ragged last row
    tile, copies narrower than 16 bytes at E=30, F1=50) against the bf16
    plain versions; each gradient in its parameter's dtype."""
    x, src, dout, params, masks = _block_inputs(np.random.default_rng(24), R, E, F, cuda,
                                                masked)
    x, src, dout = (_bf(a, cuda) for a in (x, src, dout))
    if params_bf16:
        params = [_bf(p, cuda) for p in params]
    cfg = trunk_block_cuda.BlockConfig(act, rep, 0.1, 0.3, 11, -7, True, True)
    fwd, bwd = trunk_block_cuda.trunk_block_fwd, trunk_block_cuda.trunk_block_bwd
    n0 = (fwd.launches_bf16, bwd.launches_bf16)
    out = fwd(x, src, *params, *masks, cfg)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and torch.equal(out, fwd(x, src, *params, *masks, cfg))
    bf16_close(out, trunk_block_cuda.fused_residual_block_reference(x, src, *params, *masks,
                                                                    cfg), f"K9f bf16 {R} {E} {F}")
    # the float32 kernel on the operands the bf16 instance multiplies: the
    # weights at their bf16 values (it casts them), the vectors as they are
    f32 = [a.float() for a in (x, src, dout)] + [
        p.to(torch.bfloat16).float() if p.dim() == 2 else p.float() for p in params]
    assert _cos(out, fwd(*f32[:2], *f32[3:], *masks, cfg)) >= BF16_COS
    bargs = (x, src, dout, *params, *masks, cfg)
    got = bwd(*bargs)
    again = bwd(*bargs)
    torch.cuda.synchronize()
    assert (fwd.launches_bf16, bwd.launches_bf16) == (n0[0] + 2, n0[1] + 2)
    ref = trunk_block_cuda.trunk_block_bwd_plain(*bargs)
    ref32 = bwd(*f32, *masks, cfg)
    # as the float32 test: beyond what entries of u at relu's kink may move it
    _, slack = trunk_block_cuda.relu_kink_bound(*bargs)
    for name, a, r, f, b_, p, s in zip("dsrc dw1 db1 dw2 db2 dg dlb".split(), got, ref, ref32,
                                       again, [src] + list(params), slack):
        assert a.dtype == r.dtype == p.dtype and torch.equal(a, b_)
        beyond = ((a.float() - r.float()).abs() - s).max().item()
        assert beyond <= BF16_TOL * r.float().abs().max().item(), (name, beyond)
        assert _cos(a, f) >= BF16_COS
