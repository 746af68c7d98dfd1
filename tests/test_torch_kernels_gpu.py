"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests build the kernels from ``csrc/`` and launch them, so they carry
the ``gpu`` marker and skip where no CUDA device exists.  They import no JAX,
so on the card they run without the JAX conftest:
``python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest -q``.
Float32 with TF32 off; atol = rtol = 1e-4 for K1 and K3 (summation order),
1e-3 for K2 (the additive -10000 key bias leaves masked logits only 2**-10
apart in float32).  K1b's gradients are held to 1e-4 of each gradient's
max |ref|: they are sums over T*B rows, split-K partials on the card against
cuBLAS in the plain version, and dx chains back through every step.
"""

import numpy as np
import pytest
import torch

from multimodal_transformer_robustness_tpu_torch.ops import bert_attn_cuda, bert_ffn_cuda
from multimodal_transformer_robustness_tpu_torch.ops import bigru_cuda


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
@pytest.mark.parametrize("B,L,heads,h", [(1, 8, 12, 768), (2, 200, 12, 768), (3, 13, 2, 16)])
def test_attention_block_kernel_matches_plain(cuda, B, L, heads, h):
    rng = np.random.default_rng(4)
    args = [a.to(cuda) for a in attn_torch_args(*attn_inputs(rng, B, L, h))]
    out = bert_attn_cuda.attention_block_fused(*args, n_heads=heads, eps=1e-12)
    torch.cuda.synchronize()
    ref = bert_attn_cuda.attention_block_plain(*args, n_heads=heads, eps=1e-12)
    torch.testing.assert_close(out, ref, atol=1e-3, rtol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,h,ffn", [(8, 768, 3072), (300, 768, 3072), (7, 32, 128)])
def test_ffn_ln_kernel_matches_plain(cuda, rows, h, ffn):
    rng = np.random.default_rng(5)
    x, w1, b1, w2, b2, g, b = ffn_inputs(rng, rows, h, ffn)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in (x, w1.T, b1, w2.T, b2, g, b)]
    out = bert_ffn_cuda.ffn_ln_block(*args, eps=1e-12)
    torch.cuda.synchronize()
    ref = bert_ffn_cuda.ffn_ln_block_plain(*args, eps=1e-12)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("need_dx", [True, False])
@pytest.mark.parametrize("B,T,I,H", [(1, 8, 768, 100), (67, 50, 200, 100), (3, 5, 7, 12)])
def test_gru_dir_bwd_kernel_matches_plain(cuda, B, T, I, H, need_dx):
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
