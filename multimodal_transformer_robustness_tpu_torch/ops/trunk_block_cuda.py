"""K9f / K9b: the fused residual block of a T==1 trunk layer through
hand-written CUDA kernels, forward and backward.

Counterpart of ``multimodal_transformer_robustness_tpu/ops/trunk_block_pallas.py``,
a library op there as here (the JAX package retired it from the encoder's
dispatch, and the port's encoder does not call it either).  One template
covers both halves of a T==1 encoder layer:

    y = x + d_res * (m_out * ((d_mid * act((LN(src, m_in) @ w1.T + b1) * m_mid))
                              @ w2.T + b2))

attention half: ``act`` identity, ``w1 / b1`` the value projection, ``w2 /
b2`` the out projection, ``m_mid`` the head x head-dim mask, ``d_mid`` drawn
per (row, head) with ``mid_rep`` = head_dim (the T==1 softmax is 1, so the
query and key never matter; ``src`` is ``x`` in self mode or the value
stream in cross mode); FFN half: ``act`` relu, ``m_mid`` the FFN mask.  The
LayerNorm is masked (float32 moments over ``m_in``'s channels, biased
variance, re-masked output).  Dropout keeps position (global row, col) where
``attention_cuda.hash_uniform(seed, row, col) >= rate`` and scales by
``1 / (1 - rate)``: the JAX kernel's draw bit for bit, so the same integer
seeds give the same masks in both packages, in forward and backward.

:func:`trunk_block_fwd` launches ``csrc/trunk_block.cu``'s forward on CUDA
tensors and runs :func:`fused_residual_block_reference` on CPU tensors;
:func:`trunk_block_bwd` launches the backward (every parameter gradient
reduced inside, no float atomics) or runs :func:`trunk_block_bwd_plain`.
:func:`fused_residual_block` joins them as an autograd function.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import _build
from .attention_cuda import hash_uniform

_EPS = 1e-5
_TILE_ROWS = 16   # rows per block of the backward's first pass (TB_ROWS in trunk_block.cu)


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    """What the block draws and applies besides its tensors."""
    act: str = "id"            # "id" or "relu"
    mid_rep: int = 1           # d_mid group width along F1 (head_dim for attention)
    rate_mid: float = 0.0
    rate_res: float = 0.0
    seed_mid: int = 0          # int32
    seed_res: int = 0
    use_drop_mid: bool = False
    use_drop_res: bool = False

    def __post_init__(self):
        if self.act not in ("id", "relu"):
            raise ValueError(f"act must be 'id' or 'relu', got {self.act!r}")
        for s in (self.seed_mid, self.seed_res):
            if not -2**31 <= s < 2**31:
                raise ValueError(f"seed {s} is not an int32")


def _drop_field(seed: int, rate: float, rows: torch.Tensor, cols: torch.Tensor):
    """``{0, 1 / (1 - rate)}`` where the position hash is below / at least
    ``rate``, float32 throughout as in the kernels."""
    r = torch.tensor(rate, dtype=torch.float32, device=rows.device)
    return torch.where(hash_uniform(seed, rows, cols) >= r, 1.0 / (1.0 - r),
                       torch.zeros((), device=rows.device))


def _masked_ln(src, ln_g, ln_b, m_in):
    """(s, t, inv, n): the masked LayerNorm's output, its normalised input,
    1 / std per row and the active-channel count, as the kernels take them."""
    n = torch.clamp(m_in.sum(), min=1.0)
    mu = (src * m_in).sum(-1, keepdim=True) / n
    diff = (src - mu) * m_in
    inv = torch.rsqrt((diff * diff).sum(-1, keepdim=True) / n + _EPS)
    t = (src - mu) * inv
    return (t * ln_g + ln_b) * m_in, t, inv, n


def fused_residual_block_reference(x, src, w1, b1, w2, b2, ln_g, ln_b, m_in, m_mid, m_out,
                                   cfg: BlockConfig) -> torch.Tensor:
    """Plain PyTorch version of K9f over rows ``x, src [R, E]`` with the
    kernel's masks (``[E]``, ``[F1]``, ``[E]``) and dropout field;
    differentiable by autograd, the gradient oracle of K9b."""
    rows, e = x.shape
    f1 = w1.shape[0]
    s = _masked_ln(src, ln_g, ln_b, m_in)[0]
    u = (torch.matmul(s, w1.t()) + b1) * m_mid
    a = torch.relu(u) if cfg.act == "relu" else u
    rids = torch.arange(rows, device=x.device)[:, None]
    if cfg.use_drop_mid:
        cols = torch.arange(f1, device=x.device)[None, :] // cfg.mid_rep
        a = a * _drop_field(cfg.seed_mid, cfg.rate_mid, rids, cols)
    y0 = (torch.matmul(a, w2.t()) + b2) * m_out
    if cfg.use_drop_res:
        y0 = y0 * _drop_field(cfg.seed_res, cfg.rate_res, rids,
                              torch.arange(e, device=x.device)[None, :])
    return x + y0


def relu_kink_bound(x, src, dout, w1, b1, w2, b2, ln_g, ln_b, m_in, m_mid, m_out,
                    cfg: BlockConfig, tau: float = 1e-4):
    """How far a correct backward may stand from :func:`trunk_block_bwd_plain`
    at relu's kink: an entry of ``u = (s W1^T + b1) * m_mid`` within ``tau``
    of 0 may land on the other side of it when the product is summed in
    another order (K9b recomputes u on the CUDA cores, the plain version
    with cuBLAS), and either side is a valid derivative.  Returns the number
    of such entries and, per gradient of :func:`trunk_block_bwd`, the sum of
    the absolute changes that flipping any of them can make (the dropout
    factors d_mid and d_res as drawn).  Identity blocks have no kink: zeros."""
    rows, e = x.shape
    zeros = [torch.zeros_like(a) for a in (src, w1, b1, w2, b2, ln_g, ln_b)]
    if cfg.act != "relu":
        return 0, zeros
    f1 = w1.shape[0]
    s, t, inv, n = _masked_ln(src, ln_g, ln_b, m_in)
    u = (torch.matmul(s, w1.t()) + b1) * m_mid
    near = (u.abs() < tau) & (m_mid > 0)
    rids = torch.arange(rows, device=x.device)[:, None]
    dm = (_drop_field(cfg.seed_mid, cfg.rate_mid, rids,
                      torch.arange(f1, device=x.device)[None, :] // cfg.mid_rep)
          if cfg.use_drop_mid else torch.ones((), device=x.device))
    dz = dout * m_out
    if cfg.use_drop_res:
        dz = dz * _drop_field(cfg.seed_res, cfg.rate_res, rids,
                              torch.arange(e, device=x.device)[None, :])
    flip = (torch.matmul(dz, w2) * dm).abs() * near          # |change of dp|, [R, F1]
    ds = torch.matmul(flip, w1.abs()) * m_in                 # |change of ds * m|, [R, E]
    gds = ds * ln_g.abs()
    dsrc = m_in * inv * (gds + gds.sum(-1, keepdim=True) / n
                         + t.abs() * (gds * t.abs()).sum(-1, keepdim=True) / n)
    dw2 = torch.matmul(dz.abs().t(), near * tau * dm)        # ad moves by at most |u| * d_mid
    return int(near.sum()), [dsrc, torch.matmul(flip.t(), s.abs()), flip.sum(0), dw2,
                             torch.zeros_like(b2), (ds * t.abs()).sum(0), ds.sum(0)]


def _flags(cfg: BlockConfig):
    """The kernels' integer and float arguments after the shapes."""
    return ((int(cfg.act == "relu"), cfg.mid_rep, int(cfg.use_drop_mid),
             int(cfg.use_drop_res), cfg.seed_mid, cfg.seed_res),
            (cfg.rate_mid, cfg.rate_res, _EPS))


def _check(dev, x, rows_named, w1, b1, w2, b2, ln_g, ln_b, m_in, m_mid, m_out):
    rows, e = x.shape
    f1 = w1.shape[0]
    for name, t in rows_named:
        _build.require(t, name, (rows, e), dev)
    _build.require(w1, "w1", (f1, e), dev)
    _build.require(w2, "w2", (e, f1), dev)
    for name, t, n in (("b1", b1, f1), ("b2", b2, e), ("ln_g", ln_g, e), ("ln_b", ln_b, e),
                       ("m_in", m_in, e), ("m_mid", m_mid, f1), ("m_out", m_out, e)):
        _build.require(t, name, (n,), dev)
    return rows, e, f1


def trunk_block_fwd(x, src, w1, b1, w2, b2, ln_g, ln_b, m_in, m_mid, m_out,
                    cfg: BlockConfig) -> torch.Tensor:
    """K9f over rows ``[R, E]``.  CPU tensors take
    :func:`fused_residual_block_reference`; CUDA tensors launch the kernel
    (or raise)."""
    if x.device.type == "cpu":
        return fused_residual_block_reference(x, src, w1, b1, w2, b2, ln_g, ln_b,
                                              m_in, m_mid, m_out, cfg)
    dev = _build.device_of(x)
    rows, e, f1 = _check(dev, x, (("x", x), ("src", src)), w1, b1, w2, b2, ln_g, ln_b,
                         m_in, m_mid, m_out)
    lib = _build.load_library()
    w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
    out = torch.empty_like(x)
    ints, floats = _flags(cfg)
    err = lib.mmtr_trunk_block_fwd(
        *(t.data_ptr() for t in (x, src, w1t, b1, w2t, b2, ln_g, ln_b, m_in, m_mid, m_out,
                                 out)),
        rows, e, f1, *ints, *floats, _build.stream_ptr(dev))
    _build.check(err, "trunk_block forward kernel")
    trunk_block_fwd.launches += 1
    return out


trunk_block_fwd.launches = 0


def trunk_block_bwd_plain(x, src, dout, w1, b1, w2, b2, ln_g, ln_b, m_in, m_mid, m_out,
                          cfg: BlockConfig):
    """Plain PyTorch version of K9b: ``torch.autograd.grad`` through the
    reference -> ``(dsrc, dw1, db1, dw2, db2, dln_g, dln_b)``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (src, w1, b1, w2, b2, ln_g, ln_b)]
        out = fused_residual_block_reference(x.detach(), leaves[0], *leaves[1:], m_in,
                                             m_mid, m_out, cfg)
        return torch.autograd.grad(out, leaves, dout)


def trunk_block_bwd(x, src, dout, w1, b1, w2, b2, ln_g, ln_b, m_in, m_mid, m_out,
                    cfg: BlockConfig):
    """K9b: ``(dsrc, dw1, db1, dw2, db2, dln_g, dln_b)`` for rows ``[R, E]``
    (dx is ``dout``).  CPU tensors take :func:`trunk_block_bwd_plain`; CUDA
    tensors launch the kernel (or raise)."""
    if x.device.type == "cpu":
        return trunk_block_bwd_plain(x, src, dout, w1, b1, w2, b2, ln_g, ln_b, m_in, m_mid,
                                     m_out, cfg)
    dev = _build.device_of(x)
    rows, e, f1 = _check(dev, x, (("src", src), ("dout", dout)), w1, b1, w2, b2, ln_g, ln_b,
                         m_in, m_mid, m_out)
    lib = _build.load_library()
    # split the R-row weight products into <= 64 chunks of >= 256 rows, as K1b
    kchunk = -(-max(256, -(-rows // 64)) // 16) * 16
    splits = -(-rows // kchunk)
    tiles = -(-rows // _TILE_ROWS)
    wsize = e * f1
    f32 = dict(dtype=torch.float32, device=dev)
    dsrc, s_buf, dz_buf = (torch.empty(rows, e, **f32) for _ in range(3))
    ad_buf, dp_buf = (torch.empty(rows, f1, **f32) for _ in range(2))
    part = torch.empty(tiles, f1 + 3 * e, **f32)
    partial = torch.empty(splits, 2 * wsize, **f32)
    red = torch.empty(2 * wsize + f1 + 3 * e, **f32)
    ints, floats = _flags(cfg)
    err = lib.mmtr_trunk_block_bwd(
        *(t.data_ptr() for t in (src, dout, w1.t().contiguous(), w1, w2, b1, ln_g, ln_b, m_in,
                                 m_mid, m_out, dsrc, s_buf, dz_buf, ad_buf, dp_buf, part,
                                 partial, red)),
        rows, e, f1, *ints, kchunk, splits, *floats, _build.stream_ptr(dev))
    _build.check(err, "trunk_block backward kernel")
    trunk_block_bwd.launches += 1
    dw1 = red[:wsize].view(f1, e)
    dw2 = red[wsize:2 * wsize].view(e, f1)
    db1, db2, dg, dlb = red[2 * wsize:].split([f1, e, e, e])
    return dsrc, dw1, db1, dw2, db2, dg, dlb


trunk_block_bwd.launches = 0


class TrunkBlock(torch.autograd.Function):
    """K9f forward, K9b backward; gradients for x, src and the six
    parameters, none for the masks."""

    @staticmethod
    def forward(ctx, x, src, w1, b1, w2, b2, ln_g, ln_b, m_in, m_mid, m_out, cfg):
        ctx.cfg = cfg
        ctx.save_for_backward(x, src, w1, b1, w2, b2, ln_g, ln_b, m_in, m_mid, m_out)
        return trunk_block_fwd(x, src, w1, b1, w2, b2, ln_g, ln_b, m_in, m_mid, m_out, cfg)

    @staticmethod
    def backward(ctx, dout):
        x, src, w1, b1, w2, b2, ln_g, ln_b, m_in, m_mid, m_out = ctx.saved_tensors
        grads = trunk_block_bwd(x, src, dout.contiguous(), w1, b1, w2, b2, ln_g, ln_b, m_in,
                                m_mid, m_out, ctx.cfg)
        return (dout, *grads, None, None, None, None)


def fused_residual_block(x, src, w1, b1, w2, b2, ln_g, ln_b, m_in=None, m_mid=None,
                         m_out=None, *, act: str = "id", mid_rep: int = 1,
                         rate_mid: float = 0.0, rate_res: float = 0.0, seed_mid: int = 0,
                         seed_res: int = 0, use_drop_mid: bool = False,
                         use_drop_res: bool = False) -> torch.Tensor:
    """``x + d_res * (m_out * ((d_mid * act((LN(src, m_in) @ w1.T + b1) *
    m_mid)) @ w2.T + b2))`` over ``x, src [..., E]`` (pass ``src=x`` for
    self mode: autograd sums both paths into x), ``w1 [F1, E]``, ``w2 [E,
    F1]``, masks ``[E] / [F1] / [E]`` or None (all ones).  float32 only.
    Rates are Python floats and seeds int32 Python ints; the dropout runs
    only where ``use_drop_*`` is set."""
    if x.dtype != torch.float32 or src.dtype != torch.float32:
        raise ValueError(f"fused_residual_block takes float32, got {x.dtype} / {src.dtype}")
    cfg = BlockConfig(act, int(mid_rep), float(rate_mid), float(rate_res), int(seed_mid),
                      int(seed_res), bool(use_drop_mid), bool(use_drop_res))
    e, f1 = x.shape[-1], w1.shape[0]

    def mask(m, n):
        return (torch.ones(n, device=x.device) if m is None
                else m.to(device=x.device, dtype=torch.float32).contiguous())

    out = TrunkBlock.apply(x.reshape(-1, e).contiguous(), src.reshape(-1, e).contiguous(),
                           w1.contiguous(), b1.contiguous(), w2.contiguous(), b2.contiguous(),
                           ln_g.contiguous(), ln_b.contiguous(), mask(m_in, e),
                           mask(m_mid, f1), mask(m_out, e), cfg)
    return out.reshape(x.shape)
