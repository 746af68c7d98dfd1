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
:func:`fused_residual_block` joins them as an autograd function.  On the
card each half is masked-LN row passes plus products on ``csrc/gemm_tc.cuh``'s
3xTF32 tensor-core GEMM whose epilogues carry the block's masks, act and
hash dropout, by the launch plan :func:`_plan_block` computes here.

bf16 ``x`` and ``src`` (float32 or bf16 parameters) take the bf16
instances, the TPU kernels at bf16 operands: the weights cast to bf16 on
every call (here, given to the kernels as stored and transposed), the
biases, LN parameters and masks float32; s = LN(src) in float32 rounded to
bf16, both products bf16 x bf16 with float32 sums (``csrc/gemm_bf16.cuh``,
by :func:`_plan_block_bf16`), the hidden activation rounded before the
second product, the output ``x + y0`` rounded once; the backward rounds dz,
dp and dsrc where the JAX kernel does, takes db2 and db1 from the
unrounded dz and dp, and returns every parameter gradient summed in
float32 and cast to that parameter's dtype.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from .. import _build
from . import gemm_tc
from .attention_cuda import hash_uniform

_EPS = 1e-5
# csrc/trunk_block.cu's LN backward: a warp a row, 16 warps and 32 rows a
# block, each warp's column sums [2][E] kept in shared memory
_LN_BWD_WARPS, _LN_BWD_ROWS = 16, 32
# the products promote their sums (K9_PROMOTE = 8 in trunk_block.cu), so
# their wgmma tiles are 104 or 128 wide
_K9_WIDTHS = gemm_tc.PROMOTED_WIDTHS
PRODUCTS = ("u", "y", "dp", "ds")
_BF = torch.bfloat16
TN_KEYS = ("tn_vec", "dw1_splits", "dw1_kps", "dw2_splits", "dw2_kps")


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


def _rounded(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A product's operand: ``t`` rounded to ``dtype``, in float32 (at
    float32, ``t`` itself)."""
    return t.to(dtype).float()


def fused_residual_block_reference(x, src, w1, b1, w2, b2, ln_g, ln_b, m_in, m_mid, m_out,
                                   cfg: BlockConfig) -> torch.Tensor:
    """Plain PyTorch version of K9f over rows ``x, src [R, E]`` with the
    kernel's masks (``[E]``, ``[F1]``, ``[E]``) and dropout field;
    differentiable by autograd, the gradient oracle of K9b at float32.  At
    bf16 ``x`` the JAX kernel's rounding points: s and the hidden
    activation rounded to bf16 before their products, the weights cast to
    bf16, everything else float32, the output rounded once."""
    rows, e = x.shape
    f1 = w1.shape[0]
    dt = x.dtype
    s = _rounded(_masked_ln(src.float(), ln_g.float(), ln_b.float(), m_in)[0], dt)
    u = (torch.matmul(s, _rounded(w1, dt).t()) + b1.float()) * m_mid
    a = torch.relu(u) if cfg.act == "relu" else u
    rids = torch.arange(rows, device=x.device)[:, None]
    if cfg.use_drop_mid:
        cols = torch.arange(f1, device=x.device)[None, :] // cfg.mid_rep
        a = a * _drop_field(cfg.seed_mid, cfg.rate_mid, rids, cols)
    y0 = (torch.matmul(_rounded(a, dt), _rounded(w2, dt).t()) + b2.float()) * m_out
    if cfg.use_drop_res:
        y0 = y0 * _drop_field(cfg.seed_res, cfg.rate_res, rids,
                              torch.arange(e, device=x.device)[None, :])
    return (x.float() + y0).to(dt)


def relu_kink_bound(x, src, dout, w1, b1, w2, b2, ln_g, ln_b, m_in, m_mid, m_out,
                    cfg: BlockConfig, tau: float = 1e-4):
    """How far a correct backward may stand from :func:`trunk_block_bwd_plain`
    at relu's kink: an entry of ``u = (s W1^T + b1) * m_mid`` within ``tau``
    of 0 may land on the other side of it when the product is summed in
    another order (K9b recomputes u by the forward's own 3xTF32 tensor-core
    product and plan, so its u carries the forward's bits; the plain version
    sums it with cuBLAS), and either side is a valid derivative.  Returns the
    number of such entries and, per gradient of :func:`trunk_block_bwd`, the
    sum of the absolute changes that flipping any of them can make (the
    dropout factors d_mid and d_res as drawn).  Identity blocks have no kink:
    zeros.  At bf16 ``x`` the same from the bf16 instance's operands (s, the
    weights and dz rounded to bf16; a flipped dp entry moves dp_c by up to
    one bf16 step more), in float32, with a wider band where s's rounding
    is in doubt: an entry of s within 2^-18 of its size from a bf16
    rounding edge may round the other way when the LN's moments are summed
    in another order (the kernel's row pass, against torch's), which moves
    u by that step times |W1|."""
    rows, e = x.shape
    zeros = [torch.zeros_like(a, dtype=torch.float32) for a in (src, w1, b1, w2, b2, ln_g,
                                                                 ln_b)]
    if cfg.act != "relu":
        return 0, zeros
    f1 = w1.shape[0]
    dt = x.dtype
    s32, t, inv, n = _masked_ln(src.float(), ln_g.float(), ln_b.float(), m_in)
    s, w1, w2 = _rounded(s32, dt), _rounded(w1, dt), _rounded(w2, dt)
    if dt == _BF:
        edge = s32.abs() * 2.0 ** -18
        step = (_rounded(s32 + edge, dt) - _rounded(s32 - edge, dt)).abs()   # 0 off an edge
        tau = tau + torch.matmul(step, w1.abs().t()) * m_mid
    u = (torch.matmul(s, w1.t()) + b1.float()) * m_mid
    near = (u.abs() < tau) & (m_mid > 0)
    rids = torch.arange(rows, device=x.device)[:, None]
    dm = (_drop_field(cfg.seed_mid, cfg.rate_mid, rids,
                      torch.arange(f1, device=x.device)[None, :] // cfg.mid_rep)
          if cfg.use_drop_mid else torch.ones((), device=x.device))
    dz = dout.float() * m_out
    if cfg.use_drop_res:
        dz = dz * _drop_field(cfg.seed_res, cfg.rate_res, rids,
                              torch.arange(e, device=x.device)[None, :])
    dz = _rounded(dz, dt)
    flip = (torch.matmul(dz, w2) * dm).abs() * near          # |change of dp|, [R, F1]
    if dt == _BF:
        flip = flip * (1 + 2.0 ** -8)
    ds = torch.matmul(flip, w1.abs()) * m_in                 # |change of ds * m|, [R, E]
    gds = ds * ln_g.abs()
    dsrc = m_in * inv * (gds + gds.sum(-1, keepdim=True) / n
                         + t.abs() * (gds * t.abs()).sum(-1, keepdim=True) / n)
    dw2 = torch.matmul(dz.abs().t(), near * tau * dm)        # ad moves by at most |u| * d_mid
    return int(near.sum()), [dsrc, torch.matmul(flip.t(), s.abs()), flip.sum(0), dw2,
                             zeros[4], (ds * t.abs()).sum(0), ds.sum(0)]


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


def _plan_block(rows: int, e: int, f1: int, num_sms: int = _build.NUM_SMS,
                aligned: bool = True) -> dict:
    """K9's launch plan (``csrc/trunk_block.cu`` takes it as given), one for
    both halves.  Products (:func:`gemm_tc.plan_product`, promoted widths):
    ``u`` = s W1^T ``[rows, e] x [e, f1]`` (the forward's first product, and
    the backward's recompute of it, by this same plan, so the two give the
    same bits), ``y`` = a W2^T ``[rows, f1] x [f1, e]``, ``dp`` = dz W2 (the
    shape of ``u``) and ``ds`` = dp W1 (the shape of ``y``): the wgmma tiles
    where they give every SM two blocks (``tools/k9_trials.py``: at R=4096
    the 256 wgmma tiles of N = 800 or 1000 win neither half), else the 64 x
    64 mma.sync tiles split over K (at the serving rows across the card, not
    one block); 16-byte
    copies where ``e`` and ``f1`` are multiples of 4 and the weights are
    ``aligned`` (the other operands are the kernel's own scratch).  The
    weight gradients (:func:`gemm_tc.plan_tn`): dW1^T over ``[e + 1, f1]``
    and dW2^T over ``[f1 + 1, e]``, a ones row each for db1 and db2, split
    over the ``rows``.  ``scratch``: the floats the largest product needs
    (they run one after another); ``partial``: the reductions' planes;
    ``ln_tiles``: the LN backward's blocks."""
    if 4 * _LN_BWD_WARPS * 2 * e > _build.MAX_SMEM:
        raise ValueError(f"E={e}: the LN backward's column sums exceed shared memory")
    vec = bool(aligned and e % 4 == 0 and f1 % 4 == 0)
    plan = {name: gemm_tc.plan_product(rows, n, k, vec, num_sms, widths=_K9_WIDTHS)
            for name, n, k in (("u", f1, e), ("y", e, f1), ("dp", f1, e), ("ds", e, f1))}
    dw1, dw2 = gemm_tc.plan_tn(e + 1, f1, rows, num_sms), gemm_tc.plan_tn(f1 + 1, e, rows,
                                                                           num_sms)
    plan.update(tn_vec=int(vec), dw1_splits=dw1["splits"], dw1_kps=dw1["kps"],
                dw2_splits=dw2["splits"], dw2_kps=dw2["kps"],
                scratch=max(plan[k]["scratch"] for k in PRODUCTS),
                partial=dw1["partial"] + dw2["partial"], ln_tiles=-(-rows // _LN_BWD_ROWS))
    return plan


def plan_ints(plan: dict) -> list:
    """The 21 ints the C entries read: each product's TcPlan
    (``gemm_tc.PLAN_KEYS``) in :data:`PRODUCTS` order, then :data:`TN_KEYS`."""
    return [plan[p][k] for p in PRODUCTS for k in gemm_tc.PLAN_KEYS] + [plan[k] for k in TN_KEYS]


BF16_PRODUCTS = ("u", "y", "dp", "ds", "dw1", "dw2")


def _plan_block_bf16(rows: int, e: int, f1: int, num_sms: int = _build.NUM_SMS,
                     w_addrs: tuple = (0, 0, 0, 0)) -> dict:
    """K9's bf16 plan (``csrc/trunk_block.cu``'s bf16 entries take it as
    given), :func:`gemm_tc.plan_bf16` for each product: ``u`` = s_c W1^T
    (B: W1^T ``[e, f1]``), ``y`` = a_c W2^T (B: W2^T ``[f1, e]``), ``dp`` =
    dz_c W2 (B: W2 ``[e, f1]``), ``ds`` = dp_c W1 (B: W1 ``[f1, e]``), and
    the reductions over the ``rows``, A read transposed and split into
    float32 planes: ``dw1`` = dp_c^T s_c ``[f1, e]`` and ``dw2`` = dz_c^T
    a_c ``[e, f1]``.  The A operands are the kernels' own scratch (256-byte
    aligned); B's copies as wide as its row and its address (``w_addrs``:
    the data pointers of W1^T, W2^T, W2 and W1 mod 16) allow.  ``partial``:
    the floats the largest of them needs (they run one after another);
    ``ln_tiles``: the LN backward's and the column sums' 32-row tiles."""
    if 4 * _LN_BWD_WARPS * 2 * e > _build.MAX_SMEM:
        raise ValueError(f"E={e}: the LN backward's column sums exceed shared memory")
    cw = gemm_tc.bf16_copy_width
    plan = {name: gemm_tc.plan_bf16(rows, n, k, cw((k,)), cw((n,), (addr,)), num_sms)
            for name, n, k, addr in (("u", f1, e, w_addrs[0]), ("y", e, f1, w_addrs[1]),
                                     ("dp", f1, e, w_addrs[2]), ("ds", e, f1, w_addrs[3]))}
    for name, m, n in (("dw1", f1, e), ("dw2", e, f1)):
        plan[name] = gemm_tc.plan_bf16(m, n, rows, cw((m,)), cw((n,)), num_sms,
                                       max_splits=None, transposed_a=True)
    plan.update(partial=max(plan[k]["partial"] for k in BF16_PRODUCTS),
                ln_tiles=-(-rows // _LN_BWD_ROWS))
    return plan


def plan_ints_bf16(plan: dict) -> list:
    """The 30 ints the bf16 entries read: each product's BfPlan
    (``gemm_tc.BF_PLAN_KEYS``) in :data:`BF16_PRODUCTS` order."""
    return [plan[p][k] for p in BF16_PRODUCTS for k in gemm_tc.BF_PLAN_KEYS]


@functools.lru_cache(maxsize=None)
def _cached_plan_bf16(rows, e, f1, num_sms, w_addrs):
    """(C int array, its address, the plan) for both bf16 entries."""
    plan = _plan_block_bf16(rows, e, f1, num_sms, w_addrs)
    return _build.host_ints(plan_ints_bf16(plan)) + (plan,)


@functools.lru_cache(maxsize=None)
def _cached_plan(rows, e, f1, num_sms, aligned):
    """(C int array, its address, the plan) for both entries."""
    plan = _plan_block(rows, e, f1, num_sms, aligned)
    return _build.host_ints(plan_ints(plan)) + (plan,)


def _workspace(dev, sizes):
    """Views of one allocation, ``sizes`` elements each (an int: float32;
    or ``(count, dtype)``), every view starting on a 256-byte boundary (the
    products' 16-byte copies)."""
    specs = [(n, torch.float32) if isinstance(n, int) else n for n in sizes]
    starts, total = [], 0
    for n, dt in specs:
        starts.append(total)
        total += _build.round_up(max(n, 1) * dt.itemsize, 256)
    base = torch.empty(total, dtype=torch.uint8, device=dev)
    return [base[s:s + n * dt.itemsize].view(dt) for s, (n, dt) in zip(starts, specs)]


def fwd_workspace(plan: dict, rows: int, e: int, f1: int) -> list:
    """The forward's scratch in floats: s, a and the products' scratch."""
    return [rows * e, rows * f1, plan["scratch"]]


def bwd_workspace(plan: dict, rows: int, e: int, f1: int) -> list:
    """The backward's scratch in floats: s, dz, ds, a_d, dp, each row's mean
    and 1/std, the LN backward's tile sums, the reductions' planes and the
    products' scratch."""
    return [rows * e] * 3 + [rows * f1] * 2 + [2 * rows, plan["ln_tiles"] * 2 * e,
                                               plan["partial"], plan["scratch"]]


def fwd_workspace_bf16(plan: dict, rows: int, e: int, f1: int) -> list:
    """The bf16 forward's scratch, ``(count, dtype)``: s [R, E] and a [R,
    F1] in bf16, the products' scratch in floats."""
    return [(rows * e, _BF), (rows * f1, _BF), (plan["partial"], torch.float32)]


def bwd_workspace_bf16(plan: dict, rows: int, e: int, f1: int) -> list:
    """The bf16 backward's scratch, ``(count, dtype)``: s, dz_c [R, E] and a,
    dp_c [R, F1] in bf16; dz, ds [R, E], dp [R, F1], each row's mean and
    1/std, the column sums' tiles and the products' scratch in floats."""
    f32 = torch.float32
    return ([(rows * e, _BF)] * 2 + [(rows * f1, _BF)] * 2 + [(rows * e, f32)] * 2
            + [(rows * f1, f32), (2 * rows, f32),
               (plan["ln_tiles"] * max(2 * e, f1), f32), (plan["partial"], f32)])


def _plan_for(dev, rows, e, f1, w1, w2):
    return _cached_plan(rows, e, f1, _build.num_sms(dev),
                        (w1.data_ptr() | w2.data_ptr()) % 16 == 0)


def _bf16_t(w: torch.Tensor) -> torch.Tensor:
    """``w^T`` in bf16, contiguous: one copy kernel, cast and transpose."""
    return torch.empty(w.shape[1], w.shape[0], dtype=_BF, device=w.device).copy_(w.t())


def _bf16_operands(dev, x, rows_named, w1, b1, w2, b2, ln_g, ln_b, m_in, m_mid, m_out,
                   stored: bool):
    """The bf16 entries' operands: the weights cast to bf16 (as the JAX
    wrapper casts them to x's dtype on every call), transposed (both
    entries) and, where ``stored`` (the backward's), as stored too; the
    vectors float32 (as it upcasts them); checked as the kernels take them
    -> (rows, e, f1, w1t, w2t, w1, w2, vectors), w1 and w2 None unless
    ``stored``."""
    rows, e = x.shape
    f1 = w1.shape[0]
    w1t, w2t = _bf16_t(w1), _bf16_t(w2)
    w1c, w2c = (w1.to(_BF).contiguous(), w2.to(_BF).contiguous()) if stored else (None, None)
    vecs = [v.float().contiguous() for v in (b1, b2, ln_g, ln_b)]
    specs = [(t, name, (rows, e)) for name, t in rows_named]
    specs += [(w1t, "w1t", (e, f1)), (w2t, "w2t", (f1, e))]
    if stored:
        specs += [(w1c, "w1", (f1, e)), (w2c, "w2", (e, f1))]
    for t, name, shape in specs:
        _build.require(t, name, shape, dev, _BF)
    for name, t, n in (("b1", vecs[0], f1), ("b2", vecs[1], e), ("ln_g", vecs[2], e),
                       ("ln_b", vecs[3], e), ("m_in", m_in, e), ("m_mid", m_mid, f1),
                       ("m_out", m_out, e)):
        _build.require(t, name, (n,), dev)
    return rows, e, f1, w1t, w2t, w1c, w2c, vecs


def _plan_for_bf16(dev, rows, e, f1, *weights):
    """The bf16 plan for the weights as given (W1^T, W2^T, W2, W1; a None
    weight, one the forward does not read, is a fresh copy's, aligned)."""
    return _cached_plan_bf16(rows, e, f1, _build.num_sms(dev),
                             tuple(0 if w is None else w.data_ptr() % 16 for w in weights))


def _launch_fwd_bf16(dev, x, src, w1, b1, w2, b2, ln_g, ln_b, m_in, m_mid, m_out, cfg):
    rows, e, f1, w1t, w2t, _, _, (b1f, b2f, gf, lbf) = _bf16_operands(
        dev, x, (("x", x), ("src", src)), w1, b1, w2, b2, ln_g, ln_b, m_in, m_mid, m_out,
        stored=False)
    _, addr, plan = _plan_for_bf16(dev, rows, e, f1, w1t, w2t, None, None)
    s, a, partial = _workspace(dev, fwd_workspace_bf16(plan, rows, e, f1))
    out = torch.empty_like(x)
    ints, floats = _flags(cfg)
    err = _build.load_library().mmtr_trunk_block_fwd_bf16(
        *(t.data_ptr() for t in (x, src, w1t, b1f, w2t, b2f, gf, lbf, m_in, m_mid, m_out, out,
                                 s, a, partial)),
        rows, e, f1, *ints, *floats, addr, _build.stream_ptr(dev))
    _build.check(err, "trunk_block forward kernel (bf16)")
    return out


def _launch_bwd_bf16(dev, x, src, dout, w1, b1, w2, b2, ln_g, ln_b, m_in, m_mid, m_out, cfg):
    rows, e, f1, w1t, w2t, w1c, w2c, (b1f, _, gf, lbf) = _bf16_operands(
        dev, x, (("src", src), ("dout", dout)), w1, b1, w2, b2, ln_g, ln_b, m_in, m_mid, m_out,
        stored=True)
    _, addr, plan = _plan_for_bf16(dev, rows, e, f1, w1t, w2t, w2c, w1c)
    work = _workspace(dev, bwd_workspace_bf16(plan, rows, e, f1))
    wsize = e * f1
    dsrc = torch.empty(rows, e, dtype=_BF, device=dev)
    red = torch.empty(2 * wsize + f1 + 3 * e, dtype=torch.float32, device=dev)
    ints, floats = _flags(cfg)
    err = _build.load_library().mmtr_trunk_block_bwd_bf16(
        *(t.data_ptr() for t in (src, dout, w1c, w1t, b1f, w2c, gf, lbf, m_in, m_mid, m_out,
                                 dsrc, red, *work)),
        rows, e, f1, *ints, *floats, addr, _build.stream_ptr(dev))
    _build.check(err, "trunk_block backward kernel (bf16)")
    dw1 = red[:wsize].view(f1, e)
    dw2 = red[wsize:2 * wsize].view(e, f1)
    db1, db2, dg, dlb = red[2 * wsize:].split([f1, e, e, e])
    # the JAX VJP casts each float32 sum to its parameter's dtype
    return (dsrc, *(g.to(p.dtype) for g, p in zip((dw1, db1, dw2, db2, dg, dlb),
                                                  (w1, b1, w2, b2, ln_g, ln_b))))


def _launch_fwd(dev, x, src, w1, b1, w2, b2, ln_g, ln_b, m_in, m_mid, m_out, cfg):
    rows, e, f1 = _check(dev, x, (("x", x), ("src", src)), w1, b1, w2, b2, ln_g, ln_b,
                         m_in, m_mid, m_out)
    _, addr, plan = _plan_for(dev, rows, e, f1, w1, w2)
    s, a, scratch = _workspace(dev, fwd_workspace(plan, rows, e, f1))
    out = torch.empty_like(x)
    ints, floats = _flags(cfg)
    err = _build.load_library().mmtr_trunk_block_fwd(
        *(t.data_ptr() for t in (x, src, w1, b1, w2, b2, ln_g, ln_b, m_in, m_mid, m_out, out,
                                 s, a, scratch)),
        rows, e, f1, *ints, *floats, addr, _build.stream_ptr(dev))
    _build.check(err, "trunk_block forward kernel")
    return out


def trunk_block_fwd(x, src, w1, b1, w2, b2, ln_g, ln_b, m_in, m_mid, m_out,
                    cfg: BlockConfig) -> torch.Tensor:
    """K9f over rows ``[R, E]``.  CPU tensors take
    :func:`fused_residual_block_reference`; CUDA tensors launch the kernel
    (or raise)."""
    if x.device.type == "cpu":
        return fused_residual_block_reference(x, src, w1, b1, w2, b2, ln_g, ln_b,
                                              m_in, m_mid, m_out, cfg)
    bf = x.dtype == _BF
    out = (_launch_fwd_bf16 if bf else _launch_fwd)(
        _build.device_of(x), x, src, w1, b1, w2, b2, ln_g, ln_b, m_in, m_mid, m_out, cfg)
    trunk_block_fwd.launches += 1
    trunk_block_fwd.launches_bf16 += bf
    return out


trunk_block_fwd.launches = 0
trunk_block_fwd.launches_bf16 = 0


def _bwd_plain_bf16(x, src, dout, w1, b1, w2, b2, ln_g, ln_b, m_in, m_mid, m_out,
                    cfg: BlockConfig):
    """K9b's plain version at bf16 ``x``: the JAX backward kernel's formulas
    (``trunk_block_pallas._bwd_kernel``), not autograd through the bf16
    forward, whose casts would round elsewhere: dz in float32 and dz_c its
    bf16 rounding, db2 from dz, dW2 = dz_c^T a_c, dp from dz_c W2 and dp_c
    its rounding, db1 from dp, dW1 = dp_c^T s_c, ds = dp_c W1, the masked-LN
    backward in float32, dsrc rounded; every parameter gradient summed in
    float32 and cast to its parameter's dtype."""
    rows, e = x.shape
    f1 = w1.shape[0]
    s32, t, inv, n = _masked_ln(src.float(), ln_g.float(), ln_b.float(), m_in)
    s_c = _rounded(s32, _BF)
    w1c, w2c = _rounded(w1, _BF), _rounded(w2, _BF)
    u = (torch.matmul(s_c, w1c.t()) + b1.float()) * m_mid
    a = torch.relu(u) if cfg.act == "relu" else u
    rids = torch.arange(rows, device=x.device)[:, None]
    dm = (_drop_field(cfg.seed_mid, cfg.rate_mid, rids,
                      torch.arange(f1, device=x.device)[None, :] // cfg.mid_rep)
          if cfg.use_drop_mid else None)
    ad_c = _rounded(a if dm is None else a * dm, _BF)
    dz = dout.float()
    if cfg.use_drop_res:
        dz = dz * _drop_field(cfg.seed_res, cfg.rate_res, rids,
                              torch.arange(e, device=x.device)[None, :])
    dz = dz * m_out
    dz_c = _rounded(dz, _BF)
    da = torch.matmul(dz_c, w2c)
    if dm is not None:
        da = da * dm
    if cfg.act == "relu":
        da = da * (u > 0).float()
    dp = da * m_mid
    dp_c = _rounded(dp, _BF)
    ds = torch.matmul(dp_c, w1c)
    dsm = ds * m_in
    dtn = dsm * ln_g.float()
    mean1 = dtn.sum(-1, keepdim=True) / n
    mean2 = (dtn * t).sum(-1, keepdim=True) / n
    dsrc = m_in * inv * (dtn - mean1 - t * mean2)
    grads = (torch.matmul(dp_c.t(), s_c), dp.sum(0), torch.matmul(dz_c.t(), ad_c), dz.sum(0),
             (dsm * t).sum(0), dsm.sum(0))
    return (dsrc.to(_BF), *(g.to(p.dtype) for g, p in zip(grads, (w1, b1, w2, b2, ln_g, ln_b))))


def trunk_block_bwd_plain(x, src, dout, w1, b1, w2, b2, ln_g, ln_b, m_in, m_mid, m_out,
                          cfg: BlockConfig):
    """Plain PyTorch version of K9b: ``torch.autograd.grad`` through the
    reference -> ``(dsrc, dw1, db1, dw2, db2, dln_g, dln_b)``; at bf16
    ``x``, :func:`_bwd_plain_bf16`."""
    if x.dtype == _BF:
        return _bwd_plain_bf16(x, src, dout, w1, b1, w2, b2, ln_g, ln_b, m_in, m_mid, m_out,
                               cfg)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (src, w1, b1, w2, b2, ln_g, ln_b)]
        out = fused_residual_block_reference(x.detach(), leaves[0], *leaves[1:], m_in,
                                             m_mid, m_out, cfg)
        return torch.autograd.grad(out, leaves, dout)


def _launch_bwd(dev, x, src, dout, w1, b1, w2, b2, ln_g, ln_b, m_in, m_mid, m_out, cfg):
    rows, e, f1 = _check(dev, x, (("src", src), ("dout", dout)), w1, b1, w2, b2, ln_g, ln_b,
                         m_in, m_mid, m_out)
    _, addr, plan = _plan_for(dev, rows, e, f1, w1, w2)
    work = _workspace(dev, bwd_workspace(plan, rows, e, f1))
    wsize = e * f1
    dsrc = torch.empty(rows, e, dtype=torch.float32, device=dev)
    red = torch.empty(2 * wsize + f1 + 3 * e, dtype=torch.float32, device=dev)
    ints, floats = _flags(cfg)
    err = _build.load_library().mmtr_trunk_block_bwd(
        *(t.data_ptr() for t in (src, dout, w1, b1, w2, ln_g, ln_b, m_in, m_mid, m_out, dsrc,
                                 red, *work)),
        rows, e, f1, *ints, *floats, addr, _build.stream_ptr(dev))
    _build.check(err, "trunk_block backward kernel")
    dw1 = red[:wsize].view(f1, e)
    dw2 = red[wsize:2 * wsize].view(e, f1)
    db1, db2, dg, dlb = red[2 * wsize:].split([f1, e, e, e])
    return dsrc, dw1, db1, dw2, db2, dg, dlb


def trunk_block_bwd(x, src, dout, w1, b1, w2, b2, ln_g, ln_b, m_in, m_mid, m_out,
                    cfg: BlockConfig):
    """K9b: ``(dsrc, dw1, db1, dw2, db2, dln_g, dln_b)`` for rows ``[R, E]``
    (dx is ``dout``).  CPU tensors take :func:`trunk_block_bwd_plain`; CUDA
    tensors launch the kernel (or raise)."""
    if x.device.type == "cpu":
        return trunk_block_bwd_plain(x, src, dout, w1, b1, w2, b2, ln_g, ln_b, m_in, m_mid,
                                     m_out, cfg)
    bf = x.dtype == _BF
    grads = (_launch_bwd_bf16 if bf else _launch_bwd)(
        _build.device_of(x), x, src, dout, w1, b1, w2, b2, ln_g, ln_b, m_in, m_mid, m_out, cfg)
    trunk_block_bwd.launches += 1
    trunk_block_bwd.launches_bf16 += bf
    return grads


trunk_block_bwd.launches = 0
trunk_block_bwd.launches_bf16 = 0


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
    F1]``, masks ``[E] / [F1] / [E]`` or None (all ones).  float32 x, src
    and parameters, or bf16 x and src with float32 or bf16 parameters (the
    bf16 instances; the gradients in each tensor's own dtype).  Rates are
    Python floats and seeds int32 Python ints; the dropout runs only where
    ``use_drop_*`` is set."""
    if x.dtype not in (torch.float32, _BF) or src.dtype != x.dtype:
        raise ValueError(f"fused_residual_block takes float32 or bfloat16 x and src of one "
                         f"dtype, got {x.dtype} / {src.dtype}")
    params = (w1, b1, w2, b2, ln_g, ln_b)
    if x.dtype == torch.float32 and any(p.dtype != torch.float32 for p in params):
        raise ValueError("fused_residual_block at float32 x takes float32 parameters")
    if any(p.dtype not in (torch.float32, _BF) for p in params):
        raise ValueError("fused_residual_block takes float32 or bfloat16 parameters")
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
