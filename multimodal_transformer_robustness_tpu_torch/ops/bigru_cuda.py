"""K1 / K1b: one bidirectional GRU level, T-major, through hand-written CUDA
kernels, forward and backward.

Counterpart of ``multimodal_transformer_robustness_tpu/ops/bigru_pallas.py``.
:func:`gru_dir` runs one direction forward: on a CUDA tensor it launches
``csrc/bigru.cu`` (which replaces the TPU kernel ``bigru_pallas._fwd_impl``),
on a CPU tensor it runs the plain version :func:`gru_dir_plain`.
:func:`gru_dir_bwd` is its backward: on a CUDA tensor it launches
``csrc/bigru_bwd.cu`` (replacing ``bigru_pallas._bwd_impl``), on a CPU
tensor it runs :func:`gru_dir_bwd_plain`, ``torch.autograd.grad`` through
the plain time loop.  :class:`GruDir` joins the two as an autograd
function, as ``gru_dir_pallas``'s custom VJP does.  The kernel operands
``wp / wt / bc / bhn`` are derived from torch-layout weights by
:func:`dir_operands` on every call, differentiably, so gradients reach the
reference-layout parameters ``w_ih / w_hh / b_ih / b_hh``.

The zero-padded bucket steps are run like any other step, as on the TPU:
no packing, no length masking.

bf16 operands (the JAX kernels' production dtype, under the bf16 compute
policy) take the kernels' bf16 instances (``mmtr_gru_dir_fwd_bf16`` /
``mmtr_gru_dir_bwd_bf16``: the products on the bf16 tensor cores,
``csrc/gemm_bf16.cuh``) and, on the CPU, the bf16 plain versions, at the
JAX kernels' rounding points: the gate pre-activations and h are carried
in float32, h is rounded to bf16 for ``h W_hh^T`` and for the output; the
backward rounds ``da`` for the carry and the reductions, and returns dx,
dW and db rounded to bf16 (the JAX VJP's cast to the weights' dtype).
``launches_bf16`` counts the bf16 launches within ``launches``.
"""

from __future__ import annotations

import functools

import torch

from .. import _build
from . import gemm_tc


def dir_operands(p: dict) -> dict:
    """torch-layout direction weights (``w_ih [3H, in]``, ``w_hh [3H, H]``,
    ``b_ih``, ``b_hh``) -> kernel operands, gates in (r, z, n) order:
    ``wp [3, in, H]``, ``wt [3, H, H]``, ``bc [3, H]`` holding
    ``b_ir+b_hr``, ``b_iz+b_hz`` and ``b_in``, and ``bhn [H]``."""
    h = p["w_hh"].shape[1]
    wp = p["w_ih"].reshape(3, h, -1).transpose(1, 2).contiguous()
    wt = p["w_hh"].reshape(3, h, h).transpose(1, 2).contiguous()
    bi = p["b_ih"].reshape(3, h)
    bh = p["b_hh"].reshape(3, h)
    bc = torch.stack([bi[0] + bh[0], bi[1] + bh[1], bi[2]])
    return {"wp": wp, "wt": wt, "bc": bc, "bhn": bh[2].contiguous()}


_BF16 = torch.bfloat16


def _rbf(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16, as float32."""
    return t.to(_BF16).float()


def gru_dir_plain(x: torch.Tensor, wp: torch.Tensor, wt: torch.Tensor,
                  bc: torch.Tensor, bhn: torch.Tensor,
                  reverse: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel: x [T, B, in] -> h [T, B, H]."""
    if x.dtype == _BF16:
        return _gru_dir_plain_bf16(x, wp, wt, bc, bhn, reverse)
    t_len, b = x.shape[0], x.shape[1]
    h_dim = wt.shape[-1]
    g = torch.matmul(x.unsqueeze(0), wp.unsqueeze(1)) + bc[:, None, None, :]
    h = torch.zeros(b, h_dim, dtype=torch.float32, device=x.device)
    out = [None] * t_len
    steps = range(t_len - 1, -1, -1) if reverse else range(t_len)
    for t in steps:
        r = torch.sigmoid(g[0, t] + h @ wt[0])
        z = torch.sigmoid(g[1, t] + h @ wt[1])
        n = torch.tanh(g[2, t] + r * (h @ wt[2] + bhn))
        h = (1.0 - z) * n + z * h
        out[t] = h
    return torch.stack(out)


def _gru_dir_plain_bf16(x, wp, wt, bc, bhn, reverse: bool) -> torch.Tensor:
    """The bf16 instance's plain version: products of bf16 values as
    float32 matmuls of the upcast operands (exact products, float32 sums),
    h carried in float32 and rounded to bf16 for ``h W_hh^T`` and the
    output (JAX ``bigru_pallas._fwd_kernel`` at bf16)."""
    t_len, b = x.shape[0], x.shape[1]
    wtf, bhnf = wt.float(), bhn.float()
    g = torch.matmul(x.float().unsqueeze(0), wp.float().unsqueeze(1)) + bc.float()[:, None, None, :]
    h = torch.zeros(b, wt.shape[-1], dtype=torch.float32, device=x.device)
    out = [None] * t_len
    for t in (range(t_len - 1, -1, -1) if reverse else range(t_len)):
        hm = _rbf(h)
        r = torch.sigmoid(g[0, t] + hm @ wtf[0])
        z = torch.sigmoid(g[1, t] + hm @ wtf[1])
        n = torch.tanh(g[2, t] + r * (hm @ wtf[2] + bhnf))
        h = (1.0 - z) * n + z * h
        out[t] = h.to(_BF16)
    return torch.stack(out)


_TILED_MAX_THREADS, _TILED_RT = 256, 4        # the tiled form's launch bound, rows a thread
_SMALL_KS, _SMALL_MAXK = 8, 13                # lanes a column, W terms a lane (bigru.cu)


def _plan_recurrence(G: int, B: int, H: int, num_sms: int = _build.NUM_SMS,
                     aligned: bool = True) -> dict:
    """The launch plan of ``csrc/gru_rec.cuh``'s recurrence over ``G`` groups
    of ``B`` rows (K1f: G = 1; K7f: G recurrences of N rows).

    The small form (a block a (row, group), 8 lanes a column holding W_hh^T
    in registers; h and K7f's b_hr, b_hz in shared memory) while ``G * B <=
    num_sms`` and H <= 104.  Else the tiled
    form: W_hh^T in shared memory, so one block an SM, rows a multiple of 4
    up to what shared memory and the kernel's 256 threads allow (32 at
    H = 100).  Its rows give the fewest waves of ``G * ceil(B / rows)``
    blocks over the SMs, and are the fewest that do: a step's time grows
    with a block's rows.  At G * B = 4096 (K1f's training shape) that is
    one wave of 32-row blocks; at G = 2, B = 4096 (K7f at the MOSEI header
    level) two waves of 32-row blocks, since one wave would need 64-row
    blocks (328,000 bytes of shared memory, 400 threads).  ``rec_vec``
    (16-byte gate copies) needs H a multiple of 4 and ``aligned`` gate and
    output arrays.  Raises where a 4-row tile's W_hh^T and state do not fit
    a block's 227 KB (H above ~130)."""
    hp = _build.round_up(H, 4)
    if G * B <= num_sms and H <= _SMALL_KS * _SMALL_MAXK:
        return {"rec_small": 1, "rec_rows": 1, "rec_ks": _SMALL_KS, "rec_vec": 0,
                "rec_threads": _build.round_up(H * _SMALL_KS, 32), "rec_smem": 4 * 4 * hp,
                "hp": hp, "rec_blocks": B}

    def smem(r):
        return 4 * (3 * H * hp + 8 * r * hp + 8 * hp)

    r_max = 0
    for r in range(_TILED_RT, _TILED_RT * _TILED_MAX_THREADS + 1, _TILED_RT):
        if smem(r) > _build.MAX_SMEM or (r // _TILED_RT) * (hp // 4) > _TILED_MAX_THREADS:
            break
        r_max = r
    if r_max == 0:
        raise ValueError(f"gru recurrence: H={H} leaves no room for an {_TILED_RT}-row tile "
                         f"in {_build.MAX_SMEM} bytes of shared memory")
    waves = -(-G * -(-B // r_max) // num_sms)
    rows = next(r for r in range(_TILED_RT, r_max + 1, _TILED_RT)
                if G * -(-B // r) <= waves * num_sms)
    return {"rec_small": 0, "rec_rows": rows, "rec_ks": 0,
            "rec_vec": int(aligned and H % 4 == 0),
            "rec_threads": (rows // _TILED_RT) * (hp // 4), "rec_smem": smem(rows), "hp": hp,
            "rec_blocks": -(-B // rows)}


REC_PLAN_KEYS = ("rec_small", "rec_rows", "rec_threads", "rec_smem", "rec_ks", "rec_vec", "hp")


def _plan_gru_fwd(T: int, B: int, in_dim: int, H: int, num_sms: int = _build.NUM_SMS,
                  aligned: bool = True) -> dict:
    """K1f's launch plan (``csrc/bigru.cu`` takes it as given).

    The projection: :func:`gemm_tc.plan_product` over ``[T*B, in] x [in,
    3H]``: the wgmma 3xTF32 GEMM (128 x 152 tiles at 3H = 300) where those
    tiles give every SM at least two blocks and the copies can be 16 bytes
    wide (``in`` and ``H`` multiples of 4, the operands ``aligned``), else
    64 x 64 mma.sync tiles (16-byte copies where they can be), split over K
    into up to 8 ranges of at least 3 k tiles while that still leaves two
    blocks an SM or fewer (at B=1, in=768: 8 splits of 3 k tiles, not 24
    serial ones).  ``gemm_scratch``: the floats of scratch either needs.
    The recurrence: :func:`_plan_recurrence` with G = 1 over the gate
    scratch the wrapper allocates (aligned): the small form while B <=
    ``num_sms``, else the tiled one (32 rows at B=4096: 128 blocks, one
    wave)."""
    vec = aligned and in_dim % 4 == 0 and H % 4 == 0
    g = gemm_tc.plan_product(T * B, 3 * H, in_dim, vec, num_sms)
    plan = {f"gemm_{k}": g[k] for k in gemm_tc.PLAN_KEYS + ("smem", "scratch")}
    plan.update(_plan_recurrence(1, B, H, num_sms))
    return plan


GEMM_PLAN_KEYS = tuple(f"gemm_{k}" for k in gemm_tc.PLAN_KEYS)


# csrc/bigru.cu's own bf16 projection tile's columns (gemm_wgmma 2)
_K1F_BN = 304

# csrc/gru_rec.cuh's mma form: n tiles of 8 columns a gate (H <= 104), warps
# a row group of 16, n tiles a warp at most, W's and hm's bf16 row pitches,
# row groups a block at most
_RM_NT, _RM_WPG, _RM_TPW, _RM_WLD, _RM_HLD, _RM_MAX_RG = 13, 4, 4, 120, 120, 2


def _plan_recurrence_bf16(B: int, H: int, num_sms: int = _build.NUM_SMS) -> dict:
    """K1f.bf16's recurrence plan (its own keys, ``REC_BF16_PLAN_KEYS``;
    :func:`_plan_recurrence` stays the float32 instances' and K7's): the
    small form while ``B <= num_sms`` (the serving batch of 1, the eval
    batch of 16), as the float plan's; else, at H <= 104, the mma form
    (``rec_mma``, ``gru_rec_mma_kernel``): hm W_hh^T on the bf16 tensor
    cores, a row group of 16 rows split over four warps by n tiles, which
    meet at a named barrier once a step (one warp holding a row group's 13
    tiles alone ran slower than the tiled form on the card: PERF.md).  A
    block takes one row group while ``ceil(B / 16)`` fits the SMs, else two
    (B=4096: 128 blocks of 8 warps, one wave); shared memory W_hh [3][8
    nt][120] bf16 + b_hn [8 nt] float32 + hm [groups][2][16][120] bf16 + per
    warp [2][3][4][2][32] float2 gate values (188,960 bytes at H = 100, two
    row groups).  Wider H takes the float plan's tiled form at bf16
    (``rec_mma`` 0)."""
    base = _plan_recurrence(1, B, H, num_sms)
    if base["rec_small"] or H > 8 * _RM_NT:
        return {"rec_mma": 0, **base}
    groups = 1 if -(-B // 16) <= num_sms else _RM_MAX_RG
    np_ = 8 * -(-H // 8)
    warps = groups * _RM_WPG
    smem = (2 * 3 * np_ * _RM_WLD + 4 * np_ + groups * 2 * 2 * 16 * _RM_HLD
            + warps * 8 * 2 * 3 * _RM_TPW * 2 * 32)
    return {"rec_mma": 1, "rec_small": 0, "rec_rows": 16 * groups, "rec_threads": 32 * warps,
            "rec_smem": smem, "rec_ks": 0, "rec_vec": int(H % 2 == 0), "hp": base["hp"],
            "rec_blocks": -(-B // (16 * groups))}


REC_BF16_PLAN_KEYS = ("rec_mma",) + REC_PLAN_KEYS


def _plan_gru_fwd_bf16(T: int, B: int, in_dim: int, H: int, num_sms: int = _build.NUM_SMS,
                       x_addr: int = 0, wp_addr: int = 0) -> dict:
    """The bf16 instance's plan: the projection by :func:`gemm_tc.plan_bf16`
    (A = x with row stride ``in``, B = W_ih^T gated [3, in, H]: copies that
    stay in one gate; ``partial``: its split planes, or B^T), except that
    where it takes the wgmma kernel and 3H <= 304, ``gemm_wgmma`` is 2:
    ``csrc/bigru.cu``'s own 128 x 304 tile, all of 3H = 300 in one column
    tile, so x is read once (gemm_bf16.cuh's 128-wide tiles read it three
    times and pad 300 to 384); then :func:`_plan_recurrence_bf16`."""
    acw = gemm_tc.bf16_copy_width((in_dim,), (x_addr,))
    bcw = gemm_tc.bf16_copy_width((H,), (wp_addr,))
    g = gemm_tc.plan_bf16(T * B, 3 * H, in_dim, acw, bcw, num_sms)
    plan = {f"gemm_{k}": g[k] for k in gemm_tc.BF_PLAN_KEYS + ("partial",)}
    if plan["gemm_wgmma"] and 3 * H <= _K1F_BN:
        plan["gemm_wgmma"] = 2
    plan.update(_plan_recurrence_bf16(B, H, num_sms))
    return plan


BF_GEMM_PLAN_KEYS = tuple(f"gemm_{k}" for k in gemm_tc.BF_PLAN_KEYS)


@functools.lru_cache(maxsize=None)
def _cached_plan_bf16(T, B, in_dim, H, num_sms, x_addr, wp_addr):
    """The bf16 plan as csrc/bigru.cu reads it: (C int array, its address,
    the floats of split planes)."""
    p = _plan_gru_fwd_bf16(T, B, in_dim, H, num_sms, x_addr, wp_addr)
    ints = _build.host_ints([p[k] for k in BF_GEMM_PLAN_KEYS + REC_BF16_PLAN_KEYS])
    return ints + (p["gemm_partial"],)


@functools.lru_cache(maxsize=None)
def _cached_plan(T, B, in_dim, H, num_sms, aligned):
    """The plan as csrc/bigru.cu reads it: (C int array, its address, the
    floats of GEMM scratch to allocate)."""
    p = _plan_gru_fwd(T, B, in_dim, H, num_sms, aligned)
    ints = _build.host_ints([p[k] for k in GEMM_PLAN_KEYS + REC_PLAN_KEYS])
    return ints + (p["gemm_scratch"],)


def _launch_fwd(x, wp, wt, bc, bhn, reverse: bool):
    """Launch K1 on the card -> (h [T, B, H], the input-side gate
    pre-activations [3, T*B, H] that K1b reads back, float32 at either
    dtype)."""
    dev = _build.device_of(x)
    t_len, b, in_dim = x.shape
    h_dim = wt.shape[-1]
    dt = _BF16 if x.dtype == _BF16 else torch.float32
    _build.require_all(dev, ((x, "x", (t_len, b, in_dim)), (wp, "wp", (3, in_dim, h_dim)),
                             (wt, "wt", (3, h_dim, h_dim)), (bc, "bc", (3, h_dim)),
                             (bhn, "bhn", (h_dim,))), dt)
    if dt == _BF16:
        plan = _cached_plan_bf16(t_len, b, in_dim, h_dim, _build.num_sms(dev),
                                 x.data_ptr() % 16, wp.data_ptr() % 16)
        gates = torch.empty(3, t_len * b, h_dim, dtype=torch.float32, device=dev)
        out = torch.empty(t_len, b, h_dim, dtype=_BF16, device=dev)
        partial = (torch.empty(plan[2], dtype=torch.float32, device=dev) if plan[2]
                   else None)
        err = _build.load_library().mmtr_gru_dir_fwd_bf16(
            x.data_ptr(), wp.data_ptr(), wt.data_ptr(), bc.data_ptr(), bhn.data_ptr(),
            gates.data_ptr(), out.data_ptr(), partial.data_ptr() if partial is not None else 0,
            t_len, b, in_dim, h_dim, int(reverse), plan[1], _build.stream_ptr(dev))
        _build.check(err, "gru_dir kernel (bf16)")
        gru_dir.launches += 1
        gru_dir.launches_bf16 += 1
        return out, gates
    plan = _cached_plan(t_len, b, in_dim, h_dim, _build.num_sms(dev),
                        x.data_ptr() % 16 == 0 and wp.data_ptr() % 16 == 0)
    gates = torch.empty(3, t_len * b, h_dim, dtype=torch.float32, device=dev)
    out = torch.empty(t_len, b, h_dim, dtype=torch.float32, device=dev)
    # the GEMM's scratch: W_ih's TF32 planes (wgmma) or the split-K partials
    scratch = torch.empty(plan[2], dtype=torch.float32, device=dev) if plan[2] else None
    err = _build.load_library().mmtr_gru_dir_fwd(
        x.data_ptr(), wp.data_ptr(), wt.data_ptr(), bc.data_ptr(), bhn.data_ptr(),
        gates.data_ptr(), out.data_ptr(), scratch.data_ptr() if scratch is not None else 0,
        t_len, b, in_dim, h_dim, int(reverse), plan[1], _build.stream_ptr(dev))
    _build.check(err, "gru_dir kernel")
    gru_dir.launches += 1
    return out, gates


def gru_dir(x: torch.Tensor, wp: torch.Tensor, wt: torch.Tensor,
            bc: torch.Tensor, bhn: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """One GRU direction over T-major ``x [T, B, in]`` -> ``[T, B, H]`` in
    storage time order.  CPU tensors take :func:`gru_dir_plain`; CUDA
    tensors launch the kernel (or raise)."""
    if x.device.type == "cpu":
        return gru_dir_plain(x, wp, wt, bc, bhn, reverse)
    return _launch_fwd(x, wp, wt, bc, bhn, reverse)[0]


gru_dir.launches = 0
gru_dir.launches_bf16 = 0


def gru_dir_bwd_plain(x, wp, wt, bc, bhn, hs, gates, dhs, reverse: bool = False,
                      need_dx: bool = True):
    """Plain PyTorch version of K1b: ``torch.autograd.grad`` through
    :func:`gru_dir_plain` -> ``(dx or None, dwp, dwt, dbc, dbhn)``.  ``hs``
    and ``gates`` (the kernel's saved forward) are not read.  bf16
    operands take :func:`_gru_dir_bwd_plain_bf16`."""
    if x.dtype == _BF16:
        return _gru_dir_bwd_plain_bf16(x, wp, wt, bc, bhn, hs, dhs, reverse, need_dx)
    with torch.enable_grad():
        x_ = x.detach().requires_grad_(need_dx)
        ws = [w.detach().requires_grad_(True) for w in (wp, wt, bc, bhn)]
        out = gru_dir_plain(x_, *ws, reverse)
        grads = torch.autograd.grad(out, ([x_] if need_dx else []) + ws, dhs)
    return ((grads[0],) if need_dx else (None,)) + tuple(grads[-4:])


def _gru_dir_bwd_plain_bf16(x, wp, wt, bc, bhn, hs, dhs, reverse: bool, need_dx: bool):
    """The bf16 instance's plain version, step by step newest first as
    the JAX kernel (``bigru_pallas._bwd_kernel`` at bf16): the gates
    recomputed from h_prev, the forward's bf16 output; ``da_r``, ``da_z``,
    ``da_n`` and ``dghn`` rounded to bf16 for the carry, the reductions and
    dx; products of bf16 values as float32 matmuls of the upcast operands;
    dx, dW and db rounded to bf16 (the VJP's cast to the weights' dtype)."""
    t_len, b, in_dim = x.shape
    h_dim = wt.shape[-1]
    xf, wpf, wtf, hsf = x.float(), wp.float(), wt.float(), hs.float()
    g = torch.matmul(xf.unsqueeze(0), wpf.unsqueeze(1)) + bc.float()[:, None, None, :]
    bhnf = bhn.float()
    zero = torch.zeros(b, h_dim, dtype=torch.float32, device=x.device)
    dh = zero
    da = [[None] * t_len for _ in range(4)]          # da_r, da_z, da_n, dghn
    hprev = [None] * t_len
    for t in (range(t_len) if reverse else range(t_len - 1, -1, -1)):
        tp = t + 1 if reverse else t - 1
        h_prev = hsf[tp] if 0 <= tp < t_len else zero
        r = torch.sigmoid(g[0, t] + h_prev @ wtf[0])
        z = torch.sigmoid(g[1, t] + h_prev @ wtf[1])
        gh_n = h_prev @ wtf[2] + bhnf
        n = torch.tanh(g[2, t] + r * gh_n)
        dht = dhs[t].float() + dh
        da_n = dht * (1.0 - z) * (1.0 - n * n)
        da_r = _rbf(da_n * gh_n * r * (1.0 - r))
        da_z = _rbf(dht * (h_prev - n) * z * (1.0 - z))
        dghn = _rbf(da_n * r)
        dh = dht * z + da_r @ wtf[0].t() + da_z @ wtf[1].t() + dghn @ wtf[2].t()
        for k, v in enumerate((da_r, da_z, _rbf(da_n), dghn)):
            da[k][t] = v
        hprev[t] = h_prev
    rows = t_len * b
    dar, daz, dan, dgn = (torch.stack(v).reshape(rows, h_dim) for v in da)
    hp = torch.stack(hprev).reshape(rows, h_dim)
    xr = xf.reshape(rows, in_dim)
    dwp = torch.stack([xr.t() @ v for v in (dar, daz, dan)])
    dwt = torch.stack([hp.t() @ v for v in (dar, daz, dgn)])
    dbc = torch.stack([v.sum(0) for v in (dar, daz, dan)])
    dx = None
    if need_dx:
        dx = (dar @ wpf[0].t() + daz @ wpf[1].t() + dan @ wpf[2].t()).reshape(
            t_len, b, in_dim).to(_BF16)
    return (dx, dwp.to(_BF16), dwt.to(_BF16), dbc.to(_BF16), dgn.sum(0).to(_BF16))


def _plan_rec_bwd(G: int, B: int, H: int, num_sms: int = _build.NUM_SMS) -> dict:
    """The launch plan of ``csrc/gru_rec.cuh``'s backward recurrence
    (``gru_rec_bwd_tiled_kernel``) over ``G`` groups of ``B`` rows (K1b: G =
    1; K7b: G recurrences of N rows).

    Thread tiles of 4 rows by 4 strided columns, ``js = ceil(H / 4)``
    threads across a row group; W_hh^T in shared memory once, ``[3][4
    js][wp]`` with the odd pitch ``wp = 4 js + 1`` that keeps both products'
    reads free of bank conflicts, beside h_prev ``[2][4 js][rows + 4]`` and
    da ``[3][4 js][rows + 4]``.  Rows a block: a multiple of 4, as many as
    shared memory and the kernel's 256 threads allow at most, then the
    fewest that give the fewest waves of ``G * ceil(B / rows)`` blocks (one
    an SM): B=4096, H=100, G=1: 32 rows, 128 blocks, one wave; G=2: 40 rows
    fit, but give 206 blocks, two waves, so 32 rows, 256 blocks; G * B <=
    528: 4 rows.  Raises where W_hh^T and a 4-row tile do not fit a block's
    227 KB (H above ~130)."""
    js = -(-H // 4)
    hk = 4 * js
    wp = hk + 1

    def smem(r):
        return 4 * (3 * hk * wp + 5 * hk * (r + 4))

    r_max = 0
    for r in range(_TILED_RT, _TILED_RT * _TILED_MAX_THREADS + 1, _TILED_RT):
        if smem(r) > _build.MAX_SMEM or (r // _TILED_RT) * js > _TILED_MAX_THREADS:
            break
        r_max = r
    if r_max == 0:
        raise ValueError(f"gru backward: H={H} leaves no room for a {_TILED_RT}-row tile "
                         f"in {_build.MAX_SMEM} bytes of shared memory")
    waves = -(-G * -(-B // r_max) // num_sms)
    rows = next(r for r in range(_TILED_RT, r_max + 1, _TILED_RT)
                if G * -(-B // r) <= waves * num_sms)
    return {"rows": rows, "threads": rows // _TILED_RT * js, "smem": smem(rows), "js": js,
            "wp": wp, "blocks": G * -(-B // rows)}


REC_BWD_PLAN_KEYS = ("rows", "threads", "smem", "js", "wp")


def _plan_gru_bwd(T: int, B: int, in_dim: int, H: int, need_dx: bool,
                  num_sms: int = _build.NUM_SMS, aligned: bool = True) -> dict:
    """K1b's launch plan (``csrc/bigru_bwd.cu`` takes it as given).

    The recurrence: :func:`_plan_rec_bwd` with G = 1 (B=4096, H=100: 32
    rows, 128 blocks, one wave; B <= 528: 4 rows).

    The products over T*B rows (``gemm_tc.plan_tn``, k ranges that fill one
    wave): dwp over ``[in, 3H]``, and dwt with the bias sums over ``[H + 1,
    4H]`` (a row of ones appended to h_prev); ``tn_vec`` takes 16-byte
    copies (``in`` and ``H`` multiples of 4, ``aligned`` operands).
    ``partial``: the floats of both products' planes.  dx only when
    ``need_dx``: :func:`gemm_tc.plan_product` over ``[T*B, 3H] x [3H,
    in]`` (``dx_*``; all zero without dx)."""
    plan = _plan_rec_bwd(1, B, H, num_sms)
    plan["tn_vec"] = int(aligned and in_dim % 4 == 0 and H % 4 == 0)
    dwp = gemm_tc.plan_tn(in_dim, 3 * H, T * B, num_sms)
    dwt = gemm_tc.plan_tn(H + 1, 4 * H, T * B, num_sms)
    plan.update(dwp_splits=dwp["splits"], dwp_kps=dwp["kps"], dwt_splits=dwt["splits"],
                dwt_kps=dwt["kps"], partial=dwp["partial"] + dwt["partial"])
    dx = (gemm_tc.plan_product(T * B, in_dim, 3 * H, aligned and in_dim % 4 == 0
                               and H % 4 == 0, num_sms) if need_dx else None)
    plan.update({f"dx_{k}": dx[k] if dx else 0
                 for k in gemm_tc.PLAN_KEYS + ("smem", "scratch")})
    return plan


BWD_PLAN_KEYS = REC_BWD_PLAN_KEYS + ("tn_vec", "dwp_splits", "dwp_kps", "dwt_splits",
                                     "dwt_kps") + tuple(f"dx_{k}" for k in gemm_tc.PLAN_KEYS)


@functools.lru_cache(maxsize=None)
def _cached_bwd_plan(T, B, in_dim, H, need_dx, num_sms, aligned):
    """The plan as csrc/bigru_bwd.cu reads it: (C int array, its address,
    the floats of partial planes, the floats of dx's scratch)."""
    p = _plan_gru_bwd(T, B, in_dim, H, need_dx, num_sms, aligned)
    ints = _build.host_ints([p[k] for k in BWD_PLAN_KEYS])
    return ints + (p["partial"], p["dx_scratch"])


def _plan_rec_bwd_bf16(B: int, H: int, num_sms: int = _build.NUM_SMS) -> dict:
    """K1b.bf16's recurrence plan (:func:`_plan_rec_bwd` stays the float32
    instance's and K7b's): where ``B`` passes the SM count and H <= 104,
    the mma form (``rec_mma``, ``gru_rec_bwd_mma_kernel``): both of a
    step's products on the bf16 tensor cores, a row group of 16 rows split
    over four warps by n tiles, a named barrier a step; a block one row
    group while ``ceil(B / 16)`` fits the SMs, else two (B=4096: 128 blocks
    of 8 warps, one wave); shared memory W_hh^T [3][112][120] bf16 + b_hn
    [104] float32 + per row group h_prev [2][16][120] and da [2][3][16][120]
    bf16 + per warp the gate slots [3][4][2][32] float2 and dh_in's
    [4][2][32] bf16 pairs (199,840 bytes at two row groups); ``rec_vec``: H
    a multiple of 4 (8-byte copies).  Else the tiled form by the float
    plan (``rec_mma`` 0)."""
    if B <= num_sms or H > 8 * _RM_NT:
        return {"rec_mma": 0, **_plan_rec_bwd(1, B, H, num_sms), "rec_vec": 0}
    groups = 1 if -(-B // 16) <= num_sms else _RM_MAX_RG
    kp = 16 * -(-(8 * _RM_NT) // 16)
    smem = (2 * 3 * kp * _RM_WLD + 4 * 8 * _RM_NT
            + groups * (2 * 2 * 16 * _RM_HLD + 2 * 2 * 3 * 16 * _RM_HLD)
            + groups * _RM_WPG * (8 * 3 * _RM_TPW * 2 * 32 + 4 * _RM_TPW * 2 * 32))
    return {"rec_mma": 1, "rows": 16 * groups, "threads": 32 * _RM_WPG * groups,
            "smem": smem, "js": 0, "wp": 0, "rec_vec": int(H % 4 == 0),
            "blocks": -(-B // (16 * groups))}


REC_BWD_BF16_PLAN_KEYS = ("rec_mma",) + REC_BWD_PLAN_KEYS + ("rec_vec",)


def _plan_gru_bwd_bf16(T: int, B: int, in_dim: int, H: int, need_dx: bool,
                       num_sms: int = _build.NUM_SMS, x_addr: int = 0,
                       hs_addr: int = 0) -> dict:
    """The bf16 instance's plan: the recurrence's seven ints
    (:func:`_plan_rec_bwd_bf16`: the mma form, or the float plan's tiled
    form), then :func:`gemm_tc.plan_bf16` for the reductions over ``T*B``
    rows, split into float32 planes (any number of ranges, two blocks an
    SM), with A read transposed: ``dwp`` (x^T dg[:, :3H], ``[in, 3H]``; on
    the wgmma reduction, ``wgmma`` 3, where x and dg take 16-byte rows) and
    ``dwt`` ([h_prev | 1]^T dg, ``[H + 1, 4H]``; on the wgmma reduction
    beside the mma-form recurrence, which writes [h_prev | 1 | 0..] into a
    scratch of ``hp`` = H + 1 rounded up to 8 columns; else on the mma.sync
    tiles, its copies of h dividing H, where the ones row starts); and
    ``dx`` (dg[:, :3H] wp^T, ``[T*B, in]``; zeros without dx).  dg and wp^T
    are fresh allocations, aligned."""
    rows, h3, h4 = T * B, 3 * H, 4 * H
    plan = _plan_rec_bwd_bf16(B, H, num_sms)
    bcw = gemm_tc.bf16_copy_width((h4,))
    dwp = gemm_tc.plan_bf16(in_dim, h3, rows, gemm_tc.bf16_copy_width((in_dim,), (x_addr,)),
                            bcw, num_sms, max_splits=None, transposed_a=True, reduction=True)
    # dwt on the wgmma reduction where the mma form writes h_prev into hp
    # (H + 1 columns rounded up to 8: TMA's 16-byte rows; column H the ones)
    hp = 8 * -(-(H + 1) // 8) if plan["rec_mma"] and bcw == 8 else 0
    dwt = gemm_tc.plan_bf16(H + 1, h4, rows,
                            8 if hp else gemm_tc.bf16_copy_width((H,), (hs_addr,)), bcw,
                            num_sms, max_splits=None, transposed_a=True, reduction=bool(hp))
    plan["hp"] = hp
    dx = (gemm_tc.plan_bf16(rows, in_dim, h3, bcw, gemm_tc.bf16_copy_width((in_dim,)),
                            num_sms) if need_dx else None)
    for name, q in (("dwp", dwp), ("dwt", dwt), ("dx", dx)):
        plan.update({f"{name}_{k}": q[k] if q else 0
                     for k in gemm_tc.BF_PLAN_KEYS + ("partial",)})
    return plan


BWD_BF16_PLAN_KEYS = REC_BWD_BF16_PLAN_KEYS + tuple(f"{n}_{k}" for n in ("dwp", "dwt", "dx")
                                                    for k in gemm_tc.BF_PLAN_KEYS)


@functools.lru_cache(maxsize=None)
def _cached_bwd_plan_bf16(T, B, in_dim, H, need_dx, num_sms, x_addr, hs_addr):
    """The bf16 plan as csrc/bigru_bwd.cu reads it: (C int array, its
    address, the floats of the reductions' planes, of dx's split planes,
    hp's columns)."""
    p = _plan_gru_bwd_bf16(T, B, in_dim, H, need_dx, num_sms, x_addr, hs_addr)
    ints = _build.host_ints([p[k] for k in BWD_BF16_PLAN_KEYS])
    return ints + (p["dwp_partial"] + p["dwt_partial"], p["dx_partial"], p["hp"])


def _launch_bwd_bf16(x, wt, bhn, wpT, hs, gates, dhs, reverse: bool, need_dx: bool):
    """K1b's bf16 instance -> (dx or None, red [in*3H + (H+1)*4H] bf16)."""
    dev = _build.device_of(x)
    t_len, b, in_dim = x.shape
    h = wt.shape[-1]
    plan = _cached_bwd_plan_bf16(t_len, b, in_dim, h, bool(need_dx), _build.num_sms(dev),
                                 x.data_ptr() % 16, hs.data_ptr() % 16)
    f32 = dict(dtype=torch.float32, device=dev)
    bf = dict(dtype=_BF16, device=dev)
    dg = torch.empty(t_len * b, 4 * h, **bf)
    partial = torch.empty(plan[2], **f32)
    red = torch.empty(in_dim * 3 * h + (h + 1) * 4 * h, **bf)
    dx = torch.empty(t_len, b, in_dim, **bf) if need_dx else None
    dx_partial = torch.empty(plan[3], **f32) if plan[3] else None
    hp = torch.empty(t_len * b * plan[4], **bf) if plan[4] else None
    err = _build.load_library().mmtr_gru_dir_bwd_bf16(
        x.data_ptr(), hs.data_ptr(), gates.data_ptr(), dhs.data_ptr(), wt.data_ptr(),
        bhn.data_ptr(), wpT.data_ptr() if need_dx else 0, dg.data_ptr(), partial.data_ptr(),
        red.data_ptr(), dx.data_ptr() if need_dx else 0,
        dx_partial.data_ptr() if dx_partial is not None else 0,
        hp.data_ptr() if hp is not None else 0, t_len, b, in_dim, h, int(reverse),
        int(need_dx), plan[1], _build.stream_ptr(dev))
    _build.check(err, "gru_dir_bwd kernel (bf16)")
    gru_dir_bwd.launches += 1
    gru_dir_bwd.launches_no_dx += int(not need_dx)
    gru_dir_bwd.launches_bf16 += 1
    return dx, red


def gru_dir_bwd(x, wp, wt, bc, bhn, hs, gates, dhs, reverse: bool = False,
                need_dx: bool = True):
    """Backward of one direction: ``x [T, B, in]``, the forward's ``hs``
    and saved ``gates``, and ``dhs [T, B, H]`` -> ``(dx or None, dwp, dwt,
    dbc, dbhn)``.  ``need_dx=False`` skips the dx product.  CPU tensors take
    :func:`gru_dir_bwd_plain`; CUDA tensors launch K1b (or raise)."""
    if x.device.type == "cpu":
        return gru_dir_bwd_plain(x, wp, wt, bc, bhn, hs, gates, dhs, reverse, need_dx)
    dev = _build.device_of(x)
    t_len, b, in_dim = x.shape
    h = wt.shape[-1]
    rows = t_len * b
    dhs = dhs.contiguous()
    dt = _BF16 if x.dtype == _BF16 else torch.float32
    _build.require_all(dev, ((x, "x", (t_len, b, in_dim)), (hs, "hs", (t_len, b, h)),
                             (dhs, "dhs", (t_len, b, h)), (wp, "wp", (3, in_dim, h)),
                             (wt, "wt", (3, h, h)), (bhn, "bhn", (h,))), dt)
    _build.require(gates, "gates", (3, rows, h), dev)
    # dg's gate blocks run n, r, z (then dghn): wp^T's rows in that order
    # (roll, not a list index, which would upload the index and stall the host)
    wpT = (wp.roll(1, 0).transpose(1, 2).reshape(3 * h, in_dim).contiguous()
           if need_dx else None)
    if dt == _BF16:
        dx, red = _launch_bwd_bf16(x, wt, bhn, wpT, hs, gates, dhs, reverse, need_dx)
        return (dx,) + _unpack_red(red, in_dim, h)
    plan = _cached_bwd_plan(t_len, b, in_dim, h, bool(need_dx), _build.num_sms(dev),
                            x.data_ptr() % 16 == 0 and hs.data_ptr() % 16 == 0)
    f32 = dict(dtype=torch.float32, device=dev)
    dg = torch.empty(rows, 4 * h, **f32)
    partial = torch.empty(plan[2], **f32)
    n_wp = in_dim * 3 * h
    red = torch.empty(n_wp + (h + 1) * 4 * h, **f32)
    dx = torch.empty(t_len, b, in_dim, **f32) if need_dx else None
    scratch = torch.empty(plan[3], **f32) if plan[3] else None
    err = _build.load_library().mmtr_gru_dir_bwd(
        x.data_ptr(), hs.data_ptr(), gates.data_ptr(), dhs.data_ptr(), wt.data_ptr(),
        bhn.data_ptr(), wpT.data_ptr() if need_dx else 0, dg.data_ptr(), partial.data_ptr(),
        red.data_ptr(), dx.data_ptr() if need_dx else 0,
        scratch.data_ptr() if scratch is not None else 0, t_len, b, in_dim, h, int(reverse),
        int(need_dx), plan[1], _build.stream_ptr(dev))
    _build.check(err, "gru_dir_bwd kernel")
    gru_dir_bwd.launches += 1
    gru_dir_bwd.launches_no_dx += int(not need_dx)
    return (dx,) + _unpack_red(red, in_dim, h)


def _unpack_red(red, in_dim: int, h: int) -> tuple:
    """The reductions' sums -> (dwp, dwt, dbc, dbhn): dwp's column blocks
    (n, r, z) -> (r, z, n); dwt's rows 0..H-1, blocks r, z, dghn; its row
    H: the column sums (n, r, z, dghn)."""
    n_wp = in_dim * 3 * h
    dwp = red[:n_wp].view(in_dim, 3, h).roll(-1, 1).permute(1, 0, 2).contiguous()
    blk = red[n_wp:].view(h + 1, 4, h)
    dwt = blk[:h, 1:].permute(1, 0, 2).contiguous()
    return dwp, dwt, blk[h, :3].roll(-1, 0), blk[h, 3].contiguous()


gru_dir_bwd.launches = 0
gru_dir_bwd.launches_no_dx = 0
gru_dir_bwd.launches_bf16 = 0


class GruDir(torch.autograd.Function):
    """One GRU direction whose forward is K1 and whose backward is K1b.
    ``need_dx=False`` declares x's gradient dead: the backward skips the dx
    product and returns None for it."""

    @staticmethod
    def forward(ctx, x, wp, wt, bc, bhn, reverse: bool, need_dx: bool):
        if x.device.type == "cpu":
            hs, gates = gru_dir_plain(x, wp, wt, bc, bhn, reverse), None
        else:
            hs, gates = _launch_fwd(x, wp, wt, bc, bhn, reverse)
        ctx.reverse, ctx.need_dx, ctx.gates = reverse, need_dx, gates
        ctx.save_for_backward(x, wp, wt, bc, bhn, hs)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        x, wp, wt, bc, bhn, hs = ctx.saved_tensors
        grads = gru_dir_bwd(x, wp, wt, bc, bhn, hs, ctx.gates, dhs, ctx.reverse,
                            ctx.need_dx)
        return (*grads, None, None)


def gru_dir_train(x: torch.Tensor, p: dict, reverse: bool = False,
                  need_dx: bool = True) -> torch.Tensor:
    """One direction from torch-layout weights ``p``, differentiable through
    K1 / K1b.  ``need_dx=False`` under an ``x`` that requires grad raises:
    its gradient would otherwise be silently missing."""
    if not need_dx and x.requires_grad:
        raise ValueError("need_dx=False, but x requires grad: its gradient "
                         "would be dropped")
    ops = dir_operands(p)
    return GruDir.apply(x, ops["wp"], ops["wt"], ops["bc"], ops["bhn"], reverse, need_dx)


def bigru_level_tmajor(params: dict, x_t: torch.Tensor,
                       need_dx: bool = True) -> torch.Tensor:
    """One bidirectional level: ``x_t [T, B, in]`` -> ``[T, B, 2H]``
    (fwd || bwd, storage time order).  ``params`` holds ``fwd`` / ``bwd``
    torch-layout weight dicts; ``need_dx=False`` declares ``x_t``'s
    gradient dead (see :func:`gru_dir_train`)."""
    hs_f = gru_dir_train(x_t, params["fwd"], False, need_dx)
    hs_b = gru_dir_train(x_t, params["bwd"], True, need_dx)
    return torch.cat([hs_f, hs_b], dim=-1)


def bigru_finals_tmajor(hs: torch.Tensor) -> torch.Tensor:
    """[T, B, 2H] -> torch's ``cat((h[0], h[1]), dim=1)`` final hidden
    [B, 2H]: forward after t=T-1, backward after t=0."""
    h = hs.shape[-1] // 2
    return torch.cat([hs[-1, :, :h], hs[0, :, h:]], dim=-1)
