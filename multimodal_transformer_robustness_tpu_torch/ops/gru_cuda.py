"""K7f / K7b: the whole-sequence GRU recurrence over pre-projected gates,
through hand-written CUDA kernels, forward and backward.

Counterpart of ``multimodal_transformer_robustness_tpu/ops/gru_pallas.py``.
The contract is the TPU kernel's: per-gate input projections ``gi_r, gi_z,
gi_n [G, T, N, H]`` (already ``x W_ix^T + b_ix``), transposed recurrent
weights ``wr, wz, wn [G, H, H]`` (``W_hx^T``, so ``gh_x = h @ w_x + b_x``)
and recurrent biases ``br, bz, bn [G, H]``; ``h0 = 0``; the hidden states
``hs [G, T, N, H]``.  ``G`` runs independent recurrences, each with its own
weights (the two directions of a bidirectional GRU).

:func:`gru_recurrence_cuda` launches ``csrc/gru_recurrence.cu``'s forward
(replacing ``gru_pallas._recurrence_fwd_impl``) on a CUDA tensor and runs
:func:`gru_recurrence_plain` on a CPU tensor.  The forward runs K1f's
recurrence (``csrc/gru_rec.cuh``) with a group axis; its launch plan is
``bigru_cuda._plan_recurrence`` over G groups of N rows.
:func:`gru_recurrence_bwd_cuda` is its backward (replacing
``gru_pallas._recurrence_bwd_impl``): newest step first, r / z / n
recomputed from ``h_{t-1}``, it gives the gate gradients ``da_r, da_z,
da_n`` and ``dghn = da_n * r``.  It runs K1b's backward recurrence
(``csrc/gru_rec.cuh``) with a group axis, or at few rows a block a row,
by the plan :func:`_plan_gru_rec_bwd`.  :class:`GruRecurrence` joins
the two as ``gru_recurrence_pallas``'s custom VJP does, and reduces the
weight and bias gradients outside the kernel with ``torch.einsum`` / ``sum``,
as the JAX package leaves them to XLA.

bf16 operands (every one of the nine; the bf16 instances
``mmtr_gru_rec_fwd_bf16`` / ``_bwd_bf16``, by the float32 plans) compute
what the TPU kernels compute at bf16: the forward carries h in float32 and
multiplies it unrounded by the upcast weights (``jnp.dot`` of a float32 h
and a bf16 w), rounding h only where it stores hs; the backward recomputes
from the rounded hs, carries dh and the carry's da in float32 and rounds
da_r, da_z, da_n and dghn where it stores them; the weight and bias
gradients sum the bf16 values in float32 and are rounded once.
"""

from __future__ import annotations

import functools

import torch

from .. import _build
from .bigru_cuda import REC_BWD_PLAN_KEYS, REC_PLAN_KEYS, _plan_rec_bwd, _plan_recurrence


def _hidden_gates(h, wr, wz, wn, br, bz, bn):
    return (torch.matmul(h, wr) + br[:, None], torch.matmul(h, wz) + bz[:, None],
            torch.matmul(h, wn) + bn[:, None])


def _f32(*tensors):
    """The operands in float32 (bf16 upcast, exactly; float32 as they are)."""
    return [t.float() for t in tensors]


def gru_recurrence_plain(gi_r, gi_z, gi_n, wr, wz, wn, br, bz, bn) -> torch.Tensor:
    """Plain PyTorch version of K7f: the time loop -> ``hs [G, T, N, H]``.
    At bf16 the operands are upcast, h is carried (and multiplied) in
    float32, and each stored step is rounded to bf16."""
    dtype = gi_r.dtype
    gi_r, gi_z, gi_n, wr, wz, wn, br, bz, bn = _f32(gi_r, gi_z, gi_n, wr, wz, wn, br, bz, bn)
    g, t_len, n, h_dim = gi_r.shape
    h = gi_r.new_zeros(g, n, h_dim)
    out = []
    for t in range(t_len):
        gh_r, gh_z, gh_n = _hidden_gates(h, wr, wz, wn, br, bz, bn)
        r = torch.sigmoid(gi_r[:, t] + gh_r)
        z = torch.sigmoid(gi_z[:, t] + gh_z)
        nn = torch.tanh(gi_n[:, t] + r * gh_n)
        h = (1.0 - z) * nn + z * h
        out.append(h.to(dtype))
    return torch.stack(out, dim=1)


def gru_recurrence_bwd_plain(gi_r, gi_z, gi_n, hs, dhs, wr, wz, wn, br, bz, bn):
    """Plain PyTorch version of K7b: the newest-first loop of the TPU
    kernel -> ``(da_r, da_z, da_n, dghn)``, each ``[G, T, N, H]``.  At bf16
    the operands are upcast (h_{t-1} the rounded stored hs), dh and the
    carry's da stay float32, and the four outputs are rounded as stored."""
    outs = [torch.empty_like(gi_r) for _ in range(4)]
    gi_r, gi_z, gi_n, hs, dhs, wr, wz, wn, br, bz, bn = _f32(
        gi_r, gi_z, gi_n, hs, dhs, wr, wz, wn, br, bz, bn)
    t_len = gi_r.shape[1]
    dh = torch.zeros_like(hs[:, 0])
    for t in range(t_len - 1, -1, -1):
        h_prev = hs[:, t - 1] if t > 0 else torch.zeros_like(dh)
        gh_r, gh_z, gh_n = _hidden_gates(h_prev, wr, wz, wn, br, bz, bn)
        r = torch.sigmoid(gi_r[:, t] + gh_r)
        z = torch.sigmoid(gi_z[:, t] + gh_z)
        nn = torch.tanh(gi_n[:, t] + r * gh_n)
        dht = dhs[:, t] + dh
        dz = dht * (h_prev - nn)
        da_n = dht * (1.0 - z) * (1.0 - nn * nn)
        dghn = da_n * r
        da_r = da_n * gh_n * r * (1.0 - r)
        da_z = dz * z * (1.0 - z)
        dh = (dht * z + torch.matmul(da_r, wr.transpose(1, 2))
              + torch.matmul(da_z, wz.transpose(1, 2)) + torch.matmul(dghn, wn.transpose(1, 2)))
        for o, v in zip(outs, (da_r, da_z, da_n, dghn)):
            o[:, t] = v
    return tuple(outs)


def _check_operands(gates, weights, biases, dev):
    """Shapes, and one dtype for all: float32, or bf16 for the bf16
    instances."""
    g, t_len, n, h = gates[0].shape
    dt = torch.bfloat16 if gates[0].dtype == torch.bfloat16 else torch.float32
    for name, a in zip(("gi_r", "gi_z", "gi_n", "hs", "dhs"), gates):
        _build.require(a, name, (g, t_len, n, h), dev, dt)
    for name, a in zip(("wr", "wz", "wn"), weights):
        _build.require(a, name, (g, h, h), dev, dt)
    for name, a in zip(("br", "bz", "bn"), biases):
        _build.require(a, name, (g, h), dev, dt)
    return g, t_len, n, h


@functools.lru_cache(maxsize=None)
def _cached_plan(G, N, H, num_sms, aligned):
    """K7f's plan as csrc/gru_recurrence.cu reads it: (C int array, its
    address)."""
    p = _plan_recurrence(G, N, H, num_sms, aligned)
    return _build.host_ints([p[k] for k in REC_PLAN_KEYS])


def gru_recurrence_cuda(gi_r, gi_z, gi_n, wr, wz, wn, br, bz, bn) -> torch.Tensor:
    """K7f: ``hs [G, T, N, H]``.  CPU tensors take :func:`gru_recurrence_plain`;
    CUDA tensors launch the kernel (or raise)."""
    if gi_r.device.type == "cpu":
        return gru_recurrence_plain(gi_r, gi_z, gi_n, wr, wz, wn, br, bz, bn)
    dev = _build.device_of(gi_r)
    g, t_len, n, h = _check_operands((gi_r, gi_z, gi_n), (wr, wz, wn), (br, bz, bn), dev)
    lib = _build.load_library()
    hs = torch.empty_like(gi_r)
    # 16-byte gate copies need the gate arrays 16-byte aligned (hs is fresh)
    aligned = (gi_r.data_ptr() | gi_z.data_ptr() | gi_n.data_ptr()) % 16 == 0
    plan = _cached_plan(g, n, h, _build.num_sms(dev), aligned)
    bf = gi_r.dtype == torch.bfloat16
    err = (lib.mmtr_gru_rec_fwd_bf16 if bf else lib.mmtr_gru_rec_fwd)(
        *(a.data_ptr() for a in (gi_r, gi_z, gi_n, wr, wz, wn, br, bz, bn, hs)),
        g, t_len, n, h, plan[1], _build.stream_ptr(dev))
    _build.check(err, "gru_recurrence forward kernel" + (" (bf16)" if bf else ""))
    gru_recurrence_cuda.launches += 1
    gru_recurrence_cuda.launches_bf16 += bf
    return hs


gru_recurrence_cuda.launches = 0
gru_recurrence_cuda.launches_bf16 = 0


# K7b's row form up to this many waves of one block an SM: at H=100 a row
# block's step took ~5 us, a tiled block's ~23-26 us however few its rows
# (one 25-thread warp at 4 rows), and the tiled form fits the rows left
# into one wave (tools/k7b_trials.py: 1.236 ms against 1.364 at G*N = 528,
# T=50)
_ROW_WAVES = 4


def _plan_gru_rec_bwd(G: int, N: int, H: int, num_sms: int = _build.NUM_SMS) -> dict:
    """K7b's launch plan (``csrc/gru_recurrence.cu`` takes it as given).
    While ``G * N <= _ROW_WAVES * num_sms``, ``row``: a block a (row, group)
    (``gru_rec_bwd_row_kernel``: the weights ``[3][H][H + 1]`` and biases,
    then h_{t-1}, dh, gh and da of the row in shared memory, a thread a gate
    column), as K7f keeps its small form.  Else K1b's tiled backward
    recurrence over ``G`` groups, :func:`bigru_cuda._plan_rec_bwd` (G=2
    N=4096 H=100: 32 rows, 256 blocks, two waves).  Raises where the weights
    do not fit a block's 227 KB."""
    if G * N > _ROW_WAVES * num_sms:
        return {"row": 0, **_plan_rec_bwd(G, N, H, num_sms)}
    smem = 4 * (3 * H * (H + 1) + 11 * H)
    if smem > _build.MAX_SMEM:
        raise ValueError(f"gru recurrence backward: H={H} needs {smem} bytes of shared "
                         f"memory, more than the card's {_build.MAX_SMEM}")
    return {"row": 1, "rows": 1, "threads": min(1024, max(64, _build.round_up(3 * H, 32))),
            "smem": smem, "js": 0, "wp": 0, "blocks": G * N}


@functools.lru_cache(maxsize=None)
def _cached_bwd_plan(G, N, H, num_sms):
    """K7b's plan as csrc/gru_recurrence.cu reads it: (C int array, its
    address)."""
    p = _plan_gru_rec_bwd(G, N, H, num_sms)
    return _build.host_ints([p[k] for k in ("row",) + REC_BWD_PLAN_KEYS])


def gru_recurrence_bwd_cuda(gi_r, gi_z, gi_n, hs, dhs, wr, wz, wn, br, bz, bn):
    """K7b: ``(da_r, da_z, da_n, dghn)``, each ``[G, T, N, H]``.  CPU tensors
    take :func:`gru_recurrence_bwd_plain`; CUDA tensors launch the kernel
    (or raise), which writes one ``dg [G, T, N, 4H]`` of rows (da_n, da_r,
    da_z, dghn): the four are strided views of it."""
    if gi_r.device.type == "cpu":
        return gru_recurrence_bwd_plain(gi_r, gi_z, gi_n, hs, dhs, wr, wz, wn, br, bz, bn)
    dev = _build.device_of(gi_r)
    g, t_len, n, h = _check_operands((gi_r, gi_z, gi_n, hs, dhs), (wr, wz, wn),
                                     (br, bz, bn), dev)
    plan = _cached_bwd_plan(g, n, h, _build.num_sms(dev))
    dg = torch.empty(g, t_len, n, 4, h, dtype=gi_r.dtype, device=dev)
    lib = _build.load_library()
    bf = gi_r.dtype == torch.bfloat16
    err = (lib.mmtr_gru_rec_bwd_bf16 if bf else lib.mmtr_gru_rec_bwd)(
        *(a.data_ptr() for a in (gi_r, gi_z, gi_n, hs, dhs, wr, wz, wn, br, bz, bn, dg)),
        g, t_len, n, h, plan[1], _build.stream_ptr(dev))
    _build.check(err, "gru_recurrence backward kernel" + (" (bf16)" if bf else ""))
    gru_recurrence_bwd_cuda.launches += 1
    gru_recurrence_bwd_cuda.launches_bf16 += bf
    da_n, da_r, da_z, dghn = dg.unbind(3)
    return da_r, da_z, da_n, dghn


gru_recurrence_bwd_cuda.launches = 0
gru_recurrence_bwd_cuda.launches_bf16 = 0


class GruRecurrence(torch.autograd.Function):
    """The recurrence whose forward is K7f and whose backward is K7b plus
    the weight and bias reductions, ``dW_x[g] = sum over t >= 1 of
    h_{t-1}^T da_x[t]`` (``dghn`` for the n gate) and ``db_x = sum da_x``."""

    @staticmethod
    def forward(ctx, gi_r, gi_z, gi_n, wr, wz, wn, br, bz, bn):
        hs = gru_recurrence_cuda(gi_r, gi_z, gi_n, wr, wz, wn, br, bz, bn)
        ctx.save_for_backward(gi_r, gi_z, gi_n, wr, wz, wn, br, bz, bn, hs)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        gi_r, gi_z, gi_n, wr, wz, wn, br, bz, bn, hs = ctx.saved_tensors
        da_r, da_z, da_n, dghn = gru_recurrence_bwd_cuda(
            gi_r, gi_z, gi_n, hs, dhs.contiguous(), wr, wz, wn, br, bz, bn)
        return (da_r, da_z, da_n, *weight_grads(hs, da_r, da_z, dghn))


def weight_grads(hs, da_r, da_z, dghn):
    """``(dwr, dwz, dwn, dbr, dbz, dbn)`` from K7b's gate gradients: the
    reductions over t and n that the JAX package leaves to XLA.  Each weight
    gradient is one [H, N] x [N, H] product per (g, t), batched, then summed
    over t: a single product over all T*N rows into an [H, H] output (the
    einsum's form) fills only a few blocks of the card: on an H100 it took
    22.5 ms of the 45.7 ms fwd+bwd at the MOSEI header level
    (chip_smoke.py, phase gru-recurrence).  At bf16 the products and sums
    run on the upcast values in float32 (a bf16 product is exact there),
    rounded once to bf16, as the JAX VJP's float32 einsum and sums are."""
    hsl = hs[:, :-1].float().transpose(-1, -2)
    das = _f32(da_r, da_z, dghn)
    dws = [torch.matmul(hsl, d[:, 1:]).sum(dim=1) for d in das]
    return tuple(a.to(hs.dtype) for a in (*dws, *(d.sum(dim=(1, 2)) for d in das)))
