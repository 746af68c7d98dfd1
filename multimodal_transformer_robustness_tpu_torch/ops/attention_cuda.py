"""K5 / K8: flash attention through hand-written CUDA kernels, forward and
backward, with the position-hash dropout.

Counterpart of ``multimodal_transformer_robustness_tpu/ops/attention_pallas.py``
and ``attention_pallas_bwd.py``.  Each wrapper launches ``csrc/flash_attn.cu``
on a CUDA tensor and runs its plain PyTorch version on a CPU tensor:

  * :func:`flash_fwd` (K5f): ``softmax(q k^T + future-mask rule) v`` and its
    log-sum-exp, replacing ``attention_pallas._flash_fwd_impl``, by the plan
    :func:`_plan_flash_fwd` (a persistent unit path at Tq, Tk <= 64, a
    tiled one beyond);
  * :func:`flash_bwd`: the backward from the saved log-sum-exp, replacing
    ``attention_pallas_bwd.flash_attention_bwd`` (its two pallas_calls and
    the XLA delta): K5b, one fused pass a (b*h) slice, where Tq and Tk are
    at most 64, else the delta op and :func:`flash_bwd_dq` (K5dq, by the
    plan :func:`_plan_flash_dq`) and :func:`flash_bwd_dkv` (K5dkv, by the
    plan :func:`_plan_flash_dkv`), which also stay entries of their own;
  * :func:`flash_attention_masked` (K8): the forward with a per-sample
    key-padding mask, replacing ``attention_pallas.flash_attention_masked``;
    forward only, as there.  It runs K6a's kernels (``csrc/bert_attn.cu``)
    under a hard key mask: the persistent unit kernel where Tq and Tk are
    at most 64, the tiled one beyond; either makes the all-zero-row rewrite
    itself, so a call is one launch.

:func:`flash_attention` joins K5f and :func:`flash_bwd` as an autograd function,
as the JAX package's custom VJP does, on the card and on the CPU.  q arrives
pre-scaled; the future-mask rule masks ``col - row >= offset`` (the
reference's ``offset = 1 + |Tk - Tq|``).  The in-softmax dropout keeps
weight ``(row, col)`` of slice ``b*h`` where :func:`hash_uniform`
``(seed[b*h], row, col) >= rate``: integer math, so it reproduces the JAX
package's draws bit for bit, and the forward and backward kernels
regenerate one mask without storing it.  The softmax
normalizer sums the raw weights; only the value product sees the dropped
and rescaled ones (torch drops after the softmax).

K5 takes bf16 q, k, v (and dout, out) as the JAX kernels do: its bf16
instances (``mmtr_flash_*_bf16``, counted in each wrapper's
``launches_bf16`` within ``launches``) and the plain versions upcast them,
compute in float32 (p stays float32 through the value product) and round
out, dq, dk and dv once to the operands' dtype; lse and delta stay float32,
and delta is summed in float32 from the stored (rounded) out.  K8 has no
bf16 instance yet.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from .. import _build
from . import bert_attn_cuda

NEG_INF = -1e30   # finite fill: a masked logit never makes a NaN
_MAX_HEAD_DIM = 128
_U32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c mod 2**32`` for int64 ``h`` in [0, 2**32), split into 16-bit
    halves of ``c`` so no product leaves int64's range."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _U32


def hash_uniform(seed, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Counter-based uniform in [0, 1): murmur3 fmix32 of ``seed ^ row *
    0x9E3779B1 ^ col * 0x85EBCA77`` with wrap-around 32-bit multiplies and
    logical shifts, then the top 24 bits times 2**-24.  ``seed`` is an
    int32 (a Python int or a tensor broadcasting against ``rows`` /
    ``cols``, the global positions); the result is float32, bit-equal to
    the JAX package's ``_hash_uniform`` and to the CUDA kernels' draws.
    Computed in int64 on the 32-bit patterns, where ``>>`` is logical."""
    seed = torch.as_tensor(seed, device=rows.device).to(torch.int64) & _U32
    h = (_mul32(rows.to(torch.int64) & _U32, 0x9E3779B1)
         ^ _mul32(cols.to(torch.int64) & _U32, 0x85EBCA77) ^ seed)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def dropout_uniform(seed, tq: int, tk: int, device=None) -> torch.Tensor:
    """The dense ``[tq, tk]`` field of one (batch*head) slice."""
    rows = torch.arange(tq, device=device)[:, None]
    cols = torch.arange(tk, device=device)[None, :]
    return hash_uniform(seed, rows, cols)


def _offset(tq: int, tk: int, causal: bool, offset: Optional[int]) -> int:
    if offset is None:
        offset = 1 + abs(tk - tq)
    if causal and offset < 1:
        raise ValueError(f"causal flash attention needs offset >= 1 (got {offset}); "
                         f"the reference's rule is offset = 1 + |Tk - Tq|")
    return int(offset)


def _keep_scale(seeds, rates, b, h, tq, tk, device) -> torch.Tensor:
    """``[B, H, Tq, Tk]`` inverted-dropout factors ``keep / (1 - rate)``."""
    rows = torch.arange(tq, device=device)[:, None]
    cols = torch.arange(tk, device=device)[None, :]
    u = hash_uniform(seeds.reshape(b, h, 1, 1), rows, cols)
    rate = rates.reshape(b, h, 1, 1).to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(u >= rate, 1.0 / (1.0 - rate), zero)


def _up(t: torch.Tensor) -> torch.Tensor:
    """An operand in its compute dtype: bf16 upcast to float32 (exact), any
    other dtype as it is."""
    return t.float() if t.dtype == torch.bfloat16 else t


def _hide(s: torch.Tensor, tq: int, tk: int, causal: bool, offset: int) -> torch.Tensor:
    """``s [.., Tq, Tk]`` with the pairs the future-mask rule hides set to
    the finite fill."""
    if not causal:
        return s
    rows = torch.arange(tq, device=s.device)[:, None]
    cols = torch.arange(tk, device=s.device)[None, :]
    return torch.where(cols - rows < offset, s, torch.full((), NEG_INF, device=s.device))


def flash_attention_plain(q, k, v, causal: bool = True, offset: Optional[int] = None,
                          dropout_seeds=None, dropout_rates=None):
    """Plain PyTorch version of K5f: dense logits with the same causal rule,
    finite fill, normalizer floor and hash field -> ``(out [B, H, Tq, D],
    lse [B*H, Tq])``.  bf16 operands are upcast and ``out`` is rounded once
    to q's dtype; lse stays float32.  Differentiable by autograd
    (:func:`flash_attention_bwd_plain` takes the float32 gradient oracle
    that way)."""
    b, h, tq, _ = q.shape
    tk = k.shape[2]
    offset = _offset(tq, tk, causal, offset)
    s = _hide(torch.einsum("bhqd,bhkd->bhqk", _up(q), _up(k)), tq, tk, causal, offset)
    m = s.amax(-1, keepdim=True).detach()     # the output does not depend on it
    p = torch.exp(s - m)
    l_safe = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    lse = (m + torch.log(l_safe)).reshape(b * h, tq)
    if dropout_seeds is not None:
        p = p * _keep_scale(dropout_seeds, dropout_rates, b, h, tq, tk, q.device)
    return (torch.einsum("bhqk,bhkd->bhqd", p, _up(v)) / l_safe).to(q.dtype), lse


def _delta(dout: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``rowsum(dout * out)`` ``[B*H, Tq]``, multiplied and summed in float32
    at bf16 (the JAX package's ``do.astype(f32) * out.astype(f32)``)."""
    b, h, tq, _ = out.shape
    return (_up(dout) * _up(out)).sum(-1).reshape(b * h, tq)


def flash_bwd_plain(q, k, v, dout, lse, delta, causal: bool = True,
                    offset: Optional[int] = None, dropout_seeds=None, dropout_rates=None):
    """Plain PyTorch version of K5dq and K5dkv (and of K5b, given delta from
    its out) -> ``(dq, dk, dv)``: the JAX kernels' formulas from the saved
    ``lse`` and ``delta [B*H, Tq]``: p = exp(s - lse) (0 where the rule
    hides the pair), dP = (dO V^T) M, dS = p (dP - delta), dq = dS K, dk =
    dS^T Q, dv = (M p)^T dO; float32 throughout at bf16 operands, each
    gradient rounded once to its operand's dtype."""
    b, h, tq, _ = q.shape
    tk = k.shape[2]
    offset = _offset(tq, tk, causal, offset)
    qf, kf, vf, gf = (_up(t) for t in (q, k, v, dout))
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) - lse.reshape(b, h, tq, 1).to(qf.dtype)
    p = torch.exp(_hide(s, tq, tk, causal, offset))
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, vf)
    pm = p
    if dropout_seeds is not None:
        keep = _keep_scale(dropout_seeds, dropout_rates, b, h, tq, tk, q.device)
        dp, pm = dp * keep, p * keep
    ds = p * (dp - delta.reshape(b, h, tq, 1).to(qf.dtype))
    return (torch.einsum("bhqk,bhkd->bhqd", ds, kf).to(q.dtype),
            torch.einsum("bhqk,bhqd->bhkd", ds, qf).to(k.dtype),
            torch.einsum("bhqk,bhqd->bhkd", pm, gf).to(v.dtype))


def flash_attention_bwd_plain(q, k, v, dout, causal: bool = True,
                              offset: Optional[int] = None, dropout_seeds=None,
                              dropout_rates=None):
    """The backward's reference from the inputs alone -> ``(dq, dk, dv)``.
    float32 (and wider): ``torch.autograd.grad`` through
    :func:`flash_attention_plain`, an oracle independent of the kernels'
    formulas.  bf16: :func:`flash_bwd_plain` from the plain forward's out and
    lse, since autograd through the upcast forward would take delta from
    the unrounded output, which the JAX kernels do not."""
    if q.dtype == torch.bfloat16:
        out, lse = flash_attention_plain(q, k, v, causal, offset, dropout_seeds, dropout_rates)
        return flash_bwd_plain(q, k, v, dout, lse, _delta(dout, out), causal, offset,
                               dropout_seeds, dropout_rates)
    with torch.enable_grad():
        qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out, _ = flash_attention_plain(*qkv, causal, offset, dropout_seeds, dropout_rates)
        return torch.autograd.grad(out, qkv, dout)


def _storage(q: torch.Tensor) -> torch.dtype:
    """The dtype of the kernel instance a call takes: bf16 for bf16 q, else
    float32 (another dtype then fails the operands' check)."""
    return torch.bfloat16 if q.dtype == torch.bfloat16 else torch.float32


def _check_qkv(q, k, v, dev):
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if d > _MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d}: the kernels take head_dim <= {_MAX_HEAD_DIM}")
    dt = _storage(q)
    _build.require(q, "q", (b, h, tq, d), dev, dt)
    _build.require(k, "k", (b, h, tk, d), dev, dt)
    _build.require(v, "v", (b, h, tk, d), dev, dt)
    return b, h, tq, tk, d


def _launch(entry: str, bf16: bool, what: str, *args) -> None:
    """Call the library entry ``entry`` (its ``_bf16`` instance where
    ``bf16``) and raise on the launch's error."""
    lib = _build.load_library()
    err = getattr(lib, entry + "_bf16" if bf16 else entry)(*args)
    _build.check(err, what + (" (bf16)" if bf16 else ""))


def _check_dropout(seeds, rates, bh, dev):
    """-> (seeds pointer, rates pointer, use_dropout)."""
    if seeds is None:
        return 0, 0, 0
    _build.require(seeds, "dropout_seeds", (bh,), dev, torch.int32)
    _build.require(rates, "dropout_rates", (bh,), dev)
    return seeds.data_ptr(), rates.data_ptr(), 1


def _flash_widths(D: int):
    """``(dt, ld)`` of a head width: ``dt`` 8-column tiles over D, rounded
    up to a power of two (a kernel instance each, its loops over the k steps
    of the score products and the column tiles of the value products fixed
    at compile time; the staged columns past D are zero) and ``ld = 8 dt +
    4``, a staged row's stride (4 mod 8 floats: the fragment loads are free
    of bank conflicts)."""
    if not 1 <= D <= _MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D}: the kernels take 1 <= head_dim <= {_MAX_HEAD_DIM}")
    dt = 1 << (-(-D // 8) - 1).bit_length()
    return dt, 8 * dt + 4


_KTILE = 64     # keys (K5f's tiled path) or queries (K5dkv) a ring stage holds
_KSTAGES = 2    # the ring's stages (csrc/flash_attn.cu's FK_STAGES)


def _fwd_tiled_smem(ld: int, bq: int) -> int:
    """K5f path 1's carve-up, bytes: the ring of 64-key k and v tiles, then
    the q rows' hi and lo planes."""
    return 4 * ld * (_KSTAGES * 2 * _KTILE + 2 * bq)


def _plan_flash_fwd(BH: int, Tq: int, Tk: int, D: int,
                    num_sms: int = _build.NUM_SMS) -> dict:
    """K5f's launch plan.  Path 0 (Tq, Tk <= 64, every MOSEI flash stack): a
    persistent grid of 4-warp blocks, at most ``_build.FU_BLOCKS_PER_SM`` an
    SM (the kernel's launch bound; fewer where shared memory holds fewer),
    each walking (b*h) slices with the next one in flight into the second of
    two shared-memory slots.  A slot holds q ``[qp][ld]`` (``qp`` 64: 16
    rows for each warp, zero past Tq), k and v ``[kp][ld]`` (``kp`` 32
    where Tk <= 32, else 64: the kernel instance's key tiles, which every
    warp multiplies whole) and the slice's seed and rate.  Path 1 (longer):
    a block per (slice, ``bq`` query rows, a warp each 16), 64-key tiles of
    k and v in a 2-stage ring, q split into TF32 hi / lo once, into two
    shared-memory planes.  ``bq`` is 128 where that fits shared memory (D
    <= 64), else 64: on the H100 at B=16 T=2048 D=25, 128 rows beat 64
    (PERF.md, tools/k5_trials.py)."""
    dt, ld = _flash_widths(D)
    if min(BH, Tq, Tk) < 1:
        raise ValueError(f"Tq {Tq}, Tk {Tk}, B*H {BH}: the kernels take nonempty slices")
    if Tq <= 64 and Tk <= 64:
        qp, kp = 64, 32 if Tk <= 32 else 64
        smem = 8 * (ld * (qp + 2 * kp) + 4)
        per_sm = min(_build.FU_BLOCKS_PER_SM, _build.SM_SMEM // (smem + 1024))
        return {"path": 0, "blocks": min(BH, per_sm * num_sms), "threads": 128, "smem": smem,
                "dt": dt, "ld": ld, "qp": qp, "kp": kp, "bq": 0}
    bq = 128 if _fwd_tiled_smem(ld, 128) <= _build.MAX_SMEM else 64
    return {"path": 1, "blocks": -(-Tq // bq) * BH, "threads": 2 * bq,
            "smem": _fwd_tiled_smem(ld, bq), "dt": dt, "ld": ld, "qp": 0, "kp": 0, "bq": bq}


_FF_PLAN_KEYS = ("path", "blocks", "threads", "smem", "dt", "ld", "qp", "kp", "bq")


@functools.lru_cache(maxsize=None)
def _cached_fwd_plan(BH, Tq, Tk, D, num_sms):
    """K5f's plan as csrc/flash_attn.cu reads it: (C int array, its address)."""
    p = _plan_flash_fwd(BH, Tq, Tk, D, num_sms)
    return _build.host_ints([p[k] for k in _FF_PLAN_KEYS])


def flash_fwd(q, k, v, seeds=None, rates=None, causal: bool = True,
              offset: Optional[int] = None):
    """K5f: ``q [B, H, Tq, D]`` (pre-scaled), ``k``, ``v [B, H, Tk, D]``,
    optional ``seeds [B*H]`` int32 and ``rates [B*H]`` -> ``(out, lse [B*H,
    Tq])``, out in q's dtype (float32 or bf16), lse float32.  CPU tensors
    take :func:`flash_attention_plain`; CUDA tensors launch the kernel (its
    bf16 instance for bf16 operands) by :func:`_plan_flash_fwd` (or raise):
    at Tq, Tk <= 64 the persistent unit path, a warp's 16 query rows
    against the whole slice in one pass; longer, the tiled path with the
    online softmax over 64-key tiles.  Both run their products in 3xTF32 on
    the tensor cores."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, offset, seeds, rates)
    dev = _build.device_of(q)
    b, h, tq, tk, d = _check_qkv(q, k, v, dev)
    offset = _offset(tq, tk, causal, offset)
    p_seeds, p_rates, use_dropout = _check_dropout(seeds, rates, b * h, dev)
    plan = _cached_fwd_plan(b * h, tq, tk, d, _build.num_sms(dev))
    out = torch.empty_like(q)
    lse = torch.empty(b * h, tq, dtype=torch.float32, device=dev)
    bf = q.dtype == torch.bfloat16
    _launch("mmtr_flash_fwd", bf, "flash attention forward kernel",
            q.data_ptr(), k.data_ptr(), v.data_ptr(), p_seeds, p_rates, out.data_ptr(),
            lse.data_ptr(), b * h, tq, tk, d, int(causal), offset, use_dropout, plan[1],
            _build.stream_ptr(dev))
    flash_fwd.launches += 1
    flash_fwd.launches_bf16 += bf
    return out, lse


flash_fwd.launches = 0
flash_fwd.launches_bf16 = 0


def _bwd_operands(q, k, v, dout, lse, delta, seeds, rates, causal, offset):
    """-> (device, pointers, ints) of a K5dq / K5dkv call: q, k, v and dout
    of one kernel dtype (float32 or bf16), lse and delta float32."""
    dev = _build.device_of(q)
    b, h, tq, tk, d = _check_qkv(q, k, v, dev)
    _build.require(dout, "dout", (b, h, tq, d), dev, _storage(q))
    _build.require(lse, "lse", (b * h, tq), dev)
    _build.require(delta, "delta", (b * h, tq), dev)
    p_seeds, p_rates, use_dropout = _check_dropout(seeds, rates, b * h, dev)
    return dev, (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), p_seeds, p_rates), \
        (b * h, tq, tk, d, int(causal), _offset(tq, tk, causal, offset), use_dropout)


_DQ_STAGES = 2   # K5dq's key ring (csrc/flash_attn.cu's DQ_STAGES), fewer where Tk is short


def _dq_smem(ld: int, bq: int, stages: int) -> int:
    """K5dq's carve-up, bytes: the ring of 64-key k and v tiles, then the
    hi and lo planes of the q rows and of the dO rows."""
    return 4 * ld * (stages * 2 * _KTILE + 4 * bq)


def _plan_flash_dq(BH: int, Tq: int, Tk: int, D: int) -> dict:
    """K5dq's launch plan: a block per (slice, ``bq`` query rows), a warp
    each 16, the heaviest query tile first under the causal rule; 64-key
    tiles of k and v in a ring of ``stages`` stages (2, or 1 where Tk <=
    64); q and dO split into TF32 hi / lo once, into four shared-memory
    planes.  ``bq`` is the largest of 64, 32 and 16 whose carve-up fits
    shared memory (64, but 32 at D > 64 where Tk > 64) and that is no
    larger than Tq rounded up to a power of two: at Tq <= 16 a block is one
    warp, and no warp computes on rows that are all past Tq.  The kernel's
    launch bound holds 3 blocks of 128 threads an SM at D <= 32 (170
    registers): on the H100 at B=16 T=2048 D=25, 64 rows a block beat 128
    (2 blocks of 256 threads, 128 registers, spilling; PERF.md,
    tools/k5_trials.py)."""
    dt, ld = _flash_widths(D)
    if min(BH, Tq, Tk) < 1:
        raise ValueError(f"Tq {Tq}, Tk {Tk}, B*H {BH}: the kernels take nonempty slices")
    stages = min(_DQ_STAGES, -(-Tk // _KTILE))
    rows = 1 << max(4, (Tq - 1).bit_length())
    bq = next(b for b in (64, 32, 16)
              if b <= rows and _dq_smem(ld, b, stages) <= _build.MAX_SMEM)
    return {"blocks": -(-Tq // bq) * BH, "threads": 2 * bq, "smem": _dq_smem(ld, bq, stages),
            "dt": dt, "ld": ld, "bq": bq, "stages": stages}


_FQ_PLAN_KEYS = ("blocks", "threads", "smem", "dt", "ld", "bq", "stages")


@functools.lru_cache(maxsize=None)
def _cached_dq_plan(BH, Tq, Tk, D):
    """K5dq's plan as csrc/flash_attn.cu reads it: (C int array, its address)."""
    p = _plan_flash_dq(BH, Tq, Tk, D)
    return _build.host_ints([p[k] for k in _FQ_PLAN_KEYS])


def flash_bwd_dq(q, k, v, dout, lse, delta, seeds=None, rates=None, causal: bool = True,
                 offset: Optional[int] = None) -> torch.Tensor:
    """K5dq: dq from the forward's inputs, ``dout``, ``lse`` and ``delta =
    rowsum(dout * out)`` ``[B*H, Tq]`` (both float32), in q's dtype.  CPU
    tensors take :func:`flash_bwd_plain` on the given lse and delta.  On
    the card one launch (the bf16 instance for bf16 operands) by
    :func:`_plan_flash_dq`: a block of query rows walks the key tiles they
    see, S = Q K^T and dP' = dO V^T, p and dS = p (M dP' - delta) in
    registers, then dQ += dS K, all in 3xTF32 on the tensor cores, dQ
    written once (a rerun gives the same bits)."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, dout, lse, delta, causal, offset, seeds, rates)[0]
    dev, ptrs, ints = _bwd_operands(q, k, v, dout, lse, delta, seeds, rates, causal, offset)
    plan = _cached_dq_plan(*ints[:4])
    dq = torch.empty_like(q)
    bf = q.dtype == torch.bfloat16
    _launch("mmtr_flash_bwd_dq", bf, "flash attention dq kernel", *ptrs, dq.data_ptr(), *ints,
            plan[1], _build.stream_ptr(dev))
    flash_bwd_dq.launches += 1
    flash_bwd_dq.launches_bf16 += bf
    return dq


flash_bwd_dq.launches = 0
flash_bwd_dq.launches_bf16 = 0


def _plan_flash_dkv(BH: int, Tq: int, Tk: int, D: int) -> dict:
    """K5dkv's launch plan: a block per (slice, 64 keys), 4 warps of 16 keys,
    the key tiles in order (the first, which the most queries see under the
    causal rule, first); 64-query tiles of q and dO ``[64][ld]``, lse and
    delta ``[64]`` in a 2-stage ring behind the block's k and v rows
    ``[64][ld]``."""
    dt, ld = _flash_widths(D)
    if min(BH, Tq, Tk) < 1:
        raise ValueError(f"Tq {Tq}, Tk {Tk}, B*H {BH}: the kernels take nonempty slices")
    return {"blocks": -(-Tk // _KTILE) * BH, "threads": 128, "smem": _dkv_smem(ld), "dt": dt,
            "ld": ld}


def _dkv_smem(ld: int) -> int:
    """K5dkv's carve-up, bytes: k and v ``[64][ld]``, then the ring."""
    return 4 * (2 * _KTILE * ld + _KSTAGES * (2 * _KTILE * ld + 2 * _KTILE))


_FD_PLAN_KEYS = ("blocks", "threads", "smem", "dt", "ld")


@functools.lru_cache(maxsize=None)
def _cached_dkv_plan(BH, Tq, Tk, D):
    """K5dkv's plan as csrc/flash_attn.cu reads it: (C int array, its address)."""
    p = _plan_flash_dkv(BH, Tq, Tk, D)
    return _build.host_ints([p[k] for k in _FD_PLAN_KEYS])


def flash_bwd_dkv(q, k, v, dout, lse, delta, seeds=None, rates=None, causal: bool = True,
                  offset: Optional[int] = None):
    """K5dkv: ``(dk, dv)``, operands as :func:`flash_bwd_dq`.  On the card
    one launch by :func:`_plan_flash_dkv`: a block per 64 keys walks the
    query tiles that see them, S^T = K Q^T and dP'^T = V dO^T, then dV +=
    (M p)^T dO and dK += dS^T Q, all in 3xTF32 on the tensor cores, each
    output written once (a rerun gives the same bits)."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, dout, lse, delta, causal, offset, seeds, rates)[1:]
    dev, ptrs, ints = _bwd_operands(q, k, v, dout, lse, delta, seeds, rates, causal, offset)
    plan = _cached_dkv_plan(*ints[:4])
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    bf = q.dtype == torch.bfloat16
    _launch("mmtr_flash_bwd_dkv", bf, "flash attention dk/dv kernel", *ptrs, dk.data_ptr(),
            dv.data_ptr(), *ints, plan[1], _build.stream_ptr(dev))
    flash_bwd_dkv.launches += 1
    flash_bwd_dkv.launches_bf16 += bf
    return dk, dv


flash_bwd_dkv.launches = 0
flash_bwd_dkv.launches_bf16 = 0


def _plan_flash_bwd(BH: int, Tq: int, Tk: int, D: int,
                    num_sms: int = _build.NUM_SMS) -> dict:
    """The flash backward's launch plan.  Path 0 (Tq, Tk <= 64, every MOSEI
    flash stack): one K5b launch, a persistent grid of at most
    ``_build.FB_BLOCKS_PER_SM`` blocks an SM (the kernel's launch bound;
    fewer where shared memory holds fewer), each block a (b*h) slice at a
    time, staged into one shared-memory slot by 4-byte copies.  Path 1
    (longer): the delta op, K5dq and K5dkv.

    The tensor-core tiles set the padding: ``dp4``: D rounded up to 8, in
    groups of 4 (k steps of the score products, 8-column tiles of the
    gradients); ``qp8`` / ``kp8``: Tq / Tk rounded up to 8 (staged rows);
    ``mq`` / ``mk``: 16-row tiles over the queries / keys; ``nk``: 8-key
    tiles; ``ld``: a staged row, 4 mod 8 words, and ``ldp``: a row of the
    M*p and dS tiles, 8 mod 32 words and at least 16 * mk (bank-conflict
    free fragment loads); ``ng1``: key tiles a phase-1 warp takes, 2, or 4
    where 2 would give more than the block's 8 warps."""
    if not 1 <= D <= _MAX_HEAD_DIM or min(BH, Tq, Tk) < 1:
        raise ValueError(f"head_dim {D}, Tq {Tq}, Tk {Tk}: the kernels take 1 <= head_dim "
                         f"<= {_MAX_HEAD_DIM} and nonempty slices")
    if Tq > 64 or Tk > 64:
        return {"path": 1}
    dp = _build.round_up(D, 8)
    ld = dp + 4
    qp8, kp8 = _build.round_up(Tq, 8), _build.round_up(Tk, 8)
    mq, mk, nk = -(-Tq // 16), -(-Tk // 16), kp8 // 8
    ldp = _build.round_up(max(kp8, 16 * mk) - 8, 32) + 8
    ng1 = 2 if mq * -(-nk // 2) <= 8 else 4
    # one slice's operands, then the M*p and dS tiles; at most 64 x 64 x 128
    # they come to 206,096 bytes, within MAX_SMEM
    smem = 4 * (ld * (3 * qp8 + 2 * kp8) + qp8 + 4 + (qp8 + 16 * mq) * ldp)
    per_sm = min(_build.FB_BLOCKS_PER_SM, _build.SM_SMEM // (smem + 1024))
    return {"path": 0, "blocks": min(BH, per_sm * num_sms), "smem": smem, "dp4": dp // 4,
            "ld": ld, "qp8": qp8, "kp8": kp8, "mq": mq, "mk": mk, "nk": nk, "ldp": ldp,
            "ng1": ng1}


_FB_PLAN_KEYS = ("path", "blocks", "smem", "dp4", "ld", "qp8", "kp8", "mq", "mk", "nk", "ldp",
                 "ng1")


@functools.lru_cache(maxsize=None)
def _cached_bwd_plan(BH, Tq, Tk, D, num_sms):
    """The plan as csrc/flash_attn.cu reads it: (C int array, its address),
    or None for path 1."""
    p = _plan_flash_bwd(BH, Tq, Tk, D, num_sms)
    return _build.host_ints([p[k] for k in _FB_PLAN_KEYS]) if p["path"] == 0 else None


def flash_bwd(q, k, v, dout, out, lse, seeds=None, rates=None, causal: bool = True,
              offset: Optional[int] = None):
    """The flash backward: ``(dq, dk, dv)`` in the operands' dtype from the
    forward's inputs, its output ``out`` and log-sum-exp ``lse [B*H, Tq]``
    (float32), and ``dout``.  CPU tensors take :func:`flash_bwd_plain` with
    delta = rowsum(dout * out) (float32).  On the card
    :func:`_plan_flash_bwd` picks by shape: Tq, Tk <= 64 launch K5b once
    (delta inside); longer slices take the delta op, K5dq and K5dkv (tensor
    cores, planned by :func:`_plan_flash_dq` and :func:`_plan_flash_dkv`);
    bf16 operands launch the bf16 instances.  A refused plan or launch
    raises."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, dout, lse, _delta(dout, out), causal, offset, seeds,
                               rates)
    dev = _build.device_of(q)
    b, h, tq, tk, d = _check_qkv(q, k, v, dev)
    offset = _offset(tq, tk, causal, offset)
    plan = _cached_bwd_plan(b * h, tq, tk, d, _build.num_sms(dev))
    if plan is None:
        args = (q, k, v, dout, lse, _delta(dout, out), seeds, rates, causal, offset)
        return (flash_bwd_dq(*args),) + flash_bwd_dkv(*args)
    _build.require_all(dev, [(dout, "dout", (b, h, tq, d)), (out, "out", (b, h, tq, d))],
                       _storage(q))
    _build.require(lse, "lse", (b * h, tq), dev)
    p_seeds, p_rates, use_dropout = _check_dropout(seeds, rates, b * h, dev)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    bf = q.dtype == torch.bfloat16
    _launch("mmtr_flash_bwd", bf, "flash attention fused backward kernel",
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), out.data_ptr(),
            lse.data_ptr(), p_seeds, p_rates, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b * h, tq, tk, d, int(causal), offset, use_dropout, plan[1],
            _build.stream_ptr(dev))
    flash_bwd.launches += 1
    flash_bwd.launches_bf16 += bf
    return dq, dk, dv


flash_bwd.launches = 0
flash_bwd.launches_bf16 = 0


class FlashAttention(torch.autograd.Function):
    """Forward K5f; backward :func:`flash_bwd` (K5b at Tq, Tk <= 64, else
    the delta op, K5dq and K5dkv; on the CPU their plain versions), the
    gradients in the operands' dtype.  No gradient reaches the seeds or the
    rates."""

    @staticmethod
    def forward(ctx, q, k, v, seeds, rates, causal: bool, offset: int):
        out, lse = flash_fwd(q, k, v, seeds, rates, causal, offset)
        ctx.causal, ctx.offset = causal, offset
        ctx.save_for_backward(q, k, v, seeds, rates, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, seeds, rates, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, dout.contiguous(), out, lse, seeds, rates, ctx.causal,
                               ctx.offset)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, offset: Optional[int] = None,
                    dropout_seeds: Optional[torch.Tensor] = None,
                    dropout_rates: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable fused attention over ``q [B, H, Tq, D]`` (pre-scaled),
    ``k``, ``v [B, H, Tk, D]`` -> ``[B, H, Tq, D]``.  ``offset`` defaults to
    the reference's ``1 + |Tk - Tq|``; pass ``dropout_seeds [B*H]`` int32 and
    ``dropout_rates [B*H]`` for the in-softmax dropout.  float32 or bf16
    operands (the result and the gradients in their dtype).  CUDA tensors
    run K5f and :func:`flash_bwd`; CPU tensors their plain versions, the
    backward by the same formulas (the JAX package's custom VJP), not by
    autograd through the forward."""
    offset = _offset(q.shape[2], k.shape[2], causal, offset)
    return FlashAttention.apply(q, k, v, dropout_seeds, dropout_rates, causal, offset)


def _effective_key_mask(key_mask: torch.Tensor) -> torch.Tensor:
    """int32 ``[B, Tk]``; an all-zero row (a uniform -10000 bias, which the
    softmax cancels) becomes all ones.  The plain version's composition; the
    kernels make the same rewrite from the mask row they read."""
    km = key_mask.to(torch.int32)
    return torch.where((km > 0).any(dim=1, keepdim=True), km, torch.ones_like(km))


def flash_attention_masked_plain(q, k, v, key_mask) -> torch.Tensor:
    """Plain PyTorch version of K8: dense logits, masked key columns filled
    with the finite -1e30, the all-zero-row rewrite, the normalizer floor.
    bf16 operands are upcast, p stays float32 through P V, and the output
    is rounded once to q's dtype (the JAX kernel at bf16; not K6a's bf16
    rule, which rounds p)."""
    km = _effective_key_mask(key_mask)
    s = torch.einsum("bhqd,bhkd->bhqk", _up(q), _up(k))
    s = torch.where(km[:, None, None, :] > 0, s, torch.full((), NEG_INF, device=q.device))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l_safe = torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    return (torch.einsum("bhqk,bhkd->bhqd", p, _up(v)) / l_safe).to(q.dtype)


def split_bf16_3(p: torch.Tensor):
    """float32 ``p`` as K8.bf16's unit walk splits it before P V on the bf16
    tensor cores: ``(hi, mid, lo)``, hi = bf16(p), mid = bf16(p - hi), lo =
    bf16(p - hi - mid), each difference exact in float32.  hi + mid + lo is
    p exactly for |p| >= 2^-110; below, where lo's last bits fall under
    bf16's smallest subnormal, within 2^-134 of it."""
    hi = p.to(torch.bfloat16)
    r = p - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def flash_attention_masked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           key_mask: torch.Tensor) -> torch.Tensor:
    """Attention with HF key-padding semantics (``key_mask [B, Tk]``, 1 =
    attend, shared by a sample's heads) over pre-scaled ``q [B, H, Tq, D]``,
    ``k``, ``v [B, H, Tk, D]``; no causal rule, no dropout.  Forward only,
    as in the JAX package: on the card an input that requires grad raises
    rather than losing its gradient.  CPU tensors take the plain version.
    On the card one launch (a mask that is not int32 on the card is
    converted first), planned by ``bert_attn_cuda._plan_attention`` with
    ``Lk=Tk``: the unit path at Tq, Tk <= 64, else the tiled path.  float32
    or bf16 operands.  bf16 at Tq, Tk <= 64 with D a multiple of 8 up to 64
    and 16-byte aligned q, k, v takes the bf16 unit walk
    (``bert_attn_cuda._plan_attention_masked_bf16``: S and P V on the bf16
    tensor cores, p float32 as three bf16 terms); other bf16 shapes the
    float32 kernels' arithmetic on the upcast rows by the float32 plan.
    Either way the output is rounded once."""
    if q.device.type == "cpu":
        return flash_attention_masked_plain(q, k, v, key_mask)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise ValueError("flash_attention_masked has no backward; its inputs must "
                         "not require grad")
    dev = _build.device_of(q)
    b, h, tq, tk, d = _check_qkv(q, k, v, dev)
    km = key_mask.to(device=dev, dtype=torch.int32).contiguous()
    _build.require(km, "key_mask", (b, tk), dev, torch.int32)
    qp, kp, vp = q.data_ptr(), k.data_ptr(), v.data_ptr()
    aligned, sms = (qp | kp | vp) % 16 == 0, _build.num_sms(dev)
    out = torch.empty_like(q)
    bf = q.dtype == torch.bfloat16
    walk = bert_attn_cuda._cached_plan_masked_bf16(b, tq, tk, h, d, aligned, sms) if bf else None
    if walk is not None:
        err = _build.load_library().mmtr_attention_masked_walk_bf16(
            qp, kp, vp, km.data_ptr(), out.data_ptr(), b, h, tq, tk, d, walk[1],
            _build.stream_ptr(dev))
        _build.check(err, "flash attention masked kernel (bf16 unit walk)")
    else:
        plan = bert_attn_cuda._cached_plan(b, tq, h, d, sms, aligned, tk)
        _launch("mmtr_attention_masked_fwd", bf, "flash attention masked kernel", qp, kp, vp,
                km.data_ptr(), out.data_ptr(), b, h, tq, tk, d, plan[1],
                _build.stream_ptr(dev))
    flash_attention_masked.launches += 1
    flash_attention_masked.launches_bf16 += bf
    return out


flash_attention_masked.launches = 0
flash_attention_masked.launches_bf16 = 0
