"""K1: one bidirectional GRU level, T-major, through a hand-written CUDA kernel.

Counterpart of ``multimodal_transformer_robustness_tpu/ops/bigru_pallas.py``
(forward only).  :func:`gru_dir` runs one direction: on a CUDA tensor it
launches ``csrc/bigru.cu`` (which replaces the TPU kernel
``bigru_pallas._fwd_impl``), on a CPU tensor it runs the plain version
:func:`gru_dir_plain`.  The kernel operands ``wp / wt / bc / bhn`` are
precomputed once from torch-layout weights by :func:`dir_operands`.

The zero-padded bucket steps are run like any other step, as on the TPU:
no packing, no length masking.
"""

from __future__ import annotations

import torch

from .. import _build


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
    bc = torch.stack([bi[0] + bh[0], bi[1] + bh[1], bi[2]]).contiguous()
    return {"wp": wp, "wt": wt, "bc": bc, "bhn": bh[2].contiguous()}


def gru_dir_plain(x: torch.Tensor, wp: torch.Tensor, wt: torch.Tensor,
                  bc: torch.Tensor, bhn: torch.Tensor,
                  reverse: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel: x [T, B, in] -> h [T, B, H]."""
    t_len, b = x.shape[0], x.shape[1]
    h_dim = wt.shape[-1]
    g = torch.matmul(x.unsqueeze(0), wp.unsqueeze(1)) + bc[:, None, None, :]
    h = torch.zeros(b, h_dim, dtype=torch.float32, device=x.device)
    out = torch.empty(t_len, b, h_dim, dtype=torch.float32, device=x.device)
    steps = range(t_len - 1, -1, -1) if reverse else range(t_len)
    for t in steps:
        r = torch.sigmoid(g[0, t] + h @ wt[0])
        z = torch.sigmoid(g[1, t] + h @ wt[1])
        n = torch.tanh(g[2, t] + r * (h @ wt[2] + bhn))
        h = (1.0 - z) * n + z * h
        out[t] = h
    return out


def gru_dir(x: torch.Tensor, wp: torch.Tensor, wt: torch.Tensor,
            bc: torch.Tensor, bhn: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """One GRU direction over T-major ``x [T, B, in]`` -> ``[T, B, H]`` in
    storage time order.  CPU tensors take :func:`gru_dir_plain`; CUDA
    tensors launch the kernel (or raise)."""
    if x.device.type == "cpu":
        return gru_dir_plain(x, wp, wt, bc, bhn, reverse)
    dev = _build.device_of(x)
    t_len, b, in_dim = x.shape
    h_dim = wt.shape[-1]
    _build.require(x, "x", (t_len, b, in_dim), dev)
    _build.require(wp, "wp", (3, in_dim, h_dim), dev)
    _build.require(wt, "wt", (3, h_dim, h_dim), dev)
    _build.require(bc, "bc", (3, h_dim), dev)
    _build.require(bhn, "bhn", (h_dim,), dev)
    lib = _build.load_library()
    gates = torch.empty(3, t_len * b, h_dim, dtype=torch.float32, device=dev)
    out = torch.empty(t_len, b, h_dim, dtype=torch.float32, device=dev)
    err = lib.mmtr_gru_dir_fwd(
        x.data_ptr(), wp.data_ptr(), wt.data_ptr(), bc.data_ptr(), bhn.data_ptr(),
        gates.data_ptr(), out.data_ptr(), t_len, b, in_dim, h_dim, int(reverse),
        _build.stream_ptr(dev))
    _build.check(err, "gru_dir kernel")
    gru_dir.launches += 1
    return out


gru_dir.launches = 0


def bigru_level_tmajor(params: dict, x_t: torch.Tensor) -> torch.Tensor:
    """One bidirectional level: ``x_t [T, B, in]`` -> ``[T, B, 2H]``
    (fwd || bwd, storage time order).  ``params`` holds ``fwd`` / ``bwd``
    operand dicts from :func:`dir_operands`."""
    f, b = params["fwd"], params["bwd"]
    hs_f = gru_dir(x_t, f["wp"], f["wt"], f["bc"], f["bhn"], reverse=False)
    hs_b = gru_dir(x_t, b["wp"], b["wt"], b["bc"], b["bhn"], reverse=True)
    return torch.cat([hs_f, hs_b], dim=-1)


def bigru_finals_tmajor(hs: torch.Tensor) -> torch.Tensor:
    """[T, B, 2H] -> torch's ``cat((h[0], h[1]), dim=1)`` final hidden
    [B, 2H]: forward after t=T-1, backward after t=0."""
    h = hs.shape[-1] // 2
    return torch.cat([hs[-1, :, :h], hs[0, :, h:]], dim=-1)
