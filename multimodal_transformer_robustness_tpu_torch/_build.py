"""Build and bind the hand-written CUDA kernels under ``csrc/``.

The sources are compiled at first use with ``nvcc`` for ``sm_90a``, one
``nvcc`` per source, all started together, then linked into one shared
library with a plain C interface, which is loaded with ``ctypes``.
The library lands in ``build/kernels/`` beside the package, named by a hash
of its sources and flags, so a changed source rebuilds and an unchanged one
is reused.  Nothing here runs at import time: the CPU tests import every
module of the port on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
SOURCES = ("bigru.cu", "bigru_bwd.cu", "bert_attn.cu", "bert_ffn.cu", "bert_ffn_q.cu",
           "flash_attn.cu", "flash_attn_bf16.cu", "gru_recurrence.cu", "trunk_block.cu",
           "trunk_block_bf16.cu")
# The launch bounds of K5b and of K5f's unit path, blocks an SM:
# csrc/flash_attn.cu reads them as macros, and ops/attention_cuda.
# _plan_flash_bwd / _plan_flash_fwd size their persistent grids by them.
FB_BLOCKS_PER_SM = 3
FU_BLOCKS_PER_SM = 4
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v", f"-DFB_BLOCKS_PER_SM={FB_BLOCKS_PER_SM}",
              f"-DFU_BLOCKS_PER_SM={FU_BLOCKS_PER_SM}")

# H100 SXM: 132 SMs; a block may take 227 KB of an SM's 228 KB of shared
# memory, and each resident block reserves 1 KB more.  The wrappers read the
# card's own SM count (num_sms); the launch plans take it as an argument so
# that the CPU tests can check them.
NUM_SMS = 132
MAX_SMEM = 232448
SM_SMEM = 233472

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "mmtr_gru_dir_fwd": (_I, [_P] * 8 + [_I] * 5 + [_P, _P]),
    "mmtr_gru_dir_bwd": (_I, [_P] * 12 + [_I] * 6 + [_P, _P]),
    "mmtr_ffn_ln_fwd": (_I, [_P] * 11 + [_I] * 3 + [_F, _P, _P]),
    "mmtr_attn_block_fwd": (_I, [_P] * 13 + [_I] * 4 + [_F, _P, _P]),
    "mmtr_gru_dir_fwd_bf16": (_I, [_P] * 8 + [_I] * 5 + [_P, _P]),
    "mmtr_gru_dir_bwd_bf16": (_I, [_P] * 13 + [_I] * 6 + [_P, _P]),
    "mmtr_ffn_ln_fwd_bf16": (_I, [_P] * 11 + [_I] * 3 + [_F, _P, _P]),
    "mmtr_attn_block_fwd_bf16": (_I, [_P] * 13 + [_I] * 4 + [_F, _I, _P, _P]),
    "mmtr_attention_fwd": (_I, [_P] * 5 + [_I] * 4 + [_P, _P]),
    "mmtr_attention_fwd_bf16": (_I, [_P] * 5 + [_I] * 4 + [_P, _P]),
    "mmtr_attention_masked_fwd": (_I, [_P] * 5 + [_I] * 5 + [_P, _P]),
    "mmtr_attention_masked_fwd_bf16": (_I, [_P] * 5 + [_I] * 5 + [_P, _P]),
    "mmtr_attention_masked_walk_bf16": (_I, [_P] * 5 + [_I] * 5 + [_P, _P]),
    "mmtr_proj_ln_fwd": (_I, [_P] * 9 + [_I] * 2 + [_F, _P, _P]),
    "mmtr_proj_ln_fwd_bf16": (_I, [_P] * 9 + [_I] * 2 + [_F, _P, _P]),
    "mmtr_qrows": (_I, [_P] * 3 + [_I] * 2 + [_P]),
    "mmtr_qrows_bf16": (_I, [_P] * 3 + [_I] * 2 + [_P]),
    "mmtr_qgemm_i32": (_I, [_P] * 3 + [_I] * 3 + [_P, _P]),
    "mmtr_qdot": (_I, [_P] * 6 + [_I] * 3 + [_P, _P]),
    "mmtr_qdot_bf16": (_I, [_P] * 6 + [_I] * 3 + [_P, _P]),
    "mmtr_ffn_ln_q_fwd": (_I, [_P] * 16 + [_I] * 3 + [_F, _P, _P]),
    "mmtr_ffn_ln_q_fwd_bf16": (_I, [_P] * 16 + [_I] * 3 + [_F, _P, _P]),
    "mmtr_flash_fwd": (_I, [_P] * 7 + [_I] * 7 + [_P, _P]),
    "mmtr_flash_bwd_dq": (_I, [_P] * 9 + [_I] * 7 + [_P, _P]),
    "mmtr_flash_bwd_dkv": (_I, [_P] * 10 + [_I] * 7 + [_P, _P]),
    "mmtr_flash_bwd": (_I, [_P] * 11 + [_I] * 7 + [_P, _P]),
    "mmtr_flash_fwd_bf16": (_I, [_P] * 7 + [_I] * 7 + [_P, _P]),
    "mmtr_flash_bwd_dq_bf16": (_I, [_P] * 9 + [_I] * 7 + [_P, _P]),
    "mmtr_flash_bwd_dkv_bf16": (_I, [_P] * 10 + [_I] * 7 + [_P, _P]),
    "mmtr_flash_bwd_bf16": (_I, [_P] * 11 + [_I] * 7 + [_P, _P]),
    "mmtr_gru_rec_fwd": (_I, [_P] * 10 + [_I] * 4 + [_P, _P]),
    "mmtr_gru_rec_bwd": (_I, [_P] * 12 + [_I] * 4 + [_P, _P]),
    "mmtr_gru_rec_fwd_bf16": (_I, [_P] * 10 + [_I] * 4 + [_P, _P]),
    "mmtr_gru_rec_bwd_bf16": (_I, [_P] * 12 + [_I] * 4 + [_P, _P]),
    "mmtr_trunk_block_fwd": (_I, [_P] * 15 + [_I] * 9 + [_F] * 3 + [_P, _P]),
    "mmtr_trunk_block_bwd": (_I, [_P] * 21 + [_I] * 9 + [_F] * 3 + [_P, _P]),
    "mmtr_trunk_block_fwd_bf16": (_I, [_P] * 15 + [_I] * 9 + [_F] * 3 + [_P, _P]),
    "mmtr_trunk_block_bwd_bf16": (_I, [_P] * 23 + [_I] * 9 + [_F] * 3 + [_P, _P]),
}


class BuildInfo:
    """What the last build did: seconds spent (0 when reused) and the
    compiler's resource report (``-Xptxas=-v``)."""

    seconds = 0.0
    log = ""
    path = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernels' shared library."""
    files = [_CSRC / s for s in SOURCES] + sorted(_CSRC.glob("*.cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        digest.update(f.read_bytes())
    target = BUILD_DIR / f"libmmtr_kernels_{digest.hexdigest()[:16]}.so"
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
        objs = [BUILD_DIR / f"{Path(s).stem}.{tag}.o" for s in SOURCES]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(_CSRC / s)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        BuildInfo.log = "".join(logs)
        failed = [s for s, p in zip(SOURCES, procs) if p.returncode != 0]
        if not failed:
            tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
            link = subprocess.run([_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                                   *map(str, objs)], capture_output=True, text=True)
            BuildInfo.log += link.stdout + link.stderr
            if link.returncode != 0:
                failed = ["link"]
            else:
                os.replace(tmp, target)
        BuildInfo.seconds = time.perf_counter() - t0
        for o in objs:
            o.unlink(missing_ok=True)
        if failed:
            raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{BuildInfo.log}")
    BuildInfo.path = str(target)
    lib = ctypes.CDLL(str(target))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` from an entry point (a refused
    launch, e.g. more shared memory than the card allows, never runs)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} (cudaError_t)")


def stream_ptr(device: torch.device) -> int:
    """The raw ``cudaStream_t`` of the device's current stream (the raw
    getter skips building a Stream object on every launch)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def host_ints(values) -> tuple:
    """A launch plan as a C int array the kernels read from host memory:
    ``(array, its address)``; keep the array while the address is used."""
    arr = (ctypes.c_int * len(values))(*values)
    return arr, ctypes.addressof(arr)


BF16_TODO = ("takes no bf16 operand there (every kernel has a bf16 instance, which takes "
             "bf16 where its JAX kernel does): ROADMAP")


def require(t: torch.Tensor, name: str, shape: tuple, device: torch.device,
            dtype: torch.dtype = torch.float32) -> None:
    """Raise on what the kernels do not take: they read contiguous tensors
    of one dtype (float32 unless the caller names another: the int8
    weights and codes of K4, or bfloat16 for the bf16 instances, which
    every kernel has: K1f, K1b, K2, K3, K4, K5f, K5b, K5dq, K5dkv, K6a,
    K6b, K7f, K7b, K8, K9f and K9b) on one card, of exactly the given
    shape.  A bfloat16 tensor where the kernel takes float32 (a float32
    argument of a bf16 instance, or a float32 call) raises
    NotImplementedError."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype == torch.bfloat16 and dtype != torch.bfloat16:
        raise NotImplementedError(f"{name}: the kernel {BF16_TODO}")
    if t.dtype != dtype:
        raise ValueError(f"{name} is {t.dtype}; the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def require_all(device: torch.device, specs, dtype: torch.dtype = torch.float32) -> None:
    """:func:`require` over ``(tensor, name, shape)`` triples in one pass:
    the common case costs one comparison chain a tensor, and the first
    tensor that fails raises :func:`require`'s message."""
    for t, name, shape in specs:
        if (t.device != device or t.dtype != dtype or t.shape != shape
                or not t.is_contiguous()):
            require(t, name, shape, device, dtype)


@functools.lru_cache(maxsize=None)
def num_sms(device: torch.device) -> int:
    """The card's streaming-multiprocessor count (launch plans size grids
    by it)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``cuda`` without a card raises:
    nothing falls back to the CPU, which a caller must ask for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card unless "
                           "the caller asks for device='cpu'")
    return dev


def device_of(x: torch.Tensor) -> torch.device:
    """The device a wrapper launches on; raises for anything but CUDA."""
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return x.device
