"""Flash attention whose score contraction runs over a (possibly truncated)
rank r. Port of the TPU kernel ``repro/kernels/lowrank_flash.py:
lowrank_flash``.

Two versions of one function live here:

* :func:`lowrank_flash` launches a hand-written CUDA kernel on CUDA
  tensors (built for ``sm_90a`` at first use): ``csrc/lowrank_flash.cu``
  (split TF32 on ``mma.sync``) for f32 inputs,
  ``csrc/lowrank_flash_bf16.cu`` (``wgmma`` on the bf16 tensor cores, TMA)
  for bf16 ones; it raises on anything the kernels do not take;
* :func:`lowrank_flash_plain` is the same function in plain PyTorch (f32
  einsum scores, an exact masked softmax, P.V): the CPU path and the
  reference the kernel is held against on the card.

Semantics (both): ``q`` (b, hq, sq, r), ``k`` (b, hkv, skv, r), ``v``
(b, hkv, skv, dv) with hq a multiple of hkv (GQA: q head h reads kv head
h // (hq // hkv)). Query i sits at position ``q_offset + i`` and, when
``causal``, sees keys j <= q_offset + i. ``q_offset`` must be >= 0, so
every query sees key 0 (with a negative offset the Pallas kernel and its
oracle disagree on empty rows). Output (b, hq, sq, dv) in v's dtype.

Callers: ``ops.flash_attention`` sends this kernel the flash branch's
calls of more than 16 queries (``ops.few_query``: prefills and cache-free
forwards past 1024 keys, and any call whose r or dv exceeds 128, such as
MLA's r = 192), as contiguous copies; calls of at most 16 queries (the
dense-cache decodes) go to ``decode_attn.flash_decode``, which computes
the same function with kv_len = skv and q_start = q_offset (or skv - 1
when not causal).
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

# launches of the CUDA kernels (either type) in this process; the wrapper
# adds one where it launches a kernel and nowhere else
LAUNCHES: Dict[str, int] = {"lowrank_flash": 0}

MAX_RANK = 192         # largest r the CUDA kernels take (MLA: qk_nope 128 + qk_rope 64)
MAX_DIM = 128          # largest dv the CUDA kernels take
# input type -> (csrc/<source>.cu, its C entry point)
SOURCES = {torch.float32: ("lowrank_flash", "lowrank_flash_launch"),
           torch.bfloat16: ("lowrank_flash_bf16", "lowrank_flash_bf16_launch")}


def check_offset(q_offset) -> int:
    if int(q_offset) != q_offset or q_offset < 0:
        raise ValueError(f"q_offset must be an integer >= 0, got {q_offset}")
    return int(q_offset)


def lowrank_flash_plain(q, k, v, *, scale: float, causal: bool = True,
                        q_offset: int = 0):
    """The plain PyTorch version of the kernel (f32 arithmetic)."""
    q_offset = check_offset(q_offset)
    hq, sq = q.shape[1], q.shape[2]
    hkv, skv = k.shape[1], k.shape[2]
    kr = k.float().repeat_interleave(hq // hkv, dim=1)
    vr = v.float().repeat_interleave(hq // hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * scale
    if causal:
        q_pos = torch.arange(sq, device=q.device)[:, None] + q_offset
        k_pos = torch.arange(skv, device=q.device)[None, :]
        s = s.masked_fill(k_pos > q_pos, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vr).to(v.dtype)


def _check(q, k, v):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"lowrank_flash launches on CUDA tensors, got {dev}")
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in SOURCES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("lowrank_flash takes q, k, v all float32 or all "
                         f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("expected q (b, hq, sq, r), k (b, hkv, skv, r), "
                         "v (b, hkv, skv, dv)")
    b, hq, _, r = q.shape
    if (k.shape[0] != b or v.shape[0] != b or k.shape[3] != r
            or v.shape[1] != k.shape[1] or v.shape[2] != k.shape[2]):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if hq % k.shape[1]:
        raise ValueError(f"hq={hq} is not a multiple of hkv={k.shape[1]}")
    if r > MAX_RANK or v.shape[3] > MAX_DIM:
        raise ValueError(f"the kernel takes r <= {MAX_RANK} and dv <= {MAX_DIM}, "
                         f"got r={r}, dv={v.shape[3]}")
    if min(q.shape[2], k.shape[2], r, v.shape[3]) < 1:
        raise ValueError("empty q, k or v")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _library(dtype):
    from repro_torch.kernels import build
    source, entry = SOURCES[dtype]
    fn = getattr(build.load(source), entry)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def lowrank_flash(q, k, v, *, scale: float, causal: bool = True,
                  q_offset: int = 0):
    """Launch the CUDA kernel for q's type on the current stream (no
    fallback)."""
    q_offset = check_offset(q_offset)
    _check(q, k, v)
    b, hq, sq, r = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    out = torch.empty((b, hq, sq, dv), dtype=v.dtype, device=q.device)
    launch = _library(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     b, hq, hkv, sq, skv, r, dv, q_offset, int(causal),
                     float(scale), stream)
    if err != 0:
        raise RuntimeError(f"lowrank_flash kernel launch failed: CUDA error {err}")
    LAUNCHES["lowrank_flash"] += 1
    return out
