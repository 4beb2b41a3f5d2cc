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

Both can also return each row's log-sum-exp (``return_lse``), from which
the backward rebuilds P. The backward has two versions too:
:func:`lowrank_flash_bwd` launches ``csrc/lowrank_flash_bwd.cu`` (split
TF32 on ``mma.sync``, as the forward) for f32 inputs and
``csrc/lowrank_flash_bwd_bf16.cu`` (``wgmma`` and TMA, as the bf16
forward; P and dS as two bf16 terms) for bf16 ones (the Pallas kernel has
none, the reference differentiates its flash branch with plain XLA), and
:func:`lowrank_flash_bwd_plain` computes it in plain PyTorch.
:class:`LowrankFlash` is the autograd Function over both passes: kernels
on CUDA tensors, plain versions on CPU tensors.

Semantics (both): ``q`` (b, hq, sq, r), ``k`` (b, hkv, skv, r), ``v``
(b, hkv, skv, dv) with hq a multiple of hkv (GQA: q head h reads kv head
h // (hq // hkv)). Query i sits at position ``q_offset + i`` and, when
``causal``, sees keys j <= q_offset + i. ``q_offset`` must be >= 0, so
every query sees key 0 (with a negative offset the Pallas kernel and its
oracle disagree on empty rows). Output (b, hq, sq, dv) in v's dtype.

Callers: ``ops.flash_attention`` sends :class:`LowrankFlash` every call
that autograd records, and this kernel the flash branch's other calls of
more than 16 queries (``ops.few_query``: prefills and cache-free
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
LAUNCHES: Dict[str, int] = {"lowrank_flash": 0, "lowrank_flash_bwd": 0}

MAX_RANK = 192         # largest r the CUDA kernels take (MLA: qk_nope 128 + qk_rope 64)
MAX_DIM = 128          # largest dv the CUDA kernels take
# input type -> (csrc/<source>.cu, its C entry point): the forward, the backward
SOURCES = {torch.float32: ("lowrank_flash", "lowrank_flash_launch"),
           torch.bfloat16: ("lowrank_flash_bf16", "lowrank_flash_bf16_launch")}
BWD_SOURCES = {torch.float32: ("lowrank_flash_bwd", "lowrank_flash_bwd_launch"),
               torch.bfloat16: ("lowrank_flash_bwd_bf16", "lowrank_flash_bwd_bf16_launch")}


def check_offset(q_offset) -> int:
    if int(q_offset) != q_offset or q_offset < 0:
        raise ValueError(f"q_offset must be an integer >= 0, got {q_offset}")
    return int(q_offset)


def _scores(q, k, *, scale: float, causal: bool, q_offset: int):
    """f32 scale Q K^T with K repeated over each GQA group, -inf where
    masked: (b, hq, sq, skv)."""
    hq, sq = q.shape[1], q.shape[2]
    hkv, skv = k.shape[1], k.shape[2]
    kr = k.float().repeat_interleave(hq // hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * scale
    if causal:
        q_pos = torch.arange(sq, device=q.device)[:, None] + q_offset
        k_pos = torch.arange(skv, device=q.device)[None, :]
        s = s.masked_fill(k_pos > q_pos, float("-inf"))
    return s


def lowrank_flash_plain(q, k, v, *, scale: float, causal: bool = True,
                        q_offset: int = 0, return_lse: bool = False):
    """The plain PyTorch version of the kernel (f32 arithmetic). With
    ``return_lse`` also each row's log-sum-exp of its scaled scores,
    ln sum_j exp(scale q.k_j) over the visible keys (b, hq, sq), f32."""
    q_offset = check_offset(q_offset)
    s = _scores(q, k, scale=scale, causal=causal, q_offset=q_offset)
    vr = v.float().repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vr).to(v.dtype)
    return (out, torch.logsumexp(s, dim=-1)) if return_lse else out


def lowrank_flash_bwd_plain(q, k, v, o, lse, do, *, scale: float,
                            causal: bool = True, q_offset: int = 0):
    """The plain PyTorch version of the backward (f32 arithmetic): P
    rebuilt from ``lse`` (exact zeros where masked), D = rowsum(dO o O),
    dV = P^T dO, dS = P o (dO V^T - D), dQ = scale dS K, dK = scale dS^T Q;
    dK and dV summed over each GQA group's hq / hkv heads. Returns (dq, dk,
    dv) in the inputs' shapes and dtypes."""
    q_offset = check_offset(q_offset)
    b, hq = q.shape[:2]
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    s = _scores(q, k, scale=scale, causal=causal, q_offset=q_offset)
    p = torch.exp(s - lse.float()[..., None])
    del s
    qf, dof = q.float(), do.float()
    kr = k.float().repeat_interleave(g, dim=1)
    vr = v.float().repeat_interleave(g, dim=1)
    dsum = (dof * o.float()).sum(dim=-1, keepdim=True)
    dv_r = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vr) - dsum)
    dq = scale * torch.einsum("bhqk,bhkd->bhqd", ds, kr)
    dk_r = scale * torch.einsum("bhqk,bhqd->bhkd", ds, qf)

    def fold(x):        # (b, hq, skv, d) -> (b, hkv, skv, d), summed over the group
        return x.reshape(b, hkv, g, skv, x.shape[-1]).sum(dim=2)
    return dq.to(q.dtype), fold(dk_r).to(k.dtype), fold(dv_r).to(v.dtype)


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


def _library(source, entry, n_ptrs):
    from repro_torch.kernels import build
    fn = getattr(build.load(source), entry)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def lowrank_flash(q, k, v, *, scale: float, causal: bool = True,
                  q_offset: int = 0, return_lse: bool = False):
    """Launch the CUDA kernel for q's type on the current stream (no
    fallback). ``return_lse`` also returns the kernel's log-sum-exp of each
    row, (b, hq, sq) f32 in natural units."""
    q_offset = check_offset(q_offset)
    _check(q, k, v)
    b, hq, sq, r = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    out = torch.empty((b, hq, sq, dv), dtype=v.dtype, device=q.device)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    launch = _library(*SOURCES[q.dtype], 5)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     None if lse is None else lse.data_ptr(), b, hq, hkv, sq, skv, r,
                     dv, q_offset, int(causal), float(scale), stream)
    if err != 0:
        raise RuntimeError(f"lowrank_flash kernel launch failed: CUDA error {err}")
    LAUNCHES["lowrank_flash"] += 1
    return (out, lse) if return_lse else out


def lowrank_flash_bwd(q, k, v, o, lse, do, *, scale: float,
                      causal: bool = True, q_offset: int = 0):
    """Launch the backward kernel for q's type on the current stream (no
    fallback): ``csrc/lowrank_flash_bwd.cu`` for float32,
    ``csrc/lowrank_flash_bwd_bf16.cu`` for bfloat16. (dq, dk, dv) of
    :func:`lowrank_flash` at (q, k, v) for the output gradient ``do``, from
    the forward's ``o`` and ``lse`` (``return_lse=True``): o and do in q's
    type, lse float32, all contiguous, shapes as the forward's; the
    gradients in q's type."""
    q_offset = check_offset(q_offset)
    _check(q, k, v)
    b, hq, sq, r = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    for name, t, dtype, shape in (("o", o, q.dtype, (b, hq, sq, dv)),
                                  ("do", do, q.dtype, (b, hq, sq, dv)),
                                  ("lse", lse, torch.float32, (b, hq, sq))):
        if (t.device != q.device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dtype} {shape} tensor on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    dq, dk, dvv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dsum = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    launch = _library(*BWD_SOURCES[q.dtype], 10)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                     dvv.data_ptr(), dsum.data_ptr(), b, hq, hkv, sq, skv, r, dv,
                     q_offset, int(causal), float(scale), stream)
    if err != 0:
        raise RuntimeError(f"lowrank_flash_bwd kernel launch failed: CUDA error {err}")
    LAUNCHES["lowrank_flash_bwd"] += 1
    return dq, dk, dvv


class LowrankFlash(torch.autograd.Function):
    """:func:`lowrank_flash` with a gradient. On CUDA tensors both passes
    are kernels (the forward for the inputs' type with its log-sum-exp,
    then :func:`lowrank_flash_bwd`); on CPU tensors both are the plain
    versions. Inputs contiguous; ``apply(q, k, v, scale, causal, q_offset)``. The
    backward is not itself differentiable: a second derivative raises."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, q_offset):
        fwd = lowrank_flash_plain if q.device.type == "cpu" else lowrank_flash
        out, lse = fwd(q, k, v, scale=scale, causal=causal, q_offset=q_offset,
                       return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = dict(scale=scale, causal=causal, q_offset=q_offset)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = lowrank_flash_bwd_plain if q.device.type == "cpu" else lowrank_flash_bwd
        dq, dk, dv = bwd(q, k, v, out, lse, do.contiguous(), **ctx.kw)
        return dq, dk, dv, None, None, None
