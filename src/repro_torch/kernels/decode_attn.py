"""Flash decode: new query tokens against a (possibly rank-truncated) KV
cache with per-row valid lengths. Port of the TPU kernel
``repro/kernels/decode_attn.py:flash_decode``.

Two versions of one function live here:

* :func:`flash_decode` launches a hand-written CUDA kernel on CUDA
  tensors (built for ``sm_90a`` at first use): ``csrc/decode_attn.cu`` (f32
  on the CUDA cores) for f32 inputs, ``csrc/decode_attn_bf16.cu``
  (``mma.sync`` on the bf16 tensor cores) for bf16 ones; it raises on
  anything the kernels do not take;
* :func:`flash_decode_plain` is the same function in plain PyTorch: the
  CPU path and the reference the kernel is held against on the card.

Semantics (both): ``q`` (b, hq, r) for one decode token or (b, hq, C, r)
for a per-row query chunk; ``k`` (b, hkv, M, r); ``v`` (b, hkv, M, dv);
``kv_len`` () or (b,) valid keys INCLUDING the new chunk; ``q_start`` ()
or (b,) cache position of each row's first query (default
``kv_len - C``); ``q_lens`` optional (b,) valid query count per row.
Query j of row b sees key p iff p < kv_len[b], p <= q_start[b] + j and
j < q_lens[b]. Masked scores contribute exact zeros, so a query with no
visible key gives an all-zero output and probability row. Output is in
v's dtype; ``return_probs`` appends the normalised f32 probability rows
(b, hq, [C,] M) that feed the serving engine's attention-mass
accumulator.

Callers: the paged serving step (``models/transformer.py``, through
``ops.decode_attention``) and every few-query call of the flash branch
(``ops.flash_attention`` with sq <= DECODE_MAX_C and r, dv <= MAX_DIM: the
dense-cache decodes over more than 1024 keys), which passes K and V as
(b, hkv, kv_len, d) views of the (b, max_len, hkv, d) cache.

Layout the kernels take: ``q`` contiguous; ``k`` and ``v`` with any
batch, head and key strides (elements) and a unit-stride last dimension,
so a cache is read in place. A row whose start is not 16-byte aligned
(a stride or width off the 16-byte vector) is staged by plain loads, as
an odd width is; the wrapper raises on a last dimension that is not
unit-stride or a key stride over MAX_KEY_STRIDE, and the caller copies.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Tuple

import torch

# launches of each CUDA kernel in this process; a wrapper adds one where
# it launches its kernel and nowhere else (chip_smoke.py reads it to show
# that the serving path went through the kernel)
LAUNCHES: Dict[str, int] = {"flash_decode": 0}

MAX_DIM = 128          # largest r and dv the CUDA kernels take
# input type -> (csrc/<source>.cu, its C entry point)
SOURCES = {torch.float32: ("decode_attn", "flash_decode_launch"),
           torch.bfloat16: ("decode_attn_bf16", "flash_decode_bf16_launch")}
# the kernels' two paths: chunks of at most DECODE_MAX_C queries take the
# decode path, larger ones the chunk path
DECODE_MAX_C = 16
# f32 (csrc/decode_attn.cu)
DECODE_ROW_TILE = 4    # query rows per decode block, unless there is 1 in all
CHUNK_QUERIES = 64     # queries per chunk block
# a key split is a whole number of these keys: 16 on the decode path (one
# key per 8-lane group of a 128-thread block), one 64-key tile on the chunk
SPLIT_UNIT = {"decode": 16, "chunk": 64}
# bf16 (csrc/decode_attn_bf16.cu), both paths: one block per (key split,
# b * hkv, tile of at most 64 (query, q head) rows of the kv head), and a key
# split is a whole number of its 64-key tiles
BF16_ROW_TILE = 64
BF16_SPLIT_UNIT = 64
BLOCKS_PER_SM = 8      # blocks the key split aims at, counted over the grid
# largest key stride (elements) of K and V: the bf16 kernel addresses a
# 64-key tile's rows in 32 bits
MAX_KEY_STRIDE = (2 ** 31 - 1) // 64


def _row_vector(x, b: int, device, name: str) -> torch.Tensor:
    """() or (b,) integer lengths as a contiguous (b,) int32 tensor."""
    if isinstance(x, torch.Tensor) and x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    t = torch.as_tensor(x, device=device)  # inv-ok-torch[R1]: the serving step's device lengths pass through uncopied; only a caller's host int is copied
    if t.dtype.is_floating_point or t.dtype == torch.bool:
        raise ValueError(f"{name} must be an integer tensor, got {t.dtype}")
    if t.numel() not in (1, b):
        raise ValueError(f"{name} must have 1 or {b} entries, got {t.numel()}")
    return t.reshape(-1).to(torch.int32).expand(b).contiguous()


def _defaults(q, kv_len, q_start, q_lens):
    b, C = q.shape[0], q.shape[2]
    lens = _row_vector(kv_len, b, q.device, "kv_len")
    qs = (lens - C if q_start is None
          else _row_vector(q_start, b, q.device, "q_start"))
    ql = (torch.full((b,), C, dtype=torch.int32, device=q.device)
          if q_lens is None else _row_vector(q_lens, b, q.device, "q_lens"))
    return lens, qs, ql


def flash_decode_plain(q, k, v, kv_len, *, scale: float,
                       return_probs: bool = False, q_start=None, q_lens=None):
    """The plain PyTorch version of the kernel (f32 arithmetic)."""
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, :, None, :]
    b, hq, C, _ = q.shape
    hkv, M = k.shape[1], k.shape[2]
    lens, qs, ql = _defaults(q, kv_len, q_start, q_lens)
    kr = k.float().repeat_interleave(hq // hkv, dim=1)
    vr = v.float().repeat_interleave(hq // hkv, dim=1)
    s = torch.einsum("bhcd,bhkd->bhck", q.float(), kr) * scale
    k_pos = torch.arange(M, device=q.device)[None, None, None, :]
    j = torch.arange(C, device=q.device)[None, None, :, None]
    ok = ((k_pos <= qs[:, None, None, None] + j)
          & (k_pos < lens[:, None, None, None])
          & (j < ql[:, None, None, None]))
    s = s.masked_fill(~ok, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    e = torch.exp(s - m)                         # masked: exp(-inf) == 0
    p = e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhck,bhkd->bhcd", p, vr).to(v.dtype)
    if squeeze:
        o, p = o[:, :, 0], p[:, :, 0]
    return (o, p) if return_probs else o


def split_plan(b: int, hq: int, hkv: int, C: int, M: int, sm_count: int,
               dtype: torch.dtype = torch.float32) -> Tuple[str, int, int]:
    """The path and key split of the kernel for ``dtype``, from shapes
    alone: ``(path, split_len, n_split)``. Split s covers keys [s * split_len,
    min((s + 1) * split_len, M)), so the splits cover every key position
    once. The split aims at BLOCKS_PER_SM blocks per SM over the whole grid;
    blocks whose keys lie past their rows' ``kv_len`` exit at once, so the
    plan never needs to read the lengths (a device-to-host sync)."""
    path = "decode" if C <= DECODE_MAX_C else "chunk"
    rows = hq // hkv * C
    if dtype == torch.bfloat16:
        blocks = b * hkv * math.ceil(rows / BF16_ROW_TILE)
        unit = BF16_SPLIT_UNIT
    elif path == "decode":
        blocks = b * hkv * (1 if rows == 1 else math.ceil(rows / DECODE_ROW_TILE))
        unit = SPLIT_UNIT[path]
    else:
        blocks = b * hq * math.ceil(C / CHUNK_QUERIES)
        unit = SPLIT_UNIT[path]
    n_split = max(1, min(math.ceil(BLOCKS_PER_SM * sm_count / blocks),
                         math.ceil(M / unit)))
    split_len = unit * math.ceil(math.ceil(M / n_split) / unit)
    return path, split_len, math.ceil(M / split_len)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _prepare(q, k, v, kv_len, q_start, q_lens, return_probs: bool,
             sm_count: int):
    """Everything the launch needs, made on q's device without reading
    any of it on the host: per-row int32 lengths, the outputs, the split
    plan and the f32 workspace of per-split partials (m, l, acc)."""
    b, hq, C, _ = q.shape
    hkv, M, dv = k.shape[1], k.shape[2], v.shape[3]
    lens, qs, ql = _defaults(q, kv_len, q_start, q_lens)
    plan = split_plan(b, hq, hkv, C, M, sm_count, q.dtype)
    out = torch.empty((b, hq, C, dv), dtype=v.dtype, device=q.device)
    probs = (torch.empty((b, hq, C, M), dtype=torch.float32, device=q.device)
             if return_probs else None)
    work = torch.empty(b * hq * C * plan[2] * (dv + 2), dtype=torch.float32,
                       device=q.device)
    return (lens, qs, ql), out, probs, work, plan


def _check(q, k, v):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_decode launches on CUDA tensors, got {dev}")
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in SOURCES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_decode takes q, k, v all float32 or all "
                         f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("expected q (b, hq, C, r), k (b, hkv, M, r), "
                         "v (b, hkv, M, dv)")
    b, hq, _, r = q.shape
    if (k.shape[0] != b or v.shape[0] != b or k.shape[3] != r
            or v.shape[1] != k.shape[1] or v.shape[2] != k.shape[2]):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if hq % k.shape[1]:
        raise ValueError(f"hq={hq} is not a multiple of hkv={k.shape[1]}")
    if r > MAX_DIM or v.shape[3] > MAX_DIM:
        raise ValueError(f"the kernel takes r, dv <= {MAX_DIM}, got r={r}, "
                         f"dv={v.shape[3]}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    for name, t in (("k", k), ("v", v)):
        if t.stride(3) != 1 and t.shape[3] != 1:
            raise ValueError(f"{name} must have a unit-stride last dimension, "
                             f"got strides {t.stride()}")
        if t.stride(2) > MAX_KEY_STRIDE:
            raise ValueError(f"{name}'s key stride {t.stride(2)} is over "
                             f"{MAX_KEY_STRIDE} elements")


def _library(dtype):
    from repro_torch.kernels import build
    source, entry = SOURCES[dtype]
    fn = getattr(build.load(source), entry)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                       + [ctypes.c_int64] * 6 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_decode(q, k, v, kv_len, *, scale: float, return_probs: bool = False,
                 q_start=None, q_lens=None):
    """Launch the CUDA kernels for q's type on the current stream (no
    fallback): the path's split kernel, then the combine. One call is one
    launch in ``LAUNCHES``."""
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, :, None, :]
    _check(q, k, v)
    b, hq, C, r = q.shape
    hkv, M, dv = k.shape[1], k.shape[2], v.shape[3]
    (lens, qs, ql), out, probs, work, (_, split_len, n_split) = _prepare(
        q, k, v, kv_len, q_start, q_lens, return_probs, _sm_count(q.device))
    launch = _library(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
                     qs.data_ptr(), ql.data_ptr(), out.data_ptr(),
                     None if probs is None else probs.data_ptr(),
                     work.data_ptr(), b, hq, hkv, C, M, r, dv, split_len,
                     n_split, *k.stride()[:3], *v.stride()[:3], float(scale),
                     stream)
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error {err}")
    LAUNCHES["flash_decode"] += 1
    if squeeze:
        out = out[:, :, 0]
        probs = None if probs is None else probs[:, :, 0]
    return (out, probs) if return_probs else out
