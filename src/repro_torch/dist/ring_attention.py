"""Sequence-parallel ring attention (exact, flash-style online softmax):
``repro.dist.ring_attention`` on ``torch.distributed``.

The sequence dim of q/k/v is split over one mesh axis: each rank holds its
(b, C, h, d) block, as ``shard_map`` hands the reference's body. Each rank
keeps its q block and streams the k/v blocks round the axis's process
group with ``dist.batch_isend_irecv`` (n - 1 hops), folding every block
into a running softmax in f32 (running max ``m``, normaliser ``l``,
weighted accumulator ``acc``). After the last hop every query has seen the
whole sequence, so the result equals one-device attention
(``kernels/ref.flash_ref``) to float tolerance, with one (C x C) score
tile per rank instead of the (S x S) matrix.

Causality is enforced per block from the *global* positions of the q and
k blocks. A masked probability is set to exactly zero, so a block wholly
in the future adds nothing (with ``m_new`` at -1e30, ``exp(s - m_new)``
would otherwise be 1). Plain torch ops, as the reference's are plain
einsums.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.dist.sharding import axis_names

_NEG_INF = -1e30


def _ring_shift(tensors, group, idx: int, n: int):
    """Each of ``tensors`` sent to the next rank of ``group`` and replaced
    by the one the previous rank sent."""
    nxt = dist.get_global_rank(group, (idx + 1) % n)
    prv = dist.get_global_rank(group, (idx - 1) % n)
    recv = [torch.empty_like(t) for t in tensors]
    ops = ([dist.P2POp(dist.isend, t, nxt, group) for t in tensors]
           + [dist.P2POp(dist.irecv, r, prv, group) for r in recv])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


def ring_block(q, k, v, *, scale: float, causal: bool, group, idx: int, n: int):
    """This rank's attention output. q/k/v: (b, C, h, d) local blocks, the
    ``idx``-th of ``n`` along the sequence; returns (b, C, h, dv)."""
    b, C, h, _ = q.shape
    dv = v.shape[-1]
    dev = q.device
    qf = q.float() * scale
    q_pos = idx * C + torch.arange(C, device=dev)            # global q positions

    m = torch.full((b, h, C), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, C), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, C, dv), dtype=torch.float32, device=dev)

    k_blk, v_blk = k.contiguous(), v.contiguous()
    for hop in range(n):
        src = (idx - hop) % n                                 # origin of this block
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k_blk.float())  # (b, h, C, C)
        if causal:
            k_pos = src * C + torch.arange(C, device=dev)
            mask = (k_pos[None, :] <= q_pos[:, None]).expand(b, h, C, C)
        else:
            mask = torch.ones(s.shape, dtype=torch.bool, device=dev)
        s = torch.where(mask, s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v_blk.float())
        m = m_new
        if hop != n - 1:
            k_blk, v_blk = _ring_shift((k_blk, v_blk), group, idx, n)

    out = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(v.dtype)                    # (b, C, h, dv)


def make_ring_attention(mesh, *, scale: float, causal: bool = True,
                        axis_name: Optional[str] = None):
    """Ring attention over ``axis_name`` (default: the mesh's first axis)
    of a ``DeviceMesh``. Returns ``fn(q, k, v)`` taking this rank's (b, C,
    h, d) blocks (block ``i`` of the axis holds positions i C ... (i + 1) C
    - 1) and returning its (b, C, h, dv) block of the output."""
    axis = axis_name or axis_names(mesh)[0]
    group = mesh.get_group(axis)
    n = mesh.size(axis_names(mesh).index(axis))
    idx = mesh.get_local_rank(axis)

    def fn(q, k, v):
        return ring_block(q, k, v, scale=scale, causal=causal, group=group,
                          idx=idx, n=n)
    return fn
