"""The batched advisory join: CSR pair expansion plus the version-interval
predicate, and the compaction of its hits, as a CUDA kernel
(csrc/csr_join.cu) and its plain torch version.

Signatures and outputs follow the JAX package's ops/join.py:

  csr_pair_join(adv_lo_tok, adv_hi_tok, adv_flags, ver_tok,
                q_start, q_count, q_ver, total, t_pad) → int8[t_pad]
  csr_pair_join_compact(..., t_pad, h_cap)
      → (hit_idx int32[h_cap], hit_bits int8[h_cap], n_hits, bits)

Per query: bucket start, count and installed-version row. Real queries
have count > 0 and zero-count padding sits only at the tail
(check_csr_descriptors). Slot idx < total belongs to the last query
whose exclusive start is ≤ idx; it evaluates advisory row
clamp(q_start + idx - start, 0, A-1) and reports SATISFIED |
NEEDS_RECHECK; slots past `total` are 0.

Both also take `prefix=(lo_pre, hi_pre)`, the [A, 4] planes of
`prefix_planes`, which AdvisoryTable.device_arrays uploads beside the
token vectors: the kernel reads them, the plain version does not. Both
launch the kernel for CUDA tensors (the compacted one fuses the
compaction in: three launches, no torch op, no host sync) and run the
plain version (_pair_core, csr_pair_join_plain, _compact_core) for CPU
tensors; they never move work from one to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels
from .compare import lex_eq, lex_less
from .constants import (  # noqa: F401  (re-export)
    HAS_HI, HAS_LO, HI_INCL, INEXACT, JOIN_TILE, LO_INCL, NEEDS_RECHECK,
    NEGATIVE, PREFIX_TOKENS, SATISFIED,
)

# pair slots the plain version evaluates at once (bounds its gathers)
_PLAIN_CHUNK = 1 << 21


def check_csr_descriptors(q_count: np.ndarray, n_queries: int) -> None:
    """The CSR padding invariant every join relies on: the first
    `n_queries` counts are positive and the rest are zero. An interior
    zero count would shift every later segment of the JAX expansion."""
    q_count = np.asarray(q_count)
    if n_queries > q_count.shape[0] or (q_count[:n_queries] <= 0).any() \
            or (q_count[n_queries:] != 0).any():
        raise ValueError(
            "CSR descriptors need positive counts for the first "
            f"{n_queries} queries and zero-count padding after them")


def _pair_core(adv_lo_tok, adv_hi_tok, adv_flags, ver_tok,
               pair_row, pair_ver, pair_valid):
    """The interval predicate over a flat pair list → int8[T]."""
    flags = adv_flags[pair_row]
    lo_t = adv_lo_tok[pair_row]
    hi_t = adv_hi_tok[pair_row]
    inst = ver_tok[pair_ver]

    has_lo = (flags & HAS_LO) != 0
    lo_incl = (flags & LO_INCL) != 0
    has_hi = (flags & HAS_HI) != 0
    hi_incl = (flags & HI_INCL) != 0

    ok_lo = ~has_lo | lex_less(lo_t, inst) | (lo_incl & lex_eq(lo_t, inst))
    ok_hi = ~has_hi | lex_less(inst, hi_t) | (hi_incl & lex_eq(inst, hi_t))
    satisfied = pair_valid & ok_lo & ok_hi
    inexact = pair_valid & ((flags & INEXACT) != 0)
    return satisfied.to(torch.int8) | (inexact.to(torch.int8) << 1)


pair_join = _pair_core


def prefix_planes(adv_lo_tok: torch.Tensor, adv_hi_tok: torch.Tensor):
    """The kernel's derived inputs: each bound's first PREFIX_TOKENS
    tokens as contiguous [A, 4] planes (lo_pre, hi_pre)."""
    return (adv_lo_tok[:, :PREFIX_TOKENS].contiguous(),
            adv_hi_tok[:, :PREFIX_TOKENS].contiguous())


def _exclusive_starts(q_count: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(q_count, 0, dtype=torch.int32) - q_count


def csr_pair_join_plain(adv_lo_tok, adv_hi_tok, adv_flags, ver_tok,
                        q_start, q_count, q_ver, total, t_pad: int):
    """Plain torch version of the join kernel (same slots, same bits)."""
    dev = adv_flags.device
    total = int(total)
    out = torch.zeros(t_pad, dtype=torch.int8, device=dev)
    if total == 0:
        return out
    starts = _exclusive_starts(q_count)
    n_q = q_count.shape[0]
    n_rows = adv_flags.shape[0]
    n_ver = ver_tok.shape[0]
    for off in range(0, total, _PLAIN_CHUNK):
        idx = torch.arange(off, min(off + _PLAIN_CHUNK, total),
                           dtype=torch.int32, device=dev)
        seg = torch.searchsorted(starts, idx, right=True) - 1
        seg = seg.clamp(0, n_q - 1)
        row = (q_start[seg] + (idx - starts[seg])).clamp(0, n_rows - 1)
        ver = q_ver[seg].clamp(0, n_ver - 1)
        valid = torch.ones_like(idx, dtype=torch.bool)
        out[off:off + idx.shape[0]] = _pair_core(
            adv_lo_tok, adv_hi_tok, adv_flags, ver_tok,
            row.long(), ver.long(), valid)
    return out


def _cuda_args(adv_lo_tok, adv_hi_tok, adv_flags, ver_tok, q_start,
               q_count, q_ver, total, t_pad: int, prefix) -> tuple:
    """Check the join's CUDA inputs and allocate its dense bits and
    scratch → (the C entry points' leading arguments, through the
    scratch; the bits; the scratch, to hold until the launch is
    enqueued)."""
    dev = adv_flags.device
    lo_pre, hi_pre = prefix
    for name, t, nd in (("adv_lo_tok", adv_lo_tok, 2),
                        ("adv_hi_tok", adv_hi_tok, 2),
                        ("adv_flags", adv_flags, 1),
                        ("lo_pre", lo_pre, 2), ("hi_pre", hi_pre, 2),
                        ("ver_tok", ver_tok, 2),
                        ("q_start", q_start, 1), ("q_count", q_count, 1),
                        ("q_ver", q_ver, 1)):
        if t.device != dev or t.dtype != torch.int32 or t.dim() != nd \
                or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous int32 tensor "
                             f"of rank {nd} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    n_rows, k = adv_lo_tok.shape
    n_q = q_count.shape[0]
    if adv_hi_tok.shape != adv_lo_tok.shape or adv_flags.shape[0] != n_rows \
            or ver_tok.shape[1] != k or k % 4 or k < PREFIX_TOKENS \
            or lo_pre.shape != (n_rows, PREFIX_TOKENS) \
            or hi_pre.shape != lo_pre.shape \
            or q_start.shape[0] != n_q or q_ver.shape[0] != n_q:
        raise ValueError("csr_join: inconsistent shapes")
    if n_rows == 0 or ver_tok.shape[0] == 0 or n_q == 0:
        raise ValueError("csr_join: empty table, version pool or queries")
    ptrs = (adv_lo_tok.data_ptr(), adv_hi_tok.data_ptr(),
            adv_flags.data_ptr(), lo_pre.data_ptr(), hi_pre.data_ptr())
    q_ptr = q_count.data_ptr()
    v_ptr = ver_tok.data_ptr()
    if any(p % 16 for p in (*ptrs[:2], *ptrs[3:], q_ptr, v_ptr)):
        raise ValueError("csr_join: token planes, prefix planes and "
                         "q_count must be 16-byte aligned")
    total = int(total)
    if not 0 <= total <= t_pad:
        raise ValueError(f"total {total} outside [0, t_pad={t_pad}]")
    out = torch.empty(t_pad, dtype=torch.int8, device=dev)
    # int32 scratch, laid out by the kernel (csr_join.cu `launch`): the
    # tiles' hit counts padded to 4, the query starts, each tile's first
    # query
    n_tiles = -(-t_pad // JOIN_TILE)
    scratch = torch.empty(-(-n_tiles // 4) * 4 + n_q + n_tiles + 1,
                          dtype=torch.int32, device=dev)
    return (*ptrs, n_rows, k, v_ptr, ver_tok.shape[0], q_start.data_ptr(),
            q_ptr, q_ver.data_ptr(), n_q, total, t_pad, out.data_ptr(),
            scratch.data_ptr()), out, scratch


def csr_join_cuda(adv_lo_tok, adv_hi_tok, adv_flags, ver_tok,
                  q_start, q_count, q_ver, total, t_pad: int, *, prefix):
    """Launch csrc/csr_join.cu → int8[t_pad] (on the current stream)."""
    lib = kernels.library()
    args, out, _scratch = _cuda_args(adv_lo_tok, adv_hi_tok, adv_flags,
                                     ver_tok, q_start, q_count, q_ver, total,
                                     t_pad, prefix)
    rc = lib.trivy_csr_join(
        *args, torch.cuda.current_stream(out.device).cuda_stream)
    kernels.check(rc, "csr_join")
    kernels.count_launch(csr_join_cuda)
    return out


csr_join_cuda.launches = 0


def csr_join_compact_cuda(adv_lo_tok, adv_hi_tok, adv_flags, ver_tok,
                          q_start, q_count, q_ver, total, t_pad: int,
                          h_cap: int, *, prefix):
    """Launch csrc/csr_join.cu with the compaction fused in → (hit_idx
    int32[h_cap], hit_bits int8[h_cap], n_hits int32[], bits int8[t_pad])
    on the current stream."""
    lib = kernels.library()
    if h_cap < 0:
        raise ValueError(f"h_cap {h_cap} < 0")
    args, out, _scratch = _cuda_args(adv_lo_tok, adv_hi_tok, adv_flags,
                                     ver_tok, q_start, q_count, q_ver, total,
                                     t_pad, prefix)
    dev = out.device
    hit_idx = torch.empty(h_cap, dtype=torch.int32, device=dev)
    hit_bits = torch.empty(h_cap, dtype=torch.int8, device=dev)
    n_hits = torch.empty((), dtype=torch.int32, device=dev)
    rc = lib.trivy_csr_join_compact(
        *args, hit_idx.data_ptr(), hit_bits.data_ptr(), h_cap,
        n_hits.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(rc, "csr_join_compact")
    kernels.count_launch(csr_join_compact_cuda)
    return hit_idx, hit_bits, n_hits, out


csr_join_compact_cuda.launches = 0


def csr_pair_join(adv_lo_tok, adv_hi_tok, adv_flags, ver_tok,
                  q_start, q_count, q_ver, total, t_pad: int, *, prefix):
    """The join for tensors on one device: the CUDA kernel on a GPU,
    the plain version on the CPU."""
    if adv_flags.is_cuda:
        return csr_join_cuda(adv_lo_tok, adv_hi_tok, adv_flags, ver_tok,
                             q_start, q_count, q_ver, total, t_pad,
                             prefix=prefix)
    return csr_pair_join_plain(adv_lo_tok, adv_hi_tok, adv_flags, ver_tok,
                               q_start, q_count, q_ver, total, t_pad)


def _compact_core(bits: torch.Tensor, h_cap: int):
    """Squeeze the nonzero entries of int8[T] bits into an h_cap hit
    buffer, in ascending slot order: an exclusive scan gives each hit
    its slot, and one scatter writes (slot index, bits). Misses and
    hits past capacity go to a spare slot h_cap that is cut off, so an
    overflowing call keeps the first h_cap hits and still returns the
    true n_hits. No host sync."""
    t_pad = bits.shape[0]
    dev = bits.device
    mask = bits != 0
    m32 = mask.to(torch.int32)
    csum = torch.cumsum(m32, 0, dtype=torch.int32)
    n_hits = csum[-1] if t_pad else torch.zeros((), dtype=torch.int32,
                                                device=dev)
    pos = csum - m32
    dest = torch.where(mask & (pos < h_cap), pos,
                       torch.full_like(pos, h_cap)).long()
    idx = torch.arange(t_pad, dtype=torch.int32, device=dev)
    hit_idx = torch.zeros(h_cap + 1, dtype=torch.int32, device=dev)
    hit_bits = torch.zeros(h_cap + 1, dtype=torch.int8, device=dev)
    hit_idx.scatter_(0, dest, idx)
    hit_bits.scatter_(0, dest, bits)
    return hit_idx[:h_cap], hit_bits[:h_cap], n_hits


def csr_pair_join_compact(adv_lo_tok, adv_hi_tok, adv_flags, ver_tok,
                          q_start, q_count, q_ver, total, t_pad: int,
                          h_cap: int, *, prefix):
    """csr_pair_join plus the compaction; the dense bits come back last
    and stay on the device for the overflow fetch. On a GPU one fused
    kernel computes all four; on the CPU the plain join and
    _compact_core."""
    if adv_flags.is_cuda:
        return csr_join_compact_cuda(adv_lo_tok, adv_hi_tok, adv_flags,
                                     ver_tok, q_start, q_count, q_ver,
                                     total, t_pad, h_cap, prefix=prefix)
    bits = csr_pair_join_plain(adv_lo_tok, adv_hi_tok, adv_flags, ver_tok,
                               q_start, q_count, q_ver, total, t_pad)
    hit_idx, hit_bits, n_hits = _compact_core(bits, h_cap)
    return hit_idx, hit_bits, n_hits, bits
