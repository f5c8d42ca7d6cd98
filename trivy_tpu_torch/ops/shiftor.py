"""The secret keyword prefilter kernel (csrc/shiftor.cu) and its plain
torch version over the kernel's bank layout.

`pack_bank` lays a LiteralBank out as the kernel reads it: [W, 128]
int32 word and mask planes and [1, 128] int32 bit values (the JAX
package's Pallas layout, kept so both take the same bank). Padding
entries carry word -1, mask -1 and bit value 0: an all-0xFF word can
occur in binary data, but a bit value of 0 never sets an output bit.

`bank_index` adds the kernel's bigram index of that bank: for each
bigram (bytes p, p+1 of a row) the keyword lanes that can start there.
The kernel rejects most positions with one lookup in it and verifies
only the lanes it names.

`shiftor` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; it never moves work from one to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from . import ac, kernels

K_LANES = 128  # keyword slots in the kernel's bank
BIGRAMS = 1 << 16  # b0 | b1 << 8


def pack_bank(bank) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """LiteralBank → ([W, 128] int32 words, [W, 128] int32 masks,
    [1, 128] int32 bit values)."""
    return pack_planes(bank.kw_words, bank.kw_masks)


def pack_planes(kw_words: np.ndarray, kw_masks: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """pack_bank of a bank given by its raw [W, Nk] uint32 word and mask
    planes."""
    n_state, n = kw_words.shape
    if n > K_LANES:
        raise ValueError(f"keyword bank > {K_LANES} needs multi-tile "
                         f"lanes: {n}")
    kww = np.full((n_state, K_LANES), -1, dtype=np.int32)
    kwm = np.full((n_state, K_LANES), -1, dtype=np.int32)
    bit = np.zeros(K_LANES, dtype=np.int32)
    kww[:, :n] = np.ascontiguousarray(kw_words, np.uint32).view(np.int32)
    kwm[:, :n] = np.ascontiguousarray(kw_masks, np.uint32).view(np.int32)
    bit[:n] = (np.uint32(1) << (np.arange(n, dtype=np.uint32) % 32)) \
        .view(np.int32)
    return kww, kwm, bit.reshape(1, -1)


def bank_index(kw_words: np.ndarray, kw_masks: np.ndarray,
               kw_bits: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """pack_bank's arrays → the kernel's bigram index: (int32[2048]
    presence bitmap, bit g % 32 of word g // 32; int32[65536, 4]
    candidate lanes of each bigram, bit k % 32 of word k // 32).

    Lane k is a candidate at bigram g iff its word 0 agrees with g under
    the low two bytes of its mask: a keyword of two or more bytes sits
    under its own first two bytes, a 1-byte keyword under every bigram
    that starts with its byte (second byte 0 included, which is how a
    match at a row's last byte reads), an empty keyword under all.
    Padding lanes (bit value 0) are in no set. A bigram is present iff
    its set is not empty."""
    w0 = kw_words[0].view(np.uint32) & np.uint32(0xFFFF)
    m0 = kw_masks[0].view(np.uint32) & np.uint32(0xFFFF)
    g = np.arange(BIGRAMS, dtype=np.uint32)
    cand = np.zeros((BIGRAMS, K_LANES // 32), np.uint32)
    for k in np.flatnonzero(kw_bits.reshape(-1)):
        under = ((g ^ w0[k]) & m0[k]) == 0
        cand[under, k // 32] |= np.uint32(1) << np.uint32(k % 32)
    bitmap = np.packbits(cand.any(axis=1), bitorder="little").view("<u4")
    return bitmap.astype(np.uint32).view(np.int32), cand.view(np.int32)


def shiftor_plain(kw_words, kw_masks, kw_bits, chunks, *, n_words: int):
    """Plain torch version of the kernel (ac.shiftor_scan over all 128
    lanes): each hit ORs its lane's bit value into word lane // 32."""
    return ac.shiftor_scan(kw_words, kw_masks, chunks, n_words=n_words,
                           kw_bits=kw_bits)


def shiftor_cuda(kw_words, kw_masks, kw_bits, chunks, *, n_words: int,
                 index):
    """Launch csrc/shiftor.cu → int32[B, n_words] (current stream).
    index: `bank_index` of the same bank, on the chunks' device."""
    lib = kernels.library()
    dev = chunks.device
    bitmap, cand = index
    for name, t, dtype, nd in (("kw_words", kw_words, torch.int32, 2),
                               ("kw_masks", kw_masks, torch.int32, 2),
                               ("kw_bits", kw_bits, torch.int32, 2),
                               ("bitmap", bitmap, torch.int32, 1),
                               ("cand", cand, torch.int32, 2),
                               ("chunks", chunks, torch.uint8, 2)):
        if t.device != dev or t.dtype != dtype or t.dim() != nd \
                or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {dtype} tensor "
                             f"of rank {nd} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    n_state = kw_words.shape[0]
    if kw_words.shape != (n_state, K_LANES) or kw_masks.shape != \
            kw_words.shape or kw_bits.shape != (1, K_LANES):
        raise ValueError("shiftor: bank must be pack_bank's [W, 128] "
                         "planes and [1, 128] bit values")
    if bitmap.shape != (BIGRAMS // 32,) or \
            cand.shape != (BIGRAMS, K_LANES // 32):
        raise ValueError("shiftor: index must be bank_index's [2048] "
                         "bitmap and [65536, 4] candidate lanes")
    rows, length = chunks.shape
    x_ptr, cand_ptr = chunks.data_ptr(), cand.data_ptr()
    # the bulk copy moves 16-byte granules from 16-byte aligned rows
    if not 1 <= n_words <= K_LANES // 32 or length % 16 or x_ptr % 16 \
            or cand_ptr % 16 or not 1 <= n_state <= 16:
        raise ValueError(f"shiftor: unsupported shape {tuple(chunks.shape)}"
                         f", {n_state} state words, {n_words} words")
    out = torch.empty((rows, n_words), dtype=torch.int32, device=dev)
    rc = lib.trivy_shiftor(
        x_ptr, rows, length, kw_words.data_ptr(), kw_masks.data_ptr(),
        kw_bits.data_ptr(), bitmap.data_ptr(), cand_ptr, n_state,
        out.data_ptr(), n_words, torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(rc, "shiftor")
    shiftor_cuda.launches += 1
    return out


shiftor_cuda.launches = 0


def shiftor(kw_words, kw_masks, kw_bits, chunks, *, n_words: int,
            index):
    """chunks: uint8[B, L] (lowercased) → int32[B, n_words] exact keyword
    bitmask; kw_* from `pack_bank` and `index` = (bitmap, cand) from
    `bank_index`, all on the chunks' device. The kernel reads the index,
    the plain version does not."""
    if chunks.is_cuda:
        return shiftor_cuda(kw_words, kw_masks, kw_bits, chunks,
                            n_words=n_words, index=index)
    return shiftor_plain(kw_words, kw_masks, kw_bits, chunks,
                         n_words=n_words)
