"""Exact multi-keyword matching for the secret prefilter: the keyword
bank, chunk packing, and the plain torch shift-or scan.

Keywords are fixed strings matched lowercased. Each byte position p of
a chunk row carries the little-endian word of its next 4 bytes, w4[p];
keyword k (state words w < W, word w covering its bytes 4w..4w+3, the
tail of a short word masked off and words past its end masked to 0)
occurs at p iff ((w4[p + 4w] ^ word[w, k]) & mask[w, k]) == 0 for every
w. Bytes past the end of a row are 0, which no keyword byte under its
mask equals, so a row's verdict covers exactly that row.

Files are packed into fixed [B, L] uint8 rows with an overlap of the
longest keyword minus one, so every occurrence lies wholly inside some
row and the per-row verdicts are exact for the whole file.

`shiftor_scan` here is the plain version of the CUDA kernel in
csrc/shiftor.cu (ops/shiftor.py) and the path the CPU takes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import native

_LOWER = np.arange(256, dtype=np.uint8)
_LOWER[65:91] += 32  # A-Z → a-z


def lower_bytes(data: bytes) -> np.ndarray:
    return _LOWER[np.frombuffer(data, dtype=np.uint8)]


@dataclass
class LiteralBank:
    """Keyword literals (matched lowercased) + packed word planes; word
    w of keyword k covers its bytes 4w..4w+3."""
    kw_bytes: list          # [Nk] lowercased keyword bytes (host path)
    kw_words: np.ndarray    # uint32[W, Nk] packed 4-byte words
    kw_masks: np.ndarray    # uint32[W, Nk] per-word byte masks
    n_keywords: int
    max_kw_len: int

    @property
    def words(self) -> int:
        """Output bitmask words: 32 keyword bits per int32."""
        return max(1, (self.n_keywords + 31) // 32)

    @property
    def state_words(self) -> int:
        """Shift-or state words per keyword: ceil(max_kw_len / 4)."""
        return self.kw_words.shape[0]


def build_literal_bank(keywords: list[bytes]) -> LiteralBank:
    kws = [bytes(_LOWER[np.frombuffer(k, np.uint8)]) for k in keywords]
    n = len(kws)
    max_len = max((len(k) for k in kws), default=1)
    n_state = max(1, (max_len + 3) // 4)
    words = np.zeros((n_state, n), dtype=np.uint32)
    masks = np.zeros((n_state, n), dtype=np.uint32)
    for i, k in enumerate(kws):
        for w in range(n_state):
            p = k[4 * w:4 * w + 4]
            if not p:
                break  # word fully past the keyword: mask 0 = always true
            words[w, i] = int.from_bytes(p.ljust(4, b"\0"), "little")
            masks[w, i] = (1 << (8 * len(p))) - 1 if len(p) < 4 \
                else 0xFFFFFFFF
    return LiteralBank(kw_bytes=kws, kw_words=words, kw_masks=masks,
                       n_keywords=n, max_kw_len=max_len)


def _as_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) → the same bit patterns as int32."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def word_planes(chunks: torch.Tensor, n_state: int) -> torch.Tensor:
    """uint8[B, L] → int32[B, L + 4*n_state]: w4 at every position,
    zero past the row end (the bit patterns the kernel compares)."""
    b, length = chunks.shape
    c = torch.nn.functional.pad(chunks.to(torch.int64), (0, 4 * n_state + 4))
    w4 = (c[:, 0:length + 4 * n_state]
          | (c[:, 1:length + 4 * n_state + 1] << 8)
          | (c[:, 2:length + 4 * n_state + 2] << 16)
          | (c[:, 3:length + 4 * n_state + 3] << 24))
    return _as_i32(w4)


def keyword_hits(kw_words: torch.Tensor, kw_masks: torch.Tensor,
                 chunks: torch.Tensor) -> torch.Tensor:
    """chunks: uint8[B, L] (lowercased) → bool[B, Nk]: keyword k occurs
    somewhere in the row. kw_words/kw_masks: int32[W, Nk] bit patterns
    of the bank's uint32 planes. Words whose mask is 0 (past a
    keyword's end) hold everywhere and are skipped."""
    b, length = chunks.shape
    n_state, n_kw = kw_words.shape
    words = kw_words.tolist()
    masks = kw_masks.tolist()
    planes = word_planes(chunks, n_state)
    hits = torch.zeros((b, n_kw), dtype=torch.bool, device=chunks.device)
    for k in range(n_kw):
        match = None
        for w in range(n_state):
            if masks[w][k] == 0:
                continue
            plane = planes[:, 4 * w:4 * w + length]
            eq = ((plane ^ words[w][k]) & masks[w][k]) == 0
            match = eq if match is None else match & eq
        if match is None:   # a keyword with no masked byte matches anywhere
            hits[:, k] = length > 0
        else:
            hits[:, k] = match.any(dim=1)
    return hits


def pack_hits(hits: torch.Tensor, bit_values: torch.Tensor,
              n_words: int) -> torch.Tensor:
    """bool[B, Nk] → int32[B, n_words]: OR of bit_values[k] (int64) into
    word k // 32 for every keyword k that hit."""
    b, n_kw = hits.shape
    vals = torch.where(hits, bit_values, 0)
    pad = (-n_kw) % 32
    if pad:
        vals = torch.nn.functional.pad(vals, (0, pad))
    # distinct single bits per word: the sum is the OR
    words = vals.reshape(b, -1, 32).sum(dim=2)[:, :n_words]
    if words.shape[1] < n_words:
        words = torch.nn.functional.pad(words, (0, n_words - words.shape[1]))
    return _as_i32(words)


def shiftor_scan(kw_words: torch.Tensor, kw_masks: torch.Tensor,
                 chunks: torch.Tensor, *, n_words: int,
                 kw_bits: torch.Tensor | None = None) -> torch.Tensor:
    """chunks: uint8[B, L] (lowercased) → int32[B, n_words] EXACT keyword
    bitmask — bit k%32 of word k//32 set iff keyword k occurs somewhere
    in the row (the JAX package's ac.shiftor_scan contract). kw_bits:
    int32 bit value per keyword lane (pack_bank's padded bank, whose
    padding lanes carry 0); by default 1 << (k % 32)."""
    hits = keyword_hits(kw_words, kw_masks, chunks)
    if kw_bits is None:
        k = torch.arange(hits.shape[1], dtype=torch.int64, device=hits.device)
        bits = torch.ones_like(k) << (k % 32)
    else:
        bits = kw_bits.reshape(-1).to(torch.int64) & 0xFFFFFFFF
    return pack_hits(hits, bits, n_words)


def pack_chunks(files: list[bytes], chunk_len: int,
                overlap: int) -> tuple[np.ndarray, np.ndarray]:
    """Pack lowercased file bytes into [B, chunk_len] with per-chunk file
    index map [B]. Stride = chunk_len - overlap. Each file goes through
    the native C++ packer; _pack_one_py is its plain version."""
    blocks, owner = [], []
    for fi, data in enumerate(files):
        if not data:
            continue
        block = native.lower_pack_chunks(data, chunk_len, overlap)
        if block.shape[0]:
            blocks.append(block)
            owner.extend([fi] * block.shape[0])
    if not blocks:
        return (np.zeros((0, chunk_len), np.uint8), np.zeros(0, np.int64))
    return np.concatenate(blocks, axis=0), np.asarray(owner)


def _pack_one_py(data: bytes, chunk_len: int, overlap: int) -> np.ndarray:
    stride = max(1, chunk_len - overlap)
    arr = lower_bytes(data)
    rows = []
    for off in range(0, len(arr), stride):
        # skip the final stride only when the previous chunk really
        # covers the whole remaining tail: it spans [off - stride,
        # off - stride + chunk_len), which reaches chunk_len - stride
        # past `off`
        if off > 0 and len(arr) - off <= chunk_len - stride:
            break  # fully covered by the previous chunk
        piece = arr[off:off + chunk_len]
        row = np.zeros(chunk_len, dtype=np.uint8)
        row[:len(piece)] = piece
        rows.append(row)
        if off + chunk_len >= len(arr):
            break
    if not rows:
        return np.zeros((0, chunk_len), np.uint8)
    return np.stack(rows)
