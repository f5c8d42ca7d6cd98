"""FNV-1a 64-bit hashing for join keys.

Package/advisory rows are joined on hash64(source_bucket + "\\x00" + name);
hash collisions cannot produce false findings because every device hit is
re-verified host-side against the advisory's package-name string during
result assembly (detect/engine.py).

Keys are stored as two biased int32 halves (hi, lo), the layout the JAX
package writes into its saved tables; ordering over (hi, lo) as unsigned
pairs matches uint64 ordering.
"""

from __future__ import annotations

import numpy as np

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK = (1 << 64) - 1


def fnv1a64(data: bytes) -> int:
    h = _FNV_OFFSET
    for b in data:
        h ^= b
        h = (h * _FNV_PRIME) & _MASK
    return h


def key_hash(source: str, name: str) -> int:
    return fnv1a64(source.encode() + b"\x00" + name.encode())


def split_u64(values) -> np.ndarray:
    """uint64 iterable → int32[N, 2] as (hi, lo), order-preserving.

    Each half is biased by -2^31 so that *signed* int32 comparison of the
    halves matches unsigned comparison of the original 32-bit halves.
    """
    v = np.asarray(list(values), dtype=np.uint64)
    hi = (v >> np.uint64(32)).astype(np.int64) - (1 << 31)
    lo = (v & np.uint64(0xFFFFFFFF)).astype(np.int64) - (1 << 31)
    return np.stack([hi, lo], axis=-1).astype(np.int32)
