"""Device-side primitives: the version-token compare, hashing, the
candidate-pair advisory join and the secret keyword prefilter, each a
hand-written CUDA kernel beside its plain PyTorch version."""


def next_pow2(n: int, floor: int = 128) -> int:
    """Smallest power of two ≥ max(n, floor)."""
    b = floor
    while b < n:
        b *= 2
    return b


def bucket_size(n: int, floor: int = 128, growth: float = 2.0,
                align: int = 128) -> int:
    """Smallest rung of the geometric bucket ladder ≥ max(n, floor):
    every padded dimension lands on a rung of `floor * growth^k`,
    rounded up to a multiple of `align`. The padded shapes are part of
    the scan's observable contract (hit-buffer sizing, the overflow
    rule), so they follow the JAX package's ladder exactly."""
    if growth <= 1.0:
        raise ValueError(f"bucket growth must be > 1.0, got {growth}")
    b = int(floor)
    while b < n:
        nxt = (int(b * growth) + align - 1) // align * align
        b = max(nxt, b + align)
    return b


def bucket_ladder(max_n: int, floor: int = 128, growth: float = 2.0,
                  align: int = 128) -> list:
    """Every rung of the bucket ladder from `floor` up to the first rung
    ≥ max_n: the dispatch shapes detectd's warmup launches once each."""
    rungs = [int(floor)]
    while rungs[-1] < max_n:
        rungs.append(bucket_size(rungs[-1] + 1, floor, growth, align))
    return rungs
