#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (trivy_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero:

  env      the card's name and power limit (nvidia-smi), the torch and
           CUDA versions, and the kernels' build time (nvcc, sm_90a,
           from trivy_tpu_torch/csrc/, one nvcc per source in parallel).
  ptxas    registers, shared memory, stack and spills of every kernel
           entry, from trivy_tpu_torch/_build/ptxas.log.
  kernels  each CUDA kernel against its plain torch version on the card,
           exact equality (integer outputs, tolerance 0), first on the
           inputs the rootfs scan below hands it ("main_path": the
           scan's padded secret chunk rows, its apk packages' CSR batch
           against the fixture DB), then at scale ("scale"):
             shiftor  B in {64, 4096} rows of 16384 bytes from a numpy
                      seed, keywords planted mid-row, at the last
                      positions of a row and straddling a row end; then
                      the edge banks (1- and 2-byte keywords; a full
                      bank of 128 keywords up to 64 bytes) and the worst
                      case for the two-byte filter (rows of repeated
                      "sh", rows of one 1-byte keyword), each with the
                      share of positions that passed the filter;
             csr_join a bench-shaped advisory table (~200k interval
                      rows, Zipf bucket sizes, one 4000-row bucket)
                      under 100k queries, a tenth on the big bucket.
           Median time from CUDA events beside the plain version's and
           the bound worked out from the shapes. No single PyTorch call
           computes either function, so library_ms is null.
  compact  the compacted join at scale as the detector routes it
           (BatchDetector._launch picks the hit buffer): all four
           outputs against the plain join plus _compact_core, also with
           a small hit buffer that overflows; timed in turns against a
           yardstick, the dense kernel plus the torch _compact_core
           (and that epilogue alone).
  detect   this slice's own path: BatchDetector.detect at scale on
           queries with few hits, so the compacted kernel serves it;
           launch counts set to 0 before and read after, the hits
           equal to assembling the plain join's bits.
  rootfs   the main path: `python -m trivy_tpu_torch rootfs` (a
           subprocess, vuln + secret scanners) over a generated Alpine
           3.17 rootfs with 8+ MiB of text. Expects the 5 fixture CVEs,
           exactly the planted secrets, and both kernels launched.

Then the kernel table as one JSON line (main-path shapes, with the
largest scale case under "at_scale"; the compacted join at its own
path's shapes), the card's name and power limit, and as the last line
{"ok": true, "device": {...}}. Exits non-zero without a result when
there is no CUDA device or no port beside it.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s, and the INT32
# instruction rate the shift-or's logic ops and compares issue on:
# 132 SMs x 64 INT32 lanes x 1.98 GHz boost clock
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# the two-byte filter's INT32 work per position: form the bigram, index
# the bitmap word, test and gather its bit
FILTER_OPS_PER_POSITION = 3

ALPINE_OS_RELEASE = b"""\
NAME="Alpine Linux"
ID=alpine
VERSION_ID=3.17.3
PRETTY_NAME="Alpine Linux v3.17"
"""

APK_INSTALLED = b"""\
C:Q1pSXsQcqlY5clcXDHVqZBBIfPzg4=
P:musl
V:1.2.3-r4
A:x86_64
T:the musl c library (libc) implementation
o:musl
m:Timo Teras <timo.teras@iki.fi>
L:MIT

C:Q1poBWwSMyhbfAgVmGAgSqd1bYKTA=
P:libcrypto3
V:3.0.7-r0
A:x86_64
o:openssl
m:Ariadne Conill <ariadne@dereferenced.org>
L:Apache-2.0
D:so:libc.musl-x86_64.so.1

C:Q1QKYkcqhL4XqhVFQnyFyyFyQ5EJo=
P:libssl3
V:3.0.7-r0
A:x86_64
o:openssl
L:Apache-2.0

C:Q1apkZXhAbeCZgOlWTACfe9eCM8Co=
P:zlib
V:1.2.13-r0
A:x86_64
o:zlib
L:Zlib
"""

KERNELS = (
    ("shiftor", "trivy_tpu_torch/csrc/shiftor.cu",
     "trivy_tpu/ops/shiftor_pallas.py:82"),
    ("csr_join", "trivy_tpu_torch/csrc/csr_join.cu",
     "trivy_tpu/ops/join.py:81"),
    ("csr_join_compact", "trivy_tpu_torch/csrc/csr_join.cu",
     "trivy_tpu/ops/join.py:159"),
)

EXPECTED_VULNS = {
    ("libcrypto3", "CVE-2023-0286"), ("libcrypto3", "CVE-2023-2650"),
    ("libssl3", "CVE-2023-0286"), ("libssl3", "CVE-2023-2650"),
    ("musl", "CVE-2025-26519"),
}

# corpus files whose near-miss content the builtin rules reject: they
# gate rules through the prefilter without producing findings
CLEAN_CORPUS = ("invalid-aws-secrets.txt", "multi-line.txt", "secret.txt")

# filler vocabulary: common words plus lowercase fragments of keywords,
# so the prefilter flags rows whose regexes then find nothing
_WORDS = ("the config value return import token secret password key "
          "session client server akia ghp xoxb private access aws github "
          "slack header build stage layer cache update install").split()


def phase(name: str, **kw) -> None:
    print(json.dumps({"phase": name, **kw}), flush=True)


def _token(rng, alphabet: str, n: int) -> str:
    return "".join(alphabet[i] for i in rng.integers(0, len(alphabet), n))


def make_rootfs(root: str, seed: int = SEED, filler_mib: int = 8) -> set:
    """Write an Alpine 3.17 rootfs with `filler_mib` MiB of text and a
    few planted tokens → the expected {(path, rule id)} secrets."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "etc"), exist_ok=True)
    os.makedirs(os.path.join(root, "lib/apk/db"), exist_ok=True)
    os.makedirs(os.path.join(root, "srv/app"), exist_ok=True)
    with open(os.path.join(root, "etc/os-release"), "wb") as f:
        f.write(ALPINE_OS_RELEASE)
    with open(os.path.join(root, "lib/apk/db/installed"), "wb") as f:
        f.write(APK_INSTALLED)
    corpus_dir = os.path.join(REPO, "tests", "secret_corpus")
    for name in CLEAN_CORPUS:
        shutil.copy(os.path.join(corpus_dir, name),
                    os.path.join(root, "srv/app", name))
    words = np.array(_WORDS)
    per_file = 1 << 20
    for i in range(filler_mib):
        text = " ".join(words[rng.integers(0, len(words), per_file // 5)])
        lines = [text[j:j + 90] for j in range(0, len(text), 90)]
        with open(os.path.join(root, f"srv/app/log{i:02d}.txt"), "w") as f:
            f.write("\n".join(lines)[:per_file] + "\n")
    upper = "ABCDEFGHIJKLMNOPQRSTUVWXYZ234567"
    alnum = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
    planted = {
        "srv/app/deploy.env": (
            f"AWS_ACCESS_KEY_ID=AKIA{_token(rng, upper, 16)}\n",
            "aws-access-key-id"),
        "srv/app/ci.yml": (
            f"steps:\n  - run: push\n    token: ghp_{_token(rng, alnum, 36)}\n",
            "github-pat"),
        "srv/app/notify.sh": (
            f"curl -H 'Authorization: Bearer xoxb-{_token(rng, alnum, 24)}'"
            " https://slack.com/api/chat.postMessage\n",
            "slack-access-token"),
    }
    for rel, (text, _rule) in planted.items():
        with open(os.path.join(root, rel), "w") as f:
            f.write(text)
    return {(rel, rule) for rel, (_text, rule) in planted.items()}


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of fn() over `reps` runs, CUDA events, after
    one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def looped_ms(fn, loops: int = 20, reps: int = 5) -> float:
    """Milliseconds per call of `loops` back-to-back calls between one
    pair of CUDA events (median of `reps`): the host enqueues the next
    call while the card runs the last, so this is the card's time per
    call unless the host is slower."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(loops):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / loops)
    return statistics.median(times)


def shiftor_inputs(rng, bank, rows: int, length: int) -> np.ndarray:
    """Lowercase text-like rows with keywords planted mid-row, ending at
    a row's last byte, and cut off by a row end."""
    alphabet = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz .,=_-/\n0123456789",
                             np.uint8)
    chunks = alphabet[rng.integers(0, len(alphabet), (rows, length))]
    kws = bank.kw_bytes
    for r in range(rows):
        for _ in range(int(rng.integers(0, 4))):
            kw = kws[int(rng.integers(0, len(kws)))]
            p = int(rng.integers(0, length - len(kw)))
            chunks[r, p:p + len(kw)] = np.frombuffer(kw, np.uint8)
        kw = kws[int(rng.integers(0, len(kws)))]
        if r % 3 == 0:      # ends exactly at the row's last byte
            chunks[r, length - len(kw):] = np.frombuffer(kw, np.uint8)
        elif r % 3 == 1 and len(kw) > 1:   # straddles the row end
            cut = int(rng.integers(1, len(kw)))
            chunks[r, length - cut:] = np.frombuffer(kw[:cut], np.uint8)
            if r + 1 < rows:
                chunks[r + 1, :len(kw) - cut] = \
                    np.frombuffer(kw[cut:], np.uint8)
    return chunks


def filter_share(torch, x, cand) -> float:
    """Share of the positions of uint8[B, L] rows on the card whose
    bigram (0 past the row end) has candidate lanes in the index: the
    positions that pass the two-byte filter."""
    present = (cand != 0).any(dim=1)
    nxt = torch.nn.functional.pad(x[:, 1:], (0, 1))
    g = x.long() | (nxt.long() << 8)
    return float(present[g].float().mean())


def shiftor_case(torch, bank, chunks: np.ndarray, label: str,
                 host_check: bool = False, reps: int = 20) -> dict:
    """Kernel against plain (and optionally bytes.find) on these rows;
    → the measurement."""
    from trivy_tpu_torch.ops import shiftor as so
    packed = so.pack_bank(bank)
    bank_dev = [torch.from_numpy(a).cuda() for a in packed]
    index = tuple(torch.from_numpy(a).cuda() for a in so.bank_index(*packed))
    rows, length = chunks.shape
    x = torch.from_numpy(np.ascontiguousarray(chunks)).cuda()

    def kernel():
        return so.shiftor_cuda(*bank_dev, x, n_words=bank.words,
                               index=index)

    def plain():
        return so.shiftor_plain(*bank_dev, x, n_words=bank.words)
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"shiftor != plain ({label}, B={rows}): "
                             f"{int((got != want).sum())} words differ")
    if host_check:
        host = np.zeros((rows, bank.words), np.int64)
        for r in range(rows):
            data = chunks[r].tobytes()
            for k, kw in enumerate(bank.kw_bytes):
                if kw in data:
                    host[r, k // 32] |= 1 << (k % 32)
        if not np.array_equal(got.cpu().numpy().view(np.uint32), host):
            raise AssertionError(f"shiftor != bytes.find ({label})")
    share = filter_share(torch, x, index[1])
    ms = cuda_ms(kernel, reps)
    loop_ms = looped_ms(kernel)
    plain_ms = cuda_ms(plain, 2)
    # the function's inputs (the rows, pack_bank's arrays) read once, its
    # output written once; the index is this design's own derived input
    n_bytes = rows * length + sum(a.nbytes for a in packed) + \
        rows * bank.words * 4
    # the filter's INT32 work at every position; the verify work of the
    # positions that pass is left out, so the floor is a lower bound
    ops = FILTER_OPS_PER_POSITION * rows * length
    by_ops = ops / INT32_OPS_PER_S > n_bytes / HBM_BYTES_PER_S
    bound = max(n_bytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3
    # a brute-force shift-or's bound, kept for comparison: one word-0
    # test (two INT32 instructions) per position and keyword
    brute = 2 * rows * length * bank.n_keywords / INT32_OPS_PER_S * 1e3
    phase("kernels", kernel="shiftor", at=label, rows=rows, length=length,
          keywords=bank.n_keywords, state_words=bank.state_words,
          filter_pass_share=share, equal=True, max_abs_err=err, ms=ms,
          looped_ms=loop_ms, plain_ms=plain_ms, bound_ms=bound,
          bound_by="operations" if by_ops else "bytes",
          brute_force_bound_ms=brute)
    return {"max_abs_err": err, "ms": ms, "looped_ms": loop_ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations" if by_ops else "bytes",
            "library_ms": None, "shape": [rows, length],
            "filter_pass_share": share, "brute_force_bound_ms": brute}


def join_inputs(torch, table, det, prep) -> tuple:
    """→ (the join's positional arguments through total, prefix planes)
    for one prepared batch, as BatchDetector._launch builds them."""
    lo, hi, flags, lo_pre, hi_pre = table.device_arrays(torch.device("cuda"))
    ver = det._ver_device(prep.u_pad)
    qs, qc, qv = (torch.from_numpy(a).cuda()
                  for a in (prep.q_start, prep.q_count, prep.q_ver))
    return (lo, hi, flags, ver, qs, qc, qv, prep.n_pairs), (lo_pre, hi_pre)


def join_bytes(args, out_bytes: int) -> int:
    """The join's inputs (token vectors, flags, version pool, CSR
    descriptors) read once, its outputs written once. The prefix planes
    are this design's own copy of the token vectors, so they are left
    out."""
    return sum(t.numel() * t.element_size() for t in args[:7]) + out_bytes


def join_case(torch, table, det, prep, label: str) -> dict:
    """Kernel against plain on one prepared batch; → the measurement."""
    from trivy_tpu_torch.ops import join as J
    t_pad = prep.t_pad
    args, prefix = join_inputs(torch, table, det, prep)

    def kernel():
        return J.csr_join_cuda(*args, t_pad, prefix=prefix)
    got = kernel()
    want = J.csr_pair_join_plain(*args, t_pad)
    torch.cuda.synchronize()
    err = int((got.int() - want.int()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"csr_join != plain ({label}): "
                             f"{int((got != want).sum())} slots differ")
    ms = cuda_ms(kernel, 20)
    loop_ms = looped_ms(kernel)
    plain_ms = cuda_ms(lambda: J.csr_pair_join_plain(*args, t_pad), 2)
    bound = join_bytes(args, t_pad) / HBM_BYTES_PER_S * 1e3
    phase("kernels", kernel="csr_join", at=label, rows=len(table),
          queries=prep.n_queries, pairs=prep.n_pairs, t_pad=t_pad,
          hits=int((got != 0).sum()), equal=True, max_abs_err=err, ms=ms,
          looped_ms=loop_ms, plain_ms=plain_ms, bound_ms=bound)
    return {"max_abs_err": err, "ms": ms, "looped_ms": loop_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": None,
            "shape": [len(table), prep.n_queries, t_pad]}


def check_main_path_shapes(torch, root: str) -> dict:
    """The kernels on the very inputs the rootfs scan hands them: the
    deduplicated, padded chunk rows of its secret candidates, and the
    CSR batch of its apk packages against the fixture DB."""
    from trivy_tpu_torch.__main__ import load_table
    from trivy_tpu_torch.detect.engine import BatchDetector
    from trivy_tpu_torch.detect.ospkg import OspkgScanner
    from trivy_tpu_torch.fanal.analyzers import AnalyzerGroup
    from trivy_tpu_torch.fanal.applier import apply_blob
    from trivy_tpu_torch.fanal.walker import blob_info, walk_fs
    from trivy_tpu_torch.ops import ac, next_pow2
    from trivy_tpu_torch.secret.engine import CHUNK_LEN, SecretScanner
    scan = walk_fs(root, AnalyzerGroup(), collect_secrets=True)
    bank = SecretScanner(device="cuda")._bank
    chunks, _ = ac.pack_chunks([c for _, c in scan.secret_files],
                               CHUNK_LEN, bank.max_kw_len - 1)
    chunks = np.unique(chunks, axis=0)
    padded = np.zeros((next_pow2(chunks.shape[0], floor=64), CHUNK_LEN),
                      np.uint8)
    padded[:chunks.shape[0]] = chunks
    shiftor = shiftor_case(torch, bank, padded, "main_path")
    table = load_table(os.path.join(REPO, "tests/fixtures/db/*.yaml"))
    det = BatchDetector(table, device="cuda")
    detail = apply_blob(blob_info(scan))
    queries, _finish = OspkgScanner(det).prepare(
        detail.os, detail.repository, detail.packages)
    join = join_case(torch, table, det, det._prepare(queries), "main_path")
    return {"shiftor": shiftor, "csr_join": join}


def check_shiftor_at_scale(torch, rng) -> dict:
    from trivy_tpu_torch.secret import SecretScanner
    bank = SecretScanner(device="cuda")._bank
    out = None
    for rows in (64, 4096):
        out = shiftor_case(torch, bank,
                           shiftor_inputs(rng, bank, rows, 16384),
                           "scale", host_check=rows == 64)
    return out


EDGE_KEYWORDS = (b"a", b"z", b"=", b"sk", b"sh", b"key", b"shpat_", b"a1",
                 b"zz", b"token")


def check_shiftor_edges(torch, rng) -> list:
    """The edge banks and the filter's worst case, 1024 rows each."""
    from trivy_tpu_torch.ops import ac
    from trivy_tpu_torch.secret import SecretScanner
    builtin = SecretScanner(device="cuda")._keywords
    full = list(builtin)
    alphabet = b"abcdefghijklmnopqrstuvwxyz_-=.0123456789"
    while len(full) < 128:   # to 128 keywords, the longest 64 bytes
        n = 64 if len(full) == 127 else int(rng.integers(1, 65))
        kw = bytes(alphabet[i] for i in rng.integers(0, len(alphabet), n))
        if kw not in full:
            full.append(kw)
    edge_bank = ac.build_literal_bank(list(EDGE_KEYWORDS))
    full_bank = ac.build_literal_bank(full)
    rows, length = 1024, 16384
    cases = [
        (edge_bank, shiftor_inputs(rng, edge_bank, rows, length),
         "edge_bank_1_and_2_byte"),
        (full_bank, shiftor_inputs(rng, full_bank, rows, length),
         "full_bank_128"),
        (ac.build_literal_bank(builtin),
         np.frombuffer(b"sh" * (rows * length // 2), np.uint8)
         .reshape(rows, length).copy(), "worst_case_sh_rows"),
        (edge_bank, np.full((rows, length), ord("a"), np.uint8),
         "worst_case_1_byte_rows"),
    ]
    out = []
    for bank, chunks, label in cases:
        res = shiftor_case(torch, bank, chunks, label, reps=10)
        out.append({"at": label, **res})
    return out


def _synth_versions(rng, n=2000, major_lo=0, major_hi=9):
    out = []
    for _ in range(n):
        v = (f"{rng.integers(major_lo, major_hi + 1)}."
             f"{rng.integers(0, 31)}.{rng.integers(0, 31)}")
        r = rng.random()
        if r < 0.15:
            v += f"_p{rng.integers(1, 10)}"
        elif r < 0.3:
            v += ["_rc1", "_git20230101", "a"][int(rng.integers(0, 3))]
        v += f"-r{rng.integers(0, 21)}"
        out.append(v)
    return out


def _scale_queries(rng, n_names: int, versions: list, n_q: int = 100_000):
    from trivy_tpu_torch.detect.engine import PkgQuery
    names = rng.integers(0, n_names, n_q)
    skew = rng.random(n_q) < 0.1
    vers = rng.integers(0, len(versions), n_q)
    return [PkgQuery(source="alpine 3.19", ecosystem="alpine",
                     name="linux-lts" if skew[i] else f"pkg{names[i]:05d}",
                     version=versions[vers[i]]) for i in range(n_q)]


def scale_join_setup(torch, rng):
    """The bench-shaped table and its 100k queries → (table, queries,
    n_names)."""
    from trivy_tpu_torch.db.table import RawAdvisory, build_table
    fixed = _synth_versions(rng, major_lo=0, major_hi=6)
    installed = _synth_versions(rng, major_lo=4, major_hi=9)
    n_names = 30_000
    bucket = np.clip(rng.zipf(1.7, n_names), 1, 64)
    pick = rng.integers(0, len(fixed), int(bucket.sum()) + 4000)
    raw, c = [], 0
    for i in range(n_names):
        for j in range(int(bucket[i])):
            raw.append(RawAdvisory(
                source="alpine 3.19", ecosystem="alpine",
                pkg_name=f"pkg{i:05d}", vuln_id=f"CVE-2024-{i % 10000:04d}-{j}",
                fixed_version=fixed[pick[c]]))
            c += 1
    for j in range(4000):   # the linux-style bucket
        raw.append(RawAdvisory(
            source="alpine 3.19", ecosystem="alpine", pkg_name="linux-lts",
            vuln_id=f"CVE-2019-{j:05d}", fixed_version=fixed[pick[c]]))
        c += 1
    table = build_table(raw)
    return table, _scale_queries(rng, n_names, installed), n_names


def check_compact_at_scale(torch, table, det, prep) -> dict:
    """The compacted join where the detector's routing engages it: all
    four outputs against the plain join plus _compact_core, at the
    detector's hit buffer and at one that overflows; timed in turns
    against the dense kernel plus the torch _compact_core."""
    from trivy_tpu_torch.detect.engine import _PendingCompact
    from trivy_tpu_torch.ops import join as J
    t_pad = prep.t_pad

    def launch(h_cap=None):
        return det._launch(prep.q_start, prep.q_count, prep.q_ver,
                           prep.n_queries, prep.n_pairs, t_pad, prep.u_pad,
                           h_cap)
    pend = launch()
    if not isinstance(pend, _PendingCompact):
        raise AssertionError("the detector kept the scale batch dense")
    args, prefix = join_inputs(torch, table, det, prep)
    bits = J.csr_pair_join_plain(*args, t_pad)
    err, n_hits = 0, {}
    for out in (pend, launch(1024)):
        got = (out.hit_idx, out.hit_bits, out.n_hits, out.dense)
        want = J._compact_core(bits, out.h_cap) + (bits,)
        for name, g, w in zip(("hit_idx", "hit_bits", "n_hits", "bits"),
                              got, want):
            if g.dtype != w.dtype or not torch.equal(g, w):
                raise AssertionError(
                    f"csr_join_compact {name} != plain (h_cap {out.h_cap})")
            err = max(err, int((g.long() - w.long()).abs().max())
                      if g.numel() else 0)
        n_hits[out.h_cap] = int(out.n_hits)
    if n_hits[1024] <= 1024:
        raise AssertionError("the overflow case did not overflow")
    h_cap = pend.h_cap

    def kernel():
        return J.csr_join_compact_cuda(*args, t_pad, h_cap, prefix=prefix)

    def yardstick():
        return J._compact_core(J.csr_join_cuda(*args, t_pad, prefix=prefix),
                               h_cap)
    ms, yard_ms = [], []
    for _ in range(3):   # in turns: yardstick, kernel, kernel, yardstick
        yard_ms.append(cuda_ms(yardstick, 10))
        ms += [cuda_ms(kernel, 10), cuda_ms(kernel, 10)]
        yard_ms.append(cuda_ms(yardstick, 10))
    ms, yard_ms = statistics.median(ms), statistics.median(yard_ms)
    loop_ms, loop_yard_ms = looped_ms(kernel, 10), looped_ms(yardstick, 10)
    plain_ms = cuda_ms(lambda: J._compact_core(
        J.csr_pair_join_plain(*args, t_pad), h_cap), 2)
    # the torch epilogue alone, as it ran after the dense kernel before
    # the compaction was fused in
    torch_compact_ms = cuda_ms(lambda: J._compact_core(bits, h_cap), 10)
    bound = join_bytes(args, t_pad + 5 * h_cap + 4) \
        / HBM_BYTES_PER_S * 1e3
    phase("compact", at="scale", rows=len(table), queries=prep.n_queries,
          pairs=prep.n_pairs, t_pad=t_pad, h_cap=h_cap, n_hits=n_hits,
          equal=True, max_abs_err=err, ms=ms, yardstick_ms=yard_ms,
          looped_ms=loop_ms, yardstick_looped_ms=loop_yard_ms,
          torch_compact_ms=torch_compact_ms, plain_ms=plain_ms,
          bound_ms=bound)
    if not ms < yard_ms:
        raise AssertionError(f"compacted join {ms} ms is not faster than "
                             f"the dense kernel + torch compaction "
                             f"{yard_ms} ms")
    return {"max_abs_err": err, "ms": ms, "looped_ms": loop_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
            "library_ms": None, "yardstick_ms": yard_ms,
            "yardstick_looped_ms": loop_yard_ms,
            "torch_compact_ms": torch_compact_ms,
            "shape": [len(table), prep.n_queries, t_pad, h_cap]}


def run_detect_path(torch, table, queries) -> dict:
    """BatchDetector.detect at scale with launch counts set to 0 just
    before and read just after; its hits against the plain join's bits
    assembled by the same detector → the counts."""
    from trivy_tpu_torch.__main__ import launch_counts
    from trivy_tpu_torch.detect.engine import BatchDetector
    from trivy_tpu_torch.ops import join as J
    from trivy_tpu_torch.ops import shiftor as so
    det = BatchDetector(table, device="cuda")
    for fn in (J.csr_join_cuda, J.csr_join_compact_cuda, so.shiftor_cuda):
        fn.launches = 0
    t0 = time.perf_counter()
    hits = det.detect(queries)
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    if launches["csr_join_compact"] < 1:
        raise AssertionError(f"the compacted join did not serve the "
                             f"detector: {launches}")
    prep = det._prepare(queries)
    args, _prefix = join_inputs(torch, table, det, prep)
    bits = J.csr_pair_join_plain(*args, prep.t_pad).cpu().numpy()
    want = det._assemble(prep, bits)

    def keys(hs):
        return [(h.query.name, h.query.version, h.vuln_id) for h in hs]
    if not hits or keys(hits) != keys(want):
        raise AssertionError(f"detect at scale: {len(hits)} hits, the "
                             f"plain join's bits give {len(want)}")
    phase("detect", at="scale", queries=len(queries), pairs=prep.n_pairs,
          t_pad=prep.t_pad, hits=len(hits), wall_s=wall_s,
          launches=launches)
    return launches


def ptxas_report() -> dict:
    """Registers, shared memory, stack and spills of each kernel entry
    from the build's ptxas log."""
    import re
    from trivy_tpu_torch.ops import kernels
    out, name = {}, None
    with open(os.path.join(kernels.BUILD_DIR, "ptxas.log")) as f:
        for line in f:
            m = re.search(r"entry function '(\w+)'", line)
            if m:
                name = re.sub(r"^.*\d", "",
                              re.sub(r"E[A-Za-z0-9_]*$", "", m.group(1)))
                out[name] = {}
                continue
            for key, pat in (("registers", r"Used (\d+) registers"),
                             ("smem_bytes", r"(\d+) bytes smem"),
                             ("stack_bytes", r"(\d+) bytes stack frame"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads")):
                m = re.search(pat, line)
                if m and name:
                    out[name][key] = int(m.group(1))
    return out


def run_rootfs(root: str, expected_secrets: set) -> dict:
    """The main path through the user's entry point, in a fresh process
    (so its launch counts start at 0) → its launch counts."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "trivy_tpu_torch", "rootfs", root,
         "--db", os.path.join(REPO, "tests/fixtures/db/*.yaml"),
         "--scanners", "vuln,secret", "--format", "json",
         "--debug-launches"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    wall_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"rootfs scan failed ({proc.returncode}):"
                             f"\n{proc.stderr[-4000:]}")
    counts = json.loads(proc.stderr.strip().splitlines()[-1])
    report = json.loads(proc.stdout)
    vulns, secrets = set(), set()
    for res in report.get("Results", []):
        for v in res.get("Vulnerabilities", []):
            vulns.add((v["PkgName"], v["VulnerabilityID"]))
        for s in res.get("Secrets", []):
            secrets.add((res["Target"], s["RuleID"]))
    if vulns != EXPECTED_VULNS:
        raise AssertionError(f"vulnerabilities {sorted(vulns)}")
    if secrets != expected_secrets:
        raise AssertionError(f"secrets {sorted(secrets)} != planted "
                             f"{sorted(expected_secrets)}")
    launches = counts["launches"]
    if not (launches["shiftor"] > 0 and launches["csr_join"] > 0):
        raise AssertionError(f"a kernel did not run on the main path: "
                             f"{launches}")
    if counts["prefilter_path"] != {"cuda": 1}:
        raise AssertionError(f"prefilter paths {counts['prefilter_path']}")
    phase("rootfs", wall_s=wall_s, vulnerabilities=len(vulns),
          secrets=sorted(secrets), launches=launches,
          prefilter_path=counts["prefilter_path"])
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "trivy_tpu_torch")):
        print("chip_smoke: trivy_tpu_torch is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from trivy_tpu_torch.ops import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kernels.library()
    phase("env", gpu=smi, torch=torch.__version__, cuda=torch.version.cuda,
          kernel_build_s=kernels.build_seconds)
    phase("ptxas", kernels=ptxas_report())
    from trivy_tpu_torch.detect.engine import BatchDetector

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        root = os.path.join(tmp, "rootfs")
        expected_secrets = make_rootfs(root)
        at_main = check_main_path_shapes(torch, root)
        rng = np.random.default_rng(SEED)
        at_scale = {"shiftor": check_shiftor_at_scale(torch, rng)}
        table, queries, n_names = scale_join_setup(torch, rng)
        det = BatchDetector(table, device="cuda")
        prep = det._prepare(queries)
        at_scale["csr_join"] = join_case(torch, table, det, prep, "scale")
        compact = check_compact_at_scale(torch, table, det, prep)
        # this slice's path: installed versions mostly past every fix, so
        # the hits fit the detector's hit buffer
        few_hits = _scale_queries(
            rng, n_names, _synth_versions(rng, 1900, 7, 9)
            + _synth_versions(rng, 100, 4, 9))
        detect_launches = run_detect_path(torch, table, few_hits)
        edges = check_shiftor_edges(torch, np.random.default_rng(SEED + 1))
        launches = run_rootfs(root, expected_secrets)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rows = []
    for name, source, replaces in KERNELS[:2]:
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     **at_main[name], "at_scale": at_scale[name]})
    rows[0]["edge_cases"] = edges
    name, source, replaces = KERNELS[2]
    rows.append({"name": name, "route": "cuda", "source": source,
                 "replaces": replaces,
                 "launches": detect_launches[name], **compact})
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
