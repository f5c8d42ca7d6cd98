"""The port's CUDA kernels on the card: each against its plain torch
version, exact equality, at small shapes; and the detector and secret
scanner on CUDA against the same objects on the CPU. Marked `cuda`:
they skip without a GPU. On a machine with one:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from trivy_tpu_torch.ops import ac
from trivy_tpu_torch.ops import join as J
from trivy_tpu_torch.ops import shiftor as so

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _keywords():
    from trivy_tpu_torch.secret import SecretScanner
    return SecretScanner(device="cpu")._keywords


def _edge_keywords():
    """1-byte and 2-byte keywords beside longer ones sharing their
    first bytes."""
    return [b"a", b"z", b"=", b"sk", b"sh", b"key", b"shpat_", b"a1",
            b"zz", b"token"]


def _full_keywords():
    """128 keywords: the built-in bank plus random ones of 1 to 64
    bytes (16 state words)."""
    rng = np.random.default_rng(128)
    kws = list(_keywords())
    alphabet = b"abcdefghijklmnopqrstuvwxyz_-=.0123456789"
    while len(kws) < 128:
        n = 64 if len(kws) == 127 else int(rng.integers(1, 65))
        kw = bytes(alphabet[i] for i in rng.integers(0, len(alphabet), n))
        if kw not in kws:
            kws.append(kw)
    return kws


def _shiftor_equal(cuda, bank, chunks):
    x = torch.from_numpy(chunks).to(cuda)
    packed = so.pack_bank(bank)
    arrays = [torch.from_numpy(a).to(cuda) for a in packed]
    index = tuple(torch.from_numpy(a).to(cuda)
                  for a in so.bank_index(*packed))
    before = so.shiftor_cuda.launches
    got = so.shiftor(*arrays, x, n_words=bank.words, index=index)
    want = so.shiftor_plain(*arrays, x, n_words=bank.words)
    assert torch.equal(got, want)
    assert so.shiftor_cuda.launches == before + 1
    return got


def _planted(bank, rows, length, seed):
    rng = np.random.default_rng(seed)
    chunks = rng.integers(0, 256, (rows, length), dtype=np.uint8)
    chunks[0, :64] = 0xFF
    for i, kw in enumerate(bank.kw_bytes):
        r, off = i % rows, int(rng.integers(0, length - len(kw) + 1))
        chunks[r, off:off + len(kw)] = np.frombuffer(kw, np.uint8)
    kw = bank.kw_bytes[-1]
    chunks[-1, length - len(kw):] = np.frombuffer(kw, np.uint8)
    return ac.lower_bytes(chunks.tobytes()).reshape(rows, length)


@pytest.mark.parametrize("rows,length", [(64, 16384), (3, 4096), (1, 64)])
def test_shiftor_kernel_equals_plain(cuda, rows, length):
    bank = ac.build_literal_bank(_keywords())
    _shiftor_equal(cuda, bank, _planted(bank, rows, length, rows))


@pytest.mark.parametrize("keywords", [_edge_keywords, _full_keywords])
@pytest.mark.parametrize("rows,length", [(8, 16384), (5, 8208), (2, 80)])
def test_shiftor_edge_banks_equal_plain(cuda, keywords, rows, length):
    bank = ac.build_literal_bank(keywords())
    assert bank.n_keywords <= 128
    chunks = _planted(bank, rows, length, length)
    # 1-byte keywords at a row's last byte, longer ones cut by it
    chunks[0, -1] = ord("z")
    chunks[1 % rows, -3:] = np.frombuffer(b"tok", np.uint8)
    got = _shiftor_equal(cuda, bank, chunks)
    assert got.any()


def test_shiftor_worst_case_filter_input(cuda):
    """Every position passes the filter: rows of repeated first bytes."""
    bank = ac.build_literal_bank(_keywords())
    chunks = np.frombuffer(b"sh" * (4 * 16384), np.uint8).reshape(8, -1)
    _shiftor_equal(cuda, bank, chunks.copy())
    bank = ac.build_literal_bank(_edge_keywords())
    chunks = np.full((4, 16384), ord("a"), np.uint8)
    assert _shiftor_equal(cuda, bank, chunks).any()


def _cuda_join_args(cuda, lo, hi, flags, ver, qs, qc, qv):
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in (lo, hi, flags, ver, qs, qc, qv)]
    return args, J.prefix_planes(*args[:2])


def _compact_equal(args, prefix, total, t_pad, h_cap):
    before = J.csr_join_compact_cuda.launches
    got = J.csr_pair_join_compact(*args, total, t_pad, h_cap, prefix=prefix)
    assert J.csr_join_compact_cuda.launches == before + 1
    bits = J.csr_pair_join_plain(*args, total, t_pad)
    want = J._compact_core(bits, h_cap) + (bits,)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
    return int(got[2])


def _hit_pattern_case(cuda, hit_slots, total):
    """One query over rows 0..total-1, so slot i evaluates row i: rows
    in `hit_slots` have no bounds (SATISFIED), the rest a lower bound
    above the installed version (a miss)."""
    k = 40
    lo = np.full((total, k), 1, np.int32)
    lo[:, 0] = 5
    hi = np.full((total, k), 1, np.int32)
    flags = np.full(total, J.HAS_LO, np.int32)
    flags[np.asarray(hit_slots, np.int64)] = 0
    ver = np.full((4, k), 1, np.int32)
    qs = np.zeros(64, np.int32)
    qc = np.zeros(64, np.int32)
    qc[0] = total
    return _cuda_join_args(cuda, lo, hi, flags, ver, qs, qc,
                           np.zeros(64, np.int32))


@pytest.mark.parametrize("case", ["none", "cap", "cap+1", "ends", "dense"])
def test_compaction_edges(cuda, case):
    total, t_pad, h_cap = 3000, 4096, 256  # total is no multiple of a tile
    rng = np.random.default_rng(7)
    hits = {"none": [], "ends": [0, total - 1],
            "cap": rng.choice(total, h_cap, replace=False),
            "cap+1": rng.choice(total, h_cap + 1, replace=False),
            "dense": np.arange(total)}[case]
    args, prefix = _hit_pattern_case(cuda, hits, total)
    n = _compact_equal(args, prefix, total, t_pad, h_cap)
    assert n == len(hits)


@pytest.mark.parametrize("seed", [0, 1])
def test_compaction_many_tiles(cuda, seed):
    """~100 tiles of look-back, long prefix ties, clamped bucket tails."""
    rng = np.random.default_rng(seed)
    n_rows, k, n_q = 3000, 40, 2000
    lo = rng.integers(0, 3, (n_rows, k)).astype(np.int32)
    hi = rng.integers(0, 3, (n_rows, k)).astype(np.int32)
    ver = rng.integers(0, 3, (64, k)).astype(np.int32)
    lo[:, :6] = hi[:, :6] = ver[:, :6] = 1   # ties past the prefix planes
    flags = rng.integers(0, 64, n_rows).astype(np.int32)
    qc = np.zeros(2048, np.int32)
    qc[:n_q] = rng.integers(1, 100, n_q)
    qs = np.zeros(2048, np.int32)
    qs[:n_q] = rng.integers(0, n_rows, n_q)
    qv = np.zeros(2048, np.int32)
    qv[:n_q] = rng.integers(0, 64, n_q)
    total = int(qc.sum())
    args, prefix = _cuda_join_args(cuda, lo, hi, flags, ver, qs, qc, qv)
    t_pad = 1 << int(np.ceil(np.log2(total)))
    for h_cap in (1 << 20, 4096):
        assert _compact_equal(args, prefix, total, t_pad, h_cap) > 4096
    dense = J.csr_pair_join(*args, total, t_pad, prefix=prefix)
    assert torch.equal(dense, J.csr_pair_join_plain(*args, total, t_pad))


@pytest.mark.parametrize("counts", ["zero_inside", "short_buckets"])
def test_tile_of_many_queries(cuda, counts):
    """More queries in a tile than it stages: zero-count queries inside
    the data put more queries than slots in a tile (the starts are then
    searched in global memory), and buckets of one to three rows put
    more than the 256 whose row base and version a tile stages (those
    are then read from global memory)."""
    n_rows, k = 50, 40
    rng = np.random.default_rng(2)
    lo = rng.integers(0, 3, (n_rows, k)).astype(np.int32)
    hi = rng.integers(0, 3, (n_rows, k)).astype(np.int32)
    ver = rng.integers(0, 3, (8, k)).astype(np.int32)
    lo[:, :4] = hi[:, :4] = ver[:, :4] = 1   # ties past the prefix planes
    flags = rng.integers(0, 64, n_rows).astype(np.int32)
    qc = np.zeros(4096, np.int32)
    if counts == "zero_inside":
        qc[::3] = 1
    else:
        qc[:3000] = rng.integers(1, 4, 3000)
    qs = rng.integers(0, n_rows, 4096).astype(np.int32)
    qv = rng.integers(0, 8, 4096).astype(np.int32)
    total = int(qc.sum())
    args, prefix = _cuda_join_args(cuda, lo, hi, flags, ver, qs, qc, qv)
    t_pad = 1 << int(np.ceil(np.log2(total)))
    _compact_equal(args, prefix, total, t_pad, 512)
    assert torch.equal(J.csr_pair_join(*args, total, t_pad, prefix=prefix),
                       J.csr_pair_join_plain(*args, total, t_pad))


def test_csr_join_kernel_equals_plain(cuda):
    rng = np.random.default_rng(3)
    n_rows, k, n_q = 500, 40, 100
    lo = rng.integers(0, 3, (n_rows, k)).astype(np.int32)
    hi = rng.integers(0, 3, (n_rows, k)).astype(np.int32)
    ver = rng.integers(0, 3, (32, k)).astype(np.int32)
    flags = rng.integers(0, 64, n_rows).astype(np.int32)
    qc = np.zeros(128, np.int32)
    qc[:n_q] = rng.integers(1, 30, n_q)
    qs = np.zeros(128, np.int32)
    qs[:n_q] = rng.integers(0, n_rows, n_q)   # tails past the table clamp
    qv = np.zeros(128, np.int32)
    qv[:n_q] = rng.integers(0, 32, n_q)
    total = int(qc.sum())
    args, prefix = _cuda_join_args(cuda, lo, hi, flags, ver, qs, qc, qv)
    for t_pad in (4096, total):
        got = J.csr_pair_join(*args, total, t_pad, prefix=prefix)
        want = J.csr_pair_join_plain(*args, total, t_pad)
        assert torch.equal(got, want)
    zero = J.csr_pair_join(*args[:5], torch.zeros_like(args[5]), args[6],
                           0, 512, prefix=prefix)
    assert not zero.any()
    with pytest.raises(ValueError):   # a CPU tensor in a CUDA call
        J.csr_join_cuda(*args[:3], args[3].cpu(), *args[4:], total, 4096,
                        prefix=prefix)
    with pytest.raises(TypeError):   # the kernel needs the prefix planes
        J.csr_pair_join(*args, total, 4096)


def test_detector_and_secrets_on_cuda_equal_cpu(cuda, monkeypatch):
    from trivy_tpu_torch.db.table import RawAdvisory, build_table
    from trivy_tpu_torch.detect import engine as DE
    from trivy_tpu_torch.detect.engine import BatchDetector, PkgQuery
    # small hit buffers, so the compacted kernel runs
    monkeypatch.setattr(DE, "_HIT_FLOOR", 8)
    monkeypatch.setattr(DE, "_HIT_ALIGN", 8)
    from trivy_tpu_torch.secret import SecretScanner
    raw = [RawAdvisory(source="alpine 3.17", ecosystem="alpine",
                       pkg_name=f"pkg{i % 40}", vuln_id=f"CVE-2024-{i:05d}",
                       fixed_version=f"{i % 5 + 1}.{i % 7}.{i % 3}-r0")
           for i in range(400)]
    table = build_table(raw)
    qs = [PkgQuery("alpine 3.17", "alpine", f"pkg{i % 50}",
                   f"{i % 6}.{i % 4}.0-r{i % 2}") for i in range(300)]
    keys = [[(h.query.name, h.query.version, h.vuln_id) for h in
             BatchDetector(table, device=d).detect(qs)]
            for d in ("cpu", "cuda")]
    assert keys[0] == keys[1] and keys[0]
    files = [(f"f{i}.txt", (b"token ghp_" + b"a1" * 18 + b"\n") * (i + 1)
              + b"x" * 70000) for i in range(40)]
    cpu = SecretScanner(device="cpu", small_batch_bytes=0)
    gpu = SecretScanner(device="cuda", small_batch_bytes=0)
    assert [s.to_json() for s in gpu.scan_files(files)] == \
        [s.to_json() for s in cpu.scan_files(files)]
    assert dict(gpu.prefilter_path) == {"cuda": 1}


def test_sbom_on_cuda_equals_cpu(cuda, tmp_path, monkeypatch):
    """`sbom` of the reference's CentOS 7 CycloneDX document on the card
    gives the `--device cpu` report, byte for byte with the clock fixed,
    through the join kernel."""
    import contextlib
    import io
    import os

    from trivy_tpu_torch import __main__ as cli
    gold = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "golden")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("TRIVY_TPU_FAKE_NOW", "2021-08-25T12:20:30Z")
    before = J.csr_join_cuda.launches + J.csr_join_compact_cuda.launches
    outs = []
    for device in ("cuda", "cpu"):
        out = str(tmp_path / f"{device}.json")
        with contextlib.redirect_stdout(io.StringIO()):
            assert cli.main([
                "sbom", os.path.join(gold, "inputs",
                                     "centos-7-cyclonedx.json"),
                "--db", os.path.join(gold, "db", "*.yaml"),
                "--device", device, "--cache-dir", str(tmp_path / device),
                "--output", out]) == 0
        with open(out, "rb") as f:
            outs.append(f.read())
    assert outs[0] == outs[1] and b"CVE-2019-18276" in outs[0]
    assert J.csr_join_cuda.launches + J.csr_join_compact_cuda.launches \
        > before


def test_registry_scan_on_cuda_equals_cpu(cuda, tmp_path, monkeypatch):
    """`image NAME --image-src remote` from the in-process registry,
    layers walked by the ingest pipeline, on the card: the `--device
    cpu` report byte for byte (the clock fixed), with one shift-or
    launch for the image and the join kernel launched."""
    import contextlib
    import io
    import os

    import chip_smoke
    from trivy_tpu_torch import __main__ as cli
    from trivy_tpu_torch.fanal.fixtures import (OCIRegistry, gz_bytes,
                                                sha256_hex, tar_bytes)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("TRIVY_TPU_FAKE_NOW", "2026-10-17T00:00:00Z")
    import numpy as np
    rng = np.random.default_rng(3)
    text = chip_smoke.filler_text(rng, 3 << 20) \
        + chip_smoke.planted_token(rng, "github-pat")
    layers = [tar_bytes({"etc/os-release": chip_smoke.ALPINE_OS_RELEASE,
                         "lib/apk/db/installed": chip_smoke.APK_INSTALLED}),
              tar_bytes({"srv/app/settings.txt": text})]
    db = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "fixtures", "db", "*.yaml")
    outs = []
    with OCIRegistry(token="t") as reg:
        reg.put_image("alpine", "1", [gz_bytes(b) for b in layers],
                      ["sha256:" + sha256_hex(b) for b in layers])
        for device in ("cuda", "cpu"):
            before = (so.shiftor_cuda.launches, J.csr_join_cuda.launches
                      + J.csr_join_compact_cuda.launches)
            out = str(tmp_path / f"{device}.json")
            with contextlib.redirect_stdout(io.StringIO()):
                assert cli.main([
                    "image", f"http://127.0.0.1:{reg.port}/alpine:1",
                    "--image-src", "remote", "--db", db, "--scanners",
                    "vuln,secret", "--device", device, "--cache-dir",
                    str(tmp_path / device), "--output", out]) == 0
            if device == "cuda":
                assert so.shiftor_cuda.launches == before[0] + 1
                assert J.csr_join_cuda.launches \
                    + J.csr_join_compact_cuda.launches > before[1]
            with open(out, "rb") as f:
                outs.append(f.read())
    assert outs[0] == outs[1]
    assert b"CVE-2025-26519" in outs[0] and b"github-pat" in outs[0]
