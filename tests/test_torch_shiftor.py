"""The port's secret keyword prefilter (plain torch on the CPU) against
the JAX package: the Pallas `shiftor` kernel in interpret mode, the jnp
`ac.shiftor_scan`, and host bytes.find — exact bitmask equality on
hostile rows with keywords planted at row ends. Also the bank and chunk
packing arrays."""

import numpy as np
import pytest
import torch

from trivy_tpu.ops import ac as rac
from trivy_tpu.ops import shiftor_pallas as rsp
from trivy_tpu.secret.engine import SecretScanner as RefScanner
from trivy_tpu_torch.ops import ac
from trivy_tpu_torch.ops import shiftor as so

L = 16384


@pytest.fixture(scope="module")
def bank():
    ref = RefScanner(use_device=False)
    return ac.build_literal_bank(ref._keywords)


def _host_bits(bank, chunks):
    out = np.zeros((chunks.shape[0], bank.words), np.uint32)
    for r in range(chunks.shape[0]):
        row = chunks[r].tobytes()
        for k, kw in enumerate(bank.kw_bytes):
            if kw in row:
                out[r, k // 32] |= np.uint32(1) << np.uint32(k % 32)
    return out


def _chunks(bank, rows, seed):
    """Binary rows with 0xFF runs (the padding lanes' word), NUL runs,
    every keyword planted somewhere, keywords ending at a row's last
    byte, and keywords cut off by a row end."""
    rng = np.random.default_rng(seed)
    chunks = rng.integers(0, 256, size=(rows, L), dtype=np.uint8)
    chunks[0, :512] = 0xFF
    chunks[1, 100:400] = 0x00
    kws = bank.kw_bytes
    for kw in kws:
        r = int(rng.integers(0, rows))
        off = int(rng.integers(0, L - len(kw)))
        chunks[r, off:off + len(kw)] = np.frombuffer(kw, np.uint8)
    long = max(kws, key=len)
    chunks[2, L - len(long):] = np.frombuffer(long, np.uint8)
    chunks[3, L - len(long) + 1:] = np.frombuffer(long[:-1], np.uint8)
    if rows > 4:
        chunks[4, L - 3:] = np.frombuffer(kws[5][:3], np.uint8)
        chunks[5 % rows, :len(kws[5]) - 3] = \
            np.frombuffer(kws[5][3:], np.uint8)
    return rac._LOWER[chunks]


def _port_scan(bank, chunks):
    return ac.shiftor_scan(torch.from_numpy(bank.kw_words.view(np.int32)),
                           torch.from_numpy(bank.kw_masks.view(np.int32)),
                           torch.from_numpy(chunks),
                           n_words=bank.words).numpy()


def _port_kernel_plain(bank, chunks):
    packed = so.pack_bank(bank)
    kww, kwm, bit = (torch.from_numpy(a) for a in packed)
    index = tuple(torch.from_numpy(a) for a in so.bank_index(*packed))
    return so.shiftor(kww, kwm, bit, torch.from_numpy(chunks),
                      n_words=bank.words, index=index).numpy()


def test_matches_pallas_kernel(bank):
    chunks = _chunks(bank, 4, 0)
    kww, kwm, bit = rsp.pack_bank(bank)
    pallas = np.asarray(rsp.shiftor(kww, kwm, bit, chunks,
                                    n_words=bank.words, interpret=True))
    assert np.array_equal(_port_kernel_plain(bank, chunks), pallas)
    assert np.array_equal(_port_scan(bank, chunks), pallas)


@pytest.mark.parametrize("rows,seed", [(4, 0), (8, 1)])
def test_matches_jnp_scan_and_host(bank, rows, seed):
    chunks = _chunks(bank, rows, seed)
    jnp_scan = np.asarray(rac.shiftor_scan(bank.kw_words, bank.kw_masks,
                                           chunks, n_words=bank.words))
    host = _host_bits(bank, chunks)
    for got in (_port_scan(bank, chunks), _port_kernel_plain(bank, chunks)):
        assert got.dtype == np.int32
        assert np.array_equal(got, jnp_scan)
        assert np.array_equal(got.view(np.uint32), host)


def test_row_end_boundaries(bank):
    chunks = np.zeros((3, L), np.uint8)
    long = max(bank.kw_bytes, key=len)
    k = bank.kw_bytes.index(long)
    chunks[0, L - len(long):] = np.frombuffer(long, np.uint8)   # fits
    chunks[1, L - len(long) + 1:] = np.frombuffer(long[:-1], np.uint8)
    chunks[2, :len(long) - 1] = np.frombuffer(long[1:], np.uint8)
    got = _port_kernel_plain(bank, chunks).view(np.uint32)
    bit = np.uint32(1) << np.uint32(k % 32)
    assert got[0, k // 32] & bit
    assert not got[1, k // 32] & bit and not got[2, k // 32] & bit
    assert np.array_equal(got, _host_bits(bank, chunks))


def test_ff_rows_set_no_padding_bits(bank):
    chunks = np.full((2, L), 0xFF, np.uint8)
    assert not _port_kernel_plain(bank, chunks).any()
    assert not _port_scan(bank, chunks).any()


def test_bank_and_packing_equal_reference(bank):
    ref_bank = RefScanner(use_device=False)._bank
    assert bank.kw_bytes == ref_bank.kw_bytes
    assert np.array_equal(bank.kw_words, ref_bank.kw_words)
    assert np.array_equal(bank.kw_masks, ref_bank.kw_masks)
    assert (bank.words, bank.state_words, bank.max_kw_len) == \
        (ref_bank.words, ref_bank.state_words, ref_bank.max_kw_len)
    assert (bank.n_keywords, bank.state_words, bank.words) == (93, 7, 3)
    for mine, ref in zip(so.pack_bank(bank), rsp.pack_bank(ref_bank)):
        assert mine.dtype == ref.dtype and np.array_equal(mine, ref)
    rng = np.random.default_rng(4)
    files = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
             for n in (0, 5, 40000, 16384, 16385, 70000)]
    for chunk_len, overlap in ((16384, 24), (64, 24), (32, 40)):
        mine = ac.pack_chunks(files, chunk_len, overlap)
        ref = rac.pack_chunks(files, chunk_len, overlap)
        assert np.array_equal(mine[0], ref[0])
        assert np.array_equal(mine[1], ref[1])


def test_cpu_tensor_takes_the_plain_version(bank, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the CUDA wrapper ran for a CPU tensor")
    monkeypatch.setattr(so, "shiftor_cuda", boom)
    chunks = _chunks(bank, 4, 9)
    assert np.array_equal(_port_kernel_plain(bank, chunks).view(np.uint32),
                          _host_bits(bank, chunks))


def _edge_bank():
    """1-byte and 2-byte keywords beside longer ones that share their
    first bytes."""
    return ac.build_literal_bank([b"a", b"z", b"=", b"sk", b"sh", b"key",
                                  b"shpat_", b"a1", b"zz", b"token"])


def _full_bank():
    """128 keywords: the built-in bank plus random ones of 1 to 64 bytes
    (16 state words)."""
    rng = np.random.default_rng(128)
    kws = list(RefScanner(use_device=False)._keywords)
    alphabet = b"abcdefghijklmnopqrstuvwxyz_-=.0123456789"
    while len(kws) < 128:
        n = 64 if len(kws) == 127 else int(rng.integers(1, 65))
        kw = bytes(alphabet[i] for i in rng.integers(0, len(alphabet), n))
        if kw not in kws:
            kws.append(kw)
    return ac.build_literal_bank(kws)


def _banks(builtin):
    return {"builtin": builtin, "edge": _edge_bank(), "full": _full_bank()}


def _brute_candidates(bank):
    """Keyword bytes → uint32[65536, 4]: lane k under every bigram
    b0 | b1 << 8 its keyword can start with."""
    want = np.zeros((so.BIGRAMS, 4), np.uint32)
    b1 = np.arange(256) << 8
    for k, kw in enumerate(bank.kw_bytes):
        if len(kw) >= 2:
            under = [kw[0] | kw[1] << 8]
        elif len(kw) == 1:
            under = kw[0] | b1
        else:
            under = slice(None)
        want[under, k // 32] |= np.uint32(1) << np.uint32(k % 32)
    return want


@pytest.mark.parametrize("name", ["builtin", "edge", "full"])
def test_bank_index_equals_brute_force(bank, name):
    b = _banks(bank)[name]
    bitmap, cand = so.bank_index(*so.pack_bank(b))
    assert bitmap.dtype == cand.dtype == np.int32
    assert bitmap.shape == (2048,) and cand.shape == (so.BIGRAMS, 4)
    want = _brute_candidates(b)
    assert np.array_equal(cand.view(np.uint32), want)
    present = np.unpackbits(bitmap.view(np.uint8), bitorder="little")
    assert np.array_equal(present.astype(bool), want.any(axis=1))
    # padding lanes sit in no set, not even under 0xFF 0xFF (their word)
    lanes = np.unpackbits(cand.view(np.uint8), axis=1, bitorder="little")
    assert not lanes[:, b.n_keywords:].any()
    if name == "builtin":
        assert present.sum() == 60
    if name == "edge":   # "a" under every bigram that starts with it
        assert lanes[ord("a") | np.arange(256) << 8, 0].all()


def _filter_then_verify(packed, index, chunks, n_words):
    """numpy emulation of csrc/shiftor.cu: a bitmap lookup on the
    bigram at each position, then the word-by-word test of the
    candidate lanes only → (int32[B, n_words], share passing)."""
    kww, kwm, bit = (a.view(np.uint32) for a in packed)
    bitmap, cand = index
    rows, length = chunks.shape
    n_state = kww.shape[0]
    pad = np.zeros((rows, length + 4 * n_state + 4), np.uint32)
    pad[:, :length] = chunks
    w4 = pad[:, :-3] | pad[:, 1:-2] << 8 | pad[:, 2:-1] << 16 \
        | pad[:, 3:] << 24
    g = w4[:, :length] & 0xFFFF
    present = np.unpackbits(bitmap.view(np.uint8), bitorder="little")
    r, p = np.nonzero(present[g])
    lanes = cand.view(np.uint32)[g[r, p]]
    out = np.zeros((rows, n_words), np.uint32)
    for k in range(32 * n_words):
        sel = (lanes[:, k // 32] >> np.uint32(k % 32)) & 1 == 1
        rk, pk = r[sel], p[sel]
        ok = np.ones(rk.shape, bool)
        for w in range(n_state):
            ok &= ((w4[rk, pk + 4 * w] ^ kww[w, k]) & kwm[w, k]) == 0
        out[np.unique(rk[ok]), k // 32] |= bit[0, k]
    return out.view(np.int32), r.size / g.size


@pytest.mark.parametrize("name", ["builtin", "edge", "full"])
def test_filter_then_verify_matches_pallas_kernel(bank, name):
    b = _banks(bank)[name]
    chunks = _chunks(b, 4, 3)
    chunks[0, -1] = ord("z")            # a 1-byte keyword at the row end
    chunks[1, -3:] = np.frombuffer(b"tok", np.uint8)   # cut off
    packed = so.pack_bank(b)
    got, share = _filter_then_verify(packed, so.bank_index(*packed),
                                     chunks, b.words)
    kww, kwm, bit = rsp.pack_bank(b)
    pallas = np.asarray(rsp.shiftor(kww, kwm, bit, chunks, n_words=b.words,
                                    interpret=True))
    assert np.array_equal(got, pallas)
    assert np.array_equal(got.view(np.uint32), _host_bits(b, chunks))
    assert got.any() and share < 0.05
