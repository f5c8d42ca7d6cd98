"""The port's native C++ host helpers (trivy_tpu_torch/native/), on the
CPU with the host's C++ compiler:

  * every case of tests/test_native.py, run against the port;
  * seeded cases (numpy, a fixed seed) holding the native result to the
    port's plain version (ops.hashing.fnv1a64, ops.ac._pack_one_py) and
    to trivy_tpu.native bit for bit: fnv1a64_batch on empty, non-ASCII
    and 1000-byte keys; pack_chunks on empty files, upper-case and
    >= 0x80 bytes, lengths at and around multiples of the stride, and
    an overlap at or past chunk_len (the stride clamped to 1);
  * no fallback: without a compiler, or with a source that does not
    compile, the helpers and ops.ac.pack_chunks raise NativeError with
    the compiler's output and return nothing;
  * the library lands in trivy_tpu_torch/_build/, built from the
    package's own source, never from the repo-root native/ nor into the
    JAX package's cache directory, and concurrent builds publish one
    whole file."""

import builtins
import os
import tempfile
import threading

import numpy as np
import pytest

from trivy_tpu import native as ref_native
from trivy_tpu.ops import ac as ref_ac
from trivy_tpu_torch import native
from trivy_tpu_torch.ops import ac
from trivy_tpu_torch.ops.hashing import fnv1a64

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "trivy_tpu_torch")


# ---- tests/test_native.py on the port ---------------------------------

def test_fnv_batch_matches_python():
    keys = [b"alpine 3.17\x00openssl", b"", b"x" * 1000,
            "unicode-β".encode()]
    got = native.fnv1a64_batch(keys)
    want = np.asarray([fnv1a64(k) for k in keys], dtype=np.uint64)
    assert got.dtype == np.uint64 and (got == want).all()


def test_pack_chunks_matches_python():
    files = [b"Hello WORLD " * 100, b"", b"short", b"A" * 5000]
    chunk_len, overlap = 256, 31
    native_rows, native_owner = ac.pack_chunks(files, chunk_len, overlap)
    py_blocks, py_owner = [], []
    for fi, data in enumerate(files):
        if not data:
            continue
        b = ac._pack_one_py(data, chunk_len, overlap)
        py_blocks.append(b)
        py_owner.extend([fi] * b.shape[0])
    py_rows = np.concatenate(py_blocks, axis=0)
    assert native_rows.shape == py_rows.shape
    assert (native_rows == py_rows).all()
    assert (native_owner == np.asarray(py_owner)).all()


def test_contains_lower():
    hay = b"The QUICK brown Fox"
    assert native.contains_lower(hay, b"quick")
    assert native.contains_lower(hay, b"fox")
    assert native.contains_lower(hay, b"the quick")
    assert not native.contains_lower(hay, b"wolf")


# ---- seeded cases against the plain versions and trivy_tpu.native -----

def _ref_hashes(keys):
    return np.asarray(ref_native.fnv1a64_batch(keys), dtype=np.uint64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fnv_batch_seeded(seed):
    rng = np.random.default_rng(seed)
    keys = [b"", "ünïcödé-β-名前".encode(), bytes(range(256)),
            rng.integers(0, 256, 1000, dtype=np.uint8).tobytes()]
    keys += [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
             for n in rng.integers(0, 64, 200)]
    keys += [f"debian 12\x00pkg-{i}".encode() for i in range(100)]
    got = native.fnv1a64_batch(keys)
    want = np.asarray([fnv1a64(k) for k in keys], dtype=np.uint64)
    assert (got == want).all()
    assert (got == _ref_hashes(keys)).all()


def test_fnv_batch_empty():
    got = native.fnv1a64_batch([])
    assert got.dtype == np.uint64 and got.shape == (0,)
    assert (native.fnv1a64_batch([b""]) ==
            np.asarray([fnv1a64(b"")], np.uint64)).all()


def _seeded_bytes(rng, n):
    """Upper- and lower-case ASCII, digits and bytes >= 0x80."""
    alphabet = np.frombuffer(
        b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789@[`{"
        + bytes(range(0x80, 0x100)), np.uint8)
    return alphabet[rng.integers(0, len(alphabet), n)].tobytes()


# (chunk_len, overlap): the secret scanner's shape scaled down, an
# overlap of chunk_len - 1 (stride 1), at chunk_len and past it (the
# stride clamped to 1), no overlap, one-byte rows
PACK_SHAPES = [(256, 31), (64, 63), (16, 16), (16, 40), (8, 0), (1, 0)]


@pytest.mark.parametrize("chunk_len,overlap", PACK_SHAPES)
def test_pack_chunks_seeded(chunk_len, overlap):
    rng = np.random.default_rng(chunk_len * 100 + overlap)
    stride = max(1, chunk_len - overlap)
    lengths = {0, 1, 2, chunk_len - 1, chunk_len, chunk_len + 1,
               chunk_len + overlap, 3 * chunk_len + 7}
    for k in (1, 2, 3, 5):
        lengths |= {k * stride - 1, k * stride, k * stride + 1,
                    k * stride + overlap}
    lengths = sorted(n for n in lengths if 0 <= n <= 800)
    for n in lengths:
        data = _seeded_bytes(rng, n)
        got = native.lower_pack_chunks(data, chunk_len, overlap)
        want = ac._pack_one_py(data, chunk_len, overlap)
        assert got.dtype == np.uint8 and got.shape == want.shape, n
        assert (got == want).all(), n
        ref = ref_native.lower_pack_chunks(data, chunk_len, overlap)
        if ref is None:   # the JAX loader's own fallback
            ref = ref_ac._pack_one_py(data, chunk_len, overlap)
        assert ref.shape == got.shape and (ref == got).all(), n
        # A-Z lowered, every other byte (>= 0x80 too) as it was
        if n and chunk_len >= n:
            assert bytes(got[0][:n]) == data.lower()
    files = [_seeded_bytes(rng, int(n)) for n in rng.choice(lengths, 12)]
    rows, owner = ac.pack_chunks(files, chunk_len, overlap)
    ref_rows, ref_owner = ref_ac.pack_chunks(files, chunk_len, overlap)
    assert (rows == np.asarray(ref_rows)).all()
    assert (owner == np.asarray(ref_owner)).all()


def test_pack_chunks_tail_under_clamped_stride():
    """overlap >= chunk_len: every start offset gets a row until one
    reaches the end, and the last row holds the tail."""
    data = b"ABCDEFGHIJ"
    rows = native.lower_pack_chunks(data, 4, 6)
    assert [bytes(r) for r in rows] == [
        b"abcd", b"bcde", b"cdef", b"defg", b"efgh", b"fghi", b"ghij"]
    assert (rows == ac._pack_one_py(data, 4, 6)).all()


@pytest.mark.parametrize("chunk_len,overlap", [(0, 0), (16, -1)])
def test_pack_chunks_rejects_bad_shapes(chunk_len, overlap):
    with pytest.raises(ValueError):
        native.lower_pack_chunks(b"abc", chunk_len, overlap)


@pytest.mark.parametrize("seed", [3, 4])
def test_contains_lower_seeded(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        hay = _seeded_bytes(rng, int(rng.integers(0, 40)))
        if hay and rng.random() < 0.5:
            i = int(rng.integers(0, len(hay)))
            needle = hay[i:i + int(rng.integers(1, 6))].lower()
        else:
            needle = _seeded_bytes(rng, int(rng.integers(0, 4))).lower()
        assert native.contains_lower(hay, needle) == \
            (needle in hay.lower())


# ---- the build ---------------------------------------------------------

@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """An empty build directory and no loaded library."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(native, "_lib", None)
    return tmp_path / "_build"


def test_missing_compiler_raises(fresh_build, tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    for call in (lambda: native.fnv1a64_batch([b"x"]),
                 lambda: native.fnv1a64_batch([]),
                 lambda: native.lower_pack_chunks(b"abc", 16, 3),
                 lambda: ac.pack_chunks([b"abc"], 16, 3)):
        with pytest.raises(native.NativeError, match="no host C"):
            call()
    assert native._lib is None
    assert not fresh_build.exists() or not os.listdir(fresh_build)


def test_failed_compile_raises_with_output(fresh_build, tmp_path,
                                           monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("extern \"C\" void fnv1a64_batch( {\n")
    monkeypatch.setattr(native, "SRC", str(bad))
    with pytest.raises(native.NativeError) as e:
        native.fnv1a64_batch([b"x"])
    assert "broken.cpp" in str(e.value) and "error" in str(e.value)
    assert native._lib is None
    assert [p for p in os.listdir(fresh_build) if p.endswith(".so")] == []


def test_library_lands_in_the_package_build_dir():
    lib = native.library()
    assert os.path.dirname(lib._name) == os.path.join(PKG, "_build")
    assert os.path.basename(lib._name).startswith("libtrivy_native-")
    assert native.SRC == os.path.join(PKG, "native", "trivy_native.cpp")
    jax_cache = os.path.join(tempfile.gettempdir(), "trivy_tpu_native")
    assert not lib._name.startswith(jax_cache)


def test_loader_never_opens_repo_root_native(fresh_build, monkeypatch):
    seen = []
    real_open, real_run = builtins.open, native.subprocess.run

    def spy_open(path, *a, **k):
        seen.append(os.path.abspath(os.fspath(path)))
        return real_open(path, *a, **k)

    def spy_run(cmd, *a, **k):
        seen.extend(os.path.abspath(c) for c in cmd if os.sep in c)
        return real_run(cmd, *a, **k)

    monkeypatch.setattr(builtins, "open", spy_open)
    monkeypatch.setattr(native.subprocess, "run", spy_run)
    native.fnv1a64_batch([b"x"])
    monkeypatch.undo()
    root_native = os.path.join(REPO, "native") + os.sep
    assert native.SRC in seen
    assert not [p for p in seen if p.startswith(root_native)]


def test_concurrent_builds_publish_one_library(fresh_build):
    paths, errors = [], []

    def worker():
        try:
            paths.append(native.build())
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(set(paths)) == 1
    assert os.listdir(fresh_build) == [os.path.basename(paths[0])]
    assert (native.fnv1a64_batch([b"abc"]) ==
            np.asarray([fnv1a64(b"abc")], np.uint64)).all()


def test_chip_native_line_at_a_small_size_on_cpu():
    """chip_smoke.py's `native` checks on seeded secret candidates and a
    small apps table's keys."""
    import chip_smoke
    _deb, _names, raw = chip_smoke.apps_raw(np.random.default_rng(5),
                                            shrink=50)
    rng = np.random.default_rng(6)
    files = [(f"f{i}", chip_smoke.filler_text(rng, n) if n else b"")
             for i, n in enumerate([0, 100, 16384, 40000, 70000])]
    fig = chip_smoke.native_checks(files, raw, device="cpu")
    assert fig["equal"] and fig["files"] == 5
    assert fig["keys"] == len({(r.source, r.pkg_name) for r in raw})
    assert fig["rows"] == 1 + 1 + 3 + 5
