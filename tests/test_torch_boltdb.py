"""The port's trivy.db path held against the JAX package's: the BoltDB
reader (`db/boltdb.py`) on genuine bolt page layouts written by
tests/bolt_writer.py (meta selection, branch pages, overflow chains,
inline buckets), the flattened table of every bolt file of
tests/test_boltdb_equality.py equal to the JAX package's array by
array, the `.npz` flatten memo, the cached-DB gate (`db/download.py`)
and the CLI's `--db trivy.db` and `--cache-dir` branches."""

import contextlib
import glob
import io
import json
import os
import random
import time

import numpy as np
import pytest

import test_boltdb_equality as eq
import trivy_tpu.cli as ref_cli
from bolt_writer import write_bolt
from trivy_tpu.db import boltdb as ref_boltdb
from trivy_tpu.db import download as ref_download
from trivy_tpu.db.fixtures import load_fixture_docs as ref_load_docs
from trivy_tpu.db.table import build_table as ref_build
from trivy_tpu_torch import __main__ as cli
from trivy_tpu_torch.db import boltdb, download
from trivy_tpu_torch.db.fixtures import load_fixture_docs
from trivy_tpu_torch.db.table import AdvisoryTable, build_table

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE_DB = os.path.join(HERE, "fixtures", "db", "*.yaml")
ARRAYS = ("hash", "lo_tok", "hi_tok", "flags", "group")


def _tree_of(paths) -> dict:
    docs = []
    for p in paths:
        docs.extend(eq.load_fixture_file_docs(p))
    return eq._docs_to_tree(docs)


def _same_table(port, ref) -> None:
    for name in ARRAYS:
        a, b = getattr(port, name), getattr(ref, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert port.window == ref.window
    assert eq._canonical(port) == eq._canonical(ref)
    assert [g.vuln_id for g in port.groups] == [g.vuln_id for g in ref.groups]
    assert eq._norm_details(port.details) == eq._norm_details(ref.details)
    assert port.aux == ref.aux


def _flatten_both(bolt: str):
    port = load_fixture_docs(boltdb.to_docs(bolt))
    ref = ref_load_docs(ref_boltdb.to_docs(bolt))
    aux = (lambda s: {"Red Hat CPE": s["Red Hat CPE"]}
           if "Red Hat CPE" in s else None)
    return (build_table(port[0], port[1], aux=aux(port[2])),
            ref_build(ref[0], ref[1], aux=aux(ref[2])))


@pytest.mark.parametrize("path", eq.FIXTURES,
                         ids=[os.path.basename(p) for p in eq.FIXTURES])
def test_flattened_bolt_equals_reference_array_by_array(path, tmp_path):
    bolt = write_bolt(str(tmp_path / "trivy.db"), _tree_of([path]))
    _same_table(*_flatten_both(bolt))


def test_all_fixtures_combined_equal_reference(tmp_path):
    bolt = write_bolt(str(tmp_path / "trivy.db"), _tree_of(eq.FIXTURES),
                      leaf_cap=8, inline_threshold=256)
    port, ref = _flatten_both(bolt)
    assert len(port) > 100
    _same_table(port, ref)


@pytest.mark.parametrize("page_size,leaf_cap,inline", [
    (512, 2, 0), (1024, 5, 256), (4096, 64, 0), (16384, 5, 256)])
def test_reader_matches_reference_on_fuzzed_trees(page_size, leaf_cap,
                                                  inline, tmp_path):
    rng = random.Random(page_size + leaf_cap + inline)

    def rand_tree(depth):
        out = {}
        for _ in range(rng.randint(1, 10)):
            key = "".join(rng.choices("abcdef:/.- 0123", k=rng.randint(1, 16)))
            if depth == 0 or (depth < 3 and rng.random() < 0.3):
                out[key] = rand_tree(depth + 1)
            else:
                size = rng.choice([0, 5, 300, page_size + 11, 2 * page_size])
                out[key] = bytes(rng.getrandbits(8) for _ in range(size))
        return out
    bolt = write_bolt(str(tmp_path / "f.db"), rand_tree(0),
                      page_size=page_size, leaf_cap=leaf_cap,
                      inline_threshold=inline)
    assert boltdb.to_docs(bolt, decode_json=False) == \
        ref_boltdb.to_docs(bolt, decode_json=False)
    assert boltdb.to_docs(bolt) == ref_boltdb.to_docs(bolt)


def test_page_layouts(tmp_path):
    """Branch pages, overflow values, inline buckets, another page size."""
    tree = {"big": {f"key{i:04d}": f"val{i}".encode() for i in range(300)},
            "huge": {"v": bytes(range(256)) * 40},
            "outer": {"small": {"a": b"1", "b": b"2"}}}
    p = write_bolt(str(tmp_path / "t.db"), tree, page_size=8192,
                   leaf_cap=16, inline_threshold=512)
    docs = boltdb.to_docs(p, decode_json=False)
    assert [d["bucket"] for d in docs] == ["big", "huge", "outer"]
    assert [x["key"] for x in docs[0]["pairs"]] == sorted(tree["big"])
    assert docs[1]["pairs"] == [{"key": "v", "value": tree["huge"]["v"]}]
    assert docs[2]["pairs"][0]["pairs"] == [{"key": "a", "value": b"1"},
                                           {"key": "b", "value": b"2"}]
    with boltdb.BoltDB(p) as db:
        assert db.page_size == 8192


@pytest.mark.parametrize("data", [b"\0" * 8192, b"garbage"])
def test_invalid_file_rejected(data, tmp_path):
    bad = tmp_path / "bad.db"
    bad.write_bytes(data)
    with pytest.raises(boltdb.BoltError):
        boltdb.BoltDB(str(bad))


def test_flatten_memo(tmp_path):
    """The first flatten builds and saves the memo; the second loads it;
    both equal the JAX package's flatten of a copy of the file; a
    corrupt memo is moved aside and the DB flattened again."""
    tree = _tree_of(eq.FIXTURES)
    os.makedirs(tmp_path / "port")
    bolt = write_bolt(str(tmp_path / "port" / "trivy.db"), tree)
    first, s1 = download.flatten_db(bolt)
    second, s2 = download.flatten_db(bolt)
    assert s1["cached"] is False and s2["cached"] is True
    assert s1["rows"] == s2["rows"] == len(first) > 100
    assert os.path.exists(bolt + ".npz") and os.path.exists(bolt + ".npz.src")
    os.makedirs(tmp_path / "ref")
    ref_bolt = write_bolt(str(tmp_path / "ref" / "trivy.db"), tree)
    ref, _ = ref_download.flatten_db(ref_bolt)
    _same_table(first, ref)
    _same_table(second, ref)
    with open(bolt + ".npz", "wb") as f:
        f.write(b"not an npz")
    third, s3 = download.flatten_db(bolt)
    assert s3["cached"] is False and os.path.exists(bolt + ".npz.corrupt")
    _same_table(third, ref)


def _cache_with_db(root, meta: dict | None, tree=None) -> str:
    os.makedirs(os.path.join(root, "db"), exist_ok=True)
    write_bolt(download.db_path(root), tree or _tree_of(eq.FIXTURES[:1]))
    if meta is not None:
        with open(download.metadata_path(root), "w") as f:
            json.dump(meta, f)
    return str(root)


@pytest.mark.parametrize("meta,skip,age_s,want", [
    (None, False, 0, True),
    ({"Version": 1}, False, 0, True),
    ({"Version": 2, "NextUpdate": "2999-01-01T00:00:00Z"}, False, 7200,
     False),
    ({"Version": 2, "NextUpdate": "2000-01-01T00:00:00Z"}, False, 7200,
     True),
    ({"Version": 2, "NextUpdate": "2000-01-01T00:00:00Z"}, False, 0, False),
    ({"Version": 2}, True, 7200, False),
])
def test_needs_update_like_reference(meta, skip, age_s, want, tmp_path):
    root = _cache_with_db(tmp_path, meta)
    if meta is not None and age_s:
        old = time.time() - age_s
        os.utime(download.metadata_path(root), (old, old))
    assert download.needs_update(root, skip=skip) is want
    assert ref_download.needs_update(root, skip=skip) is want


@pytest.mark.parametrize("meta", [None, {"Version": 1}])
def test_skip_update_without_a_usable_db_raises_like_reference(meta,
                                                               tmp_path):
    root = str(tmp_path)
    if meta is not None:
        _cache_with_db(tmp_path, meta)
    msgs = []
    for mod in (download, ref_download):
        with pytest.raises(mod.DBError) as e:
            mod.needs_update(root, skip=True)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _scan_both(argv, tmp_path, monkeypatch) -> tuple:
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("TRIVY_TPU_FAKE_NOW", "2026-10-17T00:00:00Z")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv["port"] + ["--device", "cpu"]) == 0
    port = buf.getvalue()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert ref_cli.main(argv["ref"]) == 0
    return port, buf.getvalue()


def _rootfs(tmp_path) -> str:
    import chip_smoke
    root = str(tmp_path / "rootfs")
    chip_smoke.make_rootfs(root, filler_mib=0)
    return root


def test_cli_db_flag_reads_a_bolt_file_like_reference(tmp_path, monkeypatch):
    """`--db trivy.db`: each CLI its own copy of the file (the memo sits
    beside it) and its own cache; the reports equal each other and the
    fixture YAML's."""
    root = _rootfs(tmp_path)
    paths = sorted(glob.glob(FIXTURE_DB))
    tree = _tree_of(paths)
    dbs = {k: write_bolt(str(tmp_path / f"{k}.db"), tree)
           for k in ("port", "ref")}
    common = ["rootfs", root, "--scanners", "vuln", "--format", "json"]
    port, ref = _scan_both(
        {"port": common + ["--db", dbs["port"], "--cache-dir",
                           str(tmp_path / "pc")],
         "ref": common + ["--db", dbs["ref"], "--cache-dir",
                          str(tmp_path / "rc")]}, tmp_path, monkeypatch)
    assert port == ref
    port2, _ = _scan_both(
        {"port": common + ["--db", dbs["port"], "--cache-dir",
                           str(tmp_path / "pc")],
         "ref": common + ["--db", FIXTURE_DB, "--cache-dir",
                          str(tmp_path / "rc")]}, tmp_path, monkeypatch)
    assert port2 == port
    assert len([v for r in json.loads(port)["Results"]
                for v in r.get("Vulnerabilities", [])]) == 5


def test_cli_cached_db_like_reference(tmp_path, monkeypatch):
    """No --db: `<cache-dir>/db/trivy.db` with its metadata, under
    --skip-db-update, in each CLI's own cache dir."""
    root = _rootfs(tmp_path)
    tree = _tree_of(sorted(glob.glob(FIXTURE_DB)))
    meta = {"Version": 2, "NextUpdate": "2999-01-01T00:00:00Z"}
    caches = {k: _cache_with_db(tmp_path / k, meta, tree)
              for k in ("port", "ref")}
    common = ["rootfs", root, "--scanners", "vuln", "--format", "json",
              "--skip-db-update"]
    port, ref = _scan_both({k: common + ["--cache-dir", caches[k]]
                            for k in ("port", "ref")}, tmp_path, monkeypatch)
    assert port == ref
    assert os.path.exists(download.db_path(caches["port"]) + ".npz")


def _closed_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_cli_without_a_db_is_refused(tmp_path, monkeypatch):
    """Nothing cached and a --db-repository that does not answer (a
    closed port on 127.0.0.1): both CLIs' "DB unavailable" message, the
    download's failure; with --skip-db-update the reference's own
    reason, without a download."""
    from trivy_tpu.resilience import RetryPolicy
    from trivy_tpu_torch import oci
    root = _rootfs(tmp_path)
    monkeypatch.chdir(tmp_path)
    fast = dict(attempts=2, base_delay_s=0.001, max_delay_s=0.002)
    monkeypatch.setattr(download, "DOWNLOAD_RETRY", oci.RetryPolicy(**fast))
    monkeypatch.setattr(ref_download, "DOWNLOAD_RETRY", RetryPolicy(**fast))
    repo = f"http://127.0.0.1:{_closed_port()}/aquasecurity/trivy-db:2"
    argv = ["rootfs", root, "--cache-dir", str(tmp_path / "empty"),
            "--db-repository", repo]
    msgs = {}
    for skip in ([], ["--skip-db-update"]):
        with pytest.raises(SystemExit) as port_e:
            cli.main(argv + ["--device", "cpu"] + skip)
        with pytest.raises(SystemExit) as ref_e:
            ref_cli.main(argv + skip)
        assert str(port_e.value) == str(ref_e.value)
        msgs[bool(skip)] = str(port_e.value)
    assert msgs[False].startswith(
        "DB unavailable: trivy-db download from 127.0.0.1:")
    assert msgs[True].startswith(
        "DB unavailable: --skip-db-update requested but no DB in cache")


def test_saved_table_roundtrip_is_atomic(tmp_path):
    paths = sorted(glob.glob(FIXTURE_DB))
    from trivy_tpu_torch.db.fixtures import load_fixture_files
    advisories, details, _ = load_fixture_files(paths)
    table = build_table(advisories, details)
    table.save(str(tmp_path / "t.npz"))
    assert sorted(os.listdir(tmp_path)) == ["t.npz"]
    back = AdvisoryTable.load(str(tmp_path / "t.npz"))
    for name in ARRAYS:
        assert np.array_equal(getattr(back, name), getattr(table, name))
