"""The port's detection-result memo (fleet/memo.py), redetectd's sweep
after a DB swap (detect/redetect.py) and the delta flatten
(db/table.py FlattenMemo), held against tests/test_memo.py, on the CPU.

  * Through test_torch_mirror's twins (both packages, tolerance 0):
    TestMemoStore's backend spellings, hit round trip and query-digest
    ordering cases, and TestDeltaFlatten. Three source edits let the
    twins pass values a twin cannot: `a is b` becomes `_is(a, b)` (the
    identity on each package's side), `g2 is not g3` likewise, and
    `json` dumps a twin through the port's side once it equals the
    reference's.
  * Against the port alone: TestMemoStore's two fs cases (the two
    packages' stores would share one directory, so the second writer
    sees the first one's entry), TestScanPathMemo and TestRedetectd on a
    live server on the CPU, and TestFleetDedupDrill: four CPU replicas
    sharing one memo behind the port's router (fleet/router.py),
    across a rolling DB swap. Their `trivy_tpu.resilience.storm` imports
    (`_post`, `canonical_digest`) are the port's graftstorm's.

Not run, with what they need:
  * TestRedetectd::test_sweep_faults_never_charge_the_backend_breaker
    and ::test_blameless_never_consumes_the_halfopen_probe — the
    device breaker, which the port does not have (ROADMAP A, not ported
    by the north star).

The four cases that arm the `memo.get`/`memo.put` failpoints (not
ported) have counterparts here that inject a memo object whose backend
reads and writes raise or sleep, through open_memo's passthrough
(`memo_backend=<object>`): TestMemoFaults.

Beside them: memo entries written by either package's FSMemo replay in
the other's, the `server --memo-backend` CLI, and the chip script's
`memo` phase at a small size on the CPU."""

import functools
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

from helpers import ALPINE_OS_RELEASE, APK_INSTALLED, make_image
from test_torch_mirror import (PORT, REF, load_mirror, port_cases,
                               run_case, twin_cases, unwrap)
from trivy_tpu import types as RT
from trivy_tpu_torch import __main__ as cli
from trivy_tpu_torch import types as T
from trivy_tpu_torch.fleet.memo import FSMemo, MemoryMemo
from trivy_tpu_torch.scanner import LocalScanner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXGLOB = os.path.join(REPO, "tests", "fixtures", "db", "*.yaml")


# ---- the twins' helpers ---------------------------------------------------

def _is(a, b) -> bool:
    """`a is b` on the port's side and on the reference's."""
    return all(unwrap(a, side) is unwrap(b, side) for side in (0, 1))


def _isnt(a, b) -> bool:
    return all(unwrap(a, side) is not unwrap(b, side) for side in (0, 1))


class _TwinJson:
    """`json` for the twin cases: dumps a twin through the port's side,
    once the reference's side dumps the same text."""
    loads = staticmethod(json.loads)

    @staticmethod
    def dumps(v, **kw):
        port = json.dumps(unwrap(v, 0), **kw)
        assert port == json.dumps(unwrap(v, 1), **kw)
        return port


_IMPORTS = [("from {root}.resilience import FAILPOINTS, GUARD\n", "")]
# the twin cases use neither helper: a twin of `_post` would send each
# request twice
_TWIN_IMPORTS = [("from {root}.resilience.storm import _post, "
                  "canonical_digest\n", "")]


def _subs(root: str, more=()) -> list:
    imports = _IMPORTS + (_TWIN_IMPORTS if root != PORT else [])
    return [(a.format(root=root), b) for a, b in imports] + list(more)


_TWIN = ("TestMemoStore::test_open_memo_spellings",
         "TestMemoStore::test_hit_round_trip_is_exact",
         "TestMemoStore::test_query_digest_orders_and_scopes",
         "TestDeltaFlatten::")
_PORT_ALONE = ("TestMemoStore::test_fs_", "TestScanPathMemo::",
               "TestRedetectd::", "TestFleetDedupDrill::")
_OWN = ("TestMemoStore::test_backend_fault_degrades_never_raises",
        "TestScanPathMemo::test_memo_faults_fall_back_to_live_detect",
        "TestRedetectd::test_drain_cancels_sweep_cleanly_no_leaked_threads",
        "TestRedetectd::test_newer_swap_preempts_running_sweep")
_NOT_RUN = (
    "TestRedetectd::test_sweep_faults_never_charge_the_backend_breaker",
    "TestRedetectd::test_blameless_never_consumes_the_halfopen_probe")
_PORT_ENV = {"LocalScanner": functools.partial(LocalScanner, device="cpu")}
_PORT_SUBS = [("memo_backend=memo, **kw)",
               "memo_backend=memo, device=\"cpu\", **kw)"),
              ("cache_backend=shared_cache, memo_backend=shared_memo)",
               "cache_backend=shared_cache, memo_backend=shared_memo, "
               "device=\"cpu\")"),
              ("cache_backend=\"memory\")",
               "cache_backend=\"memory\", device=\"cpu\")")]

# the JAX file's builders (tables, blob documents) on each package
PORT_MEMO = load_mirror("test_memo.py", PORT, _subs(PORT, _PORT_SUBS),
                        _PORT_ENV)
REF_MEMO = load_mirror("test_memo.py", REF)


def test_every_reference_case_is_accounted_for():
    ids = {c.id for c in port_cases(
        "test_memo.py", subs=_subs(PORT, _PORT_SUBS), env=_PORT_ENV)}
    groups = [{i for i in ids if i.startswith(g)}
              for g in (_TWIN, _OWN, _NOT_RUN)]
    alone = {i for i in ids if i.startswith(_PORT_ALONE)} \
        - groups[1] - groups[2]
    assert sum(map(len, groups)) + len(alone) == len(ids) == 22
    assert set().union(alone, *groups) == ids
    assert len(groups[1]) == 4 and len(groups[2]) == 2


@pytest.mark.parametrize("cls,fn,given", twin_cases(
    "test_memo.py", keep=lambda c: c.startswith(_TWIN),
    subs=_subs("twin_trivy", [
        ("assert open_memo(m) is m", "assert _is(open_memo(m), m)"),
        ("assert back[0].query is qs[2]",
         "assert _is(back[0].query, qs[2])"),
        ("assert g2 is not g3 and g2.rows is not g3.rows",
         "assert _isnt(g2, g3) and _isnt(g2.rows, g3.rows)")]),
    env={"_is": _is, "_isnt": _isnt, "json": _TwinJson}))
def test_memo_case_like_reference(cls, fn, given, request):
    run_case(cls, fn, request, given)


@pytest.mark.parametrize("cls,fn,given", port_cases(
    "test_memo.py",
    keep=lambda c: c.startswith(_PORT_ALONE) and not c.startswith(
        _OWN + _NOT_RUN),
    subs=_subs(PORT, _PORT_SUBS), env=_PORT_ENV))
def test_memo_case_on_port(cls, fn, given, request):
    run_case(cls, fn, request, given)


# ---- the failpoint cases, with a faulty backend object --------------------

class FaultyMemo(MemoryMemo):
    """A memory memo whose backend reads and writes raise (`fail`), and
    whose entry reads wait `slow_get_s` first: the JAX tests'
    `memo.get`/`memo.put` failpoints (error, slow), which the port does
    not have."""

    def __init__(self):
        super().__init__()
        self.fail = False
        self.slow_get_s = 0.0

    def _read(self, key):
        if self.fail:
            raise OSError("memo backend down")
        return super()._read(key)

    def _write(self, key, doc):
        if self.fail:
            raise OSError("memo backend down")
        super()._write(key, doc)

    def get_entry(self, blob_id, db_version):
        if self.slow_get_s:
            time.sleep(self.slow_get_s)
        return super().get_entry(blob_id, db_version)


def _serve(table, memo, **kw):
    from trivy_tpu_torch.server.listen import serve_background
    httpd, state = serve_background("127.0.0.1", 0, table, cache_dir="",
                                    cache_backend="memory",
                                    memo_backend=memo, device="cpu", **kw)
    return f"http://127.0.0.1:{httpd.server_address[1]}", httpd, state


def _stop(httpd, state):
    httpd.shutdown()
    httpd.server_close()
    state.close()


class TestMemoFaults:
    M = PORT_MEMO

    def _push_and_scan(self, base, doc):
        return self.M.TestRedetectd._push_and_scan(None, base, doc)

    def _wait_sweep(self, state, timeout=15.0):
        return self.M.TestRedetectd._wait_sweep(None, state, timeout)

    def test_backend_fault_degrades_never_raises(self):
        """tests/test_memo.py:143: a backend fault on get or put is a
        miss (None, 0 units written), never an exception; the entry is
        intact once the backend is back."""
        memo = FaultyMemo()
        memo.put_units("sha256:b1", "v1", {"os": {"q": "x", "hits": []}})
        memo.fail = True
        assert memo.get_entry("sha256:b1", "v1") is None
        assert memo.put_units("sha256:b1", "v1",
                              {"u": {"q": "y", "hits": []}}) == 0
        memo.fail = False
        assert "os" in memo.get_entry("sha256:b1", "v1")["units"]
        assert "u" not in memo.get_entry("sha256:b1", "v1")["units"]

    def test_memo_faults_fall_back_to_live_detect(self):
        """tests/test_memo.py:308: with the backend down every unit
        detects live with the memo-less report; once it is back the next
        scan stores and the one after replays, the same report."""
        from trivy_tpu_torch.fanal.cache import MemoryCache
        m = self.M
        table = m.memo_table()
        cache, memo = MemoryCache(), FaultyMemo()
        docs = [m.base_blob_doc(), m.thin_blob_doc(0)]
        m.put_blobs(cache, *docs)
        scanner = LocalScanner(cache, table, device="cpu", memo=memo)
        cold = LocalScanner(cache, table, device="cpu")
        scan = m.TestScanPathMemo().scan
        try:
            want = m.results_json(scan(cold, docs))
            memo.fail = True
            assert m.results_json(scan(scanner, docs)) == want
            v = table.content_digest()
            assert memo.key_stats(m.BASE_DIFF, v) == {"hits": 0,
                                                      "stores": 0}
            memo.fail = False
            assert m.results_json(scan(scanner, docs)) == want
            assert memo.key_stats(m.BASE_DIFF, v)["stores"] == 1
            assert m.results_json(scan(scanner, docs)) == want
            assert memo.key_stats(m.BASE_DIFF, v)["hits"] >= 1
        finally:
            scanner.close()
            cold.close()

    def test_drain_cancels_sweep_cleanly_no_leaked_threads(self):
        """tests/test_memo.py:460: slow memo reads stretch the sweep so a
        drain lands mid-flight; it cancels the sweep, whose thread ends,
        and no non-daemon thread outlives the server."""
        m = self.M
        t1, t2 = m.memo_table(0), m.memo_table(5)
        memo = FaultyMemo()
        baseline = {t.ident for t in threading.enumerate()
                    if not t.daemon}
        base, httpd, state = _serve(t1, memo)
        try:
            for i in range(10):
                code, _, _ = self._push_and_scan(base, m.thin_blob_doc(i))
                assert code == 200
            memo.slow_get_s = 0.08
            state.swap_table(t2)
            time.sleep(0.1)
            assert state.redetect.status()["phase"] in ("pending",
                                                        "sweeping")
            state.begin_drain()
            st = self._wait_sweep(state, timeout=10.0)
            assert st["phase"] == "cancelled"
            assert st["done"] < st["total"] == 10
            t = state.redetect._thread
            t.join(timeout=10.0)
            assert not t.is_alive()
        finally:
            memo.slow_get_s = 0.0
            _stop(httpd, state)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            leaked = [t.name for t in threading.enumerate()
                      if not t.daemon and t.ident not in baseline]
            if not leaked:
                break
            time.sleep(0.05)
        assert not leaked, f"leaked non-daemon threads: {leaked}"

    def test_newer_swap_preempts_running_sweep(self):
        """tests/test_memo.py:582: a swap while a slowed sweep runs
        preempts it; the newest version's sweep finishes."""
        m = self.M
        t1, t2, t3 = m.memo_table(0), m.memo_table(5), m.memo_table(9)
        memo = FaultyMemo()
        base, httpd, state = _serve(t1, memo)
        try:
            for i in range(8):
                self._push_and_scan(base, m.thin_blob_doc(i))
            memo.slow_get_s = 0.06
            state.swap_table(t2)
            time.sleep(0.05)
            memo.slow_get_s = 0.0
            state.swap_table(t3)
            st = self._wait_sweep(state)
            assert st["phase"] == "done"
            assert st["db_version"] == t3.content_digest()
            assert st["done"] == st["total"] == 8
            assert st["sweeps"] == 2
        finally:
            _stop(httpd, state)


# ---- the sweep's launches --------------------------------------------------

def test_sweep_launches_direct_under_the_redetect_site():
    """The sweep's replays join on the direct engine path, never in a
    merged detectd dispatch, and its launches carry the ledger site
    "redetect"; a live scan after it replays with no launch at all."""
    from trivy_tpu_torch.obs import LEDGER
    m = PORT_MEMO
    t1, t2 = m.memo_table(0), m.memo_table(5)
    base, httpd, state = _serve(t1, MemoryMemo())
    try:
        docs = [m.base_blob_doc()] + [m.thin_blob_doc(i) for i in range(3)]
        for d in docs:
            assert m.TestRedetectd._push_and_scan(None, base, d)[0] == 200
        LEDGER.reset_for_tests()
        state.swap_table(t2)
        st = m.TestRedetectd._wait_sweep(None, state)
        assert (st["phase"], st["done"], st["total"]) == ("done", 4, 4)
        assert state.scanner.sched.stats["dispatches"] == 0
        rows = LEDGER.shape_table()
        assert {r["site"] for r in rows} == {"redetect"}
        assert sum(r["dispatches"] for r in rows) > 0
        before = dict(state.scanner.sched.stats)
        assert m.TestRedetectd._push_and_scan(None, base, docs[0])[0] == 200
        assert state.scanner.sched.stats == before
    finally:
        _stop(httpd, state)


# ---- the delta flatten ------------------------------------------------------

@pytest.mark.parametrize("build", ["miss", "hit"])
def test_memoized_groups_never_alias_the_memo(build):
    """Every table built through the memo, the one whose build flattened
    the segment (a miss) as well as a later one (a hit), hands out its
    own groups: changing them leaves the memo, and every build after it,
    equal to a plain build."""
    from trivy_tpu_torch.db.table import FlattenMemo, build_table
    raw = PORT_MEMO.TestDeltaFlatten()._raw(3)
    memo = FlattenMemo()
    first = build_table(raw, memo=memo)
    target = first if build == "miss" else build_table(raw, memo=memo)
    for g in target.groups:
        g.rows.clear()
        g.vuln_id = "CHANGED"
    again = build_table(raw, memo=memo)
    plain = build_table(raw)
    assert again.content_digest() == plain.content_digest()
    assert [(g.vuln_id, g.rows) for g in again.groups] == \
        [(g.vuln_id, g.rows) for g in plain.groups]
    for g1, g2 in zip(target.groups, again.groups):
        assert g1 is not g2 and g1.rows is not g2.rows


# ---- state carried across the two packages ---------------------------------

def _scan_docs(scanner, docs, types=T):
    """One image of `docs`' blobs through `scanner` (either package's,
    with its `types`) → its results as sorted JSON."""
    ids = [d["DiffID"] for d in docs]
    results = scanner.scan_many([("img", ids[0], ids)],
                                types.ScanOptions())[0][0]
    return json.dumps([r.to_json() for r in results], sort_keys=True)


def test_tables_from_equal_advisories_share_a_content_digest():
    for seed in (0, 5):
        assert PORT_MEMO.memo_table(seed).content_digest() == \
            REF_MEMO.memo_table(seed).content_digest()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_fs_memo_entries_replay_across_packages(writer, tmp_path):
    """A memo entry written by one package's FSMemo replays in the
    other's: every unit of the second scan is a hit, no unit is stored
    again, and the report equals the writer's and a memo-less one."""
    from trivy_tpu.fanal.cache import MemoryCache as RefCache
    from trivy_tpu.fleet.memo import FSMemo as RefFSMemo
    from trivy_tpu.scanner import LocalScanner as RefScanner
    from trivy_tpu_torch.fanal.cache import MemoryCache
    docs = [PORT_MEMO.base_blob_doc(), PORT_MEMO.thin_blob_doc(3)]
    ref_cache, port_cache = RefCache(), MemoryCache()
    REF_MEMO.put_blobs(ref_cache, *docs)
    PORT_MEMO.put_blobs(port_cache, *docs)
    ref_memo, port_memo = RefFSMemo(str(tmp_path)), FSMemo(str(tmp_path))
    ref = RefScanner(ref_cache, REF_MEMO.memo_table(), memo=ref_memo)
    port = LocalScanner(port_cache, PORT_MEMO.memo_table(), device="cpu",
                        memo=port_memo)
    cold = LocalScanner(port_cache, PORT_MEMO.memo_table(), device="cpu")
    v = cold.table.content_digest()
    try:
        if writer == "reference":
            first, reader_memo = _scan_docs(ref, docs, RT), port_memo
            second = _scan_docs(port, docs)
        else:
            first, reader_memo = _scan_docs(port, docs), ref_memo
            second = _scan_docs(ref, docs, RT)
        assert first == second == _scan_docs(cold, docs)
        for d in docs:
            assert reader_memo.key_stats(d["DiffID"], v) == {"hits": 1,
                                                             "stores": 0}
        assert sorted(port_memo.known_blobs()) == \
            sorted(ref_memo.known_blobs()) == \
            sorted(d["DiffID"] for d in docs)
    finally:
        ref.close()
        port.close()
        cold.close()


# ---- the CLI ---------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _metric(base: str, name: str, **labels) -> float:
    from trivy_tpu_torch.obs.exposition import parse_exposition
    with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
        fams = parse_exposition(r.read().decode())
    return sum(v for n, lab, v in fams.get(name, {"samples": []})["samples"]
               if n == name and all(lab.get(k) == x
                                    for k, x in labels.items()))


def test_cli_server_memo_backend_fs(tmp_path):
    """`server --memo-backend fs --device cpu` as users run it: the
    second scan of an image replays every unit (memo hits in /metrics,
    no new store), /healthz shows the memo, and the entries sit under
    <cache-dir>/memo."""
    from trivy_tpu_torch.fanal.artifact import ImageArchiveArtifact
    from trivy_tpu_torch.server import client
    img = str(tmp_path / "img.tar")
    make_image(img, [{"etc/os-release": ALPINE_OS_RELEASE,
                      "lib/apk/db/installed": APK_INSTALLED}])
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    cache_dir = str(tmp_path / "cache")
    proc = subprocess.Popen(
        [sys.executable, "-m", "trivy_tpu_torch", "server", "--listen",
         f"127.0.0.1:{port}", "--db", FIXGLOB, "--cache-dir", cache_dir,
         "--device", "cpu", "--memo-backend", "fs",
         "--redetect-concurrency", "1"],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
        stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                urllib.request.urlopen(base + "/healthz", timeout=5)
                break
            except OSError:
                time.sleep(0.1)
        assert proc.poll() is None, proc.communicate()[1]
        ref = ImageArchiveArtifact(img, client.RemoteCache(base)).inspect()
        scanner = client.RemoteScanner(base)
        first, _ = scanner.scan(ref.name, ref.id, ref.blob_ids)
        hits = _metric(base, "trivy_tpu_memo_hits_total", backend="fs")
        stores = _metric(base, "trivy_tpu_memo_stores_total", backend="fs")
        assert (hits, stores) == (0.0, 1.0)
        second, _ = scanner.scan(ref.name, ref.id, ref.blob_ids)
        assert [r.to_json() for r in second] == \
            [r.to_json() for r in first]
        assert any(r.vulnerabilities for r in second)
        assert _metric(base, "trivy_tpu_memo_hits_total",
                       backend="fs") == 1.0
        assert _metric(base, "trivy_tpu_memo_stores_total",
                       backend="fs") == 1.0
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            memo = json.loads(r.read())["memo"]
        assert memo == {"backend": "fs", "known_blobs": 1,
                        "sweep": {"phase": "idle", "done": 0, "total": 0,
                                  "db_version": "", "sweeps": 0}}
        assert len(os.listdir(os.path.join(cache_dir, "memo"))) == 1
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err


def test_cli_unknown_memo_backend_exits_like_reference(tmp_path):
    with pytest.raises(SystemExit) as e:
        cli.main(["server", "--device", "cpu", "--db", FIXGLOB,
                  "--cache-dir", str(tmp_path), "--memo-backend", "bogus"])
    ref = subprocess.run(
        [sys.executable, "-m", "trivy_tpu.cli", "server", "--db", FIXGLOB,
         "--cache-dir", str(tmp_path / "ref"), "--memo-backend", "bogus"],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO,
                       "JAX_PLATFORMS": "cpu"},
        capture_output=True, text=True, timeout=120)
    assert ref.returncode == 1
    assert ref.stderr.strip().splitlines()[-1] == str(e.value)


@pytest.mark.parametrize("source", ["trivy.yaml", "env"])
def test_cli_memo_settings_from_config_and_env(source, tmp_path,
                                               monkeypatch):
    """`memo.backend` and `memo.redetect-concurrency` from trivy.yaml, or
    TRIVY_MEMO_BACKEND and TRIVY_REDETECT_CONCURRENCY, reach the
    server."""
    from trivy_tpu_torch.server import listen
    got = {}
    monkeypatch.setattr(listen, "serve",
                        lambda *a, **kw: got.update(kw))
    monkeypatch.chdir(tmp_path)
    if source == "env":
        monkeypatch.setenv("TRIVY_MEMO_BACKEND", "memory")
        monkeypatch.setenv("TRIVY_REDETECT_CONCURRENCY", "0")
    else:
        (tmp_path / "trivy.yaml").write_text(
            "memo:\n  backend: memory\n  redetect-concurrency: 0\n")
    assert cli.main(["server", "--device", "cpu", "--db", FIXGLOB,
                     "--cache-dir", str(tmp_path)]) == 0
    assert got["memo_backend"] == "memory"
    assert got["redetect_opts"].concurrency == 0


# ---- the chip script's memo phase, small, on the CPU -----------------------

def test_chip_smoke_memo_phase_on_cpu(tmp_path, capsys):
    """chip_smoke.memo_phase at a tenth of the apps table, 4 images and
    64-128 KiB of text a thin layer, on the CPU: its checks hold and its
    figures line is printed."""
    sys.path.insert(0, REPO)
    import chip_smoke
    rng = np.random.default_rng(chip_smoke.SEED + 6)
    table, deb, names, raw = chip_smoke.apps_table(rng, shrink=10)
    fig = chip_smoke.memo_phase(str(tmp_path), table, deb, names, raw,
                                n_images=4, device="cpu",
                                text=(1 << 16, 1 << 17))
    assert fig["sweep"]["done"] == fig["sweep"]["total"] == 5
    assert fig["round_b"]["replayed"] == fig["round_b"]["units"]
    assert fig["round_c"]["replayed"] == fig["round_c"]["units"]
    assert fig["launches_by_site"].get("redetect", 0) > 0
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith('{"phase": "memo"')]
    assert len(line) == 1
