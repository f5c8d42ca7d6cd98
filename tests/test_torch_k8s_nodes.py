"""The port's node collector and node scans (trivy_tpu_torch/k8s/
nodes.py) held against the JAX package's k8s/nodes.py on the CPU, at
tolerance 0:

  * every case of tests/test_k8s_nodes.py: through test_torch_mirror's
    twins (the checks, the collector end to end against the file's own
    fake cluster, --exclude-nodes, the Job's manifest and name), and
    TestNodeVulns on the port alone with device="cpu" (the JAX file
    builds its LocalScanner without one), held to the JAX package
    below;
  * NODE_CHECKS and _eval_check over every check kind and value shape,
    the permission bitmask included;
  * _job_name, _truncate_digest and _node_label on seeded node names up
    to cloud FQDN lengths, and _job_manifest;
  * node_vuln_apps and the batched scan_node_vulns (one detect_many for
    every node) on chip_smoke.K8S_NODES and seeded versions, against
    the JAX package's results;
  * collect_node_info and scan_infra against trivy_tpu_torch.k8s.
    fixtures.FakeKubeAPI: the Job posted, its log parsed, the Job
    deleted, node exclusion by label, and a node whose collector log is
    not JSON degrading to a warning in both packages."""

import json
import os

import numpy as np
import pytest

import chip_smoke
from test_torch_mirror import port_cases, run_case, twin_cases
from trivy_tpu.db.table import RawAdvisory as RefRaw
from trivy_tpu.db.table import build_table as ref_build
from trivy_tpu.fanal.cache import MemoryCache as RefCache
from trivy_tpu.k8s import client as ref_client
from trivy_tpu.k8s import kubeconfig as ref_kubeconfig
from trivy_tpu.k8s import nodes as ref_nodes
from trivy_tpu.scanner import LocalScanner as RefScanner
from trivy_tpu_torch.db.table import build_table
from trivy_tpu_torch.fanal.cache import MemoryCache
from trivy_tpu_torch.k8s import client as port_client
from trivy_tpu_torch.k8s import kubeconfig as port_kubeconfig
from trivy_tpu_torch.k8s import nodes as port_nodes
from trivy_tpu_torch.k8s.fixtures import FakeKubeAPI
from trivy_tpu_torch.scanner import LocalScanner

_PORT_ONLY = ("TestNodeVulns::",)
_PORT_SUBS = [("return LocalScanner(MemoryCache(), build_table(advs, "
               "details))",
               "return LocalScanner(MemoryCache(), build_table(advs, "
               "details), device=\"cpu\")")]


def test_every_reference_case_is_accounted_for():
    ids = {c.id for c in port_cases("test_k8s_nodes.py", subs=_PORT_SUBS)}
    port = {i for i in ids if i.startswith(_PORT_ONLY)}
    assert len(ids) == 11 and len(port) == 3


@pytest.mark.parametrize("cls,fn,given", twin_cases(
    "test_k8s_nodes.py", keep=lambda c: not c.startswith(_PORT_ONLY)))
def test_nodes_case_like_reference(cls, fn, given, request):
    run_case(cls, fn, request, given)


@pytest.mark.parametrize("cls,fn,given", port_cases(
    "test_k8s_nodes.py", keep=lambda c: c.startswith(_PORT_ONLY),
    subs=_PORT_SUBS))
def test_nodes_case_on_port(cls, fn, given, request):
    run_case(cls, fn, request, given)


# ---- the checks --------------------------------------------------------

VALUES = [[], [600], [644], [577], [400], ["600"], ["0600"], [700], [755],
          ["abc"], [None], ["root:root"], ["root:admin"], ["true"],
          ["TRUE"], ["false"], ["AlwaysAllow"], ["Webhook"], ["0"],
          ["10255"], [""], ["/etc/kubernetes/pki/ca.crt"], [0]]


def test_node_checks_equal():
    assert port_nodes.NODE_CHECKS == ref_nodes.NODE_CHECKS
    assert port_nodes.DEFAULT_COLLECTOR_IMAGE == \
        ref_nodes.DEFAULT_COLLECTOR_IMAGE


@pytest.mark.parametrize("kind,expected", sorted(
    {(k, e) for *_h, k, e in ref_nodes.NODE_CHECKS}, key=repr) +
    [("unknown", None)])
def test_eval_check_like_reference(kind, expected):
    for values in VALUES:
        assert port_nodes._eval_check(kind, expected, values) == \
            ref_nodes._eval_check(kind, expected, values), values


def test_scan_node_infra_on_every_check():
    """Seeded nodes, each check present or not with a value of any
    shape."""
    rng = np.random.default_rng(3)
    for _ in range(40):
        info = {key: {"values": VALUES[int(rng.integers(len(VALUES)))]}
                for _i, _t, _s, key, _k, _e in port_nodes.NODE_CHECKS
                if rng.random() < 0.6}
        doc = {"info": info}
        assert port_nodes.scan_node_infra(doc, "n1").to_json() == \
            ref_nodes.scan_node_infra(doc, "n1").to_json()


# ---- the Job ---------------------------------------------------------

def _names(n: int = 60) -> list:
    rng = np.random.default_rng(11)
    out = ["n1", "worker-a", "a" * 63, "a" * 64, "b" * 200]
    for _ in range(n):
        zone = "".join(chr(97 + int(c)) for c in rng.integers(0, 26, 12))
        out.append(f"ip-10-{rng.integers(0, 255)}-{rng.integers(0, 255)}-"
                   f"{rng.integers(0, 255)}.{zone}.compute.internal")
    return out


def test_job_names_and_labels_like_reference():
    jobs = set()
    for name in _names():
        for fn in ("_job_name", "_node_label", "_truncate_digest"):
            assert getattr(port_nodes, fn)(name) == \
                getattr(ref_nodes, fn)(name)
        job = port_nodes._job_name(name)
        assert len(job) <= 63 and job.startswith("node-collector-")
        jobs.add(job)
        assert len(port_nodes._node_label(name)) <= 63
    assert len(jobs) == len(_names())


@pytest.mark.parametrize("tolerations", [None, [
    {"key": "node-role.kubernetes.io/control-plane", "operator": "Exists",
     "effect": "NoSchedule"}]])
def test_job_manifest_like_reference(tolerations):
    for name in _names(8):
        args = (name, "trivy-temp", port_nodes.DEFAULT_COLLECTOR_IMAGE,
                port_nodes._job_name(name), tolerations)
        assert port_nodes._job_manifest(*args) == \
            ref_nodes._job_manifest(*args)


# ---- node vulnerabilities ----------------------------------------------

def _node_docs(rng, n: int) -> list:
    docs = [{"metadata": {"name": name, "labels": labels},
             "status": {"nodeInfo": {"kubeletVersion": kubelet,
                                     "containerRuntimeVersion": runtime}}}
            for name, kubelet, runtime, labels, _t in chip_smoke.K8S_NODES]
    for i in range(n):
        runtime = ["containerd://1.{}.{}", "cri-o://1.{}.{}",
                   "docker://2{}.0.{}", "unknown://1.{}.{}"][i % 4]
        docs.append({"metadata": {"name": f"node-{i}"}, "status": {
            "nodeInfo": {
                "kubeletVersion": f"v1.{rng.integers(24, 31)}."
                                  f"{rng.integers(0, 15)}" if i % 5 else "",
                "containerRuntimeVersion": runtime.format(
                    rng.integers(5, 8), rng.integers(0, 30))}}})
    return docs


@pytest.fixture(scope="module")
def scanners():
    """The port's and the JAX package's scanners over the chip script's
    component rows."""
    rows = chip_smoke.k8s_component_rows(np.random.default_rng(19))
    ref_rows = [RefRaw(**{f: getattr(r, f) for f in (
        "source", "ecosystem", "pkg_name", "vuln_id", "vulnerable_ranges",
        "severity")}) for r in rows]
    return (LocalScanner(MemoryCache(), build_table(rows), device="cpu"),
            RefScanner(RefCache(), ref_build(ref_rows)), rows)


def test_node_vulns_like_reference(scanners):
    docs = _node_docs(np.random.default_rng(4), 24)
    for doc in docs:
        assert [a.to_json() for a in port_nodes.node_vuln_apps(doc)] == \
            [a.to_json() for a in ref_nodes.node_vuln_apps(doc)]
    got = port_nodes.scan_node_vulns(docs, scanners[0])
    assert [r.to_json() for r in got] == \
        [r.to_json() for r in ref_nodes.scan_node_vulns(docs, scanners[1])]
    found = {(r.target, v.pkg_name, v.vulnerability_id) for r in got
             for v in r.vulnerabilities}
    assert {f for f in found if not f[0].startswith("node-")} == \
        chip_smoke.k8s_expected_node_vulns(scanners[2]) | {
            f for f in found if f[0] == "spot-a"}
    assert port_nodes.scan_node_vulns([], scanners[0]) == []


def test_node_vulns_are_one_detect_many(scanners, monkeypatch):
    calls = []
    det = scanners[0].detector
    real = det.detect_many

    def counted(batches):
        calls.append(len(batches))
        return real(batches)
    monkeypatch.setattr(det, "detect_many", counted)
    port_nodes.scan_node_vulns(_node_docs(np.random.default_rng(5), 10),
                               scanners[0])
    assert len(calls) == 1 and calls[0] >= 10


# ---- the collector against FakeKubeAPI -----------------------------------

@pytest.fixture
def cluster():
    routes, infos, _carried, _owned = chip_smoke.k8s_cluster(
        np.random.default_rng(2), ["http://127.0.0.1:1/x:1"])
    infos["worker-c"] = "not json"
    api = FakeKubeAPI(routes, infos, token="t")
    api.start()
    yield api
    api.stop()


def _clients(api) -> tuple:
    url = f"http://127.0.0.1:{api.port}"
    return (port_client.KubeClient(port_kubeconfig.KubeConfig(
                server=url, token="t")),
            ref_client.KubeClient(ref_kubeconfig.KubeConfig(
                server=url, token="t")))


def test_collector_like_reference(cluster):
    port, ref = _clients(cluster)
    got = port_nodes.collect_node_info(port, "worker-a", poll_interval=0.01)
    assert got == ref_nodes.collect_node_info(ref, "worker-a",
                                              poll_interval=0.01)
    assert got["type"] == "worker"
    posted = [(m, p) for m, p in cluster.requests if m == "POST"]
    assert posted == [
        ("POST", "/apis/batch/v1/namespaces/trivy-temp/jobs")] * 2
    assert cluster.jobs == {} and cluster.deleted == \
        [port_nodes._job_name("worker-a")] * 2
    for mod, c in ((port_nodes, port), (ref_nodes, ref)):
        with pytest.raises(Exception, match="unparseable on worker-c"):
            mod.collect_node_info(c, "worker-c", poll_interval=0.01)
    assert cluster.jobs == {}


@pytest.mark.parametrize("exclude", [None, {"pool": "spot"},
                                     {"pool": "general"}])
def test_scan_infra_like_reference(cluster, scanners, exclude):
    port, ref = _clients(cluster)
    got = port_nodes.scan_infra(port, scanner=scanners[0],
                                exclude_labels=exclude,
                                scanners=("misconfig", "vuln"))
    want = ref_nodes.scan_infra(ref, scanner=scanners[1],
                                exclude_labels=exclude,
                                scanners=("misconfig", "vuln"))
    assert [r.to_json() for r in got] == [r.to_json() for r in want]
    infra = {r.target for r in got if r.type == "node-info"}
    skipped = {n for n, *_r, labels, _t in chip_smoke.K8S_NODES
               if exclude and labels.get("pool") == exclude["pool"]}
    # worker-c's collector output is not JSON: a warning, no result
    assert infra == {n for n, *_ in chip_smoke.K8S_NODES} - skipped - \
        {"worker-c"}
    assert not any(r.target in skipped for r in got)
    assert cluster.jobs == {}


def test_node_enumeration_failure_degrades(cluster):
    url = f"http://127.0.0.1:{cluster.port}"
    for nodes, kc in ((port_nodes, port_kubeconfig),
                      (ref_nodes, ref_kubeconfig)):
        client = (port_client if nodes is port_nodes else ref_client)\
            .KubeClient(kc.KubeConfig(server=url, token="wrong"))
        assert nodes.scan_infra(client, scanners=("misconfig",)) == []


def test_fake_api_serves_the_collector_flow(cluster, tmp_path):
    """FakeKubeAPI itself: the kubeconfig it writes, 401 without the
    token, a Job's pod already Succeeded, its log the node's output."""
    port, _ref = _clients(cluster)
    cfg = port_kubeconfig.load_kubeconfig(
        cluster.write_kubeconfig(str(tmp_path / "kc"), namespace="ns1"))
    assert (cfg.server, cfg.token, cfg.namespace) == (
        f"http://127.0.0.1:{cluster.port}", "t", "ns1")
    bare = port_client.KubeClient(port_kubeconfig.KubeConfig(
        server=cfg.server))
    with pytest.raises(port_client.KubeError) as e:
        bare.nodes()
    assert e.value.code == 401
    job = port_nodes._job_name("cp-1")
    port.create("apis/batch/v1", "trivy-temp", "jobs",
                port_nodes._job_manifest("cp-1", "trivy-temp", "img:1", job))
    pods = port.pods_by_label("trivy-temp", f"job-name={job}")
    assert [p["status"]["phase"] for p in pods] == ["Succeeded"]
    log = port.pod_logs("trivy-temp", pods[0]["metadata"]["name"])
    assert json.loads(log)["type"] == "master"
    port.delete("apis/batch/v1", "trivy-temp", "jobs", job)
    assert cluster.jobs == {} and cluster.deleted == [job]
    assert port.pods_by_label("trivy-temp", f"job-name={job}") == []
    assert os.path.exists(tmp_path / "kc")
