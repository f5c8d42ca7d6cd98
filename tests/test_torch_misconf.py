"""Misconfiguration scanning of the port (trivy_tpu_torch.misconf,
iac.kubernetes, iac.detection, fanal.analyzers.misconf) held against the
JAX package with tolerance 0 (equal JSON): the Dockerfile parser and
checks, the Kubernetes checks, file-type detection, the misconf analyzer
with user rego checks and exceptions, the cache round trip and the
applier; the Dockerfile goldens with the assertions of
tests/test_golden_helm.py; both CLIs on the golden inputs and on a seeded
tree (chip_smoke.misconf_files), byte for byte, in fs, repo and image
--input, json, table and sarif; a CloudFormation, Terraform, Terraform
plan and ARM file each through both analyzers and both CLIs; and the
settings of one scan (user checks, rego trace) kept apart from a
concurrent scan's."""

import contextlib
import io
import json
import os

import numpy as np
import pytest

import chip_smoke
import trivy_tpu.cli as ref_cli
from trivy_tpu import misconf as ref_misconf
from trivy_tpu.fanal import analyzers as ref_an
from trivy_tpu.fanal import applier as ref_applier
from trivy_tpu.iac import detection as ref_detection
from trivy_tpu.iac import helm as ref_helm
from trivy_tpu.iac import kubernetes as ref_k8s
from trivy_tpu.iac import rego as ref_rego
from trivy_tpu.misconf import dockerfile as ref_docker
from trivy_tpu_torch import __main__ as cli
from trivy_tpu_torch import misconf as port_misconf
from trivy_tpu_torch import types as T
from trivy_tpu_torch.fanal import analyzers as port_an
from trivy_tpu_torch.fanal import applier as port_applier
from trivy_tpu_torch.fanal import cache as port_cache
from trivy_tpu_torch.fanal.fixtures import (gz_bytes, sha256_hex, tar_bytes,
                                            write_docker_archive)
from trivy_tpu_torch.iac import detection as port_detection
from trivy_tpu_torch.iac import helm as port_helm
from trivy_tpu_torch.iac import kubernetes as port_k8s
from trivy_tpu_torch.iac import rego as port_rego
from trivy_tpu_torch.misconf import dockerfile as port_docker

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden")
INPUTS = os.path.join(GOLDEN, "inputs")
DB = os.path.join(HERE, "fixtures", "db", "*.yaml")
NOW = "2026-10-17T00:00:00Z"


def clear_misconf_state() -> None:
    """The three process-wide settings of both packages: the custom-check
    scanner, the rego trace sink and the helm value overrides."""
    for misconf, rego, helm in ((port_misconf, port_rego, port_helm),
                                (ref_misconf, ref_rego, ref_helm)):
        misconf.set_custom_checks([])
        rego.set_rego_trace(None)
        helm.set_helm_overrides()


@pytest.fixture(autouse=True)
def _misconf_state():
    clear_misconf_state()
    yield
    clear_misconf_state()


@pytest.fixture
def work(tmp_path, monkeypatch):
    """A working directory of both CLIs, with the clock fixed."""
    w = tmp_path / "work"
    w.mkdir()
    monkeypatch.chdir(w)
    monkeypatch.setenv("TRIVY_TPU_FAKE_NOW", NOW)
    for k in [k for k in os.environ if k.startswith("TRIVY_")
              and k != "TRIVY_TPU_FAKE_NOW"]:
        monkeypatch.delenv(k)
    return tmp_path


def run_both(argv, tmp_path, rc=0, tag="") -> tuple:
    """Both CLIs in this process, each with its own cache dir and output
    file, the JAX package's process-wide misconf settings cleared first
    as a fresh process has them → (port bytes, reference bytes)."""
    outs = {}
    for who, main in (("port", cli.main), ("ref", ref_cli.main)):
        clear_misconf_state()
        out = str(tmp_path / f"{who}{tag}.out")
        extra = ["--cache-dir", str(tmp_path / f"{who}-cache{tag}")]
        if who == "port":
            extra += ["--device", "cpu"]
        with contextlib.redirect_stdout(io.StringIO()):
            got = main(argv + ["--output", out] + extra)
        assert got == rc, (who, got)
        with open(out, "rb") as f:
            outs[who] = f.read()
    return outs["port"], outs["ref"]


def write_tree(root, files: dict) -> str:
    for rel, data in files.items():
        path = os.path.join(str(root), rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
    return str(root)


def seeded_tree(seed: int = 5, n_docker: int = 8, n_k8s: int = 24):
    return chip_smoke.misconf_files(np.random.default_rng(seed),
                                    n_docker=n_docker, n_k8s=n_k8s)


def _failures_json(failures) -> list:
    return [f.to_json() for f in failures]


# --- the Dockerfile parser and checks ---------------------------------

GOLDEN_DOCKERFILES = [os.path.join(INPUTS, d, n) for d, n in (
    ("dockerfile", "Dockerfile"), ("dockerfile_file_pattern", "Customfile"),
    ("custom-policy", "Dockerfile"), ("namespace-exception", "Dockerfile"),
    ("rule-exception", "Dockerfile"))]


def _dockerfiles() -> dict:
    files, *_ = seeded_tree(11, n_docker=40, n_k8s=0)
    out = {p: d for p, d in files.items() if p.endswith("Dockerfile")}
    for path in GOLDEN_DOCKERFILES:
        with open(path, "rb") as f:
            out[os.path.relpath(path, INPUTS)] = f.read()
    out["edge/Dockerfile"] = (
        b"# syntax=docker/dockerfile:1\nFROM --platform=linux/amd64 "
        b"node:20 AS base\nARG V=1\nRUN apt-get update && \\\n    "
        b"apt-get install -y curl \\\n    && rm -rf /var/lib/apt\n"
        b"FROM base AS base\nCOPY --from=base a b\nCOPY a b c\n"
        b"WORKDIR $HOME/x\nEXPOSE 80/tcp 443\nUSER 0:0\n"
        b"HEALTHCHECK NONE\nHEALTHCHECK CMD true\n")
    return out


DOCKERFILES = _dockerfiles()


@pytest.mark.parametrize("path", sorted(DOCKERFILES))
def test_dockerfile_like_reference(path):
    data = DOCKERFILES[path]
    port = [vars(i) for i in port_docker.parse_dockerfile(data.decode())]
    ref = [vars(i) for i in ref_docker.parse_dockerfile(data.decode())]
    assert port == ref
    pf, ps = port_docker.scan_dockerfile(path, data)
    rf, rs = ref_docker.scan_dockerfile(path, data)
    assert (_failures_json(pf), ps) == (_failures_json(rf), rs)


def test_dockerfile_checks_match_reference():
    assert [c.id for c in port_docker.CHECKS] == \
        [c.id for c in ref_docker.CHECKS]
    rego = port_misconf.dockerfile_rego_input(DOCKERFILES[
        "dockerfile/Dockerfile"])
    assert rego == ref_misconf.dockerfile_rego_input(DOCKERFILES[
        "dockerfile/Dockerfile"])


@pytest.mark.parametrize("plant", sorted(chip_smoke.DOCKER_PLANTS))
def test_dockerfile_plant_fails_its_check(plant):
    """Each of chip_smoke's Dockerfile plants fails its check, in both
    packages, on a Dockerfile that is otherwise clean."""
    base = chip_smoke.DOCKERFILE.format(name="svc")
    text = base.replace(*chip_smoke.DOCKER_PLANTS[plant], 1).encode()
    assert port_docker.scan_dockerfile("Dockerfile", base.encode())[0] == []
    pf, _ = port_docker.scan_dockerfile("Dockerfile", text)
    rf, _ = ref_docker.scan_dockerfile("Dockerfile", text)
    assert plant in {f.id for f in pf}
    assert _failures_json(pf) == _failures_json(rf)


# the Dockerfile goldens, with tests/test_golden_helm.py's assertions

def _golden_failures(name):
    with open(os.path.join(GOLDEN, name)) as f:
        doc = json.load(f)
    return {r["Target"]: sorted(m["ID"] for m in
                                r.get("Misconfigurations") or [])
            for r in doc.get("Results", [])}


def test_golden_dockerfile():
    with open(os.path.join(INPUTS, "dockerfile", "Dockerfile"), "rb") as f:
        failures, _ = port_docker.scan_dockerfile("Dockerfile", f.read())
    assert sorted(m.id for m in failures) == \
        _golden_failures("dockerfile.json.golden")["Dockerfile"]


def test_golden_dockerfile_file_pattern():
    with open(os.path.join(INPUTS, "dockerfile_file_pattern",
                           "Customfile"), "rb") as f:
        failures, _ = port_docker.scan_dockerfile("Customfile", f.read())
    assert sorted(m.id for m in failures) == \
        _golden_failures("dockerfile_file_pattern.json.golden")["Customfile"]


def _scan_with_policies(input_dir, policy_dir, namespaces=None):
    port_misconf.set_custom_checks([policy_dir], namespaces=namespaces)
    a = next(x for x in port_an.AnalyzerGroup().analyzers
             if x.name == "misconf")
    with open(os.path.join(input_dir, "Dockerfile"), "rb") as f:
        res = a.analyze("Dockerfile", f.read())
    assert res is not None
    return res.misconfigurations[0]


def test_golden_dockerfile_custom_policies():
    mc = _scan_with_policies(os.path.join(INPUTS, "custom-policy"),
                             os.path.join(INPUTS, "custom-policy", "policy"),
                             namespaces=["user"])
    got = sorted((m.id, m.message) for m in mc.failures
                 if m.namespace.startswith("user."))
    assert got == [("N/A", "something bad: bar"),
                   ("N/A", "something bad: foo")]
    assert sorted(m.id for m in mc.failures) == _golden_failures(
        "dockerfile-custom-policies.json.golden")["Dockerfile"]


def test_golden_dockerfile_namespace_exception():
    mc = _scan_with_policies(
        os.path.join(INPUTS, "namespace-exception"),
        os.path.join(INPUTS, "namespace-exception", "policy"))
    assert mc.failures == []
    assert mc.successes == 0
    assert mc.exceptions == len(port_docker.CHECKS)


def test_golden_dockerfile_rule_exception():
    mc = _scan_with_policies(os.path.join(INPUTS, "rule-exception"),
                             os.path.join(INPUTS, "rule-exception",
                                          "policy"))
    assert sorted(m.id for m in mc.failures) == _golden_failures(
        "dockerfile-rule-exception.json.golden")["Dockerfile"]


@pytest.mark.parametrize("rules,excepted", [('["nosuchrule"]', False),
                                            ('[""]', True)])
def test_rule_exception_suffixes(rules, excepted, tmp_path):
    p = tmp_path / "policy"
    p.mkdir()
    (p / "exc.rego").write_text(
        "package builtin.dockerfile.DS002\n\nexception[rules] {\n"
        f"\trules := {rules}\n}}\n")
    mc = _scan_with_policies(os.path.join(INPUTS, "rule-exception"), str(p))
    assert ("DS002" in {m.id for m in mc.failures}) != excepted


# --- the Kubernetes checks ---------------------------------------------

def _manifests() -> dict:
    files, *_ = seeded_tree(12, n_docker=0, n_k8s=60)
    return {p: d for p, d in files.items() if p.startswith("deploy/k8s/")}


MANIFESTS = _manifests()
_CHUNKS = [sorted(MANIFESTS)[i::6] for i in range(6)]


@pytest.mark.parametrize("chunk", range(len(_CHUNKS)))
def test_kubernetes_like_reference(chunk):
    for path in _CHUNKS[chunk]:
        data = MANIFESTS[path]
        pf, ps = port_k8s.scan_kubernetes(path, data)
        rf, rs = ref_k8s.scan_kubernetes(path, data)
        assert (_failures_json(pf), ps) == (_failures_json(rf), rs), path
        assert pf


@pytest.mark.parametrize("plant", sorted(chip_smoke.K8S_PLANTS))
@pytest.mark.parametrize("kind", ["Deployment", "CronJob"])
def test_kubernetes_plant_fails_its_check(plant, kind):
    import yaml
    clean = yaml.safe_dump(chip_smoke.k8s_workload(kind, "a", []))
    assert port_k8s.scan_kubernetes("a.yaml", clean.encode())[0] == []
    text = yaml.safe_dump(chip_smoke.k8s_workload(kind, "a", [plant]))
    pf, ps = port_k8s.scan_kubernetes("a.yaml", text.encode())
    rf, rs = ref_k8s.scan_kubernetes("a.yaml", text.encode())
    assert plant in {f.id for f in pf}
    assert (_failures_json(pf), ps) == (_failures_json(rf), rs)


RBAC = b"""\
apiVersion: rbac.authorization.k8s.io/v1
kind: ClusterRole
metadata:
  name: too-much
rules:
- apiGroups: ["*"]
  resources: ["*"]
  verbs: ["*"]
- apiGroups: [""]
  resources: ["secrets", "configmaps", "pods/exec", "pods/log"]
  verbs: ["get", "create", "delete", "impersonate"]
---
apiVersion: v1
kind: Pod
metadata:
  name: win
  annotations:
    container.apparmor.security.beta.kubernetes.io/c: unconfined
spec:
  securityContext:
    windowsOptions:
      hostProcess: true
    sysctls:
    - name: kernel.shm_rmid_forced
      value: "1"
  containers:
  - name: c
    image: c@sha256:abc
    securityContext:
      procMount: Unmasked
      seLinuxOptions:
        type: custom
      capabilities:
        add: [NET_BIND_SERVICE, NET_RAW]
"""


def test_kubernetes_rbac_and_rare_fields_like_reference():
    pf, ps = port_k8s.scan_kubernetes("rbac.yaml", RBAC)
    rf, rs = ref_k8s.scan_kubernetes("rbac.yaml", RBAC)
    assert (_failures_json(pf), ps) == (_failures_json(rf), rs)
    assert len({f.id for f in pf}) >= 6
    assert [c.id for c in port_k8s.CHECKS] == [c.id for c in ref_k8s.CHECKS]


# --- detection and the analyzer ---------------------------------------

CFN = b"AWSTemplateFormatVersion: '2010-09-09'\nResources:\n  B:\n" \
      b"    Type: AWS::S3::Bucket\n"
TFPLAN = json.dumps({"format_version": "1.2", "terraform_version": "1.6.0",
                     "planned_values": {"root_module": {}}}).encode()
ARM = json.dumps({"$schema": "https://schema.management.azure.com/schemas/"
                             "2019-04-01/deploymentTemplate.json#",
                  "resources": []}).encode()
TF = b'resource "aws_s3_bucket" "b" {\n  bucket = "x"\n}\n'
# one file of each infrastructure-as-code type beside the Dockerfile,
# Kubernetes and Helm ones
IAC = {"cloudformation": ("infra/stack.yaml", CFN),
       "terraform": ("infra/main.tf", TF),
       "terraformplan": ("infra/plan.json", TFPLAN),
       "azure-arm": ("infra/azuredeploy.json", ARM)}

SNIFF_CASES = [("Dockerfile", b"FROM a"), ("x/Dockerfile.prod", b""),
               ("a.dockerfile", b""), ("Containerfile", b"FROM a"),
               ("k.yaml", MANIFESTS[sorted(MANIFESTS)[0]]),
               ("k.json", json.dumps({"apiVersion": "v1",
                                      "kind": "Pod"}).encode()),
               ("a.yml", b"apiVersion: [unclosed"), ("x.yaml", b"a: 1"),
               ("values.toml", b"a = 1"), ("terraform.tfvars", b"a = 1"),
               ("big.yaml", b"apiVersion: v1\nkind: Pod\n" + b"#" * (
                   3 * 1024 * 1024))] + list(IAC.values())


@pytest.mark.parametrize("i", range(len(SNIFF_CASES)))
def test_detection_like_reference(i):
    path, data = SNIFF_CASES[i]
    port_t, port_docs = port_detection.sniff(path, data)
    ref_t, ref_docs = ref_detection.sniff(path, data)
    assert port_t == ref_t
    assert json.dumps(port_docs, sort_keys=True, default=str) == \
        json.dumps(ref_docs, sort_keys=True, default=str)
    assert port_misconf.detect_file_type(path) == \
        ref_misconf.detect_file_type(path)


def _misconf_analyzers():
    port = next(a for a in port_an.AnalyzerGroup().analyzers
                if a.name == "misconf")
    ref = next(a for a in ref_an.AnalyzerGroup().analyzers
               if a.name == "misconf")
    return port, ref


def _analyze_json(analyzer, path, data):
    r = analyzer.analyze(path, data)
    return None if r is None else [m.to_json() for m in r.misconfigurations]


@pytest.mark.parametrize("custom", [False, True])
def test_misconf_analyzer_like_reference(custom, tmp_path):
    files, *_ = seeded_tree(13, n_docker=10, n_k8s=30)
    files["conf/app.toml"] = b'[server]\nport = 8080\n'
    files["conf/settings.json"] = b'{"replicas": 1}'
    if custom:
        checks = tmp_path / "checks"
        checks.mkdir()
        for name, text in chip_smoke.MISCONF_CHECKS.items():
            (checks / name).write_text(text)
        (checks / "toml.rego").write_text(
            "package user.toml\n\ndeny[msg] {\n\tinput.server.port == 8080\n"
            "\tmsg := \"default port\"\n}\n")
        for misconf in (port_misconf, ref_misconf):
            misconf.set_custom_checks([str(checks)], namespaces=["user"])
    port, ref = _misconf_analyzers()
    seen = 0
    for path, data in sorted(files.items()):
        if not (port.required(path) or ref.required(path)):
            continue
        assert port.required(path) == ref.required(path)
        got = _analyze_json(port, path, data)
        assert got == _analyze_json(ref, path, data), path
        seen += got is not None
    assert seen >= 40


@pytest.mark.parametrize("ftype", sorted(IAC))
def test_iac_type_analyzed_like_reference(ftype):
    """The analyzer that takes the type (the module-scoped terraform
    post-analyzer, else misconf) records it as the JAX one does."""
    path, data = IAC[ftype]
    records = []
    for group in (port_an.AnalyzerGroup(), ref_an.AnalyzerGroup()):
        if ftype == "terraform":
            a = next(a for a in group.post_analyzers
                     if a.name == "terraform")
            r = a.post_analyze({path: data}) if a.required(path) else None
        else:
            a = next(a for a in group.analyzers if a.name == "misconf")
            r = a.analyze(path, data) if a.required(path) else None
        records.append(None if r is None else
                       [m.to_json() for m in r.misconfigurations])
    assert records[0] == records[1]
    if ftype in ("cloudformation", "terraform"):
        assert records[0][0]["FileType"] == ftype
        assert records[0][0]["Failures"]


def test_custom_checks_fingerprint_like_reference(tmp_path):
    checks = tmp_path / "checks"
    checks.mkdir()
    (checks / "a.rego").write_text(chip_smoke.MISCONF_CHECKS["curlsh.rego"])
    data = tmp_path / "data.yaml"
    data.write_text("x: 1\n")
    assert port_misconf.custom_checks_fingerprint() == ""
    fps = []
    for misconf in (port_misconf, ref_misconf):
        misconf.set_custom_checks([str(checks)], data_paths=[str(data)],
                                  namespaces=["user", "ops"])
        fps.append(misconf.custom_checks_fingerprint())
    assert fps[0] == fps[1] != ""
    (checks / "a.rego").write_text("package user.x\n")
    port_misconf.set_custom_checks([str(checks)], data_paths=[str(data)],
                                   namespaces=["user", "ops"])
    assert port_misconf.custom_checks_fingerprint() != fps[0]
    port_misconf.set_custom_checks([])
    assert port_misconf.custom_checks_scanner() is None


def test_image_keys_carry_the_fingerprint_only_when_set(tmp_path):
    """The keys carry the user checks of the artifact's own group: from
    its MisconfSettings, or from the process default when the group was
    built without them, as the JAX package's keys do."""
    from trivy_tpu_torch.fanal.artifact import ImageArchiveArtifact
    from trivy_tpu_torch.fanal.cache import cache_key

    def keys(group):
        art = ImageArchiveArtifact(str(tmp_path / "none.tar"),
                                   port_cache.MemoryCache(), group=group)
        return art._image_keys("sha256:" + "1" * 64,
                               ["sha256:" + "2" * 64]), art
    plain, art = keys(port_an.AnalyzerGroup())
    versions = art.group.versions()
    assert plain[0] == cache_key("sha256:" + "1" * 64, versions,
                                 {"scanners": sorted(art.scanners)})
    checks = tmp_path / "c"
    checks.mkdir()
    (checks / "a.rego").write_text("package user.a\n")
    own = port_misconf.MisconfSettings.from_flags([str(checks)])
    keyed, _ = keys(port_an.AnalyzerGroup(misconf=own))
    assert keyed[0] != plain[0] and keyed[1] != plain[1]
    # the process default reaches a group built after it is set, and
    # equals the JAX package's key
    port_misconf.set_custom_checks([str(checks)])
    assert port_misconf.custom_checks_fingerprint() == own.fingerprint()
    assert keys(port_an.AnalyzerGroup())[0] == keyed
    port_misconf.set_custom_checks([])
    assert keys(port_an.AnalyzerGroup())[0] == plain


# --- the blob's misconfigurations: cache and applier ------------------

def _blob_with_misconf():
    files, *_ = seeded_tree(14, n_docker=2, n_k8s=4)
    port, _ = _misconf_analyzers()
    records = []
    for path, data in sorted(files.items()):
        if port.required(path):
            r = port.analyze(path, data)
            if r is not None:
                records += r.misconfigurations
    return T.BlobInfo(diff_id="sha256:" + "3" * 64,
                      misconfigurations=records)


def test_cache_round_trip(tmp_path):
    blob = _blob_with_misconf()
    assert len(blob.misconfigurations) == 6
    fs = port_cache.FSCache(str(tmp_path))
    fs.put_blob("b", blob)
    assert fs.get_blob("b").to_json() == blob.to_json()
    mem = port_cache.MemoryCache()
    mem.put_blob("b", blob)
    assert mem.get_blob("b").to_json() == blob.to_json()


def test_applier_like_reference():
    from trivy_tpu.fanal.cache import blob_from_json as ref_blob
    blob = _blob_with_misconf()
    top = T.BlobInfo(diff_id="sha256:" + "4" * 64, created_by="RUN rm",
                     whiteout_files=["services/svc00/Dockerfile"],
                     misconfigurations=[blob.misconfigurations[-1]])
    blobs = [json.loads(json.dumps(b.to_json())) for b in (blob, top)]
    port = port_applier.apply_layers(
        [port_cache.blob_from_json(j) for j in blobs])
    ref = ref_applier.apply_layers([ref_blob(j) for j in blobs])
    assert [m.to_json() for m in port.misconfigurations] == \
        [m.to_json() for m in ref.misconfigurations]
    paths = [m.file_path for m in port.misconfigurations]
    assert "services/svc00/Dockerfile" not in paths and len(paths) == 5
    assert port.misconfigurations[-1].layer.created_by == "RUN rm"


# --- both CLIs --------------------------------------------------------

GOLDEN_RUNS = {
    "dockerfile": ["dockerfile"],
    "helm_testchart": ["helm_testchart"],
    "custom_policy": ["custom-policy", "--config-check",
                      "{in}/custom-policy/policy", "--check-namespaces",
                      "user"],
    "namespace_exception": ["namespace-exception", "--config-check",
                            "{in}/namespace-exception/policy"],
    "rule_exception": ["rule-exception", "--config-check",
                       "{in}/rule-exception/policy"],
    "file_pattern": ["dockerfile_file_pattern", "--file-patterns",
                     "dockerfile:Customfile"],
}


@pytest.mark.parametrize("fmt", ["json", "table", "sarif"])
@pytest.mark.parametrize("name", sorted(GOLDEN_RUNS))
def test_golden_inputs_like_reference(name, fmt, work):
    target, *flags = [a.replace("{in}", INPUTS) for a in GOLDEN_RUNS[name]]
    port, ref = run_both(["fs", os.path.join(INPUTS, target), "--scanners",
                          "misconfig,secret", "--format", fmt, *flags], work)
    assert port == ref
    if fmt == "json" and name != "file_pattern":
        assert json.loads(port)["Results"]


@pytest.fixture
def tree(work):
    files, planted, collided = seeded_tree()
    files.update(chip_smoke_secrets())
    root = write_tree(work / "tree", files)
    return root, planted, collided


def chip_smoke_secrets() -> dict:
    rng = np.random.default_rng(3)
    return {"deploy/aws.env": chip_smoke.planted_token(rng, chip_smoke.AWS),
            "package-lock.json": json.dumps({
                "name": "m", "lockfileVersion": 3, "packages": {
                    "": {"name": "m", "version": "1.0.0"},
                    "node_modules/lodash": {"version": "4.17.20"}}}).encode()}


def _checks_dir(work) -> str:
    d = work / "checks"
    d.mkdir(exist_ok=True)
    for name, text in chip_smoke.MISCONF_CHECKS.items():
        (d / name).write_text(text)
    (work / "work" / "ignore.rego").write_text(
        chip_smoke.MISCONF_IGNORE_POLICY)
    return str(d)


@pytest.mark.parametrize("command", ["fs", "repo", "rootfs"])
@pytest.mark.parametrize("fmt", ["json", "table", "sarif"])
@pytest.mark.parametrize("custom", [False, True])
def test_seeded_tree_like_reference(command, fmt, custom, tree, work):
    root, planted, collided = tree
    flags = ["--config-check", _checks_dir(work), "--ignore-policy",
             "ignore.rego"] if custom else []
    port, ref = run_both([command, root, "--db", DB, "--scanners",
                          "vuln,secret,misconfig", "--format", fmt,
                          "--exit-code", "5", *flags], work, rc=5)
    assert port == ref
    if fmt == "json":
        got = chip_smoke.misconf_ids(json.loads(port))
        drop = chip_smoke.MISCONF_IGNORED if custom \
            else {"SMOKE001", "SMOKE002"}
        assert chip_smoke._missing_plants(json.loads(port), planted,
                                          drop) == {}
        left = set().union(*got.values())
        assert not (custom and left & chip_smoke.MISCONF_IGNORED)
        # two charts render templates/deployment.yaml: one record is kept
        collapsed = chip_smoke.helm_collapsed(json.loads(port), collided)
        deploy = collapsed["templates/deployment.yaml"]
        assert deploy["charts"] == sorted(chip_smoke.HELM_CREATE_NAMES)
        assert deploy["kept"] in deploy["charts"] and deploy["lost"]


@pytest.mark.parametrize("scanners", ["misconfig", "config",
                                      "misconfiguration,secret"])
def test_scanner_aliases_like_reference(scanners, tree, work):
    root, *_ = tree
    port, ref = run_both(["fs", root, "--scanners", scanners], work)
    assert port == ref
    assert b'"Class": "config"' in port


def test_rego_trace_like_reference(tree, work, capfd):
    root, *_ = tree
    checks = _checks_dir(work)
    argv = ["fs", root, "--scanners", "misconfig", "--config-check",
            checks, "--rego-trace", "--check-namespaces", "user"]
    run_both(argv, work)
    err = capfd.readouterr().err
    port_trace = [ln for ln in err.splitlines() if ln.startswith("TRACE")]
    assert port_trace and len(port_trace) % 2 == 0
    half = len(port_trace) // 2
    assert port_trace[:half] == port_trace[half:]


def _deploy_image(tmp_path, files: dict, prefix="srv/") -> tuple:
    """An Alpine image (the fixture DB's 5 CVEs) with a layer of
    deployment files under `prefix` and a third that whites out
    services/svc01 → (docker-save path, OCI layout path)."""
    from trivy_tpu_torch.fanal.fixtures import write_oci_layout
    base = tar_bytes({"etc/os-release": chip_smoke.ALPINE_OS_RELEASE,
                      "lib/apk/db/installed": chip_smoke.APK_INSTALLED})
    deploy = tar_bytes({prefix + k: v for k, v in sorted(files.items())})
    gone = tar_bytes({prefix + "services/.wh.svc01": b""})
    blobs = [base, deploy, gone]
    path = str(tmp_path / "deploy.tar")
    write_docker_archive(path, [gz_bytes(b, 6) for b in blobs],
                         ["sha256:" + sha256_hex(b) for b in blobs])
    oci = str(tmp_path / "deploy-oci.tar")
    write_oci_layout(oci, [gz_bytes(b, 6) for b in blobs],
                     ["sha256:" + sha256_hex(b) for b in blobs])
    return path, oci


@pytest.mark.parametrize("fmt", ["json", "table", "sarif"])
@pytest.mark.parametrize("extra", [[], ["--ingest-serial"], ["custom"]])
def test_image_input_like_reference(fmt, extra, tmp_path, work):
    files, planted, _ = seeded_tree(15, n_docker=4, n_k8s=12)
    docker, oci = _deploy_image(tmp_path, files)
    if extra == ["custom"]:
        extra = ["--config-check", _checks_dir(work), "--ignore-policy",
                 "ignore.rego"]
    for i, image in enumerate((docker, oci)):
        port, ref = run_both(["image", "--input", image, "--db", DB,
                              "--scanners", "vuln,secret,misconfig",
                              "--format", fmt, *extra], work, tag=str(i))
        assert port == ref
    if fmt == "json":
        got = chip_smoke.misconf_ids(json.loads(port))
        assert "srv/services/svc00/Dockerfile" in got
        assert not any(t.startswith("srv/services/svc01/") for t in got)
        assert any(t.startswith("srv/deploy/k8s/") for t in got)


def test_image_warm_run_keeps_misconfigurations(tmp_path, work):
    files, *_ = seeded_tree(16, n_docker=3, n_k8s=6)
    docker, _oci = _deploy_image(tmp_path, files)
    argv = ["image", "--input", docker, "--db", DB, "--scanners",
            "misconfig", "--format", "json"]
    cold, _ = run_both(argv, work)
    warm, ref_warm = run_both(argv, work)
    assert cold == warm == ref_warm
    assert len(chip_smoke.misconf_ids(json.loads(warm))) >= 8


# --- the infrastructure-as-code types -------------------------------

@pytest.mark.parametrize("ftype", sorted(IAC))
def test_iac_type_scanned_like_reference(ftype, tmp_path, work):
    path, data = IAC[ftype]
    files, *_ = seeded_tree(17, n_docker=2, n_k8s=2)
    root = write_tree(tmp_path / "t", {**files, path: data})
    for command in ("fs", "repo"):
        port, ref = run_both([command, root, "--scanners", "vuln,misconfig",
                              "--db", DB], work, tag=command)
        assert port == ref
    # in an image, walked by the ingest pipeline
    layer = tar_bytes({"srv/" + path: data})
    image = str(tmp_path / "i.tar")
    write_docker_archive(image, [gz_bytes(layer, 6)],
                         ["sha256:" + sha256_hex(layer)])
    port, ref = run_both(["image", "--input", image, "--scanners",
                          "misconfig"], work, tag="image")
    assert port == ref
    if ftype in ("cloudformation", "terraform"):
        assert chip_smoke.misconf_ids(json.loads(port))["srv/" + path]


@pytest.mark.parametrize("ftype", sorted(IAC))
def test_unported_type_untouched_without_misconfig(ftype, tmp_path, work):
    path, data = IAC[ftype]
    root = write_tree(tmp_path / "t", {path: data, **chip_smoke_secrets()})
    port, ref = run_both(["fs", root, "--db", DB, "--scanners",
                          "vuln,secret"], work)
    assert port == ref
    assert b"Ingest Degradations" not in port


@pytest.mark.parametrize("source", ["trivy.yaml", "env"])
def test_misconf_flags_from_config_and_env(source, work, monkeypatch):
    """`misconfiguration.check-paths` / `misconfiguration.namespaces` in
    trivy.yaml, and TRIVY_CONFIG_CHECK / TRIVY_CHECK_NAMESPACES, reach
    both CLIs alike."""
    policy = os.path.join(INPUTS, "custom-policy", "policy")
    if source == "env":
        monkeypatch.setenv("TRIVY_CONFIG_CHECK", policy)
        monkeypatch.setenv("TRIVY_CHECK_NAMESPACES", "user")
    else:
        (work / "work" / "trivy.yaml").write_text(
            "misconfiguration:\n  check-paths:\n  - " + policy +
            "\n  namespaces: user\n")
    port, ref = run_both(["fs", os.path.join(INPUTS, "custom-policy"),
                          "--scanners", "misconfig"], work)
    assert port == ref
    assert b"something bad: foo" in port


def test_concurrent_scans_keep_their_own_settings(tree, work):
    """Two scans in two threads of one process, one with user checks and
    the rego trace and one without: each report equals its own scan run
    alone, since each carries its settings on its own analyzer group."""
    import threading
    root, *_ = tree
    checks = _checks_dir(work)
    argvs = {"plain": ["fs", root, "--scanners", "misconfig"],
             "custom": ["fs", root, "--scanners", "misconfig",
                        "--config-check", checks, "--check-namespaces",
                        "user", "--rego-trace"]}

    def run(name, tag):
        out = str(work / f"{name}{tag}.json")
        assert cli.main(argvs[name] + [
            "--output", out, "--device", "cpu", "--cache-dir",
            str(work / f"cache-{name}{tag}")]) == 0
        with open(out, "rb") as f:
            return f.read()
    alone = {name: run(name, "-alone") for name in argvs}
    assert alone["plain"] != alone["custom"]
    got, errors = {}, []

    def worker(name):
        try:
            got[name] = run(name, "-thread")
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)
    threads = [threading.Thread(target=worker, args=(n,)) for n in argvs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert got == alone
    assert b"SMOKE002" in got["custom"] and b"SMOKE002" not in got["plain"]
