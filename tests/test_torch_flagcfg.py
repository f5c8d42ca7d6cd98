"""The port's flag sources (command line > TRIVY_* env > trivy.yaml >
default) held against the JAX package's: the cases of
tests/test_flagcfg.py, each resolved by both parsers with the same
argv, env and config file, must give the same values for every flag the
two share. Also: the env keys and the generated default config agree
with the reference's on the shared flags, and the port's own --device
and --debug-launches come from the command line only."""

import json
import os

import pytest
import yaml

import trivy_tpu.cli as ref_cli
from trivy_tpu import flagcfg as ref_flagcfg
from trivy_tpu_torch import __main__ as cli
from trivy_tpu_torch import flagcfg

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(HERE, "golden")


def _resolve(mod, build, argv, env, cfg_text, tmp_path):
    parser = build()
    args = parser.parse_args(argv)
    if cfg_text is not None:
        cfg = tmp_path / "trivy.yaml"
        cfg.write_text(cfg_text)
        args.config = str(cfg)
    return mod.apply_flag_sources(args, parser, argv, env=env)


def _both(argv, env=None, cfg_text=None, tmp_path=None) -> tuple:
    port = _resolve(flagcfg, cli.build_parser, argv, env or {}, cfg_text,
                    tmp_path)
    ref = _resolve(ref_flagcfg, ref_cli.build_parser, argv, env or {},
                   cfg_text, tmp_path)
    shared = set(vars(port)) & set(vars(ref)) - {"func"}
    assert {k: getattr(port, k) for k in shared} == \
        {k: getattr(ref, k) for k in shared}
    return port


CASES = {
    "default": (["repo", "x"], {}, None,
                {"severity": "UNKNOWN,LOW,MEDIUM,HIGH,CRITICAL",
                 "ignore_unfixed": False}),
    "env_overrides_default": (
        ["repo", "x"], {"TRIVY_SEVERITY": "HIGH,CRITICAL",
                        "TRIVY_IGNORE_UNFIXED": "true",
                        "TRIVY_EXIT_CODE": "3"}, None,
        {"severity": "HIGH,CRITICAL", "ignore_unfixed": True,
         "exit_code": 3}),
    "config_file_overrides_default": (
        ["repo", "x"], {},
        "severity: CRITICAL\nvulnerability:\n  ignore-unfixed: true\n"
        "db:\n  repository: example.com/db:2\n"
        "scan:\n  scanners:\n    - vuln\n    - secret\n",
        {"severity": "CRITICAL", "ignore_unfixed": True,
         "db_repository": "example.com/db:2", "scanners": "vuln,secret"}),
    "env_beats_config_file": (
        ["repo", "x"], {"TRIVY_SEVERITY": "HIGH"}, "severity: LOW\n",
        {"severity": "HIGH"}),
    "flag_beats_env_and_file": (
        ["repo", "x", "--severity", "MEDIUM"], {"TRIVY_SEVERITY": "HIGH"},
        "severity: LOW\n", {"severity": "MEDIUM"}),
    "flat_key_accepted": (["repo", "x"], {}, "ignore-unfixed: true\n",
                          {"ignore_unfixed": True}),
    "joined_short_option_is_explicit": (
        ["repo", "x", "-ftable"], {"TRIVY_FORMAT": "json"}, None,
        {"format": "table"}),
    "config_section_never_feeds_same_named_flag": (
        ["repo", "x"], {}, "db:\n  repository: example.com/db:2\n",
        {"db": "", "db_repository": "example.com/db:2"}),
    "security_checks_alias_flag": (
        ["repo", "x", "--security-checks", "vuln"], {}, None,
        {"scanners": "vuln"}),
    "security_checks_alias_env": (
        ["repo", "x"], {"TRIVY_SECURITY_CHECKS": "secret"}, None,
        {"scanners": "secret"}),
    "explicit_flag_beats_env_despite_other_subparsers": (
        ["repo", "x", "--security-checks", "vuln"],
        {"TRIVY_SCANNERS": "secret"}, None, {"scanners": "vuln"}),
    "legacy_security_checks_config_key": (
        ["repo", "x"], {}, "scan:\n  security-checks:\n    - secret\n",
        {"scanners": "secret"}),
    "skip_files_env_list": (
        ["fs", "x"], {"TRIVY_SKIP_FILES": "a/b,c/d"}, None,
        {"skip_files": ["a/b", "c/d"]}),
    "cache_and_db_keys": (
        ["image", "--input", "i.tar"], {"TRIVY_SKIP_DB_UPDATE": "1"},
        "cache:\n  dir: /tmp/c\njavadb:\n  path: j.db\n"
        "ignorefile: .ig\nvex: v.json\n",
        {"skip_db_update": True, "cache_dir": "/tmp/c", "java_db": "j.db",
         "ignorefile": ".ig", "vex": "v.json"}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_flag_sources_like_reference(name, tmp_path):
    argv, env, cfg, want = CASES[name]
    args = _both(argv, env, cfg, tmp_path)
    for k, v in want.items():
        assert getattr(args, k) == v, k


def test_missing_explicit_config_errors(tmp_path):
    argv = ["repo", "x", "--config", str(tmp_path / "absent.yaml")]
    for mod, build in ((flagcfg, cli.build_parser),
                       (ref_flagcfg, ref_cli.build_parser)):
        parser = build()
        with pytest.raises(mod.ConfigError, match="not found"):
            mod.apply_flag_sources(parser.parse_args(argv), parser, argv,
                                   env={})


@pytest.mark.parametrize("env,match", [
    ({"TRIVY_IGNORE_UNFIXED": "maybe"}, "invalid boolean"),
    ({"TRIVY_EXIT_CODE": "one"}, "invalid integer")])
def test_invalid_values_error(env, match):
    for mod, build in ((flagcfg, cli.build_parser),
                       (ref_flagcfg, ref_cli.build_parser)):
        parser = build()
        argv = ["repo", "x"]
        with pytest.raises(mod.ConfigError, match=match):
            mod.apply_flag_sources(parser.parse_args(argv), parser, argv,
                                   env=env)


def test_abbreviated_long_option_rejected():
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["repo", "x", "--sever", "MEDIUM"])


def test_device_and_debug_launches_come_from_the_command_line_only(
        tmp_path):
    """No env var or config key moves the port onto the CPU or turns on
    its launch report: the device is the command line's alone."""
    args = _resolve(flagcfg, cli.build_parser, ["fs", "x"],
                    {"TRIVY_DEVICE": "cpu", "TRIVY_DEBUG_LAUNCHES": "true"},
                    "device: cpu\ndebug-launches: true\n", tmp_path)
    assert args.device is None and args.debug_launches is False
    args = _resolve(flagcfg, cli.build_parser,
                    ["fs", "x", "--device", "cpu"], {}, None, tmp_path)
    assert args.device == "cpu"
    keys = {k for a in flagcfg.bound_actions(cli.build_parser())
            for k in flagcfg.env_keys(a)}
    assert "TRIVY_DEVICE" not in keys and "TRIVY_SEVERITY" in keys


def test_env_keys_match_reference():
    """Every env var the port binds is bound by the reference too, to
    the same flag."""
    def keys(mod, parser):
        out = {}
        for a in mod._leaf_actions(parser):
            if a.option_strings and a.dest not in ("help", "config"):
                for k in flagcfg.env_keys(a):
                    out.setdefault(k, a.dest)
        return out
    port = {k: d for a in flagcfg.bound_actions(cli.build_parser())
            for k, d in ((k, a.dest) for k in flagcfg.env_keys(a))}
    ref = keys(ref_flagcfg, ref_cli.build_parser())
    assert len(port) > 20
    assert {k: ref.get(k) for k in port} == port


def test_generated_default_config_matches_reference(tmp_path):
    port = yaml.safe_load(open(flagcfg.generate_default_config(
        cli.build_parser(), str(tmp_path / "port.yaml"))))
    ref = yaml.safe_load(open(ref_flagcfg.generate_default_config(
        ref_cli.build_parser(), str(tmp_path / "ref.yaml"))))

    def flat(d, pre=""):
        for k, v in d.items():
            if isinstance(v, dict):
                yield from flat(v, pre + k + ".")
            else:
                yield pre + k, v
    port_keys, ref_keys = dict(flat(port)), dict(flat(ref))
    assert port_keys and set(port_keys) <= set(ref_keys)
    assert {k: ref_keys[k] for k in port_keys} == port_keys
    assert "device" not in port and "debug-launches" not in port
    assert port["vulnerability"]["ignore-unfixed"] is False
    assert port["db"]["repository"] == "ghcr.io/aquasecurity/trivy-db:2"
    # the generated file round-trips through the loader
    parser = cli.build_parser()
    argv = ["repo", "x", "--config", str(tmp_path / "port.yaml")]
    flagcfg.apply_flag_sources(parser.parse_args(argv), parser, argv,
                               env={})


def test_generate_default_config_command(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert cli.main(["--generate-default-config"]) == 0
    assert capsys.readouterr().out.strip() == "trivy.yaml"
    assert yaml.safe_load(open(tmp_path / "trivy.yaml"))["severity"] == \
        "UNKNOWN,LOW,MEDIUM,HIGH,CRITICAL"


def test_cli_env_binding_filters_the_report(tmp_path, monkeypatch, capsys):
    """Full CLI: TRIVY_SEVERITY filters the port's report as the
    reference's."""
    target = tmp_path / "proj"
    target.mkdir()
    (target / "requirements.txt").write_text("werkzeug==0.11\n")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("TRIVY_SEVERITY", "CRITICAL")
    argv = ["repo", str(target), "--db", os.path.join(GOLD, "db", "*.yaml"),
            "--format", "json"]
    assert cli.main(argv + ["--device", "cpu", "--cache-dir",
                            str(tmp_path / "p")]) == 0
    port = json.loads(capsys.readouterr().out)
    assert ref_cli.main(argv + ["--cache-dir", str(tmp_path / "r")]) == 0
    ref = json.loads(capsys.readouterr().out)
    port.pop("CreatedAt")
    ref.pop("CreatedAt")
    assert port == ref
    sevs = {v["Severity"] for r in port.get("Results") or []
            for v in r.get("Vulnerabilities") or []}
    assert sevs <= {"CRITICAL"}


@pytest.mark.parametrize("source", ["env", "config"])
def test_golden_skip_files_via_env_and_config(source, tmp_path,
                                              monkeypatch, capsys):
    """The gomod-skip golden report through TRIVY_SKIP_FILES and through
    scan.skip-files in trivy.yaml."""
    import test_torch_golden as tg
    target = os.path.join(GOLD, "inputs", "gomod")
    argv = ["repo", target, "--db", os.path.join(GOLD, "db", "*.yaml"),
            "--format", "json", "--device", "cpu",
            "--cache-dir", str(tmp_path / "c")]
    skip = ["path/to/dummy", f"{target}/submod2/go.mod"]
    monkeypatch.chdir(tmp_path)
    if source == "env":
        monkeypatch.setenv("TRIVY_SKIP_FILES", ",".join(skip))
    else:
        (tmp_path / "trivy.yaml").write_text(yaml.safe_dump(
            {"scan": {"skip-files": skip}}))
    assert cli.main(argv) == 0
    got = json.loads(capsys.readouterr().out)
    with open(os.path.join(GOLD, "reports", "gomod-skip.json.golden")) as f:
        want = json.load(f)
    assert tg.normalize(got) == tg.normalize(want)
