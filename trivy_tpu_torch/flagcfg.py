"""Flag sources: command line > TRIVY_* env > trivy.yaml > default.

The port's copy of the JAX package's flagcfg.py (reference pkg/flag
flag.go Bind: each flag binds a viper key fed by the command line, a
TRIVY_-prefixed env var and the config file, in that order). argparse
has no layered sources, so a parsed namespace is post-processed: a flag
NOT given on the command line is looked up in the environment, then in
the config file, before its argparse default stands.

Config keys follow the reference's trivy.yaml layout (nested viper paths
such as `vulnerability.ignore-unfixed`, `db.repository`, `scan.scanners`);
a flat top-level key equal to the flag's name works too.

One difference from the JAX package: the port's own flags `--device` and
`--debug-launches` come from the command line alone. No env var or
config key moves the port onto the CPU.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Optional

# flag dest → the reference's trivy.yaml path (flat names always work);
# a list binds several keys to one flag, the first present wins
CONFIG_PATHS = {
    "scanners": ["scan.scanners", "scan.security-checks"],
    "skip_files": "scan.skip-files",
    "skip_dirs": "scan.skip-dirs",
    "parallel": "scan.parallel",
    "ignore_unfixed": "vulnerability.ignore-unfixed",
    "ignore_status": "vulnerability.ignore-status",
    "ignorefile": "ignorefile",
    "cache_dir": "cache.dir",
    "db": "db.path",
    "db_repository": "db.repository",
    "skip_db_update": "db.skip-update",
    "java_db": "javadb.path",
    "secret_config": "secret.config",
    "platform": "image.platform",
    "image_src": "image.source",
    "pkg_types": "pkg-types",
    "config_check": "misconfiguration.check-paths",
    "check_namespaces": "misconfiguration.namespaces",
    # the ingest pipeline's budgets (ingest.*)
    "ingest_serial": "ingest.serial",
    "ingest_walkers": "ingest.walkers",
    "ingest_analyzers": "ingest.analyzers",
    "ingest_max_file_bytes": "ingest.max-file-bytes",
    "ingest_max_layer_bytes": "ingest.max-layer-bytes",
    "ingest_max_members": "ingest.max-members",
    "ingest_layer_deadline_ms": "ingest.layer-deadline-ms",
    "ingest_max_inflight_bytes": "ingest.max-inflight-bytes",
    # the server's (detect.*, resilience.*, cache.*, memo.*, the mesh's
    # mesh.devices and mesh.db-shards, and the streamed table's
    # mesh.table-* and mesh.stream-prefetch), and the keys of the
    # meshguard flags it refuses, at the JAX package's paths
    "detect_coalesce_wait_ms": "detect.coalesce-wait-ms",
    "detect_max_inflight_pairs": "detect.max-inflight-pairs",
    "detect_warmup": "detect.warmup",
    "detect_dedup": "detect.dedup",
    "admit_max_active": "resilience.admit-max-active",
    "admit_max_queue": "resilience.admit-max-queue",
    "admit_queue_ms": "resilience.admit-queue-ms",
    "cache_backend": "cache.backend",
    "stream_prefetch": "mesh.stream-prefetch",
    "detect_dispatch_timeout_ms": "resilience.dispatch-timeout-ms",
    "breaker_fail_threshold": "resilience.breaker-fail-threshold",
    "breaker_reset_ms": "resilience.breaker-reset-ms",
    "failpoint": "resilience.failpoints",
    "mesh_devices": "mesh.devices",
    "mesh_db_shards": "mesh.db-shards",
    "mesh_min_devices": "mesh.min-devices",
    "mesh_rebuild_cooldown_ms": "mesh.rebuild-cooldown-ms",
    "mesh_probe_timeout_ms": "mesh.probe-timeout-ms",
    "mesh_hosts": "mesh.hosts",
    "mesh_host_loss_window_ms": "mesh.host-loss-window-ms",
    "table_device_budget_mb": "mesh.table-device-budget-mb",
    "table_stream_slices": "mesh.table-stream-slices",
    "memo_backend": "memo.backend",
    "redetect_concurrency": "memo.redetect-concurrency",
}

# dests bound to the command line only
CLI_ONLY = ("help", "command", "config", "device", "debug_launches")

_TRUE = {"1", "t", "true", "yes", "on"}
_FALSE = {"0", "f", "false", "no", "off"}


def split_commas(raw: str) -> list[str]:
    """Split a comma-joined value, ignoring commas inside parentheses."""
    out, cur, depth = [], [], 0
    for ch in raw:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth = max(depth - 1, 0)
        if ch == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    out.append("".join(cur))
    return out


class ConfigError(SystemExit):
    pass


def _flag_name(action: argparse.Action) -> str:
    longs = [o for o in action.option_strings if o.startswith("--")]
    return (longs[0] if longs else action.option_strings[0]).lstrip("-")


def env_keys(action: argparse.Action) -> list[str]:
    """One env var per long option: an alias flag (--security-checks)
    binds its own TRIVY_* name, like the reference's viper aliases."""
    return ["TRIVY_" + o.lstrip("-").upper().replace("-", "_")
            for o in action.option_strings if o.startswith("--")]


def _explicit(action: argparse.Action, argv: list[str]) -> bool:
    """Was the flag given on the command line: --opt, --opt=v, or a
    joined short option (-ftable)? The parsers disable prefix
    abbreviations (allow_abbrev=False), so exact matching is sound."""
    for opt in action.option_strings:
        short = len(opt) == 2 and not opt.startswith("--")
        for a in argv:
            if a == opt or a.startswith(opt + "=") or \
                    (short and a.startswith(opt)):
                return True
    return False


def _coerce(action: argparse.Action, raw: Any, origin: str) -> Any:
    """An env string or YAML value → the action's value type."""
    if isinstance(action, (argparse._StoreTrueAction,
                           argparse._StoreFalseAction,
                           argparse.BooleanOptionalAction)):
        if isinstance(raw, bool):
            return raw
        s = str(raw).strip().lower()
        if s in _TRUE:
            return True
        if s in _FALSE:
            return False
        raise ConfigError(
            f"{origin}: invalid boolean {raw!r} for --{_flag_name(action)}")
    if isinstance(action, argparse._AppendAction):
        if isinstance(raw, list):
            return [str(v) for v in raw]
        return [s.strip() for s in split_commas(str(raw)) if s.strip()]
    if isinstance(raw, list):  # a YAML list for a comma-joined flag
        raw = ",".join(str(v) for v in raw)
    if action.type is int or isinstance(action.default, int) and \
            not isinstance(action.default, bool):
        try:
            return int(raw)
        except (TypeError, ValueError):
            raise ConfigError(
                f"{origin}: invalid integer {raw!r} for "
                f"--{_flag_name(action)}")
    if action.type is float or isinstance(action.default, float):
        try:
            return float(raw)
        except (TypeError, ValueError):
            raise ConfigError(
                f"{origin}: invalid number {raw!r} for "
                f"--{_flag_name(action)}")
    return str(raw)


def _config_lookup(doc: dict, action: argparse.Action):
    """→ (found, value): the dotted reference paths first, then a flat
    key per long option."""
    paths = CONFIG_PATHS.get(action.dest) or []
    if isinstance(paths, str):
        paths = [paths]
    for path in paths:
        node: Any = doc
        for part in path.split("."):
            if not isinstance(node, dict) or part not in node:
                node = None
                break
            node = node[part]
        if node is not None:
            return True, node
    for opt in action.option_strings:
        if not opt.startswith("--"):
            continue
        flat = opt.lstrip("-")
        # a mapping is a config section that shares the flag's name
        # (`db:` and --db), never the flag's value
        if flat in doc and not isinstance(doc[flat], dict):
            return True, doc[flat]
    return False, None


def load_config_file(path: str, explicit: bool) -> Optional[dict]:
    """trivy.yaml → its mapping. A missing default config is fine; a
    missing config named by --config is an error (pkg/commands/app.go)."""
    if not os.path.exists(path):
        if explicit:
            raise ConfigError(f"config file {path!r} not found")
        return None
    import yaml
    try:
        with open(path) as f:
            doc = yaml.safe_load(f)
    except (OSError, yaml.YAMLError) as e:
        raise ConfigError(f"config file {path}: {e}")
    if doc is None:
        return {}
    if not isinstance(doc, dict):
        raise ConfigError(f"config file {path}: not a mapping")
    return doc


def bound_actions(parser: argparse.ArgumentParser,
                  command: str | None = None):
    """The actions that env and config can set: every option of the
    named subcommand (of all of them without one) but the CLI_ONLY
    ones, each dest once."""
    seen = set()
    for action in _leaf_actions(parser, command):
        if action.dest in seen or action.dest in CLI_ONLY or \
                not action.option_strings:
            continue
        seen.add(action.dest)
        yield action


def apply_flag_sources(args: argparse.Namespace,
                       parser: argparse.ArgumentParser,
                       argv: list[str], env=None) -> argparse.Namespace:
    """Re-resolve every flag that the command line did not give: env,
    then config file. Only the active subcommand's actions count, so
    another subcommand's same-dest action cannot overrule a flag given
    explicitly."""
    env = env if env is not None else os.environ
    cfg_path = getattr(args, "config", "") or "trivy.yaml"
    doc = load_config_file(cfg_path,
                           explicit=bool(getattr(args, "config", "")))
    for action in bound_actions(parser, getattr(args, "command", None)):
        if not hasattr(args, action.dest) or _explicit(action, argv):
            continue
        ek = next((k for k in env_keys(action) if k in env), None)
        if ek is not None:
            setattr(args, action.dest,
                    _coerce(action, env[ek], f"${ek}"))
            continue
        if doc is not None:
            found, raw = _config_lookup(doc, action)
            if found:
                setattr(args, action.dest,
                        _coerce(action, raw, cfg_path))
    return args


def _leaf_actions(parser: argparse.ArgumentParser,
                  command: str | None = None):
    """Top-level actions plus subcommand actions; with ``command``, only
    that subcommand's."""
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for name, sub in action.choices.items():
                if command is None or name == command:
                    yield from sub._actions
        else:
            yield action


def generate_default_config(parser: argparse.ArgumentParser,
                            out_path: str = "trivy.yaml") -> str:
    """--generate-default-config: write every bound flag's default in the
    reference's nested layout (flag.go writeConfig) → the file's path."""
    doc: dict = {}
    for action in bound_actions(parser):
        if action.default in (None, argparse.SUPPRESS):
            continue
        path = CONFIG_PATHS.get(action.dest, _flag_name(action))
        if isinstance(path, list):
            path = path[0]  # the canonical key only
        node = doc
        parts = path.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
            if not isinstance(node, dict):  # a flat and a nested name clash
                node = None
                break
        if node is not None:
            node[parts[-1]] = action.default
    import yaml
    with open(out_path, "w") as f:
        yaml.safe_dump(doc, f, sort_keys=True)
    return out_path
