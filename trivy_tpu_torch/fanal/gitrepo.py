"""Remote git repositories (reference pkg/fanal/artifact/repo/git.go),
the port's copy of the JAX package's fanal/gitrepo.py: a `repo` target
that is not a local path is cloned with the host's `git` (shallow; full
when a commit is pinned) into a temporary directory and scanned as a
tree, with the report naming the URL."""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import Callable


class GitError(RuntimeError):
    pass


def looks_like_url(target: str) -> bool:
    return target.startswith(("http://", "https://", "git://",
                              "ssh://", "file://")) or \
        (":" in target.split("/")[0] and "@" in target.split("/")[0])


def clone_repo(url: str, branch: str = "", tag: str = "",
               commit: str = "") -> tuple[str, Callable[[], None]]:
    """→ (checkout dir, cleanup fn). Shallow clone unless a commit is
    pinned (git.go cloneOptions: Depth 1, SingleBranch; CheckoutCommit
    needs history)."""
    dest = tempfile.mkdtemp(prefix="trivy-repo-")

    def cleanup():
        shutil.rmtree(dest, ignore_errors=True)

    cmd = ["git", "clone", "--quiet"]
    if not commit:
        cmd += ["--depth", "1", "--single-branch"]
    ref = branch or tag
    if ref:
        cmd += ["--branch", ref]
    cmd += [url, dest]
    env = dict(os.environ, GIT_TERMINAL_PROMPT="0")
    try:
        subprocess.run(cmd, check=True, capture_output=True, env=env,
                       timeout=600)
        if commit:
            subprocess.run(["git", "-C", dest, "checkout", "--quiet",
                            commit],
                           check=True, capture_output=True, env=env,
                           timeout=120)
    except subprocess.CalledProcessError as e:
        cleanup()
        raise GitError(
            f"git clone {url!r} failed: "
            f"{e.stderr.decode(errors='replace').strip()[-300:]}") \
            from None
    except subprocess.TimeoutExpired:
        cleanup()
        raise GitError(f"git clone {url!r} timed out") from None
    return dest, cleanup
