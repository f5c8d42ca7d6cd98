"""Consistent-hash ring with virtual nodes (the port's copy of
trivy_tpu/fleet/ring.py; the same placement, point for point).

The router keys every RPC by its artifact (artifact_id for Scan,
MissingBlobs and PutArtifact, diff_id for PutBlob) and asks the ring
who owns it. Each replica has `vnodes` points, placed by sha256 on a
64-bit circle, which keeps the shares balanced; a replica leaving
remaps only the keys on its own arcs, so every other key keeps its
owner and the replicas' caches and in-flight work stay warm.

On the routing path the ring does not change: a LOST replica is not
removed. The supervisor marks its fault domain open and the router
walks `successors(key)` past it, so the key's ownership, and with it
cache locality, comes back the moment the replica is readmitted.
`add` and `remove` are for real membership changes (scale-out,
scale-in) and the remap property tests.
"""

from __future__ import annotations

import bisect
import hashlib
import threading


def _point(label: str) -> int:
    """64-bit ring position for one vnode label."""
    return int.from_bytes(
        hashlib.sha256(label.encode()).digest()[:8], "big")


class HashRing:
    """Thread-safe consistent-hash ring over opaque node names."""

    def __init__(self, nodes=(), vnodes: int = 64):
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        self.vnodes = vnodes
        self._lock = threading.Lock()
        self._points: list[int] = []       # sorted vnode positions
        self._owners: list[str] = []       # _owners[i] owns _points[i]
        self._nodes: set[str] = set()
        for n in nodes:
            self.add(n)

    def add(self, node: str) -> None:
        with self._lock:
            if node in self._nodes:
                return
            self._nodes.add(node)
            for i in range(self.vnodes):
                p = _point(f"{node}#{i}")
                at = bisect.bisect_left(self._points, p)
                self._points.insert(at, p)
                self._owners.insert(at, node)

    def remove(self, node: str) -> None:
        with self._lock:
            if node not in self._nodes:
                return
            self._nodes.discard(node)
            keep = [(p, o) for p, o in zip(self._points, self._owners)
                    if o != node]
            self._points = [p for p, _ in keep]
            self._owners = [o for _, o in keep]

    def nodes(self) -> list[str]:
        with self._lock:
            return sorted(self._nodes)

    def __len__(self) -> int:
        with self._lock:
            return len(self._nodes)

    def node_for(self, key: str) -> str:
        """The replica owning `key` (first vnode clockwise)."""
        with self._lock:
            if not self._points:
                raise LookupError("empty ring")
            at = bisect.bisect_right(self._points, _point(key))
            return self._owners[at % len(self._owners)]

    def successors(self, key: str) -> list[str]:
        """Every replica in failover order for `key`: the owner first,
        then each DISTINCT replica as its first vnode appears walking
        clockwise. The whole membership is returned; the router walks
        it skipping open fault domains."""
        with self._lock:
            n = len(self._owners)
            if not n:
                return []
            start = bisect.bisect_right(self._points, _point(key)) % n
            out: list[str] = []
            seen: set[str] = set()
            for i in range(n):
                owner = self._owners[(start + i) % n]
                if owner not in seen:
                    seen.add(owner)
                    out.append(owner)
                    if len(seen) == len(self._nodes):
                        break
            return out
