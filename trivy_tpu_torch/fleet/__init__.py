"""graftfleet: the serving tier across port servers.

  ring        the consistent-hash ring with virtual nodes: artifacts
              map to replicas by key hash, and losing a replica remaps
              only that replica's keys;
  supervisor  the replica fault domains: one circuit breaker per
              replica, and /healthz probes that readmit a lost one;
  router      the Twirp front end that clients point at unchanged: it
              routes each RPC to the owning replica, fails over along
              the ring, honours 429/503 + Retry-After sheds, and
              carries X-Trivy-Deadline-Ms so no retry outlives the
              client's budget;
  memo        the detection-result memo keyed by (blob, table digest),
              shared by every replica; its sweep after a DB swap lives
              in detect/redetect.py.

The router holds no table and never touches the card: each replica is a
port server detecting on its own card, and the replicas share layer
analysis through one cache backend (fs, redis or s3), so a layer one
replica analyzed is a hit on all of them.
"""

from .memo import FSMemo, MemoryMemo, MemoSession, MemoStore, open_memo
from .ring import HashRing
from .router import (RouterOptions, RouterState, serve_router,
                     serve_router_background)
from .supervisor import ReplicaOptions, ReplicaSet

__all__ = [
    "FSMemo", "HashRing", "MemoSession", "MemoStore", "MemoryMemo",
    "open_memo", "ReplicaOptions", "ReplicaSet", "RouterOptions",
    "RouterState", "serve_router", "serve_router_background",
]
