"""The supervised streaming ingest pipeline: the port's copy of the JAX
package's fanald (`fanal/pipeline.py`).

Image sources that can open a layer as a stream (`stream_open`) walk
their missing layers here instead of one by one:

  walkers     a bounded pool of per-layer walkers streams each layer tar
              straight off its source (its own archive handle or
              registry connection), gzip inflated in C; the compressed
              blob is never copied whole, and the decompressed spool is
              bounded (a shared window plus one overdraft layer, each
              layer at most --ingest-max-layer-bytes);
  budgets     bind as the tar streams, never buffer-then-check: per-file
              and per-layer byte caps, a member cap, a per-layer
              deadline and a decompression-ratio guard trip mid-stream;
  backpressure a pipeline-wide byte and item budget caps the file content
              in flight whatever the layer's shape;
  analyzers   batched dispatch through a bounded pool
              (AnalyzerGroup.analyze_batch), merged back in member order,
              so a well-formed layer gives exactly the serial walker's
              result (the serial walker stays as the parity oracle);
  supervision each stage runs under a watchdog against its own breaker
              (INGEST: `walk`, `analyze`): a wedged walk trips the walk
              breaker, and while a breaker is open new work of that
              stage degrades at once instead of queueing;
  degradation a layer that trips a budget, errors or times out becomes a
              deterministic partial BlobScan with structured annotations
              (ingest.ingest_error), never an exception; it is cached
              only under a salted id (ingest.partial_blob_id), so the
              next scan walks it again.

The watchdog and the closed/open/half-open breakers live in this module
with the JAX package's threshold (3 failures), reset time (5 s) and
annotation kinds. The JAX package's general resilience layer and its
failpoints are not ported; its ingest series (walker occupancy, the
in-flight bytes, the analyzer depth, budget trips and partial scans),
its `fanal.layer_walk` span and its per-layer ingest cost charge are.
The tenant shares (`tenant_walker_share`, `tenant_byte_share`) bind
only for work run under a server request's cost ledger (its tenant);
every CLI walk is untenanted.
"""

from __future__ import annotations

import bisect
import contextlib
import contextvars
import gzip
import io
import tarfile
import threading
import time
import zlib
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor
from concurrent.futures import wait as _fut_wait
from dataclasses import dataclass

from ..log import get as _get_logger
from ..metrics import METRICS
from ..obs import cost as _cost
from ..obs import span
from .analyzers import AnalysisResult, AnalyzerGroup
from .ingest import ingest_error
from .walker import (DEFAULT_SECRET_CONFIG, BlobScan, classify_member,
                     looks_binary, normalize_skip_globs)

_log = _get_logger("fanal.pipeline")


@dataclass
class IngestOptions:
    """The pipeline's knobs (the `--ingest-*` scan flags).

    The defaults are sized for real images: no well-formed layer trips
    them (parity with the serial walker), and a hostile input stays
    bounded. `enabled=False` walks through the serial walker."""
    enabled: bool = True
    walkers: int = 0              # per-layer walkers; 0 = auto (cores)
    analyzers: int = 0            # analyzer pool width; 0 = auto
    batch_files: int = 32         # files per analyzer dispatch
    batch_bytes: int = 4 << 20    # bytes per analyzer dispatch
    max_file_bytes: int = 128 << 20     # per-file content cap
    max_layer_bytes: int = 2 << 30      # per-layer decompressed cap
    max_members: int = 200_000          # per-layer member-count cap
    layer_deadline_ms: float = 120_000.0
    max_inflight_bytes: int = 256 << 20  # pipeline-wide content budget
    max_inflight_items: int = 2048
    max_ratio: float = 200.0      # decompression-bomb ratio guard
    ratio_floor: int = 1 << 20    # the ratio guard arms past this output
    # patience past the watch deadline before a pool that made no
    # progress is declared wedged (absorbs scheduler jitter; not a flag)
    abandon_grace_s: float = 5.0
    # the largest share of the walker pool / in-flight byte budget one
    # tenant may hold at once (1.0 = off); the overflow degrades that
    # tenant's own layers. Untenanted work is exempt
    tenant_walker_share: float = 1.0
    tenant_byte_share: float = 1.0

    def n_walkers(self) -> int:
        """0 = auto: one walker per core, at most 8 (inflation releases
        the GIL, the walk's bookkeeping does not)."""
        import os
        return int(self.walkers) or min(os.cpu_count() or 2, 8)

    def n_analyzers(self) -> int:
        return int(self.analyzers) or max(self.n_walkers() // 2, 2)

    def watch_timeout_s(self) -> float:
        """The watchdog deadline of one stage's unit of work: the layer
        deadline plus a margin, so a layer that overruns while making
        progress stops itself (a budget annotation, no breaker charge)
        and a wedged one (blocked in a read) trips the watchdog."""
        dl = self.layer_deadline_ms / 1e3
        return dl + max(0.05, dl * 0.5)


# the process default (the CLI's --ingest-* flags land here; artifacts
# read it when they are handed no IngestOptions)
_DEFAULT_INGEST = IngestOptions()


def set_default_ingest(opts: IngestOptions) -> None:
    global _DEFAULT_INGEST
    _DEFAULT_INGEST = opts


def default_ingest() -> IngestOptions:
    return _DEFAULT_INGEST


# ---------------------------------------------------------------------------
# supervision: a breaker per stage and one watchdog


class Deadline:
    """Monotonic countdown; None seconds never expires."""

    __slots__ = ("at",)

    def __init__(self, seconds: float | None):
        self.at = None if seconds is None else time.monotonic() + seconds

    def remaining(self) -> float:
        if self.at is None:
            return float("inf")
        return self.at - time.monotonic()

    def expired(self) -> bool:
        return self.at is not None and time.monotonic() >= self.at


class StageError(RuntimeError):
    """A supervised stage raised (the cause is chained)."""


class StageTimeout(StageError):
    """A supervised stage outlived its watchdog deadline."""


_CLOSED, _OPEN, _HALF_OPEN = "closed", "open", "half_open"


class _Breaker:
    """Closed/open/half-open: `fail_threshold` failures open it, a
    watchdog expiry opens it at once; after `reset_timeout_s` one
    caller is admitted as the probe, whose success closes it."""

    def __init__(self, name: str, fail_threshold: int = 3,
                 reset_timeout_s: float = 5.0):
        self.name = name
        self.fail_threshold = fail_threshold
        self.reset_timeout_s = reset_timeout_s
        self._lock = threading.Lock()
        self._state = _CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False

    def state_name(self) -> str:
        with self._lock:
            return self._state

    def failures(self) -> int:
        with self._lock:
            return self._failures

    def _open(self) -> None:
        self._state = _OPEN
        self._opened_at = time.monotonic()
        self._probing = False
        _log.warning("ingest %s breaker opened", self.name)

    def allow(self) -> bool:
        with self._lock:
            if self._state == _CLOSED:
                return True
            if self._state == _OPEN and \
                    time.monotonic() - self._opened_at \
                    >= self.reset_timeout_s:
                self._state = _HALF_OPEN
                self._probing = True
                return True
            if self._state == _HALF_OPEN and not self._probing:
                self._probing = True
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            if self._state == _HALF_OPEN:
                self._state = _CLOSED
                self._probing = False
                _log.warning("ingest %s breaker closed", self.name)

    def record_failure(self) -> None:
        with self._lock:
            if self._state == _HALF_OPEN:
                self._open()
                return
            self._failures += 1
            if self._state == _CLOSED and \
                    self._failures >= self.fail_threshold:
                self._open()

    def trip(self) -> None:
        with self._lock:
            if self._state != _OPEN:
                self._open()
            self._probing = False

    def reset(self) -> None:
        with self._lock:
            self._state = _CLOSED
            self._failures = 0
            self._probing = False


class _Token:
    __slots__ = ("deadline", "breaker", "expired")

    def __init__(self, deadline: Deadline, breaker: _Breaker):
        self.deadline = deadline
        self.breaker = breaker
        self.expired = False


class _Watchdog:
    """One daemon thread, started on the first watch, that marks each
    armed token whose deadline passed and trips its breaker: the stage
    is judged wedged while its thread is still blocked."""

    def __init__(self):
        self._cv = threading.Condition()
        self._tokens: list[_Token] = []
        self._thread = None

    @contextlib.contextmanager
    def watch(self, timeout_s: float, breaker: _Breaker):
        """Supervise one unit of work: an exception becomes StageError
        (a breaker failure), an expiry StageTimeout, a clean exit a
        breaker success."""
        tok = _Token(Deadline(timeout_s), breaker)
        with self._cv:
            self._tokens.append(tok)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="ingest-watchdog", daemon=True)
                self._thread.start()
            self._cv.notify()
        try:
            yield tok
        except Exception as e:
            self._disarm(tok)
            breaker.record_failure()
            raise StageError(f"{type(e).__name__}: {e}") from e
        except BaseException:
            self._disarm(tok)
            raise
        self._disarm(tok)
        if tok.expired:
            raise StageTimeout("exceeded the watchdog deadline")
        breaker.record_success()

    def _disarm(self, tok: _Token) -> None:
        with self._cv:
            self._tokens = [t for t in self._tokens if t is not tok]

    def _run(self) -> None:
        while True:
            with self._cv:
                due = [t for t in self._tokens
                       if not t.expired and t.deadline.expired()]
                for t in due:
                    t.expired = True
                nearest = min((t.deadline.remaining() for t in self._tokens
                               if not t.expired), default=None)
            for t in due:
                _log.warning("ingest watchdog: %s stage outlived its "
                             "deadline; tripping its breaker",
                             t.breaker.name)
                t.breaker.trip()
            with self._cv:
                wait = 0.25 if nearest is None else \
                    max(min(nearest, 0.25), 0.001)
                self._cv.wait(timeout=wait)


class IngestSupervisor:
    """The process-wide ingest fault domains: one breaker per stage
    (`walk`, `analyze`) and the watchdog that charges them."""

    STAGES = ("walk", "analyze")

    def __init__(self):
        self._breakers = {s: _Breaker(s) for s in self.STAGES}
        self.watchdog = _Watchdog()
        self._lock = threading.Lock()
        self._busy = 0

    def breaker(self, stage: str) -> _Breaker:
        return self._breakers[stage]

    def configure(self, fail_threshold: int | None = None,
                  reset_timeout_s: float | None = None) -> None:
        for br in self._breakers.values():
            if fail_threshold is not None:
                br.fail_threshold = fail_threshold
            if reset_timeout_s is not None:
                br.reset_timeout_s = reset_timeout_s

    def walker_busy(self, delta: int) -> None:
        """Walker-pool occupancy (trivy_tpu_ingest_walker_busy)."""
        with self._lock:
            self._busy += delta
            busy = self._busy
        METRICS.set_gauge("trivy_tpu_ingest_walker_busy", float(busy))

    def status(self) -> dict:
        """→ /healthz's `resilience.ingest` block: each stage's breaker
        and the walkers busy."""
        with self._lock:
            busy = self._busy
        return {"breakers": {s: self._breakers[s].state_name()
                             for s in self.STAGES},
                "busy_walkers": busy}

    def reset_for_tests(self) -> None:
        for br in self._breakers.values():
            br.reset()
        with self._lock:
            self._busy = 0


INGEST = IngestSupervisor()

def _qos_tenant():
    """The clamped tenant label of the request this work serves (its
    cost ledger, obs/cost.py); None, exempt from the tenant shares, for
    untenanted and system work (every CLI walk)."""
    led = _cost.active()
    label = _cost.TENANTS.resolve(led.tenant) if led is not None else None
    return None if label in (None, "system") else label


# ---------------------------------------------------------------------------
# budgets


class IngestIntegrityError(RuntimeError):
    """A layer failed its content check (a registry blob whose digest
    does not match). The one failure the pipeline does not degrade
    around: tampered bytes are neither cached nor scanned; the artifact
    re-raises the wrapped original."""


class _PoolClosed(Exception):
    """The pipeline is being torn down under this walker: a cooperative
    stop, charged to no breaker and no budget."""


class IngestBudgetTrip(Exception):
    """A cooperative budget or deadline stop: the layer ends as a
    deterministic partial. Never charges a breaker (the input's fault,
    not the stage's)."""

    def __init__(self, kind: str, detail: str):
        super().__init__(detail)
        self.kind = kind
        self.detail = detail


class _ByteBudget:
    """The pipeline-wide in-flight content budget (bytes and items): a
    walker acquires a file's bytes before reading them, and the analyzer
    stage releases them when its batch resolves. `high_water` is the
    bound the tests assert. With `tenant_share` < 1.0 one tenant may
    hold at most that share of the window."""

    def __init__(self, max_bytes: int, max_items: int,
                 tenant_share: float = 1.0):
        self._cv = threading.Condition()
        self.max_bytes = max(int(max_bytes), 1)
        self.max_items = max(int(max_items), 1)
        share = float(tenant_share)
        self.tenant_cap = (max(1, int(self.max_bytes * share))
                           if 0.0 < share < 1.0 else 0)   # 0 = off
        self._bytes = 0
        self._items = 0
        self._t_bytes: dict[str, int] = {}
        self.high_water = 0

    def _tenant(self):
        return _qos_tenant() if self.tenant_cap > 0 else None

    def acquire(self, n: int, deadline: Deadline) -> bool:
        """Block until `n` bytes fit; → False when the deadline expires
        first (the caller annotates and stops)."""
        n = min(int(n), self.max_bytes)
        tenant = self._tenant()
        cap = self.tenant_cap if tenant is not None else 0
        if cap:
            n = min(n, cap)
        with self._cv:
            while (self._bytes + n > self.max_bytes
                   or self._items + 1 > self.max_items
                   or (cap and self._t_bytes.get(tenant, 0) + n > cap)):
                left = deadline.remaining()
                if left <= 0:
                    return False
                self._cv.wait(timeout=min(left, 0.05))
            self._bytes += n
            self._items += 1
            if cap:
                self._t_bytes[tenant] = self._t_bytes.get(tenant, 0) + n
            self.high_water = max(self.high_water, self._bytes)
            held = self._bytes
        METRICS.set_gauge("trivy_tpu_ingest_inflight_bytes", float(held))
        return True

    def release(self, n: int) -> None:
        n = min(int(n), self.max_bytes)
        tenant = self._tenant()
        cap = self.tenant_cap if tenant is not None else 0
        if cap:
            n = min(n, cap)
        with self._cv:
            self._bytes -= n
            self._items -= 1
            if cap:
                cur = self._t_bytes.get(tenant, 0) - n
                if cur > 0:
                    self._t_bytes[tenant] = cur
                else:
                    self._t_bytes.pop(tenant, None)
            held = self._bytes
            self._cv.notify_all()
        METRICS.set_gauge("trivy_tpu_ingest_inflight_bytes", float(held))


class _SpoolWindow:
    """A shared cap on the decompressed layer bytes held in spool buffers
    across walkers, with one overdraft: when the window is full, one
    walker at a time may spool past it (its layer still capped by
    max_layer_bytes), so big layers serialize instead of exhausting the
    host or deadlocking. Spool memory ≤ window + one layer + one chunk."""

    def __init__(self, max_bytes: int):
        self._cv = threading.Condition()
        self.max_bytes = max(int(max_bytes), 1)
        self._bytes = 0
        self._overdraft_held = False
        self.high_water = 0

    def _fits(self, st, n: int) -> bool:
        # callers hold self._cv
        if self._bytes + n > self.max_bytes:
            return False
        self._bytes += n
        st.spool_budgeted += n
        self.high_water = max(self.high_water, self._bytes)
        return True

    def charge(self, st, n: int, deadline: Deadline) -> None:
        """Account `n` more spooled bytes to layer state `st`; blocks
        (deadline-bounded) for the overdraft when the window is full."""
        with self._cv:
            if not st.spool_overdraft and self._fits(st, n):
                return
            while not st.spool_overdraft:
                # re-check the window first: another layer's release may
                # have made room while this one waited
                if self._fits(st, n):
                    return
                if not self._overdraft_held:
                    self._overdraft_held = True
                    st.spool_overdraft = True
                    break
                left = deadline.remaining()
                if left <= 0:
                    raise IngestBudgetTrip(
                        "deadline",
                        "spool backpressure wait exceeded the layer "
                        "deadline (shared spool window saturated)")
                self._cv.wait(timeout=min(left, 0.05))

    def release(self, st) -> None:
        with self._cv:
            self._bytes -= st.spool_budgeted
            st.spool_budgeted = 0
            if st.spool_overdraft:
                self._overdraft_held = False
                st.spool_overdraft = False
            self._cv.notify_all()


# ---------------------------------------------------------------------------
# streaming layer opens


class _ChainReader:
    """Serve a sniffed prefix, then the underlying stream."""

    def __init__(self, head: bytes, raw):
        self._head = head
        self._raw = raw

    def read(self, n: int = -1):
        if self._head:
            if n is None or n < 0 or n >= len(self._head):
                out, self._head = self._head, b""
                if n is not None and n >= 0:
                    n -= len(out)
                    if n == 0:
                        return out
                rest = self._raw.read(n if n is not None and n >= 0
                                      else -1)
                return out + rest
            out, self._head = self._head[:n], self._head[n:]
            return out
        return self._raw.read(n)


class _CountingReader:
    """A byte counter with an optional limit and a per-chunk trip check:
    where the stream budgets bind, so a decompression bomb stops
    mid-stream. Wraps a file (`read`) or is fed by the inflate loop
    (`note`)."""

    def __init__(self, raw=None, limit: int | None = None, trip=None):
        self.raw = raw
        self.count = 0
        self.limit = limit
        self.trip = trip    # callable() raising IngestBudgetTrip

    def note(self, n: int) -> None:
        # count, then the trip check (ratio, deadline), then the limit:
        # a bomb trips as a bomb, not as the layer cap it also blows
        self.count += n
        if self.trip is not None:
            self.trip()
        if self.limit is not None and self.count > self.limit:
            raise IngestBudgetTrip(
                "budget.layer_bytes",
                f"layer stream exceeded {self.limit} decompressed "
                f"bytes (--ingest-max-layer-bytes)")

    def read(self, n: int = -1):
        b = self.raw.read(n)
        self.note(len(b))
        return b


class _ChunkListReader(io.RawIOBase):
    """A seekable zero-copy reader over the spooled chunk list, so the
    spool window's charge is the spool's whole memory."""

    def __init__(self, chunks: list):
        self._chunks = chunks
        self._offsets = [0]
        for c in chunks:
            self._offsets.append(self._offsets[-1] + len(c))
        self._size = self._offsets[-1]
        self._pos = 0

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def seek(self, offset: int, whence: int = io.SEEK_SET) -> int:
        if whence == io.SEEK_SET:
            pos = offset
        elif whence == io.SEEK_CUR:
            pos = self._pos + offset
        elif whence == io.SEEK_END:
            pos = self._size + offset
        else:
            raise ValueError(f"invalid whence {whence}")
        if pos < 0:
            raise ValueError("negative seek position")
        self._pos = pos
        return pos

    def tell(self) -> int:
        return self._pos

    def readinto(self, b) -> int:
        if self._pos >= self._size:
            return 0
        view = memoryview(b)
        i = bisect.bisect_right(self._offsets, self._pos) - 1
        n, pos = 0, self._pos
        while n < len(view) and i < len(self._chunks):
            c = self._chunks[i]
            start = pos - self._offsets[i]
            take = min(len(c) - start, len(view) - n)
            view[n:n + take] = memoryview(c)[start:start + take]
            n += take
            pos += take
            i += 1
        self._pos = pos
        return n


class LayerStream:
    """A layer blob on its way into a tar reader: `c_in` counts the
    compressed bytes off the source (None for a plain layer), `c_out`
    the decompressed ones; their ratio is the bomb guard.

    The caller arms `c_out.limit`/`c_out.trip`, then `spool()` pulls the
    decompressed stream through the counter in CHUNK pieces (budgets
    bind per chunk, mid-stream) into a chunk list that `tar` reads."""

    CHUNK = 4 << 20          # decompressed bytes per budget check
    # compressed bytes per source read: small enough that a normal layer
    # inflates under CHUNK in one call (a bigger read re-feeds the
    # unconsumed tail, quadratic copying)
    IN_CHUNK = 256 << 10

    def __init__(self, c_in, c_out, gz: bool):
        self.c_in = c_in
        self.c_out = c_out
        self._gz = gz
        self.charge = None   # callable(nbytes): the spool window account
        self.tar: tarfile.TarFile | None = None
        # True once spool() read the compressed stream to its end; the
        # registry source verifies the digest only then, or after a
        # bounded drain (a partial layer never caches canonically)
        self.fully_spooled = False

    def spool(self) -> tarfile.TarFile:
        parts: list = []
        if self._gz:
            # zlib with the gzip wrapper (wbits=31); max_length bounds
            # each inflate, so a bomb expands at most CHUNK past a check
            d = zlib.decompressobj(31)
            tail = b""
            while True:
                comp = tail if tail else self.c_in.read(self.IN_CHUNK)
                if not comp:
                    if not d.eof:
                        raise EOFError(
                            "Compressed file ended before the "
                            "end-of-stream marker was reached")
                    break
                data = d.decompress(comp, self.CHUNK)
                tail = d.unconsumed_tail
                if data:
                    self.c_out.note(len(data))
                    if self.charge is not None:
                        self.charge(len(data))
                    parts.append(data)
                if d.eof:
                    # concatenated gzip members restart the inflater;
                    # bare trailing padding ends the stream
                    rest = d.unused_data.lstrip(b"\0")
                    if not rest:
                        break
                    d = zlib.decompressobj(31)
                    tail = rest
        else:
            while True:
                data = self.c_out.read(self.CHUNK)
                if not data:
                    break
                if self.charge is not None:
                    self.charge(len(data))
                parts.append(data)
        self.fully_spooled = True
        self.tar = tarfile.open(fileobj=io.BufferedReader(
            _ChunkListReader(parts), buffer_size=64 << 10))
        return self.tar

    def close(self) -> None:
        with contextlib.suppress(Exception):
            if self.tar is not None:
                self.tar.close()


@contextlib.contextmanager
def layer_tar_stream(raw):
    """Wrap a layer blob stream (gzip sniffed by its magic) in counting
    readers; the caller arms the budgets, then spool()s."""
    head = raw.read(2)
    src = _ChainReader(head, raw)
    if head[:2] == b"\x1f\x8b":
        ls = LayerStream(_CountingReader(src), _CountingReader(), gz=True)
    else:
        ls = LayerStream(None, _CountingReader(src), gz=False)
    try:
        yield ls
    finally:
        ls.close()


def bounded_drain(stream, ls) -> bool:
    """Drain a partly walked blob's tail so its digest can still be
    checked: read through `stream` (which hashes as it reads) up to
    `ls.drain_limit` bytes while `ls.drain_deadline` holds. → True at
    EOF (the digest is checkable); False when the tail is too big or
    too slow, and the caller skips the check rather than wedging."""
    limit = int(getattr(ls, "drain_limit", 0) or (64 << 20))
    deadline = getattr(ls, "drain_deadline", None)
    drained = 0
    while True:
        if deadline is not None and deadline.expired():
            return False
        chunk = stream.read(min(1 << 20, limit - drained + 1))
        if not chunk:
            return True
        drained += len(chunk)
        if drained > limit:
            return False


@contextlib.contextmanager
def archive_member_stream(archive_path: str, member_name: str):
    """A thread-safe layer open for archives: each call opens its own
    outer handle, and the compressed blob streams off it."""
    with tarfile.open(archive_path) as otf:
        raw = otf.extractfile(member_name)
        if raw is None:
            raise FileNotFoundError(
                f"{archive_path}: no such member {member_name}")
        with layer_tar_stream(raw) as ls:
            yield ls


# ---------------------------------------------------------------------------
# the pipeline


@dataclass
class LayerTask:
    idx: int
    diff_id: str
    blob_id: str
    created_by: str
    open_stream: object   # () -> context manager yielding LayerStream


class _LayerState:
    """One layer's in-walk state, touched only by its walker thread; the
    analyzer pool answers through the futures in `pending`."""

    def __init__(self):
        self.seq = 0
        self.members = 0
        self.layer_bytes = 0
        self.post: dict = {}       # seq -> (path, content)
        self.secrets: list = []    # (seq, path, content)
        self.pending: list = []    # (first_seq, Future, batch items)
        self.spool_budgeted = 0    # bytes charged to the spool window
        self.spool_overdraft = False
        self.integrity_error = None   # IngestIntegrityError to re-raise


# input-shaped failures: partials WITHOUT a walk-breaker charge (one
# hostile layer must not degrade the stage for everyone). Not a bare
# OSError: a failing disk is a stage fault; only gzip.BadGzipFile is
# input-shaped
_HOSTILE_INPUT_ERRORS = (tarfile.TarError, gzip.BadGzipFile, EOFError,
                         UnicodeError, ValueError, zlib.error)
# at the layer's open, a missing member is the manifest's fault too
_HOSTILE_OPEN_ERRORS = _HOSTILE_INPUT_ERRORS + (FileNotFoundError,
                                                KeyError)


class IngestPipeline:
    """One pipelined walk over an image's missing layers: the walker
    pool streams layers concurrently into the analyzer pool through the
    byte budget; each layer resolves to a complete BlobScan (the serial
    walker's) or a deterministic annotated partial."""

    def __init__(self, group: AnalyzerGroup, opts: IngestOptions,
                 collect_secrets: bool = False,
                 secret_config_path: str = DEFAULT_SECRET_CONFIG,
                 skip_files: tuple = (), skip_dir_globs: tuple = ()):
        self.group = group
        self.opts = opts
        self.collect_secrets = collect_secrets
        self.secret_config_path = secret_config_path
        self.skip_files = normalize_skip_globs(skip_files)
        self.skip_dir_globs = normalize_skip_globs(skip_dir_globs)
        self.budget = _ByteBudget(opts.max_inflight_bytes,
                                  opts.max_inflight_items,
                                  tenant_share=opts.tenant_byte_share)
        # per-tenant count of layers holding (or queued for) a walker
        self._wcv = threading.Condition()
        self._wbusy: dict[str, int] = {}
        # the spool shares its own window of the same size
        self.spool = _SpoolWindow(opts.max_inflight_bytes)
        self._walk_pool = ThreadPoolExecutor(
            opts.n_walkers(), thread_name_prefix="ingest-walk")
        self._an_pool = ThreadPoolExecutor(
            opts.n_analyzers(), thread_name_prefix="ingest-analyze")
        # liveness for run()'s abandon rule: bumped by every resolved
        # analyzer batch, so a layer still draining batches reads as
        # progress, not as a wedge
        self._progress_lock = threading.Lock()
        self._progress = 0
        # the walker threads that walked a layer (the walkers used)
        self.walker_threads: set = set()

    def _note_progress(self) -> None:
        with self._progress_lock:
            self._progress += 1

    def _progress_mark(self) -> int:
        with self._progress_lock:
            return self._progress

    def close(self) -> None:
        # wait=False: a wedged walker must not hold up the scan that
        # already degraded around it
        self._walk_pool.shutdown(wait=False)
        self._an_pool.shutdown(wait=False)

    # ---- orchestration -------------------------------------------------

    def run(self, tasks: list[LayerTask]) -> dict[int, BlobScan]:
        """→ {layer idx: BlobScan}. Never raises for a layer's failure.

        The abandon rule is progress-aware: the patience (one layer's
        watch deadline plus a margin) restarts on every completed layer
        or analyzer batch, so a deep image draining through a small pool
        is never abandoned; a whole window with no progress means the
        pool is wedged, and every remaining layer is abandoned at once."""
        futs = []
        out: dict[int, BlobScan] = {}
        share = self.opts.tenant_walker_share
        tenant = _qos_tenant() if 0.0 < share < 1.0 else None
        wcap = (max(1, int(self.opts.n_walkers() * share))
                if tenant is not None else 0)
        for t in tasks:
            if wcap:
                slot_dl = Deadline(self.opts.layer_deadline_ms / 1e3)
                if not self._acquire_walker_slot(tenant, wcap, slot_dl):
                    out[t.idx] = self._partial(
                        t, "walk", "tenant_budget",
                        "tenant walker-slot share saturated past the "
                        "layer deadline; layer abandoned")
                    continue
            ctx = contextvars.copy_context()
            fut = self._walk_pool.submit(ctx.run, self._walk_layer, t)
            if wcap:
                # done-callbacks run for cancelled futures too
                fut.add_done_callback(
                    lambda _f, _t=tenant: self._release_walker_slot(_t))
            futs.append((t, fut))
        grace = self.opts.watch_timeout_s() + self.opts.abandon_grace_s
        by_fut = {fut: t for t, fut in futs}
        pending = set(by_fut)
        last_progress = self._progress_mark()
        while pending:
            done, pending = _fut_wait(pending, timeout=grace,
                                      return_when=FIRST_COMPLETED)
            if not done:
                cur = self._progress_mark()
                if cur != last_progress:
                    last_progress = cur
                    continue
                for fut in pending:
                    fut.cancel()
                    t = by_fut[fut]
                    out[t.idx] = self._partial(
                        t, "walk", "wedged",
                        f"walker pool made no progress for "
                        f"{grace:.0f}s; layer abandoned")
                break
            for fut in done:
                t = by_fut[fut]
                try:
                    out[t.idx] = fut.result()
                except IngestIntegrityError:
                    raise   # tampered content: never degraded or cached
                except Exception as e:  # noqa: BLE001 — never fatal
                    _log.exception("ingest: layer %d walk raised", t.idx)
                    out[t.idx] = self._partial(
                        t, "walk", "internal", f"{type(e).__name__}: {e}")
        # counted once per layer returned: an abandoned walker that
        # finishes later does not count its layer again
        for t in tasks:
            if t.idx in out and out[t.idx].partial:
                METRICS.inc("trivy_tpu_ingest_partial_scans_total")
        return out

    def _acquire_walker_slot(self, tenant: str, cap: int,
                             deadline: Deadline) -> bool:
        with self._wcv:
            while self._wbusy.get(tenant, 0) >= cap:
                left = deadline.remaining()
                if left <= 0:
                    return False
                self._wcv.wait(timeout=min(left, 0.05))
            self._wbusy[tenant] = self._wbusy.get(tenant, 0) + 1
            return True

    def _release_walker_slot(self, tenant: str) -> None:
        with self._wcv:
            cur = self._wbusy.get(tenant, 0) - 1
            if cur > 0:
                self._wbusy[tenant] = cur
            else:
                self._wbusy.pop(tenant, None)
            self._wcv.notify_all()

    def _partial(self, task: LayerTask, stage: str, kind: str,
                 detail: str) -> BlobScan:
        scan = BlobScan(result=AnalysisResult())
        scan.errors.append(ingest_error(stage, kind, detail,
                                        layer=task.idx))
        scan.partial = True
        return scan

    # ---- walk stage ----------------------------------------------------

    def _walk_layer(self, task: LayerTask) -> BlobScan:
        opts = self.opts
        scan = BlobScan(result=AnalysisResult())
        br = INGEST.breaker("walk")
        if not br.allow():
            # an open stage degrades at once (the half-open probe walk
            # comes through this same gate)
            scan.errors.append(ingest_error(
                "walk", "breaker_open",
                "ingest walk breaker open; layer skipped",
                layer=task.idx))
        else:
            self.walker_threads.add(threading.current_thread().name)
            INGEST.walker_busy(+1)
            st = _LayerState()
            deadline = Deadline(opts.layer_deadline_ms / 1e3)
            t_walk = time.perf_counter()
            try:
                with span("fanal.layer_walk", layer=task.idx,
                          diff_id=task.diff_id, pipelined=True) as sp:
                    try:
                        with INGEST.watchdog.watch(opts.watch_timeout_s(),
                                                   br) as tok:
                            self._stream_layer(task, scan, st, deadline,
                                               tok)
                    except StageTimeout:
                        scan.errors.append(ingest_error(
                            "walk", "timeout",
                            "layer walk outlived the ingest watchdog "
                            "deadline", layer=task.idx))
                    except StageError as e:
                        cause = e.__cause__ or e
                        scan.errors.append(ingest_error(
                            "walk", "error",
                            f"{type(cause).__name__}: {cause}",
                            layer=task.idx))
                    # the spooled chunks died with the layer stream:
                    # give their window back before the analyzer drain
                    self.spool.release(st)
                    self._collect(task, scan, st)
                    sp.attrs.update(partial=bool(scan.errors),
                                    members=st.members,
                                    read_bytes=st.layer_bytes)
            finally:
                INGEST.walker_busy(-1)
                self.spool.release(st)
                # one layer's ingest bill: the bytes read and the
                # walker's wall ms, on the requesting tenant's ledger
                _cost.charge_ingest(float(st.layer_bytes),
                                    (time.perf_counter() - t_walk) * 1e3)
            if st.integrity_error is not None:
                # raised outside the watch, so content integrity (the
                # input's fault) never charges the walk breaker
                raise st.integrity_error
        if scan.errors:
            scan.partial = True
        return scan

    def _stream_layer(self, task: LayerTask, scan: BlobScan,
                      st: _LayerState, deadline: Deadline, tok) -> None:
        try:
            cm = task.open_stream()
        except Exception as e:  # noqa: BLE001 — contained as a partial
            scan.errors.append(ingest_error(
                "walk", "open_error", f"{type(e).__name__}: {e}",
                layer=task.idx))
            return
        try:
            self._stream_layer_inner(task, scan, st, deadline, tok, cm)
        except IngestIntegrityError as e:
            # caught inside the watch, so a digest mismatch is no stage
            # failure; _walk_layer re-raises it after the watch
            st.integrity_error = e

    def _stream_layer_inner(self, task: LayerTask, scan: BlobScan,
                            st: _LayerState, deadline: Deadline, tok,
                            cm) -> None:
        opts = self.opts
        batch: list = []
        batch_bytes = 0
        with contextlib.ExitStack() as stack:
            try:
                ls = stack.enter_context(cm)
            except _HOSTILE_OPEN_ERRORS as e:
                scan.errors.append(ingest_error(
                    "walk", "open_error", f"{type(e).__name__}: {e}",
                    layer=task.idx))
                return
            ls.c_out.limit = opts.max_layer_bytes
            ls.charge = lambda n: self.spool.charge(st, n, deadline)

            def _trip_check():
                if deadline.expired() or tok.expired:
                    raise IngestBudgetTrip(
                        "deadline", "layer deadline expired "
                        "mid-stream (--ingest-layer-deadline-ms)")
                if ls.c_in is not None \
                        and ls.c_out.count > opts.ratio_floor \
                        and ls.c_out.count > opts.max_ratio * \
                        max(ls.c_in.count, 1):
                    raise IngestBudgetTrip(
                        "bomb",
                        f"decompression ratio "
                        f"{ls.c_out.count / max(ls.c_in.count, 1):.0f}"
                        f" exceeds {opts.max_ratio:g} "
                        f"(decompression-bomb guard)")

            ls.c_out.trip = _trip_check
            # the registry source's digest drain binds to this layer's
            # own budgets
            ls.drain_deadline = deadline
            ls.drain_limit = opts.max_layer_bytes
            try:
                for member in ls.spool():
                    if tok.expired:
                        # the watchdog already tripped: leave, so the
                        # watch raises StageTimeout
                        break
                    if deadline.expired():
                        raise IngestBudgetTrip(
                            "deadline", "layer deadline expired "
                            "(--ingest-layer-deadline-ms)")
                    st.members += 1
                    if st.members > opts.max_members:
                        raise IngestBudgetTrip(
                            "budget.members",
                            f"layer exceeds {opts.max_members} "
                            f"members (--ingest-max-members)")
                    kind, path, wants3 = classify_member(
                        member, self.group, self.collect_secrets,
                        self.secret_config_path, self.skip_files,
                        self.skip_dir_globs)
                    if kind == "opaque":
                        scan.opaque_dirs.append(path)
                        continue
                    if kind == "whiteout":
                        scan.whiteout_files.append(path)
                        continue
                    if kind != "file":
                        continue
                    size = member.size
                    if size > opts.max_file_bytes:
                        METRICS.inc("trivy_tpu_ingest_budget_trips_total",
                                    kind="budget.file_bytes")
                        scan.errors.append(ingest_error(
                            "walk", "budget.file_bytes",
                            f"{size} bytes exceeds "
                            f"--ingest-max-file-bytes "
                            f"({opts.max_file_bytes}); file skipped",
                            layer=task.idx, path=path))
                        continue
                    if st.layer_bytes + size > opts.max_layer_bytes:
                        raise IngestBudgetTrip(
                            "budget.layer_bytes",
                            f"layer content exceeds "
                            f"{opts.max_layer_bytes} bytes "
                            f"(--ingest-max-layer-bytes)")
                    try:
                        f = ls.tar.extractfile(member)
                    except tarfile.StreamError:
                        # a hardlink whose target cannot be reached: the
                        # target analyzes under its own member
                        continue
                    except (KeyError, RecursionError):
                        # a link target that never existed, or a link
                        # cycle (tarfile's resolution recurses forever)
                        scan.errors.append(ingest_error(
                            "walk", "link_error",
                            "unresolvable or cyclic link target",
                            layer=task.idx, path=path))
                        continue
                    if f is None:
                        continue
                    if not self.budget.acquire(size, deadline):
                        raise IngestBudgetTrip(
                            "deadline",
                            "backpressure wait exceeded the layer "
                            "deadline (pipeline byte budget "
                            "saturated)")
                    try:
                        content = f.read()
                    except BaseException:
                        self.budget.release(size)
                        raise
                    st.layer_bytes += len(content)
                    wants, wants_post, wants_secret = wants3
                    seq = st.seq
                    st.seq += 1
                    if wants_post:
                        st.post[seq] = (path, content)
                    if wants_secret and not looks_binary(content):
                        st.secrets.append((seq, path, content))
                    if wants:
                        batch.append((seq, path, content, size))
                        batch_bytes += size
                        if len(batch) >= opts.batch_files or \
                                batch_bytes >= opts.batch_bytes:
                            self._submit_batch(task, st, batch)
                            batch, batch_bytes = [], 0
                    else:
                        # retained only (post, secret) or nothing: the
                        # analysis window is over for these bytes
                        self.budget.release(size)
            except IngestBudgetTrip as trip:
                METRICS.inc("trivy_tpu_ingest_budget_trips_total",
                            kind=trip.kind)
                scan.errors.append(ingest_error(
                    "walk", trip.kind, trip.detail, layer=task.idx))
            except _HOSTILE_INPUT_ERRORS as e:
                # hostile or corrupt input (truncated gzip, lying member
                # sizes, malformed headers): a partial, no breaker charge
                scan.errors.append(ingest_error(
                    "walk", "layer_error", f"{type(e).__name__}: {e}",
                    layer=task.idx))
            except _PoolClosed:
                scan.errors.append(ingest_error(
                    "walk", "cancelled",
                    "pipeline shutting down; layer walk stopped",
                    layer=task.idx))
            finally:
                if batch:
                    try:
                        self._submit_batch(task, st, batch)
                    except _PoolClosed:
                        scan.errors.append(ingest_error(
                            "walk", "cancelled",
                            "pipeline shutting down; final analyzer "
                            "batch dropped", layer=task.idx))

    # ---- analyze stage -------------------------------------------------

    def _submit_batch(self, task: LayerTask, st: _LayerState,
                      batch: list) -> None:
        ctx = contextvars.copy_context()
        items = list(batch)
        METRICS.gauge_add("trivy_tpu_ingest_analyze_depth", 1.0)
        try:
            fut = self._an_pool.submit(ctx.run, self._analyze_batch,
                                       task, items)
        except RuntimeError as e:
            METRICS.gauge_add("trivy_tpu_ingest_analyze_depth", -1.0)
            # "cannot schedule new futures after shutdown": close() raced
            # this walker. The batch never runs, so release its budget
            # here, and empty it so the caller's finally cannot resubmit
            for _seq, _p, _c, sz in items:
                self.budget.release(sz)
            batch.clear()
            raise _PoolClosed(str(e)) from e
        st.pending.append((batch[0][0], fut, items))

    def _analyze_batch(self, task: LayerTask, items: list):
        """→ ({seq: AnalysisResult}, [ingest_error]), on the analyzer
        pool under the `analyze` breaker; releases the byte budget of
        every item whatever happens."""
        br = INGEST.breaker("analyze")
        results: dict = {}
        errors: list = []
        t_batch = time.perf_counter()
        try:
            if not br.allow():
                errors.append(ingest_error(
                    "analyze", "breaker_open",
                    f"{len(items)} file(s) skipped: ingest analyze "
                    f"breaker open", layer=task.idx))
                return results, errors

            def on_error(analyzer: str, path: str, exc: Exception):
                errors.append(ingest_error(
                    "analyze", "analyzer_error",
                    f"{analyzer}: {type(exc).__name__}: {exc}",
                    layer=task.idx, path=path))

            try:
                with INGEST.watchdog.watch(self.opts.watch_timeout_s(),
                                           br):
                    rs = self.group.analyze_batch(
                        [(p, c) for _seq, p, c, _sz in items],
                        on_error=on_error)
                for (seq, _p, _c, _sz), r in zip(items, rs):
                    if r is not None:
                        results[seq] = r
            except StageTimeout:
                errors.append(ingest_error(
                    "analyze", "timeout",
                    f"analyzer batch ({len(items)} files) outlived "
                    f"the ingest watchdog deadline", layer=task.idx))
            except StageError as e:
                cause = e.__cause__ or e
                errors.append(ingest_error(
                    "analyze", "error", f"{type(cause).__name__}: {cause}",
                    layer=task.idx))
            return results, errors
        finally:
            for _seq, _p, _c, sz in items:
                self.budget.release(sz)
            METRICS.gauge_add("trivy_tpu_ingest_analyze_depth", -1.0)
            # the analyzers' wall ms joins the layer's ingest bill (its
            # bytes were charged at the walk)
            _cost.charge_ingest(0.0, (time.perf_counter() - t_batch) * 1e3)
            self._note_progress()

    # ---- layer finalize ------------------------------------------------

    def _collect(self, task: LayerTask, scan: BlobScan,
                 st: _LayerState) -> None:
        """Merge the layer's analyzer batches back in member order, so
        the BlobScan equals the serial walker's member-order merge."""
        results_by_seq: dict = {}
        batch_errs: list = []
        grace = self.opts.watch_timeout_s() + self.opts.abandon_grace_s
        # the same progress-aware wait as run(): a whole window with no
        # progress drops every unresolved batch at once
        by_fut = {fut: (first_seq, items)
                  for first_seq, fut, items in st.pending}
        pending = set(by_fut)
        while pending:
            done, pending = _fut_wait(pending, timeout=grace,
                                      return_when=FIRST_COMPLETED)
            if not done:
                for fut in pending:
                    first_seq, items = by_fut[fut]
                    if fut.cancel():
                        # a cancelled batch never runs _analyze_batch,
                        # so its budget is released here; a running one
                        # releases its own when it wakes
                        for _seq, _p, _c, sz in items:
                            self.budget.release(sz)
                    batch_errs.append((first_seq, [ingest_error(
                        "analyze", "wedged",
                        f"analyzer pool made no progress for "
                        f"{grace:.0f}s; batch dropped",
                        layer=task.idx)]))
                break
            for fut in done:
                first_seq, _items = by_fut[fut]
                try:
                    rs, errs = fut.result()
                except Exception as e:  # noqa: BLE001 — never fatal
                    rs, errs = {}, [ingest_error(
                        "analyze", "internal",
                        f"{type(e).__name__}: {e}", layer=task.idx)]
                results_by_seq.update(rs)
                if errs:
                    batch_errs.append((first_seq, errs))
        for seq in sorted(results_by_seq):
            scan.result.merge(results_by_seq[seq])
        for _first, errs in sorted(batch_errs, key=lambda t: t[0]):
            scan.errors.extend(errs)
        scan.post_files = {p: c for _seq, (p, c) in sorted(st.post.items())}
        scan.secret_files = [(p, c) for _seq, p, c in sorted(st.secrets)]
        try:
            self.group.post_analyze(scan.post_files, scan.result)
        except Exception as e:  # noqa: BLE001 — hostile post content
            scan.errors.append(ingest_error(
                "analyze", "post_analyze_error",
                f"{type(e).__name__}: {e}", layer=task.idx))
