"""Cluster coordination: node discovery and the querier's staging fan-in.

Counterpart of `parseable_tpu/server/cluster.py` (:1-683; reference:
handlers/http/cluster/mod.rs, airplane.rs, utils/arrow/flight.rs). A
query-mode node finds the ingestors in the object-store node registry
(`Metastore.list_nodes`), probes their liveness, and pulls each live
ingestor's staging window as Arrow record batches before a query. The data
plane is a two-tier transport ladder:

- Arrow Flight (`server/flight.py`) when the peer's registry entry
  advertises a `flight_url` and this client has not pinned HTTP
  (`P_FLIGHT_CLIENT=0`): batches stream over a cached channel per peer
  (`FlightChannelPool`);
- HTTP + Arrow IPC (`/api/v1/internal/staging/{stream}`) over keep-alive
  connections per peer (`PeerConnectionPool`), decoded batch by batch off
  the socket. Any Flight decline lands here; batches a failed Flight read
  had already received are dropped first, so no row counts twice.

A dead node is skipped after a failed liveness probe and remembered for
`DEAD_NODE_TTL` seconds. `sync_with_ingestors` fans a control-plane
mutation (stream create or delete) out to the live ingestors.

The JAX module's telemetry spans, trace propagation and Prometheus counters
are not ported (the port has neither yet); the `stats` dicts they mirror
are, since the querier's `stats.stages.fanout` reports them. Its metrics
scrape, cluster trace, node removal and querier round-robin are later
slices.
"""

from __future__ import annotations

import base64
import http.client
import io
import json
import logging
import ssl
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor, as_completed
from contextlib import contextmanager

import pyarrow as pa
import pyarrow.ipc as ipc

from parseable_tpu_torch.core import Parseable

logger = logging.getLogger(__name__)

LIVENESS_TIMEOUT = 2.0
STAGING_TIMEOUT = 10.0
DEAD_NODE_TTL = 30.0

# domain -> monotonic time of its last failed probe or fetch
_dead_nodes: dict[str, float] = {}

# Process-wide intra-cluster worker pool, built lazily and re-creatable
# after `shutdown_cluster_pool` (servers restart within one test process)
_POOL: ThreadPoolExecutor | None = None
_POOL_LOCK = threading.Lock()


def get_cluster_pool() -> ThreadPoolExecutor:
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = ThreadPoolExecutor(max_workers=8, thread_name_prefix="cluster")
        return _POOL


def shutdown_cluster_pool(wait: bool = True) -> None:
    """Deterministic stop (`ServerState.stop`); the next
    `get_cluster_pool()` builds a fresh pool."""
    global _POOL
    with _POOL_LOCK:
        pool, _POOL = _POOL, None
    if pool is not None:
        pool.shutdown(wait=wait)


class PeerConnectionPool:
    """Keep-alive `http.client` connections per peer for the HTTP tier.

    At most `max_idle` warm sockets are kept per (scheme, host, port). A
    kept socket the peer closed while idle is retried ONCE on a fresh one
    before any error surfaces. The error contract is urllib's: a status of
    400 or more raises `urllib.error.HTTPError` (with `.code` and a
    readable body), a transport failure `urllib.error.URLError` or
    `OSError`."""

    def __init__(self, max_idle: int = 4):
        self.max_idle = max_idle
        self._lock = threading.Lock()
        self._idle: dict[tuple, list] = {}  # guarded-by: self._lock
        self._closed = False  # guarded-by: self._lock

    def _checkout(self, key):
        with self._lock:
            conns = self._idle.get(key)
            if conns:
                return conns.pop()
        return None

    def _checkin(self, key, conn) -> None:
        with self._lock:
            if not self._closed:
                conns = self._idle.setdefault(key, [])
                if len(conns) < self.max_idle:
                    conns.append(conn)
                    return
        conn.close()

    @staticmethod
    def _connect(scheme: str, host: str, port: int, timeout: float):
        if scheme == "https":
            return http.client.HTTPSConnection(
                host, port, timeout=timeout, context=ssl.create_default_context()
            )
        return http.client.HTTPConnection(host, port, timeout=timeout)

    @contextmanager
    def request(self, method, url, body=None, headers=None, timeout=10.0):
        parts = urllib.parse.urlsplit(url)
        scheme = parts.scheme or "http"
        host = parts.hostname or ""
        port = parts.port or (443 if scheme == "https" else 80)
        key = (scheme, host, port)
        path = parts.path or "/"
        if parts.query:
            path = f"{path}?{parts.query}"
        resp = None
        for attempt in (0, 1):
            conn = self._checkout(key)
            reused = conn is not None
            if conn is None:
                conn = self._connect(scheme, host, port, timeout)
            try:
                # the per-request deadline on a kept socket (the constructor
                # timeout only covered its first connect)
                if conn.sock is not None:
                    conn.sock.settimeout(timeout)
                else:
                    conn.timeout = timeout
                conn.request(method, path, body=body, headers=headers or {})
                resp = conn.getresponse()
                break
            except (http.client.HTTPException, OSError) as e:
                conn.close()
                stale = isinstance(
                    e,
                    (
                        http.client.BadStatusLine,
                        http.client.RemoteDisconnected,
                        BrokenPipeError,
                        ConnectionResetError,
                    ),
                )
                # a kept socket the peer closed while idle is not a peer
                # failure: retry once on a fresh connection
                if reused and attempt == 0 and stale:
                    continue
                if isinstance(e, OSError):
                    raise
                raise urllib.error.URLError(e) from e
        if resp.status >= 400:
            data = resp.read()
            self._maybe_reuse(key, conn, resp)
            raise urllib.error.HTTPError(url, resp.status, resp.reason, resp.headers, io.BytesIO(data))
        try:
            yield resp
        finally:
            self._maybe_reuse(key, conn, resp)

    def _maybe_reuse(self, key, conn, resp) -> None:
        try:
            if not resp.isclosed():
                resp.read()  # drain, so the next request on this socket starts clean
            if getattr(resp, "will_close", True):
                conn.close()
            else:
                self._checkin(key, conn)
        except Exception:
            conn.close()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            conns = [c for lst in self._idle.values() for c in lst]
            self._idle.clear()
        for c in conns:
            try:
                c.close()
            except OSError:
                pass


_CONN_POOL: PeerConnectionPool | None = None
_CONN_POOL_LOCK = threading.Lock()


def get_conn_pool() -> PeerConnectionPool:
    global _CONN_POOL
    with _CONN_POOL_LOCK:
        if _CONN_POOL is None:
            _CONN_POOL = PeerConnectionPool()
        return _CONN_POOL


def shutdown_conn_pool() -> None:
    """Close every idle keep-alive socket (`ServerState.stop`). A request
    in flight holds its connection outside the pool and closes it on
    check-in (the pool is marked closed)."""
    global _CONN_POOL
    with _CONN_POOL_LOCK:
        pool, _CONN_POOL = _CONN_POOL, None
    if pool is not None:
        pool.close()


class FlightChannelPool:
    """Cached Arrow Flight clients per peer: channel set-up is the cost per
    call that the Flight tier exists to avoid. `invalidate` drops a channel
    that a failure implicated; the next call redials."""

    # gRPC's bandwidth-delay probe starts each stream with a small window
    # and ramps it from RTT estimates, which caps DoGet well under wire
    # speed on a loopback or LAN; a large static window ships staging
    # windows faster, and the maximum HTTP/2 frame keeps 2 MB record
    # batches whole. Flow control is the receiver's, so the client's
    # channel options govern the DoGet direction
    GRPC_OPTIONS = [
        ("grpc.http2.bdp_probe", 0),
        ("grpc.http2.lookahead_bytes", 16 * 1024 * 1024),
        ("grpc.http2.max_frame_size", 16777215),
    ]

    def __init__(self):
        self._lock = threading.Lock()
        self._clients: dict[str, object] = {}  # guarded-by: self._lock

    def get(self, location: str):
        import pyarrow.flight as fl

        with self._lock:
            client = self._clients.get(location)
            if client is None:
                client = fl.FlightClient(location, generic_options=list(self.GRPC_OPTIONS))
                self._clients[location] = client
            return client

    def invalidate(self, location: str) -> None:
        with self._lock:
            client = self._clients.pop(location, None)
        if client is not None:
            try:
                client.close()
            except Exception:  # noqa: BLE001 - best-effort channel teardown
                pass

    def close(self) -> None:
        with self._lock:
            clients, self._clients = list(self._clients.values()), {}
        for client in clients:
            try:
                client.close()
            except Exception:  # noqa: BLE001 - best-effort channel teardown
                pass


_FLIGHT_POOL: FlightChannelPool | None = None
_FLIGHT_POOL_LOCK = threading.Lock()


def get_flight_pool() -> FlightChannelPool:
    global _FLIGHT_POOL
    with _FLIGHT_POOL_LOCK:
        if _FLIGHT_POOL is None:
            _FLIGHT_POOL = FlightChannelPool()
        return _FLIGHT_POOL


def shutdown_flight_pool() -> None:
    """Close every cached Flight channel (`ServerState.stop`)."""
    global _FLIGHT_POOL
    with _FLIGHT_POOL_LOCK:
        pool, _FLIGHT_POOL = _FLIGHT_POOL, None
    if pool is not None:
        pool.close()


def flight_location(p: Parseable, node: dict) -> str | None:
    """The peer's advertised Flight endpoint, or None where the Flight tier
    does not apply: no `flight_url` in its registry entry, this client
    pinned to HTTP (`P_FLIGHT_CLIENT=0`), or a pyarrow built without
    Flight."""
    loc = node.get("flight_url")
    if not loc or not p.options.flight_client:
        return None
    try:
        import pyarrow.flight  # noqa: F401
    except ImportError:
        return None
    return loc


def _flight_call_options(p: Parseable, timeout: float):
    """The Basic cluster credentials of the HTTP tier, as gRPC call headers
    for `server/flight.py`'s middleware."""
    import pyarrow.flight as fl

    return fl.FlightCallOptions(
        timeout=timeout, headers=[(b"authorization", _auth_header(p).encode())]
    )


def _auth_header(p: Parseable) -> str:
    cred = f"{p.options.username}:{p.options.password}".encode()
    return "Basic " + base64.b64encode(cred).decode()


def _urlopen(req, timeout: float):
    """Intra-cluster urlopen; an https peer gets the default client context."""
    url = req.full_url if hasattr(req, "full_url") else str(req)
    if url.startswith("https://"):
        return urllib.request.urlopen(req, timeout=timeout, context=ssl.create_default_context())
    return urllib.request.urlopen(req, timeout=timeout)


def _http(p: Parseable, method: str, url: str, body: bytes | None = None, headers=None, timeout=10.0):
    """One intra-cluster HTTP round trip over the keep-alive pool, with the
    cluster credentials. Returns a context manager yielding the response;
    raises urllib's errors (HTTPError at 400 or more, URLError or OSError
    on transport failure)."""
    hdrs = {"Authorization": _auth_header(p)}
    hdrs.update(headers or {})
    if body is not None and "Content-Type" not in hdrs:
        hdrs["Content-Type"] = "application/json"
    return get_conn_pool().request(method, url, body=body, headers=hdrs, timeout=timeout)


def check_liveness(domain: str) -> bool:
    """GET `/api/v1/liveness` on a peer; a failure marks it dead for
    `DEAD_NODE_TTL` seconds, during which it is not probed again."""
    cached = _dead_nodes.get(domain)
    if cached is not None and time.monotonic() - cached < DEAD_NODE_TTL:
        return False
    try:
        req = urllib.request.Request(f"{domain}/api/v1/liveness", method="GET")
        with _urlopen(req, LIVENESS_TIMEOUT) as resp:
            ok = resp.status == 200
    except (urllib.error.URLError, OSError):
        ok = False
    if not ok:
        _dead_nodes[domain] = time.monotonic()
    else:
        _dead_nodes.pop(domain, None)
    return ok


def live_ingestors(p: Parseable) -> list[dict]:
    """Registered ingestors other than this node that answer liveness."""
    nodes = [n for n in p.metastore.list_nodes("ingestor") if n.get("node_id") != p.node_id]
    return [n for n in nodes if check_liveness(n["domain_name"])]


def live_peers(p: Parseable, kinds: tuple[str, ...]) -> list[dict]:
    """Live nodes of the given kinds, this node excluded."""
    nodes = [
        n for kind in kinds for n in p.metastore.list_nodes(kind) if n.get("node_id") != p.node_id
    ]
    return [n for n in nodes if check_liveness(n["domain_name"])]


def _staging_params(time_bounds=None, columns=None) -> str:
    """Query string of the bounded fan-in: the peer filters its window to
    [start, end) and projects to `fields` before serializing. The querier
    filters again either way, so the bound saves bytes and never decides
    an answer."""
    params: list[tuple[str, str]] = []
    if time_bounds is not None:
        if time_bounds.low is not None:
            params.append(("start", time_bounds.low.isoformat()))
        if time_bounds.high is not None:
            params.append(("end", time_bounds.high.isoformat()))
    if columns is not None:
        params.append(("fields", ",".join(sorted(columns))))
    return urllib.parse.urlencode(params)


def _staging_ticket(stream: str, time_bounds=None, columns=None) -> dict:
    """The Flight twin of `_staging_params`."""
    ticket: dict = {"kind": "staging", "stream": stream}
    if time_bounds is not None:
        if time_bounds.low is not None:
            ticket["start"] = time_bounds.low.isoformat()
        if time_bounds.high is not None:
            ticket["end"] = time_bounds.high.isoformat()
    if columns is not None:
        ticket["fields"] = sorted(columns)
    return ticket


def _count(stats: dict | None, **deltas: int) -> None:
    """Add to the fan-in counters of one query. Workers of one fetch add
    under the GIL, as the JAX module does."""
    if stats is not None:
        for k, v in deltas.items():
            stats[k] = stats.get(k, 0) + v


class _CountingReader:
    """The file protocol pyarrow's IPC reader needs, counting the wire
    bytes as they pass: batches decode off the socket one by one while the
    fan-in still sees the payload's exact size."""

    closed = False

    def __init__(self, raw):
        self._raw = raw
        self.count = 0

    def read(self, n=None):
        data = self._raw.read() if n is None else self._raw.read(n)
        self.count += len(data)
        return data

    def readable(self):
        return True

    def writable(self):
        return False

    def seekable(self):
        return False

    def flush(self):
        pass

    def close(self):
        pass


def _fetch_one(
    p: Parseable, domain: str, stream: str, time_bounds=None, columns=None, stats: dict | None = None
) -> list[pa.RecordBatch]:
    """HTTP tier of the staging fan-in: one bounded pull, decoded off the
    socket. A failure is logged and counted, and gives no rows."""
    url = f"{domain}/api/v1/internal/staging/{stream}"
    qs = _staging_params(time_bounds, columns)
    if qs:
        url = f"{url}?{qs}"
    try:
        with _http(p, "GET", url, timeout=STAGING_TIMEOUT) as resp:
            if resp.status == 204:
                return []
            counting = _CountingReader(resp)
            try:
                with ipc.open_stream(counting) as reader:
                    batches = list(reader)
            except pa.ArrowInvalid as e:
                logger.warning("bad staging payload from %s: %s", domain, e)
                _count(stats, errors=1)
                return []
    except (urllib.error.URLError, OSError) as e:
        logger.warning("staging fan-in from %s failed: %s", domain, e)
        _count(stats, errors=1)
        _dead_nodes[domain] = time.monotonic()
        return []
    _count(stats, bytes=counting.count, http_bytes=counting.count)
    return batches


def _fetch_one_flight(
    p: Parseable,
    location: str,
    domain: str,
    stream: str,
    time_bounds=None,
    columns=None,
    stats: dict | None = None,
) -> list[pa.RecordBatch] | None:
    """Flight tier of the staging fan-in: one DoGet with the bounded-window
    ticket. Returns None on ANY failure: the caller declines to HTTP, and
    batches already received are dropped so no row counts twice."""
    import pyarrow.flight as fl

    ticket = _staging_ticket(stream, time_bounds, columns)
    pool = get_flight_pool()
    try:
        client = pool.get(location)
        reader = client.do_get(
            fl.Ticket(json.dumps(ticket).encode()), _flight_call_options(p, STAGING_TIMEOUT)
        )
        batches: list[pa.RecordBatch] = []
        nbytes = 0
        for chunk in reader:
            b = chunk.data
            if b.num_rows:
                batches.append(b)
                nbytes += b.nbytes
    except Exception as e:  # noqa: BLE001 - any decline falls back to HTTP
        logger.warning("flight fan-in from %s declined: %s", domain, e)
        pool.invalidate(location)
        _count(stats, flight_fallbacks=1)
        return None
    _count(stats, bytes=nbytes, flight_bytes=nbytes, flight_peers=1)
    return batches


def _fetch_node(
    p: Parseable, node: dict, stream: str, time_bounds=None, columns=None, stats: dict | None = None
) -> list[pa.RecordBatch]:
    """The transport ladder for one peer's staging window: Flight where the
    registry advertises it, else (or on any Flight decline) HTTP. Both
    tiers serve the same `staging_window_table`."""
    location = flight_location(p, node)
    if location is not None:
        out = _fetch_one_flight(p, location, node["domain_name"], stream, time_bounds, columns, stats)
        if out is not None:
            return out
    return _fetch_one(p, node["domain_name"], stream, time_bounds, columns, stats)


def fetch_staging_batches(
    p: Parseable,
    stream: str,
    time_bounds=None,
    columns=None,
    nodes: list[dict] | None = None,
    stats: dict | None = None,
) -> list[pa.RecordBatch]:
    """Pull the staging window of `stream` from every live ingestor at once
    (reference: airplane.rs:155-184), bounded by the query's time range and
    projected columns. `nodes` restricts the pull to some peers (the
    pushdown's fallback); `stats` gathers `bytes`, `errors`, `http_bytes`,
    `flight_bytes`, `flight_peers` and `flight_fallbacks`. Results gather
    in completion order."""
    if nodes is None:
        nodes = live_ingestors(p)
    if not nodes:
        return []
    pool = get_cluster_pool()
    futures = [
        pool.submit(_fetch_node, p, n, stream, time_bounds, columns, stats) for n in nodes
    ]
    out: list[pa.RecordBatch] = []
    for f in as_completed(futures):
        out.extend(f.result())
    return out


def sync_with_ingestors(
    p: Parseable,
    method: str,
    path: str,
    json_body: dict | list | None = None,
    headers: dict | None = None,
    kinds: tuple[str, ...] = ("ingestor",),
) -> list[str]:
    """Fan a control-plane mutation (stream create or delete) out to every
    live ingestor (reference: cluster/mod.rs:391-840). Returns the domains
    that failed: the metastore holds the durable state, so a failure leaves
    an ingestor's cache stale, not state lost."""
    body = json.dumps(json_body).encode() if json_body is not None else None
    failed: list[str] = []

    def one(domain: str) -> None:
        try:
            with _http(p, method, f"{domain}{path}", body, headers) as resp:
                if resp.status >= 300:
                    failed.append(domain)
        except (urllib.error.URLError, OSError) as e:
            logger.warning("ingestor sync %s %s to %s failed: %s", method, path, domain, e)
            failed.append(domain)

    nodes = live_peers(p, kinds)
    list(get_cluster_pool().map(one, [n["domain_name"] for n in nodes]))
    return failed
