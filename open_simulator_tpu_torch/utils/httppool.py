"""Bounded keep-alive HTTP connection pools for extender I/O.

The serial extender path paid a fresh TCP dial per request
(`urllib.request.urlopen` builds and tears down a connection every call);
under the wave engine (engine/extender_wave.py) dozens of requests per wave
would each pay that dial. One pool per (scheme, host, port) endpoint holds at
most `OSIM_EXTENDER_POOL` persistent `http.client` connections; checkout
blocks when all are in flight, so per-endpoint concurrency is bounded by the
knob, not by the caller's thread count. A kept-alive socket the server closed
between requests is redialed transparently (one retry on the same logical
request — the stale-socket race is indistinguishable from it on the client
side, and the extender verbs riding the pool are idempotent).

Thread-safety: pool internals are guarded by a per-pool Condition; the
endpoint registry mirrors the resilience breaker registry
(`_pools` under `_pools_lock`).
"""

from __future__ import annotations

import http.client
import os
import socket
import threading
import urllib.parse
from typing import Dict, List, Optional, Tuple

DEFAULT_POOL_SIZE = 8


def configured_pool_size() -> int:
    """OSIM_EXTENDER_POOL: max persistent connections per extender endpoint
    (and the wave engine's HTTP worker count). Floor 1."""
    try:
        n = int(os.environ.get("OSIM_EXTENDER_POOL", "") or DEFAULT_POOL_SIZE)
    except ValueError:
        n = DEFAULT_POOL_SIZE
    return max(1, n)


def keepalive_enabled() -> bool:
    """OSIM_EXTENDER_KEEPALIVE: 0 routes extender HTTP through the legacy
    fresh-connection-per-request transport (`urllib.request.urlopen`) instead
    of these pools — the transport escape hatch for proxies or servers that
    misbehave on persistent connections, and the bench's `legacy_serial`
    baseline."""
    return os.environ.get("OSIM_EXTENDER_KEEPALIVE", "1") != "0"


class HTTPConnectionPool:
    """At most `size` persistent connections to one endpoint."""

    def __init__(
        self,
        scheme: str,
        host: str,
        port: Optional[int],
        size: int,
    ) -> None:
        self.scheme = scheme
        self.host = host
        self.port = port
        self.size = max(1, size)
        self._cond = threading.Condition(threading.Lock())
        self._idle: List[http.client.HTTPConnection] = []
        self._live = 0        # checked out + idle
        self.created = 0      # connections dialed over the pool's lifetime
        self.requests = 0     # round trips served

    def _new_conn(self) -> http.client.HTTPConnection:
        cls = (
            http.client.HTTPSConnection
            if self.scheme == "https"
            else http.client.HTTPConnection
        )
        self.created += 1
        return cls(self.host, self.port)

    def _checkout(self) -> http.client.HTTPConnection:
        with self._cond:
            while not self._idle and self._live >= self.size:
                self._cond.wait()
            if self._idle:
                return self._idle.pop()  # LIFO keeps sockets warm
            self._live += 1
            return self._new_conn()

    def _checkin(self, conn: http.client.HTTPConnection) -> None:
        with self._cond:
            self._idle.append(conn)
            self._cond.notify()

    def _drop(self, conn: http.client.HTTPConnection) -> None:
        try:
            conn.close()
        except Exception:
            pass
        with self._cond:
            self._live -= 1
            self._cond.notify()

    def _roundtrip(
        self,
        conn: http.client.HTTPConnection,
        method: str,
        path: str,
        body: Optional[bytes],
        headers: Dict[str, str],
        timeout: Optional[float],
    ) -> Tuple[int, str, bytes]:
        conn.timeout = timeout
        if conn.sock is None:
            conn.connect()
        if conn.sock is not None:
            conn.sock.settimeout(timeout)
            try:
                # http.client writes headers and body as separate segments;
                # without TCP_NODELAY, Nagle holds the second until the
                # peer's delayed ACK (~40ms per round trip on keep-alive
                # connections)
                conn.sock.setsockopt(
                    socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
                )
            except OSError:
                pass
        conn.request(method, path, body=body, headers=headers)
        resp = conn.getresponse()
        data = resp.read()
        if resp.will_close:
            # HTTP/1.0 peer or Connection: close — next use redials
            conn.close()
        return resp.status, resp.reason, data

    def request(
        self,
        method: str,
        path: str,
        body: Optional[bytes],
        headers: Dict[str, str],
        timeout: Optional[float] = None,
    ) -> Tuple[int, str, bytes]:
        """One round trip: (status, reason, response body). Transport
        failures raise OSError/http.client.HTTPException; the connection is
        dropped from the pool so the next request dials fresh.

        When the calling thread is inside a trace (utils/tracing.py), the
        request automatically carries the W3C `traceparent` header so the
        far side can continue the same trace. An explicit header from the
        caller wins; an explicitly EMPTY one suppresses the header entirely
        (for callers that know the surrounding span is not a trace worth
        propagating)."""
        if "traceparent" not in headers:
            from . import tracing

            tp = tracing.current_traceparent()
            if tp is not None:
                headers = dict(headers)
                headers["traceparent"] = tp
        elif not headers["traceparent"]:
            headers = dict(headers)
            del headers["traceparent"]
        conn = self._checkout()
        try:
            try:
                out = self._roundtrip(
                    conn, method, path, body, headers, timeout
                )
            except (
                http.client.RemoteDisconnected,
                http.client.CannotSendRequest,
                BrokenPipeError,
                ConnectionResetError,
            ):
                # stale keep-alive socket: redial once (http.client
                # auto-reconnects after close())
                conn.close()
                with self._cond:
                    self.created += 1
                out = self._roundtrip(
                    conn, method, path, body, headers, timeout
                )
        except BaseException:
            self._drop(conn)
            raise
        with self._cond:
            self.requests += 1
        self._checkin(conn)
        return out

    def stats(self) -> Dict[str, int]:
        with self._cond:
            return {
                "size": self.size,
                "live": self._live,
                "idle": len(self._idle),
                "created": self.created,
                "requests": self.requests,
            }

    def close(self) -> None:
        with self._cond:
            idle, self._idle = self._idle, []
            self._live -= len(idle)
        for conn in idle:
            try:
                conn.close()
            except Exception:
                pass


# ---------------------------------------------------------------------------
# Endpoint-keyed registry, mirroring resilience.policy._breakers: extender
# objects are rebuilt per simulate() call, so warm connections must live
# OUTSIDE them to survive across pods, waves, and capacity-search probes.
# ---------------------------------------------------------------------------

_pools: Dict[Tuple[str, str, Optional[int]], HTTPConnectionPool] = {}
_pools_lock = threading.Lock()


def pool_for(url: str) -> Tuple[HTTPConnectionPool, str]:
    """Get-or-create the endpoint pool for `url`; returns (pool, request
    path). Pool size comes from OSIM_EXTENDER_POOL at creation."""
    parts = urllib.parse.urlsplit(url)
    key = (parts.scheme, parts.hostname or "", parts.port)
    with _pools_lock:
        pool = _pools.get(key)
        if pool is None:
            pool = _pools[key] = HTTPConnectionPool(
                parts.scheme, parts.hostname or "", parts.port,
                size=configured_pool_size(),
            )
    path = parts.path or "/"
    if parts.query:
        path = f"{path}?{parts.query}"
    return pool, path


def reset_pools() -> None:
    """Close every pooled connection and drop the registry (test isolation;
    respects a changed OSIM_EXTENDER_POOL on next use)."""
    with _pools_lock:
        pools = list(_pools.values())
        _pools.clear()
    for p in pools:
        p.close()


def pool_stats() -> Dict[str, Dict[str, int]]:
    """endpoint -> counters for every registered pool (debugging, tests)."""
    with _pools_lock:
        items = sorted(
            (f"{scheme}://{host}:{port}", pool)
            for (scheme, host, port), pool in _pools.items()
        )
    return {ep: pool.stats() for ep, pool in items}
