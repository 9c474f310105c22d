"""Event-loop HTTP serving for the platform's WSGI tiers (the port's
copy of the JAX package's ``machinery/eventloop.py``).

The web apps (``web/microweb.py``) and the REST façade
(``machinery/httpapi.py``) served thread-per-request
(``ThreadingMixIn``): every connection spawned a thread, and every
long-lived watch stream PINNED one for its whole life — so a replica's
concurrency was bounded by thread count, and 500 open watches meant
500 parked threads. :class:`EventLoopServer` replaces that with one
asyncio loop thread that multiplexes all connections and watch
streams, dispatching the short CPU-bound WSGI handler bodies to a
small worker pool:

- **requests**: parsed on the loop by a callback
  :class:`asyncio.Protocol` — NOT asyncio streams: the stream reader's
  coroutine-per-read machinery measured 3x slower than transport
  callbacks on the cached hot path, and the whole point of this tier
  is requests-per-replica. Handler bodies run **inline on the loop**
  while a route's observed runtime stays under
  ``WEB_INLINE_THRESHOLD_MS`` (default 5) and are dispatched to the
  worker pool (``WEB_WORKERS``, default 8) once its EWMA crosses it —
  the cached hot paths finish in tens of microseconds, where a pool
  round-trip (two thread wake-ups) costs an order of magnitude more
  than the handler, while a genuinely slow route must not stall every
  other connection on the loop. Response bytes are written back on
  the loop either way;
- **watches**: a handler that returns a :class:`WatchBody` hands the
  stream to the loop. The pump parks on an ``asyncio.Event`` wired to
  ``Watch.set_notify`` — zero threads, zero polling — and wakes only
  when an event (or the heartbeat interval, or client EOF) arrives.
  Frames come from the body's ``frame`` callable so the serve layer
  can fan identical serialized bytes to every subscriber;
- **shedding**: the APF-lite ``InflightLimiter`` keeps working
  unchanged inside the WSGI app — with the pool bounding actual
  parallelism it now enforces a true concurrency bound rather than a
  thread count.

The WSGI contract is untouched: apps still run under wsgiref (tests,
benches call them directly), and ``WEB_EVENT_LOOP=false`` reverts
``microweb.App.serve``/``httpapi.serve`` to the thread-per-request
servers. Responses are HTTP/1.1 with **persistent connections** — a
parked idle connection costs the loop one registered fd instead of
the thread wsgiref would pin, so clients amortise TCP setup across
requests (the structural half of the requests-per-replica win; the
thread server can't offer this without a thread per connection). A
client that sends ``Connection: close`` gets the old one-shot
lifecycle; watch streams always close on end.
"""

from __future__ import annotations

import asyncio
import io
import os
import socket as _socket
import sys
import threading
import time
import urllib.parse
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterator, Optional

from odh_kubeflow_tpu_torch.machinery import overload

DEFAULT_WORKERS = int(os.environ.get("WEB_WORKERS", "8"))
# routes whose EWMA handler runtime exceeds this run in the worker
# pool; under it they run inline on the loop (dispatch overhead would
# dominate them)
INLINE_THRESHOLD_SECONDS = (
    float(os.environ.get("WEB_INLINE_THRESHOLD_MS", "5")) / 1000.0
)
_MAX_HEADER_BYTES = 65536
# request bodies buffer on the loop before dispatch (the WSGI contract
# hands handlers a complete wsgi.input), so they must be bounded BEFORE
# routing/auth runs — platform bodies are CR-sized, nowhere near this
MAX_BODY_BYTES = int(os.environ.get("WEB_MAX_BODY_BYTES", str(16 << 20)))
_SSL_HANDSHAKE_TIMEOUT = 10.0
# EWMA route buckets are bounded; past this the table resets and routes
# re-learn (unseen routes dispatch to the pool — the safe direction)
_MAX_ROUTE_BUCKETS = 4096

_HOP_HEADERS = frozenset({"content-type", "content-length"})


def event_loop_enabled() -> bool:
    """The serve-layer default: event-loop serving unless
    ``WEB_EVENT_LOOP=false`` opts a process out."""
    return os.environ.get("WEB_EVENT_LOOP", "true").lower() != "false"


class WatchBody:
    """A streaming watch response body.

    Dual-contract: iterating it is the blocking WSGI form (wsgiref and
    direct ``app(environ, start_response)`` consumers get the exact
    pre-event-loop behaviour, one thread parked per stream), while the
    event-loop server recognises the type and pumps ``watch`` on the
    loop instead — no thread, no blocking get.

    ``frame(item) -> bytes`` turns one ``(etype, obj)`` event into its
    wire line; the serve layer passes the serialized-bytes-cache frame
    so every subscriber of the same event writes the same bytes object.

    ``heartbeat_fn`` (optional) builds each heartbeat line dynamically —
    the replication stream uses it to ship a CONTROL frame carrying the
    leader's current rv/epoch/wall-clock, which is what makes follower
    lag and staleness observable even on an idle stream.
    """

    def __init__(
        self,
        watch: Any,
        frame: Callable[[tuple[str, Any]], bytes],
        heartbeat: float,
        heartbeat_line: bytes = b'{"type":"HEARTBEAT"}\n',
        heartbeat_fn: Optional[Callable[[], bytes]] = None,
    ):
        self.watch = watch
        self.frame = frame
        self.heartbeat = heartbeat
        self._static_heartbeat = heartbeat_line
        self.heartbeat_fn = heartbeat_fn

    @property
    def heartbeat_line(self) -> bytes:
        fn = self.heartbeat_fn
        return fn() if fn is not None else self._static_heartbeat

    def __iter__(self) -> Iterator[bytes]:
        w = self.watch
        try:
            # immediate greeting: the client's watch opener blocks
            # until status+headers+first bytes arrive; greeting NOW is
            # what makes watch-then-list ordering real over HTTP
            yield self.heartbeat_line
            while True:
                item = w.get(timeout=self.heartbeat)
                if item is None:
                    # a server-side-ended stream (slow-consumer
                    # eviction, replica teardown) must CLOSE, not
                    # heartbeat forever on a dead queue; the client
                    # reconnects/relists per its 410 contract
                    if w.ended or w._stopped:
                        return
                    # queue timeout → heartbeat; a dead client raises
                    # on the write and the finally stops the watch
                    yield self.heartbeat_line
                    continue
                # join the pending burst into one chunk (one socket
                # write downstream) — same batching the async pump does
                frames = [self.frame(item)]
                while len(frames) < 256:
                    nxt = w.try_get()
                    if nxt is None:
                        break
                    frames.append(self.frame(nxt))
                yield b"".join(frames) if len(frames) > 1 else frames[0]
        finally:
            w.stop()

    def close(self) -> None:
        """WSGI result-close hook: wsgiref (the thread-fallback server)
        calls this on client disconnect, so the Watch deregisters
        deterministically — the old generator body's ``finally`` did
        this; without it teardown would wait on GC."""
        self.watch.stop()


class _Connection(asyncio.Protocol):
    """One client connection on the loop.

    Transport callbacks, no stream readers: ``data_received`` parses
    complete requests out of a byte buffer and dispatches them, so the
    hot path (request in one TCP segment, cached-bytes response) is a
    single callback with zero coroutine switches. Only the slow cases
    grow machinery — pooled handlers park the connection until their
    future resolves (pipelined bytes stay buffered, order preserved),
    and a watch upgrade hands the connection to an async pump task.
    """

    __slots__ = (
        "srv",
        "transport",
        "buf",
        "head",
        "need_body",
        "busy",
        "closing",
        "half_closed",
        "reading_paused",
        "watch_task",
        "writable",
    )

    def __init__(self, srv: "EventLoopServer"):
        self.srv = srv
        self.transport: Optional[asyncio.Transport] = None
        self.buf = bytearray()
        self.head: Optional[tuple] = None  # parsed head awaiting body
        self.need_body = 0
        self.busy = False  # a pooled handler is in flight
        self.closing = False
        self.half_closed = False  # client sent FIN; finish, then close
        self.reading_paused = False
        self.watch_task: Optional[asyncio.Task] = None
        # set ⇔ the transport's write buffer is under its high-water
        # mark; watch pumps and pipelined bursts park on it so a slow
        # client backpressures its own connection, never the loop
        self.writable = asyncio.Event()
        self.writable.set()

    # -- transport callbacks -------------------------------------------------

    def connection_made(self, transport) -> None:
        self.transport = transport
        sock = transport.get_extra_info("socket")
        try:
            if sock is not None:
                sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
        except OSError:
            pass  # already closed, or an exotic transport

    def pause_writing(self) -> None:
        self.writable.clear()
        self._update_reading()

    def resume_writing(self) -> None:
        self.writable.set()
        self._update_reading()
        if not self.busy and self.watch_task is None and not self.closing:
            self._process()

    def _update_reading(self) -> None:
        """Stop reading while we can't make progress — a pooled handler
        is in flight or the client isn't draining its responses — so a
        sender can't grow ``buf`` without bound (kernel backpressure
        takes over); resume when the stall clears."""
        want_pause = self.busy or not self.writable.is_set()
        if want_pause == self.reading_paused or self.transport is None:
            return
        try:
            if want_pause:
                self.transport.pause_reading()
            else:
                self.transport.resume_reading()
            self.reading_paused = want_pause
        except RuntimeError:
            pass  # transport already closed

    def data_received(self, data: bytes) -> None:
        if self.watch_task is not None:
            # watch requests carry no further input; a client that
            # pipelines after an upgrade is simply ignored (the
            # stream closes when the watch ends)
            return
        self.buf += data
        if len(self.buf) > _MAX_HEADER_BYTES + MAX_BODY_BYTES:
            # backstop for bytes already in flight around a pause
            self.transport.close()
            return
        if not self.busy:
            self._process()

    def eof_received(self) -> bool:
        # client half-closed: tear a live watch down NOW instead of
        # discovering the dead socket at the next heartbeat write
        if self.watch_task is not None:
            self.watch_task.cancel()
            return False
        # legal half-close: FIN after the request, reading for the
        # reply (the old thread server handled this). Drain whatever
        # complete requests are buffered, then keep the transport open
        # only while a pooled handler still owes a response — it must
        # not execute its side effects and then drop the 201.
        self.half_closed = True
        if not self.busy:
            self._process()
        if self.busy:
            return True  # _pooled_done closes after answering
        return False  # all answered; close flushes the written bytes

    def connection_lost(self, exc) -> None:
        self.closing = True
        self.writable.set()  # unblock a parked pump so it can exit
        if self.watch_task is not None:
            self.watch_task.cancel()

    # -- request framing -----------------------------------------------------

    def _process(self) -> None:
        """Drain complete requests from the buffer, one at a time.
        Halts while a pooled handler is in flight (responses must go
        out in request order) or the write buffer is over its
        high-water mark (a client not reading its responses must not
        buffer unbounded bytes in the transport)."""
        while (
            not self.busy
            and self.watch_task is None
            and not self.closing
            and self.writable.is_set()
        ):
            if self.need_body:
                if len(self.buf) < self.need_body:
                    return
                body = bytes(self.buf[: self.need_body])
                del self.buf[: self.need_body]
                head, self.head, self.need_body = self.head, None, 0
                environ = self._environ(head, body)
            else:
                idx = self.buf.find(b"\r\n\r\n")
                if idx < 0:
                    if len(self.buf) > _MAX_HEADER_BYTES:
                        self.transport.close()
                    return
                head_bytes = bytes(self.buf[:idx])
                del self.buf[: idx + 4]
                head = self._parse_head(head_bytes)
                if head is None:
                    self.transport.close()
                    return
                if "transfer-encoding" in head[4]:
                    # chunked framing is not implemented; parsing the
                    # chunk stream as pipelined requests would let a
                    # client smuggle attacker-framed requests onto an
                    # authenticated keep-alive connection — refuse and
                    # close instead
                    self.transport.write(
                        b"HTTP/1.1 501 Not Implemented\r\n"
                        b"Content-Length: 0\r\nConnection: close\r\n\r\n"
                    )
                    self.transport.close()
                    return
                length = head[3]
                if length < 0:
                    self.transport.write(
                        b"HTTP/1.1 400 Bad Request\r\n"
                        b"Content-Length: 0\r\nConnection: close\r\n\r\n"
                    )
                    self.transport.close()
                    return
                if length > MAX_BODY_BYTES:
                    # bounded BEFORE buffering: bodies accumulate on
                    # the loop ahead of routing/auth, so an oversized
                    # Content-Length must not get to fill memory
                    self.transport.write(
                        b"HTTP/1.1 413 Payload Too Large\r\n"
                        b"Content-Length: 0\r\nConnection: close\r\n\r\n"
                    )
                    self.transport.close()
                    return
                if length > 0:
                    self.head = head
                    self.need_body = length
                    continue  # loop back into the body branch
                environ = self._environ(head, b"")
            self._dispatch(environ)

    @staticmethod
    def _parse_head(head: bytes) -> Optional[tuple]:
        """``(method, path, query, content_length, headers)`` from the
        raw request head, or None on a malformed request line. A
        duplicate, non-numeric, or negative Content-Length yields
        ``content_length = -1`` (the caller 400s and closes): silently
        coercing it to 0 would reparse the unread body bytes as the
        next pipelined request — the same framing-desync class the
        Transfer-Encoding guard blocks."""
        lines = head.decode("latin-1").split("\r\n")
        try:
            method, target, *_ = lines[0].split()
        except ValueError:
            return None
        headers: dict[str, str] = {}
        cl_seen = 0
        for line in lines[1:]:
            key, sep, value = line.partition(":")
            if sep:
                key = key.strip().lower()
                if key == "content-length":
                    cl_seen += 1
                headers[key] = value.strip()
        raw_cl = headers.get("content-length")
        if raw_cl is None and cl_seen == 0:
            length = 0
        elif cl_seen == 1 and raw_cl.isdigit():
            length = int(raw_cl)
        else:
            length = -1  # duplicate / non-numeric / negative
        path, _, query = target.partition("?")
        return (method, path, query, length, headers)

    def _environ(self, head: tuple, body: bytes) -> dict:
        method, path, query, _, headers = head
        if "%" in path:
            path = urllib.parse.unquote(path, "iso-8859-1")
        srv = self.srv
        peer = self.transport.get_extra_info("peername") or ("", 0)
        environ: dict[str, Any] = {
            "REQUEST_METHOD": method.upper(),
            "PATH_INFO": path,
            "QUERY_STRING": query,
            "SERVER_PROTOCOL": "HTTP/1.1",
            "SERVER_NAME": srv.server_address[0],
            "SERVER_PORT": str(srv.server_address[1]),
            "REMOTE_ADDR": peer[0] if isinstance(peer, tuple) else "",
            "wsgi.version": (1, 0),
            "wsgi.url_scheme": "https" if srv._ssl is not None else "http",
            "wsgi.input": io.BytesIO(body),
            "wsgi.errors": sys.stderr,
            "wsgi.multithread": True,
            "wsgi.multiprocess": False,
            "wsgi.run_once": False,
            # arrival stamp: anchors the X-Request-Deadline delta so
            # time spent queued for the worker pool counts against the
            # end-to-end budget (machinery.overload.environ_deadline)
            "odh.request.arrival": time.monotonic(),
        }
        if "content-type" in headers:
            environ["CONTENT_TYPE"] = headers["content-type"]
        if "content-length" in headers:
            environ["CONTENT_LENGTH"] = headers["content-length"]
        for key, value in headers.items():
            if key in _HOP_HEADERS:
                continue
            environ["HTTP_" + key.upper().replace("-", "_")] = value
        return environ

    # -- dispatch ------------------------------------------------------------

    def _dispatch(self, environ: dict) -> None:
        # adaptive dispatch: inline once the route is PROVEN fast (the
        # cached hot paths are ~10-100µs — two thread wake-ups of pool
        # round-trip would dominate), pool for unseen routes and any
        # whose EWMA shows it would stall the loop (e.g. a blocking
        # admission hook: inlining an unknown route could park every
        # connection behind one slow handler)
        srv = self.srv
        # route-shape bucket: enough segments to separate resources
        # ('/api/v1/namespaces/<ns>/<plural>' keeps its plural — one
        # resource's slow handler must not ride another's fast EWMA
        # onto the loop) plus the segment count so collection and
        # object paths sharing a prefix stay distinct
        segs = environ["PATH_INFO"].split("/")
        key = (environ["REQUEST_METHOD"], len(segs), "/".join(segs[:6]))
        ewma = srv._route_ewma.get(key)
        if ewma is not None and ewma < INLINE_THRESHOLD_SECONDS:
            self._finish(environ, key, ewma, srv._run_app(environ))
            return
        self.busy = True
        self._update_reading()
        fut = srv._loop.run_in_executor(srv._pool, srv._run_app, environ)
        fut.add_done_callback(
            lambda f: self._pooled_done(environ, key, ewma, f)
        )

    def _pooled_done(self, environ, key, ewma, fut) -> None:
        self.busy = False
        self._update_reading()
        try:
            result = fut.result()
        except Exception:  # noqa: BLE001 — pool rejected (shutdown race)
            if not self.closing:
                self.transport.close()
            return
        if self.closing:
            return
        self._finish(environ, key, ewma, result)
        if self.watch_task is None and not self.transport.is_closing():
            self._process()  # pipelined bytes buffered while pooled
            if self.half_closed and not self.busy:
                # client FINed while we worked; every received request
                # is now answered (or in flight and will re-check)
                self.transport.close()

    def _finish(self, environ, key, ewma, result) -> None:
        status, headers, payload, took = result
        # EWMA of the HANDLER body alone (timed inside _run_app),
        # never the dispatch round-trip: pool scheduling delay under
        # load would otherwise keep a fast route's EWMA above the
        # threshold forever once one slow sample pushed it there
        # (pooled → slow took → stays pooled), a measured 20%
        # throughput loss
        table = self.srv._route_ewma
        if len(table) >= _MAX_ROUTE_BUCKETS and key not in table:
            table.clear()  # degenerate key cardinality: re-learn
        table[key] = took if ewma is None else 0.8 * ewma + 0.2 * took
        if isinstance(payload, WatchBody):
            self._start_watch(status, headers, payload)
            return
        close = environ.get("HTTP_CONNECTION", "").lower() == "close"
        head = [f"HTTP/1.1 {status}\r\n"]
        saw_length = False
        for k, v in headers:
            if not saw_length and k.lower() == "content-length":
                saw_length = True
            head.append(f"{k}: {v}\r\n")
        if not saw_length:
            head.append(f"Content-Length: {len(payload)}\r\n")
        head.append(
            "Connection: close\r\n\r\n"
            if close
            else "Connection: keep-alive\r\n\r\n"
        )
        self.transport.write("".join(head).encode("latin-1") + payload)
        if close:
            self.transport.close()  # flushes buffered bytes first

    # -- watch streaming -----------------------------------------------------

    def _start_watch(self, status, headers, wb: WatchBody) -> None:
        head = [f"HTTP/1.1 {status}\r\n"]
        for k, v in headers:
            head.append(f"{k}: {v}\r\n")
        head.append("Connection: close\r\n\r\n")
        self.transport.write("".join(head).encode("latin-1"))
        self.buf.clear()
        self.watch_task = self.srv._loop.create_task(self._pump_watch(wb))

    async def _pump_watch(self, wb: WatchBody) -> None:
        w = wb.watch
        loop = self.srv._loop
        transport = self.transport
        wake = asyncio.Event()

        def _notify():
            try:
                loop.call_soon_threadsafe(wake.set)
            except RuntimeError:
                pass  # loop shutting down; the pump is being cancelled

        set_notify = getattr(w, "set_notify", None)
        if set_notify is not None:
            set_notify(_notify)
        try:
            transport.write(wb.heartbeat_line)  # greeting (see WatchBody)
            while not self.closing:
                # slow client: park until the transport drains, so
                # events queue in the Watch instead of ballooning the
                # write buffer
                await self.writable.wait()
                if self.closing:
                    return
                item = w.try_get()
                if item is not None:
                    # drain the whole pending burst into ONE transport
                    # write: events arrive in group-commit batches, and
                    # per-event write+wait iterations (a syscall and a
                    # coroutine resume each) were the serving loop's
                    # dominant per-record cost on the replication path
                    frames = [wb.frame(item)]
                    while len(frames) < 256:
                        nxt = w.try_get()
                        if nxt is None:
                            break
                        frames.append(wb.frame(nxt))
                    transport.write(
                        b"".join(frames) if len(frames) > 1 else frames[0]
                    )
                    continue
                if w._stopped or w.ended:
                    return
                if set_notify is None:
                    # exotic duck Watch without the notify hook: poll
                    await asyncio.sleep(0.05)
                    continue
                try:
                    await asyncio.wait_for(wake.wait(), timeout=wb.heartbeat)
                    wake.clear()
                except asyncio.TimeoutError:
                    transport.write(wb.heartbeat_line)
        finally:
            if set_notify is not None:
                set_notify(None)
            w.stop()
            if not self.closing:
                try:
                    transport.close()
                except RuntimeError:
                    pass


class EventLoopServer:
    """One asyncio loop thread serving a WSGI app; duck-compatible
    with the ``ThreadingMixIn`` servers it replaces
    (``server_address``, ``shutdown()``)."""

    def __init__(
        self,
        app: Callable,
        host: str = "127.0.0.1",
        port: int = 0,
        ssl_context: Optional[Any] = None,
        workers: Optional[int] = None,
    ):
        self._app = app
        self._ssl = ssl_context
        # route → EWMA handler runtime, updated on every request from
        # BOTH dispatch modes so a route whose cache warms up (slow
        # first hit, fast after) migrates back to inline
        self._route_ewma: dict[tuple, float] = {}
        self._loop = asyncio.new_event_loop()
        self._pool = ThreadPoolExecutor(
            max_workers=workers or DEFAULT_WORKERS,
            thread_name_prefix="web-worker",
        )
        self._server: Optional[asyncio.AbstractServer] = None
        self._boot_error: Optional[BaseException] = None
        self._started = threading.Event()
        self._shut = threading.Event()
        self.server_address: tuple[str, int] = (host, 0)
        self._thread = threading.Thread(
            target=self._run, args=(host, port), daemon=True,
            name=f"event-loop-server:{host}",
        )
        self._thread.start()
        self._started.wait(timeout=30.0)
        if self._boot_error is not None:
            raise self._boot_error

    # -- lifecycle -----------------------------------------------------------

    def _run(self, host: str, port: int) -> None:
        loop = self._loop
        asyncio.set_event_loop(loop)
        try:
            kwargs: dict[str, Any] = {}
            if self._ssl is not None:
                # handshake runs per-connection ON THE LOOP with a
                # timeout: a client that connects and sends no
                # ClientHello can't park the acceptor (the hazard the
                # old threading server dodged in finish_request)
                kwargs = dict(
                    ssl=self._ssl,
                    ssl_handshake_timeout=_SSL_HANDSHAKE_TIMEOUT,
                )
            self._server = loop.run_until_complete(
                loop.create_server(
                    lambda: _Connection(self), host, port, **kwargs
                )
            )
            sock = self._server.sockets[0]
            self.server_address = sock.getsockname()[:2]
        except BaseException as e:  # noqa: BLE001 — surfaced to the opener
            self._boot_error = e
            self._started.set()
            loop.close()
            return
        self._started.set()
        try:
            loop.run_forever()
        finally:
            # cancel in-flight watch pumps and let their finally
            # blocks run (each must stop its Watch)
            tasks = asyncio.all_tasks(loop)
            for t in tasks:
                t.cancel()
            if tasks:
                loop.run_until_complete(
                    asyncio.gather(*tasks, return_exceptions=True)
                )
            loop.run_until_complete(loop.shutdown_asyncgens())
            loop.close()

    def shutdown(self) -> None:
        """Stop serving (idempotent, callable from any thread)."""
        if self._shut.is_set():
            return
        self._shut.set()
        if self._boot_error is not None:
            return

        def _stop():
            if self._server is not None:
                self._server.close()
            self._loop.stop()

        try:
            self._loop.call_soon_threadsafe(_stop)
        except RuntimeError:
            pass  # loop already closed
        self._thread.join(timeout=10.0)
        self._pool.shutdown(wait=False)

    @property
    def server_port(self) -> int:  # stdlib-server duck compat
        return self.server_address[1]

    def server_close(self) -> None:  # stdlib-server duck compat
        self.shutdown()

    # -- handler execution ---------------------------------------------------

    def _dispatch_traced(self, environ: dict, start_response):
        """Run the WSGI app, with a dispatch span when the request is
        traced (inbound ``traceparent``): the span shows which server
        front end handled the hop and what the handler body cost,
        distinct from the app's own request span. Untraced requests
        pay one header check and nothing else."""
        from odh_kubeflow_tpu_torch.utils import tracing

        remote = tracing.parse_traceparent(environ.get("HTTP_TRACEPARENT"))
        if remote is None:
            return self._app(environ, start_response)
        with tracing.span(
            "web.dispatch",
            parent=remote,
            server="eventloop",
            method=environ.get("REQUEST_METHOD", ""),
        ):
            return self._app(environ, start_response)

    def _run_app(self, environ: dict) -> tuple[str, list, Any, float]:
        """Execute the WSGI app (inline on the loop or in the worker
        pool). Returns ``(status, headers, payload, elapsed)`` with
        payload either joined bytes or the app's :class:`WatchBody`
        (streamed by the loop); ``elapsed`` is the handler-body wall
        time feeding the dispatch EWMA."""
        state: dict[str, Any] = {}

        def start_response(status, headers, exc_info=None):
            state["status"] = status
            state["headers"] = list(headers)

        # end-to-end deadline shed at dequeue (machinery.overload): a
        # request can sit queued behind slow handlers long enough for
        # its client to give up — running the app then is dead work
        # that amplifies the overload. Malformed header values fall
        # through: the app's own parse answers the 400.
        try:
            deadline = overload.environ_deadline(environ)
        except ValueError:
            deadline = None
        if deadline is not None and deadline <= time.monotonic():
            payload = (
                b'{"kind": "Status", "apiVersion": "v1", "status": '
                b'"Failure", "message": "request deadline expired '
                b'before dispatch", "reason": "DeadlineExceeded", '
                b'"code": 504}'
            )
            return (
                "504 Gateway Timeout",
                [
                    ("Content-Type", "application/json"),
                    ("Content-Length", str(len(payload))),
                ],
                payload,
                0.0,
            )

        t0 = time.perf_counter()
        try:
            result = self._dispatch_traced(environ, start_response)
            if isinstance(result, WatchBody):
                return (
                    state["status"], state["headers"], result,
                    time.perf_counter() - t0,
                )
            try:
                payload = b"".join(result)
            finally:
                close = getattr(result, "close", None)
                if close is not None:
                    close()
            return (
                state["status"], state["headers"], payload,
                time.perf_counter() - t0,
            )
        except Exception as e:  # noqa: BLE001 — a crash must not kill serving
            body = f"internal error: {type(e).__name__}: {e}".encode()
            return (
                "500 Internal Server Error",
                [("Content-Type", "text/plain")],
                body,
                time.perf_counter() - t0,
            )


def serve_wsgi(
    app: Callable,
    host: str = "127.0.0.1",
    port: int = 0,
    ssl_context: Optional[Any] = None,
    workers: Optional[int] = None,
) -> EventLoopServer:
    """Serve a WSGI app on the event loop; returns the running server
    (``server_address`` bound, ``shutdown()`` stops it)."""
    return EventLoopServer(
        app, host=host, port=port, ssl_context=ssl_context, workers=workers
    )
