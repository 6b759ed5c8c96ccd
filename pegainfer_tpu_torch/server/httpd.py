"""A small HTTP/1.1 server on asyncio streams: the transport that the JAX
package's frontend takes from aiohttp, on the standard library.

- Requests with ``Content-Length`` bodies (up to ``MAX_BODY_BYTES``, as
  aiohttp's default client limit) and keep-alive; a chunked request body is
  refused (501), a malformed head answered 400 and the connection closed.
- ``json_response`` for JSON bodies; ``StreamResponse`` for streams such as
  ``text/event-stream``, sent with ``Transfer-Encoding: chunked``, one chunk
  a ``write``, as aiohttp's ``StreamResponse`` sends them.
- 404 for an unknown path, 405 (with ``Allow``) for a known path asked with
  another method, 500 for a handler that raised before it answered, with
  aiohttp's texts.
- A client that disconnects while its handler runs cancels the handler
  (the connection is watched for end of file meanwhile), so a streaming
  handler's ``finally`` closes its request's channel and the scheduler
  retires the request.

``serve(app, host, port, threads)`` runs the server on an event loop of its
own thread and returns once it listens: the ``Server``'s ``port`` is the
bound one (pass 0 for a free port), ``close()`` stops it. The loop's
default executor has ``threads`` threads: each streaming handler holds one
while it waits for its next token (``TokenChannel.__aiter__``), so fewer
than the engine's batch would queue streams behind one another.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import json
import logging
import threading
from http import HTTPStatus
from typing import Any, Awaitable, Callable, Dict, Optional, Union

log = logging.getLogger("pegainfer_torch.httpd")

MAX_HEAD_BYTES = 64 * 1024
MAX_BODY_BYTES = 1024 * 1024
_READ = 64 * 1024


class _BadRequest(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class _Eof(Exception):
    """The client closed the connection."""


class Request:
    """One parsed request: ``method``, ``path`` (without the query),
    ``version``, ``headers`` (lower-case names) and ``body``."""

    def __init__(self, method: str, path: str, version: str, headers: Dict[str, str],
                 body: bytes, conn: "_Conn"):
        self.method, self.path, self.version = method, path, version
        self.headers, self.body = headers, body
        self._conn = conn

    def json(self) -> Any:
        """The body as JSON; raises ``json.JSONDecodeError``."""
        return json.loads(self.body)

    @property
    def keep_alive(self) -> bool:
        conn = self.headers.get("connection", "").lower()
        if self.version == "HTTP/1.0":
            return conn == "keep-alive"
        return conn != "close"


class Response:
    """A whole response with a ``Content-Length`` body."""

    def __init__(self, body: bytes = b"", status: int = 200,
                 content_type: str = "text/plain; charset=utf-8",
                 headers: Optional[Dict[str, str]] = None):
        self.body, self.status = body, status
        self.headers = {"Content-Type": content_type, **(headers or {})}


def json_response(data: Any, status: int = 200) -> Response:
    return Response(json.dumps(data).encode(), status, "application/json; charset=utf-8")


def _text_response(status: int, headers: Optional[Dict[str, str]] = None) -> Response:
    return Response(f"{status}: {HTTPStatus(status).phrase}".encode(), status,
                    headers=headers)


class StreamResponse:
    """A response sent as it is written: ``prepare`` sends the head,
    ``write`` one chunk, ``write_eof`` the last (empty) chunk."""

    def __init__(self, status: int = 200, headers: Optional[Dict[str, str]] = None):
        self.status = status
        self.headers = dict(headers or {})
        self._conn: Optional[_Conn] = None
        self.eof_sent = False

    async def prepare(self, request: Request) -> None:
        self._conn = request._conn
        self._conn.head_sent = True
        self.headers["Transfer-Encoding"] = "chunked"
        await self._conn.send(_head(self.status, self.headers))

    async def write(self, data: bytes) -> None:
        if data:
            await self._conn.send(b"%x\r\n%s\r\n" % (len(data), data))

    async def write_eof(self) -> None:
        if not self.eof_sent:
            self.eof_sent = True
            await self._conn.send(b"0\r\n\r\n")


Handler = Callable[[Request], Awaitable[Union[Response, StreamResponse]]]


class App:
    """Routes: (path, method) -> handler."""

    def __init__(self) -> None:
        self.routes: Dict[str, Dict[str, Handler]] = {}

    def add_route(self, method: str, path: str, handler: Handler) -> None:
        self.routes.setdefault(path, {})[method] = handler

    def add_get(self, path: str, handler: Handler) -> None:
        self.add_route("GET", path, handler)

    def add_post(self, path: str, handler: Handler) -> None:
        self.add_route("POST", path, handler)


def _head(status: int, headers: Dict[str, str]) -> bytes:
    lines = [f"HTTP/1.1 {status} {HTTPStatus(status).phrase}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


class _Conn:
    """One client connection: a byte buffer over the stream reader (so the
    bytes read while watching for end of file are kept for the next
    request) and the writer."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader, self.writer = reader, writer
        self.buf = bytearray()
        self.head_sent = False  # of the response to the current request

    async def _fill(self) -> None:
        data = await self.reader.read(_READ)
        if not data:
            raise _Eof()
        self.buf += data

    async def send(self, data: bytes) -> None:
        self.writer.write(data)
        await self.writer.drain()

    async def watch_eof(self) -> None:
        """Returns when the client closes the connection."""
        try:
            while True:
                await self._fill()
        except _Eof:
            return

    async def read_request(self) -> Optional[Request]:
        """The next request, or None when the client closed the connection
        between requests."""
        while True:
            end = self.buf.find(b"\r\n\r\n")
            if end >= 0:
                break
            if len(self.buf) > MAX_HEAD_BYTES:
                raise _BadRequest(431, "request head too large")
            try:
                await self._fill()
            except _Eof:
                if self.buf:
                    raise _BadRequest(400, "incomplete request head") from None
                return None
        head = bytes(self.buf[:end]).decode("latin-1")
        del self.buf[:end + 4]
        line, *fields = head.split("\r\n")
        parts = line.split(" ")
        if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
            raise _BadRequest(400, f"malformed request line {line!r}")
        method, target, version = parts
        headers = {}
        for f in fields:
            name, sep, value = f.partition(":")
            if not sep or not name.strip():
                raise _BadRequest(400, f"malformed header line {f!r}")
            headers[name.strip().lower()] = value.strip()
        if "transfer-encoding" in headers:
            raise _BadRequest(501, "request bodies are taken with Content-Length only")
        try:
            n = int(headers.get("content-length", "0"))
        except ValueError:
            raise _BadRequest(400, "malformed Content-Length") from None
        if n < 0:
            raise _BadRequest(400, "malformed Content-Length")
        if n > MAX_BODY_BYTES:
            raise _BadRequest(413, f"request body of {n} bytes exceeds {MAX_BODY_BYTES}")
        while len(self.buf) < n:
            try:
                await self._fill()
            except _Eof:
                raise _BadRequest(400, "incomplete request body") from None
        body = bytes(self.buf[:n])
        del self.buf[:n]
        return Request(method, target.partition("?")[0], version, headers, body, self)


class Server:
    """A running server (made by ``serve``): ``host``, ``port``,
    ``close()``."""

    def __init__(self, app: App, host: str, port: int, threads: int):
        self.app = app
        self._loop = asyncio.new_event_loop()
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=threads, thread_name_prefix="pegainfer-httpd-wait")
        self._loop.set_default_executor(self._pool)
        self._conns: set = set()
        self._closed = False
        ready: concurrent.futures.Future = concurrent.futures.Future()
        self._thread = threading.Thread(target=self._run, args=(host, port, ready),
                                        name="pegainfer-httpd", daemon=True)
        self._thread.start()
        self._server = ready.result(timeout=60)
        self.host, self.port = self._server.sockets[0].getsockname()[:2]

    def _run(self, host: str, port: int, ready: concurrent.futures.Future) -> None:
        asyncio.set_event_loop(self._loop)
        try:
            server = self._loop.run_until_complete(
                asyncio.start_server(self._connection, host, port))
        except BaseException as e:  # noqa: BLE001 — handed to the caller of serve()
            ready.set_exception(e)
            self._loop.close()
            return
        ready.set_result(server)
        try:
            self._loop.run_forever()
        finally:
            self._loop.close()

    def close(self, timeout: float = 30.0) -> None:
        """Stop listening, end every connection (a running handler is
        cancelled, so its channel is closed), stop the loop's thread."""
        if self._closed:
            return
        self._closed = True
        asyncio.run_coroutine_threadsafe(self._shutdown(), self._loop).result(timeout)
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError("the HTTP server's thread did not stop")
        self._pool.shutdown(wait=False)

    async def _shutdown(self) -> None:
        self._server.close()
        for t in list(self._conns):
            t.cancel()
        await asyncio.gather(*self._conns, return_exceptions=True)
        await self._server.wait_closed()

    async def _connection(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        conn = _Conn(reader, writer)
        try:
            while True:
                try:
                    req = await conn.read_request()
                except _BadRequest as e:
                    log.info("bad request: %s", e)
                    await conn.send(_response_bytes(_text_response(e.status, {
                        "Connection": "close"})))
                    return
                if req is None:
                    return
                conn.head_sent = False
                if not await self._dispatch(req, conn) or not req.keep_alive:
                    return
        except ConnectionError:
            pass
        finally:
            self._conns.discard(task)
            writer.close()

    async def _dispatch(self, req: Request, conn: _Conn) -> bool:
        """Answer ``req``. Returns whether the connection can take another
        request."""
        methods = self.app.routes.get(req.path)
        if methods is None:
            await conn.send(_response_bytes(_text_response(404), req.keep_alive))
            return True
        handler = methods.get(req.method)
        if handler is None:
            await conn.send(_response_bytes(
                _text_response(405, {"Allow": ",".join(sorted(methods))}), req.keep_alive))
            return True
        work = asyncio.ensure_future(handler(req))
        watch = asyncio.ensure_future(conn.watch_eof())
        try:
            await asyncio.wait({work, watch}, return_when=asyncio.FIRST_COMPLETED)
        finally:
            for t in (work, watch):
                t.cancel()
            await asyncio.gather(work, watch, return_exceptions=True)
        if work.cancelled():
            return False  # the client left (or the server is closing)
        exc = work.exception()
        if isinstance(exc, ConnectionError):
            return False
        if exc is not None:
            log.error("handler for %s %s failed", req.method, req.path, exc_info=exc)
            if conn.head_sent:  # a stream already begun cannot become a 500
                return False
            resp = Response(b"500 Internal Server Error\n\nServer got itself in trouble", 500)
        else:
            resp = work.result()
        if isinstance(resp, StreamResponse):
            await resp.write_eof()
            return True
        await conn.send(_response_bytes(resp, req.keep_alive))
        return True


def _response_bytes(resp: Response, keep_alive: bool = False) -> bytes:
    headers = {**resp.headers, "Content-Length": str(len(resp.body))}
    if not keep_alive:
        headers["Connection"] = "close"
    return _head(resp.status, headers) + resp.body


def serve(app: App, host: str = "127.0.0.1", port: int = 0, threads: int = 64) -> Server:
    """Start serving ``app`` on ``host``:``port`` (0: a free port) from a
    thread of its own; returns once it listens."""
    return Server(app, host, port, threads)
