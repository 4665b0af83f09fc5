"""Minimal RFC6455 WebSocket server on asyncio (no external deps; a copy of
``funasr_tpu/serving/ws_protocol.py``).

The environment has no ``websockets`` package; this implements the subset the FunASR
realtime protocol needs: HTTP upgrade handshake, text/binary frames, fragmentation,
ping/pong, close. Server-side only (no masking on send; client frames must be masked
per RFC).
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import struct
from typing import Optional, Tuple, Union

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT, OP_TEXT, OP_BIN, OP_CLOSE, OP_PING, OP_PONG = 0x0, 0x1, 0x2, 0x8, 0x9, 0xA

# Cap on a single frame AND on a fragmented message's total size; an
# unauthenticated client declaring a 64-bit length must not make readexactly
# buffer it (matches the C++ runtime's 64 MiB frame cap in websocket.cc).
MAX_MESSAGE_BYTES = 64 * 1024 * 1024


class MessageTooBig(Exception):
    pass


class ConnectionClosed(Exception):
    pass


class WebSocket:
    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                 path: str = "/", headers: Optional[dict] = None):
        self.reader = reader
        self.writer = writer
        self.path = path
        self.headers = headers or {}
        self.closed = False

    # -- receive -----------------------------------------------------------

    async def _read_frame(self) -> Tuple[int, bool, bytes]:
        head = await self.reader.readexactly(2)
        fin = bool(head[0] & 0x80)
        opcode = head[0] & 0x0F
        masked = bool(head[1] & 0x80)
        length = head[1] & 0x7F
        if length == 126:
            length = struct.unpack(">H", await self.reader.readexactly(2))[0]
        elif length == 127:
            length = struct.unpack(">Q", await self.reader.readexactly(8))[0]
        if length > MAX_MESSAGE_BYTES:
            raise MessageTooBig(length)
        mask = await self.reader.readexactly(4) if masked else None
        payload = await self.reader.readexactly(length) if length else b""
        if mask:
            payload = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
        return opcode, fin, payload

    async def recv(self) -> Union[str, bytes]:
        """Next text/binary message (handles fragmentation + control frames)."""
        if self.closed:
            raise ConnectionClosed
        buffer = b""
        msg_op = None
        while True:
            try:
                opcode, fin, payload = await self._read_frame()
            except (asyncio.IncompleteReadError, ConnectionResetError):
                self.closed = True
                raise ConnectionClosed from None
            except MessageTooBig:
                await self.close(code=1009)  # RFC6455: message too big
                raise ConnectionClosed from None
            if opcode == OP_PING:
                await self._send_frame(OP_PONG, payload)
                continue
            if opcode == OP_PONG:
                continue
            if opcode == OP_CLOSE:
                self.closed = True
                try:
                    await self._send_frame(OP_CLOSE, payload)
                except (ConnectionResetError, RuntimeError):
                    pass
                raise ConnectionClosed
            if opcode in (OP_TEXT, OP_BIN):
                msg_op = opcode
                buffer = payload
            elif opcode == OP_CONT:
                buffer += payload
            if len(buffer) > MAX_MESSAGE_BYTES:
                await self.close(code=1009)
                raise ConnectionClosed
            if fin:
                return buffer.decode("utf-8") if msg_op == OP_TEXT else buffer

    # -- send --------------------------------------------------------------

    async def _send_frame(self, opcode: int, payload: bytes):
        header = bytes([0x80 | opcode])
        n = len(payload)
        if n < 126:
            header += bytes([n])
        elif n < 1 << 16:
            header += bytes([126]) + struct.pack(">H", n)
        else:
            header += bytes([127]) + struct.pack(">Q", n)
        self.writer.write(header + payload)
        await self.writer.drain()

    async def send(self, message: Union[str, bytes]):
        if isinstance(message, str):
            await self._send_frame(OP_TEXT, message.encode("utf-8"))
        else:
            await self._send_frame(OP_BIN, bytes(message))

    async def close(self, code: int = 1000):
        if not self.closed:
            self.closed = True
            try:
                await self._send_frame(OP_CLOSE, struct.pack(">H", code))
            except (ConnectionResetError, RuntimeError):
                pass
        self.writer.close()


async def _handshake(reader, writer) -> Optional[WebSocket]:
    request = await reader.readuntil(b"\r\n\r\n")
    lines = request.decode("latin1").split("\r\n")
    path = lines[0].split(" ")[1] if len(lines[0].split(" ")) > 1 else "/"
    headers = {}
    for line in lines[1:]:
        if ":" in line:
            k, v = line.split(":", 1)
            headers[k.strip().lower()] = v.strip()
    key = headers.get("sec-websocket-key")
    if key is None or "upgrade" not in headers.get("connection", "").lower():
        writer.write(b"HTTP/1.1 400 Bad Request\r\n\r\n")
        await writer.drain()
        writer.close()
        return None
    accept = base64.b64encode(
        hashlib.sha1((key + _GUID).encode()).digest()).decode()
    writer.write(
        b"HTTP/1.1 101 Switching Protocols\r\n"
        b"Upgrade: websocket\r\nConnection: Upgrade\r\n"
        + f"Sec-WebSocket-Accept: {accept}\r\n\r\n".encode())
    await writer.drain()
    return WebSocket(reader, writer, path, headers)


class ClientWebSocket(WebSocket):
    """Client side: frames are masked on send (RFC requirement)."""

    async def _send_frame(self, opcode: int, payload: bytes):
        import os
        header = bytes([0x80 | opcode])
        n = len(payload)
        if n < 126:
            header += bytes([0x80 | n])
        elif n < 1 << 16:
            header += bytes([0x80 | 126]) + struct.pack(">H", n)
        else:
            header += bytes([0x80 | 127]) + struct.pack(">Q", n)
        mask = os.urandom(4)
        masked = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
        self.writer.write(header + mask + masked)
        await self.writer.drain()


async def connect(host: str, port: int, path: str = "/",
                  ssl=None) -> ClientWebSocket:
    """``ssl``: an SSLContext for wss:// servers (pass
    ``ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)`` with verification configured,
    or a default context for public certs)."""
    reader, writer = await asyncio.open_connection(host, port, ssl=ssl)
    key = base64.b64encode(hashlib.sha1(str(id(reader)).encode()).digest()[:16])
    writer.write(
        f"GET {path} HTTP/1.1\r\nHost: {host}:{port}\r\n"
        f"Upgrade: websocket\r\nConnection: Upgrade\r\n"
        f"Sec-WebSocket-Key: {key.decode()}\r\n"
        f"Sec-WebSocket-Version: 13\r\n\r\n".encode())
    await writer.drain()
    resp = await reader.readuntil(b"\r\n\r\n")
    if b"101" not in resp.split(b"\r\n", 1)[0]:
        raise ConnectionError(f"handshake failed: {resp[:80]!r}")
    return ClientWebSocket(reader, writer, path)


async def serve(handler, host: str = "0.0.0.0", port: int = 10095, ssl=None):
    """Start a websocket server: ``handler(ws)`` per connection."""

    async def on_conn(reader, writer):
        ws = await _handshake(reader, writer)
        if ws is None:
            return
        try:
            await handler(ws)
        except ConnectionClosed:
            pass
        finally:
            await ws.close()

    return await asyncio.start_server(on_conn, host, port, ssl=ssl)
