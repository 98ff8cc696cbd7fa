"""Minimal pure-python PostgreSQL client (wire protocol v3).

Reference parity: the SQL module is Postgres-only in the reference (pqxx —
sql.cpp:6-20); this image has no libpq or psycopg2, so this is a
from-scratch driver speaking the v3 protocol directly over a socket:
StartupMessage, cleartext/MD5/SCRAM-SHA-256 authentication, the simple
query protocol (Query → RowDescription/DataRow/CommandComplete), and text
result decoding by type OID. The surface is the DB-API subset
storage/sql.py uses: ``connect() → Connection`` with ``cursor()``/
``commit()``, cursors with ``execute(sql, params)`` (client-side literal
binding, postgres quoting rules), ``description``, ``fetchone``/
``fetchall``.

Tested against an in-process wire-server emulator (tests/test_sql_pgwire.py)
— same framing, same SCRAM exchange a real server performs.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import math
import os
import re
import socket
import struct
from typing import Any, List, Optional, Sequence, Tuple


class PgError(Exception):
    pass


# ------------------------------------------------------------- framing

def _msg(tag: bytes, payload: bytes) -> bytes:
    return tag + struct.pack("!I", len(payload) + 4) + payload


def _cstr(s: str) -> bytes:
    return s.encode() + b"\x00"


class _Reader:
    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._buf = b""

    def _need(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise PgError("server closed connection")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def message(self) -> Tuple[bytes, bytes]:
        tag = self._need(1)
        (ln,) = struct.unpack("!I", self._need(4))
        return tag, self._need(ln - 4)


# ------------------------------------------------------- SCRAM-SHA-256

def _scram_client(user: str, password: str):
    """Generator implementing the client side of SCRAM-SHA-256 (RFC 5802,
    channel binding 'n'). send/receive via .send()."""
    nonce = base64.b64encode(os.urandom(18)).decode()
    first_bare = f"n={user},r={nonce}"
    server_first = yield ("n,," + first_bare).encode()

    parts = dict(p.split("=", 1) for p in server_first.decode().split(","))
    r, s, i = parts["r"], base64.b64decode(parts["s"]), int(parts["i"])
    if not r.startswith(nonce):
        raise PgError("SCRAM: server nonce does not extend client nonce")
    salted = hashlib.pbkdf2_hmac("sha256", password.encode(), s, i)
    client_key = hmac.new(salted, b"Client Key", hashlib.sha256).digest()
    stored = hashlib.sha256(client_key).digest()
    without_proof = f"c={base64.b64encode(b'n,,').decode()},r={r}"
    auth_msg = ",".join([first_bare, server_first.decode(), without_proof])
    sig = hmac.new(stored, auth_msg.encode(), hashlib.sha256).digest()
    proof = bytes(a ^ b for a, b in zip(client_key, sig))
    final = f"{without_proof},p={base64.b64encode(proof).decode()}"

    server_final = yield final.encode()
    sparts = dict(p.split("=", 1) for p in server_final.decode().split(","))
    server_key = hmac.new(salted, b"Server Key", hashlib.sha256).digest()
    want = hmac.new(server_key, auth_msg.encode(), hashlib.sha256).digest()
    if base64.b64decode(sparts.get("v", "")) != want:
        raise PgError("SCRAM: bad server signature")


# ------------------------------------------------------------ literals

def quote_literal(v: Any) -> str:
    """Client-side parameter binding with postgres quoting rules."""
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "TRUE" if v else "FALSE"
    if isinstance(v, float):
        if math.isnan(v):
            return "'NaN'::float8"
        if math.isinf(v):
            return "'Infinity'::float8" if v > 0 else "'-Infinity'::float8"
        return repr(v)
    if isinstance(v, int):
        return repr(v)
    if isinstance(v, (bytes, bytearray, memoryview)):
        return r"'\x" + bytes(v).hex() + "'"
    s = str(v).replace("'", "''")
    if "\\" in s:
        return " E'" + s.replace("\\", "\\\\") + "'"
    return "'" + s + "'"


def _bind(sql: str, params: Sequence[Any]) -> str:
    """Substitute %s placeholders OUTSIDE quoted regions with quoted params.

    str.format-based binding broke on SQL containing literal braces
    (postgres array/JSON literals like '{1,2}') and rewrote %s inside
    string literals; this walks the statement tracking single-quoted
    strings (with '' escapes), double-quoted identifiers (with ""
    escapes), dollar-quoted blocks, and -- / nested /* */ comments, and
    only substitutes in plain SQL text.
    """
    out: List[str] = []
    vals = [quote_literal(p) for p in params]
    vi = 0
    i = 0
    n = len(sql)
    while i < n:
        c = sql[i]
        if c == "'":
            j = i + 1
            while j < n:
                if sql[j] == "'":
                    if j + 1 < n and sql[j + 1] == "'":
                        j += 2
                        continue
                    break
                j += 1
            out.append(sql[i:j + 1])
            i = j + 1
        elif c == '"':
            j = i + 1
            while j < n:  # "" escapes inside quoted identifiers
                if sql[j] == '"':
                    if j + 1 < n and sql[j + 1] == '"':
                        j += 2
                        continue
                    break
                j += 1
            out.append(sql[i:j + 1])
            i = j + 1
        elif c == "-" and i + 1 < n and sql[i + 1] == "-":
            j = sql.find("\n", i)  # -- line comment: opaque to end of line
            j = n if j < 0 else j
            out.append(sql[i:j])
            i = j
        elif c == "/" and i + 1 < n and sql[i + 1] == "*":
            depth, j = 1, i + 2  # /* */ nests in postgres
            while j < n and depth:
                if sql.startswith("/*", j):
                    depth, j = depth + 1, j + 2
                elif sql.startswith("*/", j):
                    depth, j = depth - 1, j + 2
                else:
                    j += 1
            out.append(sql[i:j])
            i = j
        elif c == "$":
            m = re.match(r"\$[A-Za-z_]*\$", sql[i:])
            if m:
                tag = m.group(0)
                j = sql.find(tag, i + len(tag))
                j = n if j < 0 else j + len(tag)
                out.append(sql[i:j])
                i = j
            else:
                out.append(c)
                i += 1
        elif c == "%" and i + 1 < n and sql[i + 1] == "s":
            if vi >= len(vals):
                raise PgError("not enough parameters for %s placeholders")
            out.append(vals[vi])
            vi += 1
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _decode(oid: int, text: Optional[bytes]) -> Any:
    if text is None:
        return None
    t = text.decode()
    if oid in (20, 21, 23, 26):          # int8/int2/int4/oid
        return int(t)
    if oid in (700, 701, 1700):          # float4/float8/numeric
        return float(t)
    if oid == 16:                        # bool
        return t == "t"
    if oid == 17:                        # bytea (hex form)
        return bytes.fromhex(t[2:]) if t.startswith("\\x") else t.encode()
    return t


# ------------------------------------------------------------- DB-API

class Cursor:
    def __init__(self, conn: "Connection"):
        self._conn = conn
        self.description: Optional[List[tuple]] = None
        self._rows: List[tuple] = []
        self._pos = 0
        self.rowcount = -1

    def execute(self, sql: str, params: Sequence[Any] = ()) -> "Cursor":
        if params:
            sql = _bind(sql, params)
        self.description, self._rows, self.rowcount = self._conn._query(sql)
        self._pos = 0
        return self

    def fetchone(self) -> Optional[tuple]:
        if self._pos >= len(self._rows):
            return None
        row = self._rows[self._pos]
        self._pos += 1
        return row

    def fetchall(self) -> List[tuple]:
        rows = self._rows[self._pos:]
        self._pos = len(self._rows)
        return rows

    def close(self) -> None:
        pass


class Connection:
    def __init__(self, host: str, port: int, user: str, password: str,
                 dbname: str):
        self._sock = socket.create_connection((host, port))
        self._r = _Reader(self._sock)
        self._params = {}
        self._startup(user, password, dbname)

    # --------------------------------------------------------- handshake
    def _startup(self, user: str, password: str, dbname: str) -> None:
        body = struct.pack("!I", 196608)  # protocol 3.0
        body += _cstr("user") + _cstr(user)
        body += _cstr("database") + _cstr(dbname or user)
        body += b"\x00"
        self._sock.sendall(struct.pack("!I", len(body) + 4) + body)
        scram = None
        while True:
            tag, payload = self._r.message()
            if tag == b"R":
                (code,) = struct.unpack("!I", payload[:4])
                if code == 0:
                    continue  # AuthenticationOk
                if code == 3:  # cleartext
                    self._sock.sendall(_msg(b"p", _cstr(password)))
                elif code == 5:  # md5
                    salt = payload[4:8]
                    inner = hashlib.md5(
                        password.encode() + user.encode()).hexdigest()
                    outer = hashlib.md5(
                        inner.encode() + salt).hexdigest()
                    self._sock.sendall(_msg(b"p", _cstr("md5" + outer)))
                elif code == 10:  # SASL: mechanisms list
                    mechs = payload[4:].split(b"\x00")
                    if b"SCRAM-SHA-256" not in mechs:
                        raise PgError(f"unsupported SASL mechanisms {mechs}")
                    scram = _scram_client(user, password)
                    first = next(scram)
                    body = (_cstr("SCRAM-SHA-256")
                            + struct.pack("!I", len(first)) + first)
                    self._sock.sendall(_msg(b"p", body))
                elif code == 11:  # SASLContinue
                    final = scram.send(payload[4:])
                    self._sock.sendall(_msg(b"p", final))
                elif code == 12:  # SASLFinal
                    try:
                        scram.send(payload[4:])
                    except StopIteration:
                        pass
                else:
                    raise PgError(f"unsupported auth method {code}")
            elif tag == b"S":  # ParameterStatus
                k, v = payload.split(b"\x00")[:2]
                self._params[k.decode()] = v.decode()
            elif tag == b"K":  # BackendKeyData
                pass
            elif tag == b"Z":  # ReadyForQuery
                return
            elif tag == b"E":
                raise PgError(self._err(payload))
            else:
                raise PgError(f"unexpected message {tag!r} during startup")

    @staticmethod
    def _err(payload: bytes) -> str:
        fields = {}
        for part in payload.split(b"\x00"):
            if part:
                fields[chr(part[0])] = part[1:].decode(errors="replace")
        return fields.get("M", "unknown error")

    # ------------------------------------------------------------- query
    def _query(self, sql: str):
        self._sock.sendall(_msg(b"Q", _cstr(sql)))
        description = None
        oids: List[int] = []
        rows: List[tuple] = []
        rowcount = -1
        error = None
        while True:
            tag, payload = self._r.message()
            if tag == b"T":  # RowDescription
                (n,) = struct.unpack("!H", payload[:2])
                off = 2
                description = []
                oids = []
                for _ in range(n):
                    end = payload.index(b"\x00", off)
                    name = payload[off:end].decode()
                    off = end + 1
                    _, _, oid, size, mod, fmt = struct.unpack(
                        "!IHIhih", payload[off:off + 18])
                    off += 18
                    oids.append(oid)
                    description.append((name, oid, None, None, None, None,
                                        None))
            elif tag == b"D":  # DataRow
                (n,) = struct.unpack("!H", payload[:2])
                off = 2
                vals = []
                for i in range(n):
                    (ln,) = struct.unpack("!i", payload[off:off + 4])
                    off += 4
                    if ln < 0:
                        vals.append(None)
                    else:
                        vals.append(_decode(oids[i], payload[off:off + ln]))
                        off += ln
                rows.append(tuple(vals))
            elif tag == b"C":  # CommandComplete
                words = payload.rstrip(b"\x00").split()
                if words and words[-1].isdigit():
                    rowcount = int(words[-1])
            elif tag == b"E":
                error = self._err(payload)
            elif tag == b"Z":  # ReadyForQuery
                if error:
                    raise PgError(error)
                return description, rows, rowcount
            # N (notice), S (parameter), I (empty query) — ignored

    def cursor(self) -> Cursor:
        return Cursor(self)

    def commit(self) -> None:
        # simple-query protocol runs autocommit unless a BEGIN is open;
        # issue COMMIT defensively (no-op warning outside a transaction)
        self._query("COMMIT")

    def rollback(self) -> None:
        self._query("ROLLBACK")

    def close(self) -> None:
        try:
            self._sock.sendall(_msg(b"X", b""))
        except OSError:
            pass
        self._sock.close()


def connect(host: str = "localhost", port: int = 5432, user: str = "",
            password: str = "", dbname: str = "") -> Connection:
    return Connection(host, port, user, password, dbname)
