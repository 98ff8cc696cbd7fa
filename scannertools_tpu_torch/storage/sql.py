"""SQL storage: database rows as input/output streams.

Reference parity: scannertools_sql — ``SQLStorage``/``SQLInputStream``/
``SQLOutputStream`` (scannertools_sql/storage.py) over the C++ source/sink
(sql_source.cpp:34-190, sql_sink.cpp:38-147):

  * element count = ``SELECT COUNT(DISTINCT group) WHERE filter``;
  * element i = JSON array of the rows whose ``group`` equals the i-th
    distinct group value (ordered), fields per the query;
  * sink rows are JSON objects: UPDATE by ``id`` (insert=False) or INSERT
    (insert=True); the completed job name is recorded in ``job_table``
    (sql_sink.cpp:63-70) which backs ``committed()``.

The reference is Postgres-only (pqxx). Here any DB-API adapter works:
``adapter='sqlite'`` (stdlib) or ``adapter='postgres'`` — psycopg2 when the
image has it, else the bundled pure-python wire driver (pgwire.py), which
tests/test_sql_pgwire.py exercises against an in-process v3 wire server.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence

from .base import StorageBackend, StoredStream, StreamWriter


@dataclasses.dataclass
class SQLConfig:
    adapter: str = "sqlite"
    # sqlite: ``dbname`` is the file path. postgres: standard params.
    dbname: str = ":memory:"
    hostaddr: str = "localhost"
    port: int = 5432
    user: str = ""
    password: str = ""


@dataclasses.dataclass
class SQLQuery:
    fields: str   # e.g. "test.id as id, test.a"
    table: str    # e.g. "test" (may include joins)
    id: str       # id column, e.g. "test.id"
    group: str    # group column: one element per distinct value


class SQLStorage(StorageBackend):
    def __init__(self, config: SQLConfig, job_table: Optional[str] = None):
        self._config = config
        self._job_table = job_table
        self._conn = None

    def connection(self):
        if self._conn is None:
            if self._config.adapter == "sqlite":
                import sqlite3

                self._conn = sqlite3.connect(self._config.dbname,
                                             check_same_thread=False)
                self._conn.row_factory = sqlite3.Row
            elif self._config.adapter == "postgres":
                # pure-python v3 wire driver (pgwire.py) — no libpq needed;
                # psycopg2 is preferred when the image has it
                try:
                    import psycopg2

                    self._conn = psycopg2.connect(
                        host=self._config.hostaddr, port=self._config.port,
                        dbname=self._config.dbname, user=self._config.user,
                        password=self._config.password or None,
                    )
                except ImportError:
                    from . import pgwire

                    self._conn = pgwire.connect(
                        host=self._config.hostaddr, port=self._config.port,
                        dbname=self._config.dbname, user=self._config.user,
                        password=self._config.password,
                    )
            else:
                raise ValueError(f"unknown adapter {self._config.adapter!r}")
        return self._conn

    def _rows(self, cur) -> List[Dict[str, Any]]:
        cols = [d[0] for d in cur.description]
        return [dict(zip(cols, row)) for row in cur.fetchall()]

    def job_committed(self, job_name: str) -> bool:
        if not self._job_table:
            return False
        cur = self.connection().cursor()
        try:
            cur.execute(
                f"SELECT COUNT(*) FROM {self._job_table} WHERE name = ?"
                .replace("?", self._ph()), (job_name,))
            return cur.fetchone()[0] > 0
        except Exception:
            return False

    def record_job(self, job_name: str) -> None:
        if not self._job_table:
            return
        cur = self.connection().cursor()
        cur.execute(
            f"INSERT INTO {self._job_table} (name) VALUES ({self._ph()})",
            (job_name,))
        self.connection().commit()

    def _ph(self) -> str:
        return "?" if self._config.adapter == "sqlite" else "%s"


class SQLInputStream(StoredStream):
    def __init__(self, query: SQLQuery, filter: str, storage: SQLStorage,
                 num_elements: Optional[int] = None):
        assert isinstance(storage, SQLStorage)
        self._query = query
        self._filter = filter or "1=1"
        self._storage = storage
        self._num = num_elements
        self._groups: Optional[List[Any]] = None

    def _distinct_groups(self) -> List[Any]:
        if self._groups is None:
            q = self._query
            cur = self._storage.connection().cursor()
            cur.execute(
                f"SELECT DISTINCT {q.group} FROM {q.table} "
                f"WHERE {self._filter} ORDER BY {q.group}"
            )
            self._groups = [r[0] for r in cur.fetchall()]
        return self._groups

    def __len__(self) -> int:
        # num_elements is the reference's count-skipping optimization
        return self._num if self._num is not None \
            else len(self._distinct_groups())

    def load_bytes(self, rows: Optional[Sequence[int]] = None):
        q = self._query
        groups = self._distinct_groups()
        idxs = range(len(groups)) if rows is None else rows
        conn = self._storage.connection()
        ph = self._storage._ph()
        for i in idxs:
            cur = conn.cursor()
            cur.execute(
                f"SELECT {q.fields} FROM {q.table} "
                f"WHERE ({self._filter}) AND {q.group} = {ph} "
                f"ORDER BY {q.id}",
                (groups[i],),
            )
            yield json.dumps(self._storage._rows(cur)).encode("utf-8")

    def storage(self) -> SQLStorage:
        return self._storage


class SQLOutputStream(StoredStream):
    def __init__(self, table: str, storage: SQLStorage, job_name: str,
                 insert: bool = True):
        assert isinstance(storage, SQLStorage)
        self._table = table
        self._storage = storage
        self._job_name = job_name
        self._insert = insert

    def __len__(self) -> int:
        return 0

    def load_bytes(self, rows=None):
        raise NotImplementedError("SQLOutputStream is output-only")

    def committed(self) -> bool:
        return self._storage.job_committed(self._job_name)

    def exists(self) -> bool:
        return self.committed()

    def writer(self, type_name: str) -> "SQLStreamWriter":
        return SQLStreamWriter(self)


class SQLStreamWriter(StreamWriter):
    def __init__(self, stream: SQLOutputStream):
        self._stream = stream
        self._conn = stream._storage.connection()

    def append(self, element: bytes) -> None:
        rows = json.loads(bytes(element).decode("utf-8")) if element else []
        if isinstance(rows, dict):
            rows = [rows]
        st = self._stream
        ph = st._storage._ph()
        cur = self._conn.cursor()
        for row in rows:
            if st._insert:
                cols = [c for c in row.keys()]
                cur.execute(
                    f"INSERT INTO {st._table} "
                    f"({', '.join(cols)}) VALUES "
                    f"({', '.join([ph] * len(cols))})",
                    tuple(row[c] for c in cols),
                )
            else:
                cols = [c for c in row.keys() if c != "id"]
                sets = ", ".join(f"{c} = {ph}" for c in cols)
                cur.execute(
                    f"UPDATE {st._table} SET {sets} WHERE id = {ph}",
                    tuple(row[c] for c in cols) + (row["id"],),
                )

    def commit(self) -> None:
        self._conn.commit()
        self._stream._storage.record_job(self._stream._job_name)
