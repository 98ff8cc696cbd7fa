"""The port's SQL storage, its pure-python postgres driver and its object
store clients held to the JAX package's.

The sqlite flows of tests/test_sql.py (update by id, group aggregation,
inserts, the job-completion table) run through ``Client(device="cpu")``
and through the JAX package on copies of one database: equal tables
after. The in-process servers come from the JAX package's own tests (the
v3 wire-protocol emulator of tests/test_sql_pgwire.py and the S3/GCS
server of tests/test_object_store.py, each on a port-0 socket of
127.0.0.1); both packages' clients run against one server, with equal
results and equal bytes stored. SigV4 signatures of one request at one
instant are equal, and so are ``_bind`` and ``quote_literal``.
"""

import datetime
import json
import sqlite3

import pytest

import scannertools_tpu as jst
import scannertools_tpu_torch as st
from scannertools_tpu.storage import object_store as jos
from scannertools_tpu.storage import pgwire as jpg
from scannertools_tpu.storage import sql as jsql
from scannertools_tpu_torch.storage import files as pfiles
from scannertools_tpu_torch.storage import object_store as pos
from scannertools_tpu_torch.storage import pgwire as ppg
from scannertools_tpu_torch.storage import sql as psql
from test_object_store import _ERRORS, _STORE, server  # noqa: F401
from test_sql_pgwire import PASSWORD, USER, pg  # noqa: F401

PKGS = {"port": (st, psql), "jax": (jst, jsql)}


# ------------------------------------------------------------ sqlite jobs


def _add_one(rows):
    return [json.dumps([{"id": x["id"], "b": x["a"] + 1}
                        for x in json.loads(bytes(r).decode())]).encode()
            for r in rows]


def _add_all(rows):
    out = []
    for r in rows:
        r = json.loads(bytes(r).decode())
        total = sum(x["a"] for x in r)
        out.append(json.dumps([{"id": x["id"], "b": total}
                               for x in r]).encode())
    return out


def _insert(rows):
    return [json.dumps([{"s": "hello world", "b": x["a"] + 1}
                        for x in json.loads(bytes(r).decode())]).encode()
            for r in rows]


# (op, group column, output table, insert?) of each tests/test_sql.py flow
FLOWS = {"update_by_id": (_add_one, "test.id", "test", False),
         "group_aggregation": (_add_all, "test.grp", "test", False),
         "insert": (_insert, "test.grp", "test2", True)}
for _pkg, _ in PKGS.values():
    for _flow, (_fn, *_) in FLOWS.items():
        _pkg.register_python_op(name=f"PortSqlParity_{_flow}",
                                outputs=("bytes",))(
            lambda ctx, rows, _fn=_fn: _fn(rows))


def _make_db(path):
    conn = sqlite3.connect(path)
    conn.execute("CREATE TABLE test (id integer PRIMARY KEY, a integer, "
                 "b integer, grp integer)")
    for i, (a, grp) in enumerate([(10, 0), (20, 0), (30, 1)], start=1):
        conn.execute("INSERT INTO test (id, a, b, grp) VALUES (?, ?, 0, ?)",
                     (i, a, grp))
    conn.execute("CREATE TABLE jobs (id integer PRIMARY KEY, name text)")
    conn.execute("CREATE TABLE test2 (id integer PRIMARY KEY, b integer, "
                 "s text)")
    conn.commit()
    conn.close()


def _run_flow(pkg_name, flow, db, tmp_path):
    pkg, sql = PKGS[pkg_name]
    _, group, table, insert = FLOWS[flow]
    storage = sql.SQLStorage(sql.SQLConfig(adapter="sqlite", dbname=db),
                             job_table="jobs")
    stream = sql.SQLInputStream(
        query=sql.SQLQuery(fields="test.id as id, test.a as a",
                           table="test", id="test.id", group=group),
        filter="1=1", storage=storage)
    kw = {"device": "cpu"} if pkg_name == "port" else {}
    sc = pkg.Client(db_path=str(tmp_path / f"{pkg_name}_db"), **kw)
    node = getattr(sc.ops, f"PortSqlParity_{flow}")(
        rows=sc.io.Input([stream]))
    out = sql.SQLOutputStream(table=table, storage=storage,
                              job_name=f"job_{flow}", insert=insert)
    sc.run(sc.io.Output(node, [out]), pkg.PerfParams.estimate(),
           cache_mode=pkg.CacheMode.Overwrite)
    assert out.committed()
    return len(stream)


def _dump(db):
    conn = sqlite3.connect(db)
    try:
        return {t: conn.execute(f"SELECT * FROM {t} ORDER BY id").fetchall()
                for t in ("test", "test2", "jobs")}
    finally:
        conn.close()


@pytest.mark.parametrize("flow", list(FLOWS))
def test_sqlite_flow_equals_jax(tmp_path, flow):
    dbs = {}
    for name in PKGS:
        dbs[name] = str(tmp_path / f"{name}.db")
        _make_db(dbs[name])
        n = _run_flow(name, flow, dbs[name], tmp_path)
        assert n == (3 if flow == "update_by_id" else 2)
    got, want = _dump(dbs["port"]), _dump(dbs["jax"])
    assert got == want
    b = [r[2] for r in got["test"]]
    assert b == {"update_by_id": [11, 21, 31], "group_aggregation":
                 [30, 30, 30], "insert": [0, 0, 0]}[flow]
    if flow == "insert":
        assert len(got["test2"]) == 3 and got["test2"][0][2] == "hello world"
    assert got["jobs"][0][1] == f"job_{flow}"


# ------------------------------------------------------------ pgwire


def test_scram_handshake_and_query(pg):  # noqa: F811
    for drv in (ppg, jpg):
        conn = drv.connect("127.0.0.1", pg.port, USER, PASSWORD, "db")
        cur = conn.cursor()
        cur.execute("SELECT 1 + 1 AS two, 'x' AS s, NULL AS n")
        assert cur.description[0][0] == "two"
        assert cur.fetchone() == (2, "x", None)
        conn.close()


def test_bad_password_rejected(pg):  # noqa: F811
    before = pg.auth_failures
    with pytest.raises(ppg.PgError):
        ppg.connect("127.0.0.1", pg.port, USER, "wrong", "db")
    assert pg.auth_failures == before + 1


def test_parameter_binding_and_errors(pg):  # noqa: F811
    """Rows written through one driver read back through the other; an
    error surfaces and the connection survives."""
    port = ppg.connect("127.0.0.1", pg.port, USER, PASSWORD, "db")
    jax = jpg.connect("127.0.0.1", pg.port, USER, PASSWORD, "db")
    pc, jc = port.cursor(), jax.cursor()
    pc.execute("CREATE TABLE IF NOT EXISTS tp (a, b, c)")
    pc.execute("DELETE FROM tp")
    # what the sqlite-backed emulator parses: no E'' strings or bytea
    values = [("it's", 3.5, None), ("{1,2}", -2.0, 7), ("%s -- x", 1e300, 8)]
    for row in values:
        pc.execute("INSERT INTO tp VALUES (%s, %s, %s)", row)
    pc.execute("SELECT a, b, c FROM tp WHERE a = %s", ("it's",))
    jc.execute("SELECT a, b, c FROM tp WHERE a = %s", ("it's",))
    assert pc.fetchall() == jc.fetchall() == [("it's", 3.5, None)]
    pc.execute("SELECT * FROM tp")
    jc.execute("SELECT * FROM tp")
    assert pc.fetchall() == jc.fetchall()
    with pytest.raises(ppg.PgError):
        pc.execute("SELECT * FROM nonexistent_table")
    pc.execute("SELECT 7")
    assert pc.fetchone() == (7,)
    port.close()
    jax.close()


BIND_CASES = [
    ("INSERT INTO t VALUES ('{1,2}', %s)", [3]),
    ("SELECT 'a%sb', %s", ["x'y"]),
    ("SELECT $$100%s$$, %s", [1]),
    ('SELECT "col%s", %s', [2]),
    ("SELECT %s -- don't bind %s here\n, %s", [1, 2]),
    ("SELECT %s /* isn't /* nested %s */ ok */, %s", [1, 2]),
    ('SELECT "a""b%s", %s', [7]),
    ("SELECT %s -- tail", [5]),
    ("SELECT %s, %s, %s, %s", [None, True, b"\x00\xff", float("nan")]),
]


@pytest.mark.parametrize("sql,params", BIND_CASES)
def test_bind_equals_jax(sql, params):
    assert ppg._bind(sql, params) == jpg._bind(sql, params)


def test_quote_literal_equals_jax():
    for v in (None, 5, True, False, "a'b", "a\\b", b"\x01\x02",
              float("nan"), float("inf"), float("-inf"), 2.5, -7):
        assert ppg.quote_literal(v) == jpg.quote_literal(v)
    assert ppg.quote_literal("a\\b") == " E'a\\\\b'"


def test_sql_streams_on_postgres(pg):  # noqa: F811
    """The reference's postgres flow (scannertools_sql/tests/
    test_all.py:214-294) through the port's SQLStorage; the JAX package's
    reads the same elements and sees the job recorded."""
    def storage(sql):
        return sql.SQLStorage(sql.SQLConfig(
            adapter="postgres", hostaddr="127.0.0.1", port=pg.port,
            user=USER, password=PASSWORD, dbname="db"), job_table="jobs_t")

    ps, js = storage(psql), storage(jsql)
    conn = ps.connection()
    cur = conn.cursor()
    cur.execute("CREATE TABLE IF NOT EXISTS vid_t (id INTEGER, grp INTEGER, "
                "a INTEGER, b INTEGER)")
    cur.execute("CREATE TABLE IF NOT EXISTS jobs_t (name TEXT)")
    cur.execute("DELETE FROM vid_t")
    cur.execute("DELETE FROM jobs_t")
    for i in range(6):
        cur.execute("INSERT INTO vid_t VALUES (%s, %s, %s, %s)",
                    (i, i // 2, i * 10, 0))
    conn.commit()
    ins = {}
    for name, sql, s in (("port", psql, ps), ("jax", jsql, js)):
        q = sql.SQLQuery(fields="vid_t.id as id, vid_t.a as a",
                         table="vid_t", id="vid_t.id", group="vid_t.grp")
        ins[name] = sql.SQLInputStream(q, filter="1=1", storage=s)
    assert len(ins["port"]) == len(ins["jax"]) == 3
    elems = list(ins["port"].load_bytes())
    assert elems == list(ins["jax"].load_bytes())
    out = psql.SQLOutputStream("vid_t", storage=ps, job_name="job-pg-port",
                               insert=False)
    assert not out.committed()
    w = out.writer("bytes")
    for e in elems:
        w.append(json.dumps([{"id": r["id"], "b": r["a"] + 1}
                             for r in json.loads(e.decode())]).encode())
    w.commit()
    assert out.committed()
    assert jsql.SQLOutputStream("vid_t", storage=js,
                                job_name="job-pg-port").committed()
    cur.execute("SELECT b FROM vid_t ORDER BY id")
    assert [r[0] for r in cur.fetchall()] == [1, 11, 21, 31, 41, 51]


# ------------------------------------------------------------ object store


def test_sigv4_equals_jax():
    now = datetime.datetime(2024, 5, 6, 7, 8, 9,
                            tzinfo=datetime.timezone.utc)
    for token in (None, "TOKEN"):
        kw = dict(region="eu-west-1", endpoint="http://127.0.0.1:9",
                  access_key="AKID", secret_key="SECRET",
                  session_token=token)
        p = pos.S3Client("bkt", **kw)
        j = jos.S3Client("bkt", **kw)
        for method, key, body in (("PUT", "a/b c.bin", b"x" * 10),
                                  ("GET", "k~1", b"")):
            assert p._sign(method, key, body, now) == \
                j._sign(method, key, body, now)


def test_s3_and_gcs_cross_read(server):  # noqa: F811
    """Objects put by one package's client are got by the other's."""
    _ERRORS.clear()
    kw = dict(region="us-east-1", endpoint=server, access_key="AKID",
              secret_key="SECRET")
    for put_c, get_c in ((pos.S3Client("bkt", **kw),
                          jos.S3Client("bkt", **kw)),
                         (pos.GCSClient("gbkt", endpoint=server,
                                        token="test-token"),
                          jos.GCSClient("gbkt", endpoint=server,
                                        token="test-token"))):
        put_c.put("x/port.bin", b"from-the-port\x00\xff")
        assert get_c.get("x/port.bin") == b"from-the-port\x00\xff"
        get_c.put("x/jax.bin", b"from-jax")
        assert put_c.get("x/jax.bin") == b"from-jax"
        assert put_c.exists("x/jax.bin") and get_c.exists("x/port.bin")
        put_c.delete("x/port.bin")
        assert not get_c.exists("x/port.bin")
    with pytest.raises(pos.ObjectStoreError):
        pos.S3Client("bkt", **kw).get("nope")
    assert _ERRORS == []


def test_files_stream_on_s3(server):  # noqa: F811
    """FilesStream with storage_type='s3' (files_source.cpp:149-165):
    written by the port, read by the JAX package, equal bytes."""
    kw = dict(storage_type="s3", bucket="bkt", region="us-east-1",
              endpoint=server)
    keys = ["out/0.bin", "out/1.bin"]
    stream = st.FilesStream(keys, storage=st.FilesStorage(**kw))
    w = stream.writer("bytes")
    w.append(b"elem-0")
    w.append(b"elem-1")
    w.commit()
    assert stream.committed()
    theirs = jst.FilesStream(keys, storage=jst.FilesStorage(**kw))
    assert list(theirs.load_bytes()) == list(stream.load_bytes()) == \
        [b"elem-0", b"elem-1"]
    assert _STORE  # the objects live in the test server
    stream.delete()
    assert not theirs.exists()


def test_posix_and_unknown_storage(tmp_path):
    p = [str(tmp_path / "a"), str(tmp_path / "b")]
    s = st.FilesStream(p)
    w = s.writer("bytes")
    w.append(b"x")
    w.append(b"y")
    assert s.committed() and list(s.load_bytes()) == [b"x", b"y"]
    with pytest.raises(ValueError):
        pfiles.FilesStorage(storage_type="ftp")
