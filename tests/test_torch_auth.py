"""The port's users and auth (meta/users.py, the executor's privilege
checks, server/http.py's Basic auth and u/p, the write and read checks)
against the JAX package, on the CPU.

The auth cases of the reference's tests/test_auth_delete.py and its
union case of tests/test_join_union.py run on the port
(test_torch_raft.mirror_reference; the DELETE cases are
tests/test_torch_delete.py's, and /api/v1/consume's are
tests/test_torch_edges.py's).
Besides: a users.json written by either package authenticates in the
other, PBKDF2 with the same salt gives the same hash, and both
``HttpService``s answer the same status for each credential and route.
"""

from __future__ import annotations

import base64
import json
import urllib.error
import urllib.parse
import urllib.request

import pytest
import torch

from opengemini_tpu.meta import users as jusers
from opengemini_tpu.server.http import HttpService as JHttp
from opengemini_tpu.storage.engine import Engine as JEngine
from opengemini_tpu_torch.meta import users as tusers
from opengemini_tpu_torch.server.http import HttpService as THttp
from test_torch_raft import CpuEngine, mirror_reference

torch.set_num_threads(1)

globals().update(mirror_reference("test_auth_delete", names={
    "TestUserStore", "TestUserStatements", "TestHttpAuth",
    "TestReviewRegressions.test_bootstrap_only_allows_admin_creation",
    "TestReviewRegressions.test_show_databases_any_authenticated_user",
    "TestReviewRegressions.test_http_auth_error_status_codes",
    "TestAdvisorRegressions.test_cross_db_source_requires_read",
    "TestAdvisorRegressions.test_into_requires_write_on_target_db",
    "TestAdvisorRegressions.test_show_databases_filtered_by_privilege",
    "TestAdvisorRegressions.test_explain_analyze_into_requires_write",
}))
# a union is authorized side by side (tests/test_join_union.py)
globals().update(mirror_reference("test_join_union", names={
    "TestUnion.test_union_auth_checks_each_side"}))


@pytest.mark.parametrize("writer,reader", [(jusers, tusers),
                                           (tusers, jusers)])
def test_users_json_read_by_the_other(tmp_path, writer, reader):
    path = str(tmp_path / "users.json")
    us = writer.UserStore(path)
    us.create("root", "pw", admin=True)
    us.create("bob", "secret")
    us.grant("bob", "db", "READ")
    us.grant("bob", "other", "ALL")
    got = reader.UserStore(path)
    assert got.authenticate("root", "pw").admin
    bob = got.authenticate("bob", "secret")
    assert bob.can("READ", "db") and not bob.can("WRITE", "db")
    assert bob.can("WRITE", "other")
    with pytest.raises(reader.AuthError):
        got.authenticate("bob", "wrong")
    salt = "00112233445566778899aabbccddeeff"
    assert writer._hash("pw", salt) == reader._hash("pw", salt)


def _status(port, path, method="GET", body=b"", headers=None, **params):
    url = f"http://127.0.0.1:{port}{path}?" + urllib.parse.urlencode(params)
    req = urllib.request.Request(url, data=body if method == "POST" else None,
                                 headers=headers or {}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _auth_statuses(svc_cls, engine):
    engine.create_database("db")
    engine.create_database("prom")
    svc = svc_cls(engine, "127.0.0.1", 0, auth_enabled=True)
    svc.start()
    port = svc.port
    out = []
    try:
        def basic(u, p):
            return {"Authorization": "Basic "
                    + base64.b64encode(f"{u}:{p}".encode()).decode()}

        out.append(_status(port, "/query", "POST",
                           q="CREATE USER root WITH PASSWORD 'pw' "
                             "WITH ALL PRIVILEGES")[0])
        out.append(_status(port, "/query", "POST", u="root", p="pw",
                           q="CREATE USER reader WITH PASSWORD 'r'")[0])
        out.append(_status(port, "/query", "POST", u="root", p="pw",
                           q="GRANT READ ON db TO reader")[0])
        for creds in ({}, {"u": "root", "p": "pw"}, {"u": "reader", "p": "r"},
                      {"u": "reader", "p": "bad"}):
            out.append(_status(port, "/write", "POST", b"m v=1 1",
                               db="db", **creds)[0])
            st, body = _status(port, "/query", q="SELECT count(v) FROM m",
                               db="db", **creds)
            out.append((st, json.loads(body) if st == 200 else None))
            out.append(_status(port, "/query", q="SHOW USERS", **creds)[0])
            out.append(_status(port, "/api/v1/labels", db="prom",
                               **creds)[0])
            out.append(_status(port, "/api/v1/labels", db="db",
                               **creds)[0])
        out.append(_status(port, "/query", headers=basic("root", "pw"),
                           q="SHOW GRANTS FOR reader")[1])
    finally:
        svc.stop()
        engine.close()
    return out


def test_http_auth_statuses_equal(tmp_path):
    j = _auth_statuses(JHttp, JEngine(str(tmp_path / "j")))
    t = _auth_statuses(THttp, CpuEngine(str(tmp_path / "t")))
    assert t == j
