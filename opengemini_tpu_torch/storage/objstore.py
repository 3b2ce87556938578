"""Object-storage tier (reference: lib/fileops obs backends — cold
shards live in a bucket, hot paths hydrate them back on demand).

`ObjectStore` is the minimal interface a bucket needs (put/get/list/
delete by key). `FSObjectStore` is the filesystem-backed implementation
used for dev/test and network-less deployments; an S3/OBS client drops
in behind the same five methods.

The port of ``opengemini_tpu/storage/objstore.py``, whole, with its
imports rewritten.
"""

from __future__ import annotations

import os
import shutil


class ObjectStore:
    def put(self, key: str, src_path: str) -> None:  # pragma: no cover
        raise NotImplementedError

    def get(self, key: str, dst_path: str) -> None:  # pragma: no cover
        raise NotImplementedError

    def list(self, prefix: str) -> list[str]:  # pragma: no cover
        raise NotImplementedError

    def delete_prefix(self, prefix: str) -> int:  # pragma: no cover
        raise NotImplementedError

    def exists(self, key: str) -> bool:  # pragma: no cover
        raise NotImplementedError


class FSObjectStore(ObjectStore):
    """Keys are relative POSIX-ish paths under a root directory."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: str) -> str:
        p = os.path.abspath(os.path.join(self.root, key))
        if not p.startswith(self.root + os.sep):
            raise ValueError(f"key escapes store root: {key!r}")
        return p

    def put(self, key: str, src_path: str) -> None:
        dst = self._path(key)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        tmp = dst + ".tmp"
        shutil.copyfile(src_path, tmp)
        os.replace(tmp, dst)

    def get(self, key: str, dst_path: str) -> None:
        os.makedirs(os.path.dirname(dst_path), exist_ok=True)
        tmp = dst_path + ".tmp"
        shutil.copyfile(self._path(key), tmp)
        os.replace(tmp, dst_path)

    def list(self, prefix: str) -> list[str]:
        base = self._path(prefix)
        out = []
        if not os.path.isdir(base):
            return out
        for dirpath, _dirs, files in os.walk(base):
            for f in files:
                full = os.path.join(dirpath, f)
                out.append(os.path.relpath(full, self.root))
        return sorted(out)

    def delete_prefix(self, prefix: str) -> int:
        base = self._path(prefix)
        n = len(self.list(prefix))
        shutil.rmtree(base, ignore_errors=True)
        return n

    def exists(self, key: str) -> bool:
        return os.path.exists(self._path(key))


class ObjectStoreError(OSError):
    pass


class HTTPObjectStore(ObjectStore):
    """S3-compatible REST client (subset: PUT/GET/DELETE object, ranged
    GET, ListObjectsV2). Reference: openGemini lib/obs +
    engine/immutable/detached_*.go (remote bucket behind the cold tier).

    Auth is a bearer token (or none); AWS SigV4 belongs in a deployment
    wrapper, not the storage engine. Transient failures retry with
    backoff; a missing object surfaces as ObjectStoreError so hydrate
    paths fail loudly instead of installing a torn shard."""

    def __init__(self, base_url: str, token: str | None = None,
                 retries: int = 3, timeout_s: float = 30.0):
        self.base = base_url.rstrip("/")
        self.token = token
        self.retries = retries
        self.timeout_s = timeout_s

    # -- http plumbing ---------------------------------------------------

    def _request(self, method: str, path: str, body=None, headers=None,
                 ok=(200, 204), stream_to: str | None = None,
                 want_status: bool = False):
        """want_status=True returns (status, payload) so callers can
        distinguish e.g. a 206 partial reply from a 200 full-object one
        (get_range must slice the latter client-side)."""
        import time as _time
        import urllib.error
        import urllib.request

        from opengemini_tpu_torch.utils.failpoint import inject as _fp

        url = f"{self.base}/{_quote(path)}"
        hdrs = dict(headers or {})
        if self.token:
            hdrs["Authorization"] = f"Bearer {self.token}"
        last = None
        for attempt in range(self.retries):
            # body may be a factory producing a fresh file object per
            # attempt: multi-GB TSF uploads stream instead of loading
            # into one bytes object
            data = body() if callable(body) else body
            req = urllib.request.Request(
                url, data=data, headers=hdrs, method=method)
            try:
                try:
                    with urllib.request.urlopen(
                            req, timeout=self.timeout_s) as resp:
                        if resp.status not in ok:
                            raise ObjectStoreError(
                                f"{method} {path}: HTTP {resp.status}")
                        if stream_to is not None:
                            _fp("objstore-get-torn")  # truncated download
                            with open(stream_to, "wb") as f:
                                while True:
                                    chunk = resp.read(1 << 20)
                                    if not chunk:
                                        break
                                    f.write(chunk)
                            return (resp.status, None) if want_status else None
                        got = resp.read()
                        return (resp.status, got) if want_status else got
                finally:
                    if data is not None and hasattr(data, "close"):
                        data.close()
            except ObjectStoreError:
                # deliberate unexpected-status raise above: must NOT be
                # swallowed by the OSError clause below and retried
                # (ObjectStoreError derives from OSError)
                raise
            except urllib.error.HTTPError as e:
                if e.code in ok:  # e.g. DELETE tolerating 404
                    return (e.code, None) if want_status else None
                if e.code == 404:
                    raise ObjectStoreError(
                        f"object not found: {path}") from None
                last = e
            except (urllib.error.URLError, TimeoutError, OSError) as e:
                last = e
            _time.sleep(0.05 * (2 ** attempt))
        raise ObjectStoreError(f"{method} {path} failed: {last}")

    # -- ObjectStore surface ---------------------------------------------

    def put(self, key: str, src_path: str) -> None:
        from opengemini_tpu_torch.utils.failpoint import inject as _fp

        _fp("objstore-put-torn")  # upload dies before reaching the bucket
        size = os.path.getsize(src_path)
        self._request(
            "PUT", key,
            body=lambda: open(src_path, "rb"),  # streamed per attempt
            headers={"Content-Length": str(size)})

    def get(self, key: str, dst_path: str) -> None:
        from opengemini_tpu_torch.utils.failpoint import inject as _fp

        _fp("objstore-get-missing")  # hydrate meets a vanished object
        os.makedirs(os.path.dirname(dst_path), exist_ok=True)
        tmp = dst_path + ".tmp"
        try:
            self._request("GET", key, stream_to=tmp)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
        os.replace(tmp, dst_path)

    def get_range(self, key: str, start: int, length: int) -> bytes:
        """Ranged read for lazy hydration (detached chunk meta/bloom
        reads without pulling the whole object). A server that ignores
        the Range header and replies 200 with the full body is sliced
        client-side — callers always get exactly the requested window."""
        end = start + length - 1
        status, got = self._request(
            "GET", key, headers={"Range": f"bytes={start}-{end}"},
            ok=(200, 206), want_status=True)
        if status == 200:
            # server ignored the Range header and sent the whole object.
            # Slice on STATUS, not on len(got) > length: a short tail
            # read (start + length past EOF) of a small object would
            # otherwise silently return bytes from offset 0.
            got = got[start:start + length]
        return got

    def list(self, prefix: str) -> list[str]:
        """ListObjectsV2 with continuation-token pagination: real S3
        truncates at 1000 keys per page; stopping at one page would
        hydrate partial shards (and the local-wins reconcile would then
        delete the only complete copy)."""
        import re as _re

        keys: list[str] = []
        token = None
        while True:
            q = f"?list-type=2&prefix={_quote(prefix)}"
            if token:
                q += f"&continuation-token={_quote(token)}"
            xml = self._request("GET", q, ok=(200,))
            text = xml.decode("utf-8", errors="replace")
            keys.extend(_unescape_xml(k)
                        for k in _re.findall(r"<Key>(.*?)</Key>", text))
            m = _re.search(r"<NextContinuationToken>(.*?)"
                           r"</NextContinuationToken>", text)
            trunc = _re.search(r"<IsTruncated>true</IsTruncated>", text)
            if not (trunc and m):
                break
            token = _unescape_xml(m.group(1))
        return sorted(keys)

    def delete_prefix(self, prefix: str) -> int:
        keys = self.list(prefix)
        for k in keys:
            self._request("DELETE", k, ok=(200, 204, 404))
        return len(keys)

    def exists(self, key: str) -> bool:
        import urllib.error
        import urllib.request

        req = urllib.request.Request(
            f"{self.base}/{_quote(key)}", method="HEAD")
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                return r.status == 200
        except urllib.error.HTTPError as e:
            # only a definitive 404 means absent; 403/5xx must surface —
            # "False" on a flaky auth/server error would let reconcile
            # paths conclude an object is gone and re-upload or delete
            if e.code == 404:
                return False
            raise ObjectStoreError(
                f"HEAD {key}: HTTP {e.code}") from None
        except OSError:
            raise ObjectStoreError(f"HEAD {key} failed") from None


def _quote(path: str) -> str:
    from urllib.parse import quote

    # keep '/' and the list query intact; escape everything else
    if path.startswith("?"):
        return path
    return quote(path, safe="/")


def _unescape_xml(s: str) -> str:
    return (s.replace("&lt;", "<").replace("&gt;", ">")
            .replace("&quot;", '"').replace("&amp;", "&"))


def _escape_xml(s: str) -> str:
    return (s.replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;").replace('"', "&quot;"))


class MiniBucketServer:
    """In-process S3-subset bucket for tests and dev deployments:
    PUT/GET (with Range)/HEAD/DELETE objects + ListObjectsV2. Speaks
    exactly the protocol HTTPObjectStore consumes; storage is a dict or
    a spill directory."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 token: str | None = None, max_keys: int = 1000):
        import http.server
        import threading

        store: dict[str, bytes] = {}
        self.objects = store
        expect_token = token
        page_size = max_keys

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def _key(self):
                from urllib.parse import unquote, urlsplit

                return unquote(urlsplit(self.path).path.lstrip("/"))

            def _authed(self) -> bool:
                if expect_token is None:
                    return True
                return self.headers.get("Authorization") == \
                    f"Bearer {expect_token}"

            def _deny(self):
                self.send_response(403)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def do_PUT(self):
                if not self._authed():
                    return self._deny()
                n = int(self.headers.get("Content-Length", "0"))
                store[self._key()] = self.rfile.read(n)
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def do_GET(self):
                from urllib.parse import parse_qs, urlsplit

                if not self._authed():
                    return self._deny()
                parts = urlsplit(self.path)
                qs = parse_qs(parts.query)
                if "list-type" in qs:
                    prefix = qs.get("prefix", [""])[0]
                    keys = sorted(k for k in store if k.startswith(prefix))
                    after = qs.get("continuation-token", [""])[0]
                    if after:
                        keys = [k for k in keys if k > after]
                    trunc = len(keys) > page_size
                    page = keys[:page_size]
                    tail = ""
                    if trunc:
                        tail = ("<IsTruncated>true</IsTruncated>"
                                "<NextContinuationToken>"
                                f"{_escape_xml(page[-1])}"
                                "</NextContinuationToken>")
                    else:
                        tail = "<IsTruncated>false</IsTruncated>"
                    body = ("<?xml version=\"1.0\"?><ListBucketResult>"
                            + "".join(f"<Contents><Key>{_escape_xml(k)}"
                                      "</Key></Contents>" for k in page)
                            + tail + "</ListBucketResult>").encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/xml")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                key = self._key()
                data = store.get(key)
                if data is None:
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                rng = self.headers.get("Range")
                status = 200
                if rng and rng.startswith("bytes="):
                    lo, _, hi = rng[6:].partition("-")
                    lo = int(lo or 0)
                    hi = int(hi) if hi else len(data) - 1
                    data = data[lo:hi + 1]
                    status = 206
                self.send_response(status)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_HEAD(self):
                if not self._authed():
                    return self._deny()
                ok = self._key() in store
                self.send_response(200 if ok else 404)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def do_DELETE(self):
                if not self._authed():
                    return self._deny()
                existed = store.pop(self._key(), None) is not None
                self.send_response(204 if existed else 404)
                self.send_header("Content-Length", "0")
                self.end_headers()

        self.httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self.url = f"http://{host}:{self.port}"
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True)

    def start(self) -> "MiniBucketServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


def shard_prefix(db: str, rp: str, group_start: int) -> str:
    return f"shards/{db}/{rp}/{group_start}"
