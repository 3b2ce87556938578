"""Cluster-internal HTTP scheme + TLS client context.

The port of ``opengemini_tpu/utils/peers.py``, whole.

The reference exposes TLS options in lib/config (sql.go https-enabled /
certificate/private-key) applied to the httpd listener and to
inter-node transports; here one process-wide switch flips every peer
call site (raft messages, /internal/* data-plane, /cluster/* control)
to https with a shared ssl.SSLContext. Server-side wrapping lives in
server/http.py (HttpService tls=...); this module is the CLIENT half —
call sites build URLs with url() and open them with urlopen() so none
of them hard-code a scheme.
"""

from __future__ import annotations

import ssl
import urllib.request

_scheme = "http"
_context: ssl.SSLContext | None = None


def configure_tls(ca_file: str | None = None,
                  skip_verify: bool = False) -> None:
    """Switch peer traffic to https. `ca_file` trusts a private CA (the
    usual cluster deployment); `skip_verify` disables verification for
    self-signed lab setups (reference: insecure-skip-verify)."""
    global _scheme, _context
    ctx = ssl.create_default_context(cafile=ca_file)
    if skip_verify:
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    _scheme = "https"
    _context = ctx


def reset() -> None:
    """Back to plain http (tests)."""
    global _scheme, _context
    _scheme = "http"
    _context = None


def url(addr: str, path: str) -> str:
    """Peer URL under the configured scheme. `path` starts with '/'."""
    return f"{_scheme}://{addr}{path}"


def urlopen(req, timeout: float | None = None):
    """urllib.request.urlopen with the peer TLS context applied."""
    if timeout is None:
        return urllib.request.urlopen(req, context=_context)
    return urllib.request.urlopen(req, timeout=timeout, context=_context)
