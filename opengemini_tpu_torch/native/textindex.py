"""Full-text index binding (native/textindex.cpp) and the token rules of
``match(field, 'token')``.

The port of ``opengemini_tpu/native/textindex.py``. ``tokenize`` is the
tokenizer the shard's text-index sidecars (storage/shard.py ``.tidx``)
and the row filter share, ``query_grams`` the lookup tokens of a search
term and ``match_token`` the row mask of ``WHERE match(f, 'term')``.
``TextIndex`` binds the repository's ``native/textindex.cpp``, which the
port builds with ``native.build_shared`` into ``build/native/`` at first
use; a build that fails raises (the reference falls back to Python when
its library is absent; the port does not). ``PlainTextIndex`` is the
pure-Python search, the plain version the tests hold ``TextIndex`` to.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from opengemini_tpu_torch import native

_LIB = None
_lib_lock = threading.Lock()


def load():
    """The text-index library, built and bound at first use."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _lib_lock:
        if _LIB is None:
            lib = ctypes.CDLL(native.build_shared("textindex.cpp"))
            lib.ogt_text_index_new.restype = ctypes.c_void_p
            lib.ogt_text_index_free.argtypes = [ctypes.c_void_p]
            lib.ogt_text_index_add.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p,
                ctypes.c_int64]
            lib.ogt_text_index_search.restype = ctypes.c_int64
            lib.ogt_text_index_search.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int64]
            lib.ogt_text_index_tokens.restype = ctypes.c_int64
            lib.ogt_text_index_tokens.argtypes = [ctypes.c_void_p]
            _LIB = lib
    return _LIB


def _search_grams(search_one, token: str) -> np.ndarray:
    """Doc ids matching a term. Multi-gram terms (CJK strings, mixed
    script) intersect their non-ASCII grams' postings (ASCII fragments
    may sit inside longer tokens); a pure-ASCII multi-token term needs
    every token. ASCII lowercases; non-ASCII is byte-exact."""
    grams = query_grams(token)
    if len(grams) > 1:
        out = None
        for g in grams:
            if g.isascii():
                continue
            ids = set(search_one(g).tolist())
            out = ids if out is None else out & ids
        if out is None:
            for g in grams:
                ids = set(search_one(g).tolist())
                out = ids if out is None else out & ids
        return np.asarray(sorted(out or ()), dtype=np.int64)
    return search_one(token.lower() if token.isascii() else token)


class TextIndex:
    """Inverted token index over documents, in native/textindex.cpp."""

    def __init__(self) -> None:
        self._lib = load()
        self._h = self._lib.ogt_text_index_new()

    def add(self, doc_id: int, text: str) -> None:
        b = text.encode("utf-8", errors="replace")
        self._lib.ogt_text_index_add(self._h, doc_id, b, len(b))

    def _search_one(self, token: str) -> np.ndarray:
        b = token.encode("utf-8", errors="replace")
        cap = 1024
        while True:
            out = np.empty(cap, dtype=np.int64)
            n = self._lib.ogt_text_index_search(self._h, b, len(b),
                                                out.ctypes.data, cap)
            if n <= cap:
                return out[:n].copy()
            cap = int(n)

    def search(self, token: str) -> np.ndarray:
        return _search_grams(self._search_one, token)

    def token_count(self) -> int:
        return int(self._lib.ogt_text_index_tokens(self._h))

    def close(self) -> None:
        if self._h:
            self._lib.ogt_text_index_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


class PlainTextIndex:
    """The pure-Python search: TextIndex's plain version."""

    def __init__(self) -> None:
        self._post: dict[str, list[int]] = {}

    def add(self, doc_id: int, text: str) -> None:
        for tok in set(tokenize(text)):
            self._post.setdefault(tok, []).append(doc_id)

    def _search_one(self, token: str) -> np.ndarray:
        return np.asarray(sorted(self._post.get(token, [])), dtype=np.int64)

    def search(self, token: str) -> np.ndarray:
        return _search_grams(self._search_one, token)

    def token_count(self) -> int:
        return len(self._post)


def tokenize(text: str) -> list[str]:
    """ASCII alnum runs of 2 or more characters, lowercased, plus one
    gram per non-ASCII character (CJK text indexes per character), the
    same tokens as the C++ tokenizer over utf-8 input."""
    out: list[str] = []
    cur: list[str] = []
    for ch in text:
        if ch.isascii():
            if ch.isalnum():
                cur.append(ch.lower())
                continue
            if len(cur) >= 2:
                out.append("".join(cur))
            cur = []
        else:
            if len(cur) >= 2:
                out.append("".join(cur))
            cur = []
            out.append(ch)
    if len(cur) >= 2:
        out.append("".join(cur))
    return out


def query_grams(term: str) -> list[str]:
    """Index lookup tokens for one match() search term: its own
    tokenization (a multi-character CJK term becomes several grams that
    the caller intersects)."""
    return tokenize(term)


def match_token(values: np.ndarray, valid: np.ndarray,
                token: str) -> np.ndarray:
    """Row mask for WHERE match(f, 'term'). ASCII terms match whole
    tokens case-insensitively; terms with non-ASCII characters match as
    exact substrings (the index never case-folds non-ASCII, so the row
    filter must not either, or pruning would drop rows the filter
    accepts)."""
    has_cjk = not token.isascii()
    term = token if has_cjk else token.lower()
    out = np.zeros(len(values), dtype=np.bool_)
    for i, v in enumerate(values):
        if not (valid[i] and isinstance(v, str)):
            continue
        if has_cjk:
            out[i] = term in v
        else:
            out[i] = term in tokenize(v)
    return out
