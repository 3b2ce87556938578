"""User accounts + privileges.

The port of ``opengemini_tpu/meta/users.py``, whole, with a plain
``threading`` lock; users.json and the PBKDF2 credentials are the JAX
package's. Reference: the influx meta user model (lib/util/lifted/influx/meta
data.go users; httpd auth in handler.go). Passwords are salted
PBKDF2-SHA256; privileges are per-database READ/WRITE/ALL plus a global
admin flag. Persisted in users.json next to the engine meta (atomic
replace).
"""

from __future__ import annotations

import hashlib
import json
import os
import secrets
import threading

from opengemini_tpu_torch.utils import lockdep

READ = "READ"
WRITE = "WRITE"
ALL = "ALL"

_ITERS = 20_000


class AuthError(Exception):
    pass


class User:
    def __init__(self, name: str, salt: str, pw_hash: str, admin: bool = False,
                 privileges: dict[str, str] | None = None):
        self.name = name
        self.salt = salt
        self.pw_hash = pw_hash
        self.admin = admin
        self.privileges = privileges or {}

    def check_password(self, password: str) -> bool:
        return secrets.compare_digest(_hash(password, self.salt), self.pw_hash)

    def can(self, action: str, db: str) -> bool:
        if self.admin:
            return True
        p = self.privileges.get(db)
        return p == ALL or p == action

    def to_json(self):
        return {
            "name": self.name, "salt": self.salt, "hash": self.pw_hash,
            "admin": self.admin, "privileges": self.privileges,
        }

    @classmethod
    def from_json(cls, j):
        return cls(j["name"], j["salt"], j["hash"], j.get("admin", False),
                   j.get("privileges", {}))


class UserStore:
    def __init__(self, path: str | None = None):
        self.path = path
        self._lock = lockdep.Lock()
        self.users: dict[str, User] = {}
        if path and os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                for j in json.load(f).get("users", []):
                    u = User.from_json(j)
                    self.users[u.name] = u

    def _save(self) -> None:
        if not self.path:
            return
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"users": [u.to_json() for u in self.users.values()]}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    # -- management ------------------------------------------------------

    def create(self, name: str, password: str, admin: bool = False) -> None:
        with self._lock:
            if name in self.users:
                raise AuthError(f"user already exists: {name}")
            salt = secrets.token_hex(16)
            self.users[name] = User(name, salt, _hash(password, salt), admin)
            self._save()

    def drop(self, name: str) -> None:
        with self._lock:
            if name not in self.users:
                raise AuthError(f"user not found: {name}")
            del self.users[name]
            self._save()

    def set_password(self, name: str, password: str) -> None:
        with self._lock:
            u = self.users.get(name)
            if u is None:
                raise AuthError(f"user not found: {name}")
            u.salt = secrets.token_hex(16)
            u.pw_hash = _hash(password, u.salt)
            self._save()

    def grant(self, name: str, db: str, privilege: str) -> None:
        with self._lock:
            u = self.users.get(name)
            if u is None:
                raise AuthError(f"user not found: {name}")
            u.privileges[db] = privilege
            self._save()

    def grant_admin(self, name: str, admin: bool = True) -> None:
        with self._lock:
            u = self.users.get(name)
            if u is None:
                raise AuthError(f"user not found: {name}")
            u.admin = admin
            self._save()

    def revoke(self, name: str, db: str) -> None:
        with self._lock:
            u = self.users.get(name)
            if u is None:
                raise AuthError(f"user not found: {name}")
            u.privileges.pop(db, None)
            self._save()

    # -- replicated application (raft listener path) ---------------------

    def restore_replicated(self, users_state: dict) -> None:
        """Rebuild the store from an FSM snapshot's user state (full
        credential material is carried in FSM state exactly so compacted
        histories can still produce a working replica)."""
        with self._lock:
            self.users = {}
            for name, u in users_state.items():
                if not u.get("salt") or not u.get("hash"):
                    continue  # flags-only entry from a pre-credential log
                self.users[name] = User(
                    name, u["salt"], u["hash"], u.get("admin", False),
                    dict(u.get("privileges", {})),
                )
            self._save()

    def apply_replicated(self, cmd: dict) -> None:
        """Enact a replicated user command carrying pre-computed salt/hash
        (hashes are computed once at propose time so every replica stores
        identical credentials). Idempotent by construction."""
        op = cmd.get("op")
        with self._lock:
            if op == "create_user":
                self.users[cmd["name"]] = User(
                    cmd["name"], cmd["salt"], cmd["hash"], cmd.get("admin", False)
                )
            elif op == "drop_user":
                self.users.pop(cmd["name"], None)
            elif op == "set_password":
                u = self.users.get(cmd["name"])
                if u is not None:
                    u.salt = cmd["salt"]
                    u.pw_hash = cmd["hash"]
            elif op == "grant":
                u = self.users.get(cmd["user"])
                if u is not None:
                    u.privileges[cmd["db"]] = cmd["privilege"]
            elif op == "revoke":
                u = self.users.get(cmd["user"])
                if u is not None:
                    u.privileges.pop(cmd["db"], None)
            elif op == "grant_admin":
                u = self.users.get(cmd["user"])
                if u is not None:
                    u.admin = cmd.get("admin", True)
            else:
                return
            self._save()

    @staticmethod
    def make_credentials(password: str) -> tuple[str, str]:
        """(salt, hash) for replication-time hashing."""
        salt = secrets.token_hex(16)
        return salt, _hash(password, salt)

    # -- authentication --------------------------------------------------

    def authenticate(self, name: str, password: str) -> User:
        u = self.users.get(name)
        if u is None or not u.check_password(password):
            raise AuthError("authorization failed")
        return u

    def __len__(self) -> int:
        return len(self.users)


def _hash(password: str, salt: str) -> str:
    return hashlib.pbkdf2_hmac(
        "sha256", password.encode("utf-8"), bytes.fromhex(salt), _ITERS
    ).hex()
