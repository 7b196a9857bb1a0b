"""RBAC, trimmed to the bootstrapped admin and Basic auth.

Counterpart of `parseable_tpu/rbac/__init__.py` (reference: src/rbac/):
the `Action`s the port's routes check, the admin role, scrypt password
hashes with a verified-credential cache, and `authorize`. Users beyond the
admin, roles, sessions, OIDC and API keys are later slices.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import os
import threading
from dataclasses import dataclass, field
from enum import Enum, auto


class Action(Enum):
    INGEST = auto()
    QUERY = auto()
    CREATE_STREAM = auto()
    DELETE_STREAM = auto()
    LIST_STREAM = auto()
    GET_SCHEMA = auto()
    GET_ABOUT = auto()
    ALL = auto()


@dataclass
class Permission:
    action: Action
    resource: str | None = None  # None = unit/global, "*" = all streams

    def allows(self, action: Action, resource: str | None) -> bool:
        if self.action not in (action, Action.ALL):
            return False
        if self.resource in (None, "*") or resource is None:
            return True
        return self.resource == resource


def role_privileges(privilege: str, resource: str | None = None) -> list[Permission]:
    """A role's permission list (reference: RoleBuilder role.rs:92-190);
    only the admin role is ported."""
    if privilege == "admin":
        return [Permission(Action.ALL, "*")]
    raise ValueError(f"privilege {privilege!r} is not supported by this server yet")


def hash_password(password: str, salt: bytes | None = None) -> str:
    salt = salt or os.urandom(16)
    digest = hashlib.scrypt(password.encode(), salt=salt, n=2**14, r=8, p=1)
    return base64.b64encode(salt).decode() + "$" + base64.b64encode(digest).decode()


def verify_password(password: str, stored: str) -> bool:
    try:
        salt_b64, digest_b64 = stored.split("$", 1)
        salt = base64.b64decode(salt_b64)
        expected = base64.b64decode(digest_b64)
    except ValueError:
        return False
    digest = hashlib.scrypt(password.encode(), salt=salt, n=2**14, r=8, p=1)
    return hmac.compare_digest(digest, expected)


@dataclass
class User:
    username: str
    password_hash: str
    roles: set[str] = field(default_factory=set)


class RbacStore:
    """In-memory users and roles (reference: global USERS/ROLES maps,
    map.rs)."""

    def __init__(self) -> None:
        self.users: dict[str, User] = {}  # guarded-by: self._lock
        self.roles: dict[str, list[Permission]] = {}  # guarded-by: self._lock
        # verified-credential cache: scrypt costs tens of ms by design, too
        # much per ingest request; a fast hash of (user, password) is cached
        # after the first successful verification
        self._cred_cache: dict[str, bytes] = {}  # guarded-by: self._lock
        self._lock = threading.RLock()

    def put_role(self, name: str, perms: list[Permission]) -> None:
        with self._lock:
            self.roles[name] = perms

    def try_cached_authenticate(self, username: str, password: str) -> tuple[User | None, bool]:
        """`(user_or_None, True)` when the credential cache can answer,
        `(None, False)` when the scrypt verification is needed (the HTTP
        middleware runs that off the event loop)."""
        with self._lock:
            u = self.users.get(username)
            cached = self._cred_cache.get(username)
        if u is None:
            return None, True
        if cached is None:
            return None, False
        fast = hashlib.sha256(f"{username}\x00{password}".encode()).digest()
        return (u if hmac.compare_digest(cached, fast) else None), True

    def authenticate(self, username: str, password: str) -> User | None:
        user, decided = self.try_cached_authenticate(username, password)
        if decided:
            return user
        with self._lock:
            u = self.users.get(username)
        if u is None or not verify_password(password, u.password_hash):
            return None
        fast = hashlib.sha256(f"{username}\x00{password}".encode()).digest()
        with self._lock:
            self._cred_cache[username] = fast
        return u

    def authorize(self, username: str, action: Action, resource: str | None = None) -> bool:
        """(reference: Users.authorize mod.rs:242-292)"""
        with self._lock:
            u = self.users.get(username)
            if u is None:
                return False
            return any(
                perm.allows(action, resource)
                for role_name in u.roles
                for perm in self.roles.get(role_name, [])
            )


def bootstrap_admin(store: RbacStore, username: str, password: str) -> None:
    """Root user from P_USERNAME/P_PASSWORD (reference: rbac/map.rs:105)."""
    store.put_role("admin", role_privileges("admin"))
    with store._lock:
        store.users[username] = User(
            username=username, password_hash=hash_password(password), roles={"admin"}
        )
