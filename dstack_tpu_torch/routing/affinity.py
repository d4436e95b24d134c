"""Prefix-affinity: KV-cache-aware replica scoring for the router (the
port's copy of ``dstack_tpu.routing.affinity``: the same env reads and
the same hash, so both packages key a request alike).

The serve engine's prompt-prefix cache halves TTFT when a request
shares a chunk-aligned prefix with KV rows a replica still holds
(``serve/engine.py`` ``_prefix_registry``) — but the cache lives on
ONE replica, and a load-only picker scatters a returning chat session
across the fleet, so in a multi-replica service the win evaporates.
This module gives the router the missing signal:

- **Digest chain.** Every completions/chat payload is reduced to a
  chain of rolling hashes over its normalized prefix units (chat
  messages, or fixed-size blocks of a plain prompt). Turn *k+1* of a
  conversation extends turn *k*, so its chain REPEATS turn *k*'s
  digests as a head — matching the longest recorded digest finds the
  replica whose KV covers the deepest shared prefix, with zero
  payload retention (only 8-byte hashes are kept).
- **Session key.** The QoS-trusted ``X-DTPU-Tenant`` (proxy-asserted,
  never client-supplied) plus the conversation head digest identify a
  chat session across turns even when mid-conversation edits break
  the digest chain — a second, coarser affinity signal.
- **Bounded learning.** :class:`AffinityMap` learns digest → replica
  from the pool's own dispatch history (recorded on each successful
  forward), bounded by max-entries LRU + TTL so a session flood cannot
  grow it, and invalidated when a replica dies, drains, or leaves the
  pool — a mapping must never outlive the KV it points at.

The pool's ``pick()`` turns the lookup into a two-term score: the
affinity target wins unless its load exceeds the least-loaded
routable peer by more than a configurable imbalance cap (or a fresh
probe proves its prefix registry empty), in which case the pick falls
back to plain least-outstanding and the override is counted. See
``docs/guides/serving.md`` §10 for the operator-facing contract.

Import-light on purpose (stdlib only): unit tests and the docs
checker instantiate this without aiohttp or torch.
"""

import hashlib
import os
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Iterable, Optional, Tuple

# one digest per prefix unit, newest last; longer conversations only
# ever need the deepest few, and an unbounded chain over a pathological
# million-message payload would be its own flood vector
MAX_PREFIX_UNITS = 32

# plain-prompt requests hash in fixed blocks so "the same document plus
# a longer question" still shares a chain head with its earlier request
PROMPT_BLOCK_CHARS = 256


def _h(parent: bytes, unit: str) -> bytes:
    """One rolling-hash step: digest of (previous digest ‖ unit)."""
    d = hashlib.blake2b(digest_size=8)
    d.update(parent)
    d.update(unit.encode("utf-8", "surrogatepass"))
    return d.digest()


def _normalize(role: object, content: object) -> str:
    """Whitespace-insensitive message identity: retried clients and
    template re-renders must not fork the chain over trailing space."""
    return f"{role}\x1f{' '.join(str(content or '').split())}"


@dataclass(frozen=True)
class AffinityKey:
    """One request's affinity identity: the prefix digest chain
    (shallowest first, deepest last) and the tenant-scoped session
    key. ``digests`` may be empty (unparseable prompt); ``session``
    is None when the edge asserted no tenant."""

    digests: Tuple[str, ...]
    session: Optional[str] = None


def chain_digests(units: Iterable[str]) -> Tuple[str, ...]:
    """Rolling-hash chain over ``units`` (capped at
    :data:`MAX_PREFIX_UNITS`): element *i* identifies the prefix
    ``units[:i+1]``, so two payloads share element *i* iff their
    first *i+1* units match exactly."""
    out = []
    parent = b"dtpu-affinity-v1"
    for unit in units:
        if len(out) >= MAX_PREFIX_UNITS:
            break
        parent = _h(parent, unit)
        out.append(parent.hex())
    return tuple(out)


def payload_units(path: str, payload: dict) -> list:
    """The payload's prefix units, or ``[]`` when the request has no
    meaningful prompt prefix (non-completion path, malformed body)."""
    leaf = path.rstrip("/")
    if leaf.endswith("chat/completions"):
        messages = payload.get("messages")
        if not isinstance(messages, list):
            return []
        units = []
        for m in messages:
            if not isinstance(m, dict):
                return []
            units.append(_normalize(m.get("role"), m.get("content")))
        return units
    if leaf.endswith("completions"):
        prompt = payload.get("prompt")
        if not isinstance(prompt, str) or not prompt:
            return []
        return [
            prompt[i: i + PROMPT_BLOCK_CHARS]
            for i in range(0, len(prompt), PROMPT_BLOCK_CHARS)
        ]
    return []


def request_affinity(
    path: str, payload: Optional[dict], tenant: Optional[str] = None
) -> Optional[AffinityKey]:
    """→ the request's :class:`AffinityKey`, or None when it carries
    nothing to be affine to. The session key hashes the tenant with
    the conversation head (first two units — a shared system prompt
    alone must not glue every conversation of a tenant into one
    session)."""
    if not isinstance(payload, dict):
        return None
    units = payload_units(path, payload)
    if not units:
        return None
    digests = chain_digests(units)
    session = None
    if tenant:
        head = digests[min(1, len(digests) - 1)]
        session = _h(b"dtpu-session-v1", f"{tenant}\x1f{head}").hex()
    return AffinityKey(digests=digests, session=session)


def _env_flag(name: str, default: str) -> bool:
    return os.getenv(name, default).strip().lower() not in ("0", "false", "no")


def _env_num(name: str, default: float, cast=float):
    try:
        return cast(os.getenv(name, "").strip() or default)
    except (TypeError, ValueError):
        return cast(default)


@dataclass
class AffinityConfig:
    """Knobs for the affinity map and the pick-time score, read once
    per pool from ``DTPU_ROUTER_AFFINITY_*`` (documented in
    docs/reference/server.md)."""

    enabled: bool = True
    # a hot replica may carry at most this many more outstanding
    # requests than the least-loaded routable peer before affinity is
    # overridden back to load balancing
    max_imbalance: int = 4
    max_entries: int = 4096  # digest+session entries per pool
    ttl_seconds: float = 600.0  # KV registries churn; stale hints lie

    @classmethod
    def from_env(cls) -> "AffinityConfig":
        return cls(
            enabled=_env_flag("DTPU_ROUTER_AFFINITY", "1"),
            max_imbalance=max(
                0, _env_num("DTPU_ROUTER_AFFINITY_MAX_IMBALANCE", 4, int)
            ),
            max_entries=max(
                1, _env_num("DTPU_ROUTER_AFFINITY_MAP_SIZE", 4096, int)
            ),
            ttl_seconds=max(
                1.0, _env_num("DTPU_ROUTER_AFFINITY_TTL", 600.0, float)
            ),
        )


@dataclass
class AffinityMap:
    """Bounded LRU(+TTL) of digest/session → replica_id, learned from
    dispatch history. One per :class:`~dstack_tpu_torch.routing.pool.ReplicaPool`;
    single event loop, no locking (same concurrency contract as the
    pool itself)."""

    config: AffinityConfig = field(default_factory=AffinityConfig.from_env)
    _entries: "OrderedDict[str, tuple[str, float, float]]" = field(
        default_factory=OrderedDict
    )

    def __len__(self) -> int:
        return len(self._entries)

    def record(self, key: Optional[AffinityKey], replica_id: str) -> None:
        """Learn that ``replica_id`` now holds the KV for every prefix
        in ``key`` (it just served the request end-to-end)."""
        if key is None or not self.config.enabled:
            return
        now = time.monotonic()
        expires = now + self.config.ttl_seconds
        for digest in key.digests:
            self._put(digest, replica_id, expires, now)
        if key.session is not None:
            self._put(key.session, replica_id, expires, now)

    def _put(
        self, k: str, replica_id: str, expires: float, recorded_at: float
    ) -> None:
        self._entries[k] = (replica_id, expires, recorded_at)
        self._entries.move_to_end(k)
        while len(self._entries) > self.config.max_entries:
            self._entries.popitem(last=False)

    def lookup(self, key: Optional[AffinityKey]) -> Optional[str]:
        """The replica that most recently served this request's
        DEEPEST known prefix (longest digest first, session key as
        the coarse fallback). Expired entries are dropped on the way."""
        hit = self.lookup_entry(key)
        return hit[0] if hit is not None else None

    def lookup_entry(
        self, key: Optional[AffinityKey]
    ) -> Optional[Tuple[str, float]]:
        """Like :meth:`lookup`, but → ``(replica_id, recorded_at)`` so
        the picker can compare mapping age against probe age (a probe
        OLDER than the mapping says nothing about the KV it promised)."""
        if key is None or not self.config.enabled:
            return None
        now = time.monotonic()
        probes = list(reversed(key.digests))
        if key.session is not None:
            probes.append(key.session)
        for k in probes:
            hit = self._entries.get(k)
            if hit is None:
                continue
            rid, expires, recorded_at = hit
            if now >= expires:
                del self._entries[k]
                continue
            self._entries.move_to_end(k)
            return rid, recorded_at
        return None

    def invalidate_replica(self, replica_id: str) -> None:
        """Forget every mapping to ``replica_id`` — its KV is gone
        (death) or about to be (drain/teardown). O(map) but the map is
        bounded and replica death is not the hot path."""
        for k in [
            k for k, (rid, _, _) in self._entries.items()
            if rid == replica_id
        ]:
            del self._entries[k]

    def clear(self) -> None:
        self._entries.clear()
