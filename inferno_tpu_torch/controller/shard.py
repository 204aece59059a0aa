"""Consistent-hash fleet partitioning for sharded controllers.

A million-variant fleet is too large for one controller process to
watch, collect, and solve alone. This module splits ownership of the
variant namespace across N controller replicas with rendezvous
(highest-random-weight) hashing: each variant name is owned by the
member whose `sha256(member || NUL || name)` digest is highest.

Why rendezvous rather than a token ring: ownership is a *pure function*
of the membership set and the name — no coordination, no persisted ring
state, no virtual-node tuning. Every controller that agrees on
`SHARD_MEMBERS` computes the identical partition independently, which is
what makes handoff deterministic:

- when a member **leaves**, exactly its names redistribute (every
  surviving member's score for every other name is unchanged);
- when a member **joins**, the only names that move are those whose new
  member's score beats the previous maximum — an expected 1/N of the
  fleet — and they all move *to* the joiner.

`handoff()` states those moves explicitly so tests (and operators) can
assert no variant is double-owned or orphaned across a membership
change.

Hashing is `hashlib.sha256`, never Python's builtin `hash()`:
PYTHONHASHSEED randomizes the latter per process, which would give each
controller replica a *different* partition of the same fleet — the exact
split-brain this module exists to prevent.

Configuration (both read at Reconciler construction):

- ``SHARD_MEMBERS`` — comma-separated member names; empty (default)
  disables sharding and the controller owns the whole fleet.
- ``SHARD_NAME`` — this replica's own member name; must appear in
  ``SHARD_MEMBERS`` when that is set.

Ownership is keyed by the variant's full name (``name:namespace``), the
same key the fleet snapshot and the event DirtyQueue use, so a shard's
owned set, its dirty set, and its solved set are all slices of one
namespace.

Port copy of `inferno_tpu/controller/shard.py`, verbatim apart from its imports.
"""

from __future__ import annotations

import hashlib
from typing import Iterable

from inferno_tpu_torch.config.defaults import env_str


class ShardMap:
    """Immutable rendezvous-hash partition over a member set.

    Members are deduplicated and sorted at construction so the map's
    identity is the membership *set*: two controllers configured with
    the same members in any order hold equal maps.
    """

    def __init__(self, members: Iterable[str]):
        names = sorted({m.strip() for m in members if m and m.strip()})
        if not names:
            raise ValueError("ShardMap needs at least one member")
        self.members: tuple[str, ...] = tuple(names)

    def __eq__(self, other) -> bool:
        return isinstance(other, ShardMap) and self.members == other.members

    def __hash__(self) -> int:
        return hash(self.members)

    def __repr__(self) -> str:
        return f"ShardMap({list(self.members)!r})"

    @staticmethod
    def _score(member: str, name: str) -> bytes:
        # NUL separator so ("ab","c") and ("a","bc") cannot collide into
        # the same preimage; member names and variant keys never contain
        # NUL (kube object names are DNS labels, keys are name:namespace)
        return hashlib.sha256(
            member.encode() + b"\x00" + name.encode()
        ).digest()

    def owner(self, name: str) -> str:
        """The member that owns `name` under the current membership.

        Ties on the digest are broken by member name — unreachable in
        practice (a tie is a sha256 collision) but it keeps the function
        total and deterministic on paper.
        """
        return max(self.members, key=lambda m: (self._score(m, name), m))

    def owned(self, names: Iterable[str], member: str) -> list[str]:
        """The sorted subset of `names` that `member` owns."""
        if member not in self.members:
            raise ValueError(f"{member!r} is not a member of {self!r}")
        return sorted(n for n in names if self.owner(n) == member)

    def partition(self, names: Iterable[str]) -> dict[str, list[str]]:
        """All of `names` split by owner: every member keys the dict
        (empty list when it owns nothing), every name appears in exactly
        one bucket, each bucket sorted."""
        buckets: dict[str, list[str]] = {m: [] for m in self.members}
        for n in sorted(set(names)):
            buckets[self.owner(n)].append(n)
        return buckets


def handoff(
    old: ShardMap, new: ShardMap, names: Iterable[str]
) -> list[tuple[str, str, str]]:
    """The deterministic move list for a membership change: sorted
    `(name, old_owner, new_owner)` for every name whose owner differs
    between the two maps. Names whose owner is unchanged do not appear —
    rendezvous hashing guarantees that is all but ~1/N of the fleet for
    a single join or leave."""
    moves: list[tuple[str, str, str]] = []
    for n in sorted(set(names)):
        a, b = old.owner(n), new.owner(n)
        if a != b:
            moves.append((n, a, b))
    return moves


def shard_from_env() -> tuple[ShardMap | None, str]:
    """The (map, self-name) pair from SHARD_MEMBERS / SHARD_NAME, or
    `(None, "")` when sharding is off. Misconfiguration — members set
    but SHARD_NAME missing or not a member — raises at construction
    rather than silently reconciling nothing (a controller that owns an
    empty slice looks healthy while its variants go unactuated)."""
    raw = env_str("SHARD_MEMBERS", "")
    members = [m.strip() for m in raw.split(",") if m.strip()]
    if not members:
        return None, ""
    name = env_str("SHARD_NAME", "")
    shard_map = ShardMap(members)
    if name not in shard_map.members:
        raise ValueError(
            f"SHARD_NAME={name!r} is not one of SHARD_MEMBERS "
            f"{list(shard_map.members)} — refusing to start a controller "
            f"that would own no variants"
        )
    return shard_map, name
