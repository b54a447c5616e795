"""Versioned consistent-hash placement ring — elastic membership's map.

The reference fleet is fixed (4 clients x 1 server) and `ReplicaGroup`'s
original key→replica-set map was a static `hash % N`: correct while N
never changes, but a join/leave under that map MOVES ~(N-1)/N of the key
space — every rejoin would be a full reshuffle. "Consistent RDMA-Friendly
Hashing on Remote Persistent Memory" (arxiv 2107.06836) gives the
production shape this module reproduces host-side:

- **Virtual nodes.** Every member owns `vnodes` pseudo-random points on
  a u64 ring (murmur3 of (member, replica-index), two salted lanes
  folded to 64 bits so position collisions are negligible). More vnodes
  ⇒ smoother load spread and smaller per-transition variance.
- **Owner sets.** A key hashes to a ring position; its owner set is the
  first `rf` DISTINCT members walking clockwise. A single join/leave
  therefore moves only the arcs the changed member's vnodes cover —
  ~1/N of the key space in expectation (`tests/test_elastic.py` measures
  the bound).
- **Epochs.** Rings are IMMUTABLE; `join`/`leave`/`replace` return a new
  ring with `epoch + 1`. The epoch is the membership generation the
  migration engine, the flight recorder, and the wire's `MSG_RINGNOTE`
  verb all speak; monotonicity is load-bearing (a dual-read window is
  keyed on exactly one (old, new) epoch pair).
- **Batch resolution.** `owners_np` is numpy-vectorized like
  `shard_of_np` (`parallel/partitioning.py`): one `searchsorted` into
  the sorted vnode positions plus one gather from a precomputed
  per-vnode preference table — no per-key Python. The scalar
  `owner_set` exists only as the identity oracle the tests pin the
  batch resolver against.

The ring is pure data (no locks, no I/O, numpy-only): `ReplicaGroup`
swaps whole-ring references under its own lock and `cluster/migrate.py`
diffs two rings to compute the moved key ranges.
"""

from __future__ import annotations

import numpy as np

from pmdfc_tpu_torch.utils.hashing_np import hash_u64_np

# second-lane salt: two independent 32-bit murmur lanes fold into one
# u64 ring position, putting same-position collisions at the 2^-64 class
_LANE2 = 0x9E37_79B9


def _u64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    return ((np.asarray(hi, np.uint64) << np.uint64(32))
            | np.asarray(lo, np.uint64))


def key_pos(keys: np.ndarray, seed: int) -> np.ndarray:
    """[B, 2] u32 longkeys -> u64 ring positions. Depends only on the
    ring SEED, never on membership — every epoch of one ring family
    places a key at the same position, which is what makes the moved
    set exactly the changed arcs."""
    keys = np.asarray(keys, np.uint32).reshape(-1, 2)
    hi = hash_u64_np(keys[:, 0], keys[:, 1], seed=seed)
    lo = hash_u64_np(keys[:, 1], keys[:, 0], seed=seed ^ _LANE2)
    return _u64(hi, lo)


class HashRing:
    """Immutable consistent-hash ring over integer member ids.

    `members` are the stable endpoint SLOT ids of `ReplicaGroup`
    (indexes into its endpoint list — slots are never reused, so a
    member id means the same endpoint across every epoch). Resolution:

        ring.owners_np(keys, rf)  -> [B, rf] member ids, primary first
        ring.owner_set(key, rf)   -> tuple (scalar oracle, tests only)

    Mutations return a NEW ring: `join(m)`, `leave(m)`,
    `replace(old, new)` — each bumps `epoch` by exactly one.
    """

    def __init__(self, members, vnodes: int = 64, seed: int = 0x51C0_C0DE,
                 epoch: int = 1):
        members = tuple(sorted(int(m) for m in members))
        if len(set(members)) != len(members):
            raise ValueError("duplicate ring members")
        if not members:
            raise ValueError("a ring needs at least one member")
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        self.members = members
        self.vnodes = int(vnodes)
        self.seed = int(seed)
        self.epoch = int(epoch)
        n = len(members)
        marr = np.repeat(np.asarray(members, np.uint32), vnodes)
        jarr = np.tile(np.arange(vnodes, dtype=np.uint32), n)
        pos = _u64(hash_u64_np(marr, jarr, seed=self.seed),
                   hash_u64_np(jarr, marr, seed=self.seed ^ _LANE2))
        # deterministic total order: position, then member id breaks the
        # (astronomically unlikely) u64 tie the same way on every build
        order = np.lexsort((marr, pos))
        self._pos = pos[order]
        self._own = marr[order].astype(np.int64)
        # per-vnode preference table: tab[i] = the first n DISTINCT
        # members walking clockwise from vnode i — owners_np is then one
        # searchsorted + one row gather. V = n * vnodes stays small
        # (fleet-scale, not key-scale), so the build loop is cheap and
        # runs once per membership change.
        V = len(self._pos)
        tab = np.empty((V, n), np.int64)
        for i in range(V):
            seen: list[int] = []
            k = i
            while len(seen) < n:
                o = int(self._own[k % V])
                if o not in seen:
                    seen.append(o)
                k += 1
            tab[i] = seen
        self._tab = tab

    # -- resolution --

    def positions(self, keys: np.ndarray) -> np.ndarray:
        return key_pos(keys, self.seed)

    def owners_np(self, keys: np.ndarray, rf: int) -> np.ndarray:
        """[B, rf] owner slots per key, primary first, all distinct —
        the numpy batch resolver the serving path routes through."""
        rf = min(int(rf), len(self.members))
        p = self.positions(keys)
        # successor vnode: first position >= the key's, wrapping past
        # the top of the ring back to vnode 0
        idx = np.searchsorted(self._pos, p, side="left") % len(self._pos)
        return self._tab[idx, :rf]

    def owner_set(self, key, rf: int) -> tuple:
        """Scalar resolution of ONE (hi, lo) key — the identity oracle
        `owners_np` is tested against, never the serving path."""
        k = np.asarray([key], np.uint32).reshape(1, 2)
        return tuple(int(x) for x in self.owners_np(k, rf)[0])

    # -- membership (immutable: each op returns a new ring, epoch + 1) --

    def _with_members(self, members) -> "HashRing":
        return HashRing(members, vnodes=self.vnodes, seed=self.seed,
                        epoch=self.epoch + 1)

    def join(self, member: int) -> "HashRing":
        member = int(member)
        if member in self.members:
            raise ValueError(f"member {member} already on the ring")
        return self._with_members((*self.members, member))

    def leave(self, member: int) -> "HashRing":
        member = int(member)
        if member not in self.members:
            raise ValueError(f"member {member} not on the ring")
        if len(self.members) == 1:
            raise ValueError("cannot remove the last ring member")
        return self._with_members(m for m in self.members if m != member)

    def rejoin(self, member: int) -> "HashRing":
        """Same members, one epoch bump — the warm-restart transition.
        A member that crashed and came back with its snapshot chain +
        journal tail owns the same arcs it did before, but every epoch
        pair must still be distinct so in-flight migration plans keyed
        on (old, new) epochs cannot be replayed across the restart."""
        member = int(member)
        if member not in self.members:
            raise ValueError(f"member {member} not on the ring")
        return self._with_members(self.members)

    def replace(self, old: int, new: int) -> "HashRing":
        """Swap one member for another in ONE epoch bump — the
        failed-server-replacement transition (arcs of `old` move to
        `new`, everyone else's keys stay put)."""
        old, new = int(old), int(new)
        if old not in self.members:
            raise ValueError(f"member {old} not on the ring")
        if new in self.members:
            raise ValueError(f"member {new} already on the ring")
        return self._with_members(
            new if m == old else m for m in self.members)

    # -- introspection --

    def describe(self) -> dict:
        """Ring card for logs/flight events: epoch, members, vnode
        count, and the per-member arc share (load-spread diagnostic)."""
        V = len(self._pos)
        pos = self._pos.astype(np.float64)
        arcs = np.empty(V)
        arcs[:-1] = np.diff(pos)
        arcs[-1] = 2.0 ** 64 - pos[-1] + pos[0]  # wrap arc
        share = {int(m): 0.0 for m in self.members}
        # arc [pos[i], pos[i+1]) belongs to the SUCCESSOR vnode i+1
        for i in range(V):
            share[int(self._own[(i + 1) % V])] += arcs[i]
        tot = sum(share.values()) or 1.0
        return {
            "epoch": self.epoch,
            "members": list(self.members),
            "vnodes": self.vnodes,
            "share": {m: round(s / tot, 4) for m, s in share.items()},
        }

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return (f"HashRing(epoch={self.epoch}, members={self.members}, "
                f"vnodes={self.vnodes})")


def moved_mask(old: "HashRing", new: "HashRing", keys: np.ndarray,
               rf: int) -> np.ndarray:
    """[B] bool: keys whose owner SET changed between two ring epochs —
    the migration candidate predicate AND the `miss_routed` attribution
    predicate (a miss mid-window on a moved key is a routing casualty,
    not a cold/remote miss)."""
    mo = np.sort(old.owners_np(keys, rf), axis=1)
    mn = np.sort(new.owners_np(keys, rf), axis=1)
    if mo.shape[1] != mn.shape[1]:
        # rf clamps to the smaller fleet: any key is "moved" when the
        # set WIDTH itself changed (grow from under-replicated is a move)
        return np.ones(len(mo), bool)
    return (mo != mn).any(axis=1)
