"""Checkpoint / restore of KV state (twin of `pmdfc_tpu/checkpoint.py`).

Reference: the PMEM build persists every index mutation with
`mfence → clflush → mfence` (`server/util/persist.h:26-44`), publishes slots
crash-atomically via value-before-key SENTINEL ordering
(`server/CCEH_hybrid.cpp:158-162`), and repairs the directory on restart
(`CCEH::Recovery` :391-410).

Device memory is not persistent, so persistence is snapshot-based:
host-side atomic snapshots of every state leaf (write-temp + rename, the
file-level analog of the crash-atomic publication ordering), and the
index's `recovery` repair runs on load.

The file is the JAX package's format v2, member for member: `leaf_{i}` in
that package's `jax.tree.leaves` order of the admission-stripped state,
`__integrity__` (one CRC32 per leaf over its dtype, shape and bytes),
`__meta__` (version, each leaf's dotted name, dtype and shape, the chain
linkage) and, for a delta, `__delta_rows__` / `__delta_pages__`. Leaf
names and dtypes come from `carry.py` (u32 words as numpy uint32), so a
snapshot or a chain written by either package restores in the other, and
the refusals (`CheckpointCorruptError`, `SnapshotChainError`, the named
shape refusals) read the same.

Delta chains: `save_delta` writes only the pool rows whose at-rest digest
(or tier liveness) changed since the chain's previous member; every other
leaf ships whole. Members are bound by `(chain_id, seq, prev_crc)`, where
`prev_crc` is the CRC of the previous member's manifest.

What differs from the JAX module is where the bytes go, since the pool is
an 8 GiB tensor on the card:

- a leaf crosses to the host once, with one device-to-host copy per leaf
  (`carry.leaf_to_numpy`, a u32 view, never a conversion), and every CRC
  runs over a view of the array, not over a `.tobytes()` copy; the
  writers read leaves through a source (`StateLeaves` for one state; the
  sharded plane passes its own, whose leaves stack the shards'
  `[n_shards, ...]`);
- a delta gathers its dirty rows on the device, and only those rows cross;
- `materialize_chain` folds each delta in place into the page leaf it
  read, without a copy of the leaf;
- a restore takes the leaf names and shapes from a skeleton on the `meta`
  device (no pool is allocated for it), hands the freshly read arrays to
  the device without a further host copy (`carry.state_from_numpy(...,
  consume=True)`), and builds the admission gate's fresh leaves alone.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
import zipfile
import zlib

import numpy as np
import torch

from pmdfc_tpu_torch import carry
from pmdfc_tpu_torch import kv as kv_mod
from pmdfc_tpu_torch import tier as tier_mod
from pmdfc_tpu_torch.config import KVConfig
from pmdfc_tpu_torch.models.base import get_index_ops
from pmdfc_tpu_torch.utils import u32

_MANIFEST = "__integrity__"
_META = "__meta__"
_DELTA_ROWS = "__delta_rows__"
_DELTA_PAGES = "__delta_pages__"
FORMAT_VERSION = 2
# the one leaf delta snapshots ship partially (the page store dominates
# snapshot bytes; everything else ships whole in every chain member)
_DELTA_LEAF = "pool.pages"

_ADMIT_LEAVES = ("admit_cm", "admit_door", "admit_ops", "admit_thresh",
                 "admit_stats")


def strip_admission(state):
    """Drop the TinyLFU admission-gate leaves from a `KVState` (a no-op
    unless its pool is a gated `TierState`).

    The sketch is VOLATILE BY CONTRACT: it restarts empty across
    snapshot/restore and the live threshold restarts at its config
    default. Stripping at the (de)serialize boundary makes snapshot bytes
    IDENTICAL with or without the gate, so restores never refuse over it
    in either direction."""
    pool = getattr(state, "pool", None)
    if not isinstance(pool, tier_mod.TierState) or pool.admit_cm is None:
        return state
    return dataclasses.replace(
        state, pool=dataclasses.replace(
            pool, **{k: None for k in _ADMIT_LEAVES}))


def transplant_admission(state, config: KVConfig):
    """Fresh (empty) admission leaves, built from `config` on the state's
    device, onto a restored state whose gate was stripped. No-op when the
    config carries no gate. (The JAX twin takes them off a whole live
    `kv.init` skeleton; here only the gate's leaves are built.)"""
    pool = getattr(state, "pool", None)
    tier = config.tier
    if not isinstance(pool, tier_mod.TierState) or tier is None \
            or tier.admit is None:
        return state
    return dataclasses.replace(state, pool=dataclasses.replace(
        pool, **tier_mod.init_admission(tier.admit, pool.pages.device)))


class CheckpointCorruptError(RuntimeError):
    """The snapshot file is torn or corrupt — truncated archive, an
    unreadable member, a missing integrity manifest, or leaf bytes whose
    digest no longer matches what `save` recorded. Restoring such a file
    would serve partial/wrong state as if it were durable; callers must
    treat it like a missing snapshot (cold start or an older snapshot),
    never a best-effort restore."""


class SnapshotChainError(ValueError):
    """The chain's members are individually intact but do not form one
    contiguous history: a delta is missing, out of order, from another
    chain, or its `prev_crc` does not match the member it claims to
    follow. Restoring past the break would resurrect rows the later
    history overwrote or deleted — the whole chain is refused."""


def leaf_names(state) -> list:
    """Dotted path per leaf of the SERIALIZED state (admission stripped),
    in the JAX package's `jax.tree.leaves` order — the vocabulary of v2
    manifests and their named refusals (`pool.pages`, `index.keys`,
    `stats`, ...)."""
    return [n for n, _ in carry.leaves(strip_admission(state))]


def _view(a: np.ndarray) -> np.ndarray:
    """A leaf's bytes as a flat uint8 view (no copy when contiguous)."""
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _leaf_crc(a: np.ndarray) -> int:
    """CRC32 over a leaf's dtype, shape, and raw bytes — the unit the
    integrity manifest records per leaf."""
    meta = f"{a.dtype.str}:{a.shape}".encode()
    return zlib.crc32(_view(a), zlib.crc32(meta))


def _write_npz(path: str, arrays: dict) -> None:
    """The crash-atomic publication discipline every snapshot kind
    shares: temp file in the same dir + fsync + atomic rename +
    directory fsync (the file-level analog of the reference's
    value-before-key SENTINEL ordering, `server/CCEH_hybrid.cpp:158-162`)."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)  # atomic publication (the rename "clflush")
        # the rename itself must reach disk for crash durability
        dfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _meta_blob(kind: str, names: list, arrays: dict, chain: dict | None,
               delta: dict | None = None) -> np.ndarray:
    doc = {
        "version": FORMAT_VERSION,
        "kind": kind,
        "leaves": [
            {"name": n,
             "dtype": (delta["dtype"] if delta is not None
                       and n == delta["leaf"] else arrays[f"leaf_{i}"].dtype.str),
             "shape": (delta["full_shape"] if delta is not None
                       and n == delta["leaf"]
                       else list(arrays[f"leaf_{i}"].shape))}
            for i, n in enumerate(names)],
        "chain": chain,
        "delta": delta,
    }
    return np.frombuffer(json.dumps(doc, sort_keys=True).encode("utf-8"),
                         np.uint8)


class StateLeaves:
    """The serialized leaves of one `KVState` (admission stripped), as
    the writers read them: `names`, `shape(i)`, `host(i)` (the leaf on the
    host, one device-to-host copy, a u32 view) and `gather_rows(i, rows)`
    (rows of the leaf viewed as `[-1, W]`, gathered on its device and
    then copied). The sharded plane hands the writers its own source of
    the same shape, whose leaves are stacked over the shards."""

    def __init__(self, state):
        named = carry.leaves(strip_admission(state))
        self.names = [n for n, _ in named]
        self._t = [t for _, t in named]

    def shape(self, i: int) -> tuple:
        return tuple(self._t[i].shape)

    def host(self, i: int) -> np.ndarray:
        return carry.leaf_to_numpy(self.names[i], self._t[i])

    def gather_rows(self, i: int, rows: np.ndarray) -> np.ndarray:
        t = self._t[i]
        flat = t.reshape(-1, t.shape[-1])
        return u32.to_numpy(flat[torch.from_numpy(rows).to(flat.device)])


def _source(state):
    return state if hasattr(state, "gather_rows") else StateLeaves(state)


def save(state: kv_mod.KVState, path: str, chain: dict | None = None) -> int:
    """Crash-safe full snapshot: temp file in the same dir + fsync +
    atomic rename + directory fsync, with a per-leaf CRC32 manifest
    embedded so `load` can prove the bytes it reads are the bytes that
    were written, and a v2 `__meta__` member naming every leaf. `chain`
    (optional) records `{"id", "seq", "prev_crc"}` linkage when this
    full starts a snapshot chain. Returns the manifest CRC — the
    `prev_crc` the chain's next member must carry.

    The TinyLFU admission sketch is NOT serialized (`strip_admission`).
    Callers that share the state with other threads hold its lock and
    have synchronized its device (`KV.snapshot`)."""
    src = _source(state)
    arrays = {f"leaf_{i}": src.host(i) for i in range(len(src.names))}
    manifest = np.array(
        [_leaf_crc(arrays[f"leaf_{i}"]) for i in range(len(src.names))],
        np.uint32,
    )
    arrays[_MANIFEST] = manifest
    arrays[_META] = _meta_blob("full", src.names, arrays, chain)
    _write_npz(path, arrays)
    return zlib.crc32(manifest.tobytes())


def save_delta(state: kv_mod.KVState, path: str, chain: dict,
               dirty: np.ndarray) -> int:
    """One chain delta: every leaf EXCEPT the page store ships whole; of
    `pool.pages` (viewed as `[-1, W]` rows) only the rows flagged in
    `dirty` are written, with the flat row indices alongside. The rows
    are gathered on the device and only they cross to the host. The
    manifest still carries one CRC per logical leaf — the page-store
    entry digests (indices ‖ dirty rows), so a torn delta fails its
    integrity check exactly like a torn full. Returns the manifest CRC
    (the next member's `prev_crc`). `chain` must carry the linkage
    (`{"id", "seq", "prev_crc"}`) of the member this delta follows."""
    src = _source(state)
    names = src.names
    if _DELTA_LEAF not in names:
        raise ValueError(
            f"state has no {_DELTA_LEAF!r} leaf (unpaged config) — "
            "delta snapshots need a page store; save a full instead")
    di = names.index(_DELTA_LEAF)
    full_shape = [int(x) for x in src.shape(di)]
    n_rows = int(np.prod(full_shape[:-1]))
    dirty = np.asarray(dirty, bool).reshape(-1)
    if len(dirty) != n_rows:
        raise ValueError(
            f"dirty bitmap covers {len(dirty)} rows but {_DELTA_LEAF} "
            f"has {n_rows} — base/state shape drift; save a full")
    rows = np.flatnonzero(dirty).astype(np.int64)
    drows = src.gather_rows(di, rows)
    dtype = drows.dtype.str
    arrays = {}
    crcs = []
    for i, n in enumerate(names):
        if i == di:
            # the delta pair's manifest entry: dtype/shape header of the
            # FULL leaf, then indices, then the dirty rows' bytes
            c = zlib.crc32(f"{dtype}:{tuple(full_shape)}".encode())
            c = zlib.crc32(_view(rows), c)
            crcs.append(zlib.crc32(_view(drows), c))
            continue
        a = src.host(i)
        arrays[f"leaf_{i}"] = a
        crcs.append(_leaf_crc(a))
    arrays[_DELTA_ROWS] = rows
    arrays[_DELTA_PAGES] = drows
    manifest = np.array(crcs, np.uint32)
    arrays[_MANIFEST] = manifest
    arrays[_META] = _meta_blob(
        "delta", names, arrays, chain,
        delta={"leaf": _DELTA_LEAF, "index": di, "rows": int(len(rows)),
               "full_shape": full_shape, "dtype": dtype})
    _write_npz(path, arrays)
    return zlib.crc32(manifest.tobytes())


def chain_step(state, path: str, cursor: dict | None, sums, live,
               delta: bool) -> tuple:
    """One snapshot-chain step (`KV.snapshot`): decide full-vs-delta,
    write the member, advance the chain cursor. `cursor` is the previous
    step's second return (None = no chain yet); `sums`/`live` are the
    host dirty basis for the NEXT delta (digest sidecar + tier liveness
    over the flat row space, None when unpaged). A delta is only written
    when a cursor exists and the row space didn't drift — anything else
    degrades to a full, which starts a NEW chain. Returns
    `(report, new_cursor)`."""
    report: dict = {"path": path,
                    "total_rows": None if sums is None else len(sums)}
    dirty = None
    if delta and cursor is not None and sums is not None \
            and cursor.get("base_sums") is not None \
            and len(sums) == len(cursor["base_sums"]):
        dirty = sums != cursor["base_sums"]
        bl = cursor.get("base_live")
        if live is not None and bl is not None and len(live) == len(bl):
            dirty |= live != bl
    if dirty is not None:
        chain = {"id": cursor["id"], "seq": cursor["seq"] + 1,
                 "prev_crc": cursor["prev_crc"]}
        crc = save_delta(state, path, chain, dirty)
        report.update(kind="delta", dirty_rows=int(dirty.sum()))
    else:
        chain = {"id": os.urandom(8).hex(), "seq": 0, "prev_crc": None}
        crc = save(state, path, chain=chain)
        report.update(kind="full", dirty_rows=report["total_rows"])
    report.update(chain_id=chain["id"], seq=chain["seq"], crc=crc)
    new_cursor = {"id": chain["id"], "seq": chain["seq"],
                  "prev_crc": crc, "base_sums": sums, "base_live": live}
    return report, new_cursor


def _read_snapshot(path: str) -> dict:
    """Integrity-verified raw read of one snapshot file (full or delta):
    `{"meta": dict|None, "leaves": [arrays, None at the delta slot],
    "delta": (rows, drows)|None, "manifest_crc": int}`. Every refusal
    here is a torn/corrupt verdict (`CheckpointCorruptError`); config
    and chain checks live with the callers."""
    try:
        with np.load(path) as z:
            members = set(z.files)
            if _MANIFEST not in members:
                raise CheckpointCorruptError(
                    f"snapshot {path!r} carries no integrity manifest — "
                    "not a (whole) snapshot written by checkpoint.save"
                )
            manifest = z[_MANIFEST]
            meta = None
            if _META in members:
                meta = json.loads(bytes(z[_META]).decode("utf-8"))
            delta = None
            if meta is not None and meta.get("kind") == "delta":
                delta = (z[_DELTA_ROWS], z[_DELTA_PAGES])
            n = (len(meta["leaves"]) if meta is not None
                 else len(members) - 1)
            di = meta["delta"]["index"] if delta is not None else -1
            loaded = [None if i == di else z[f"leaf_{i}"]
                      for i in range(n)]
    except CheckpointCorruptError:
        raise
    except (OSError, EOFError, KeyError, ValueError, UnicodeDecodeError,
            zipfile.BadZipFile) as e:
        # a torn write / flipped bit breaks the zip structure, a member's
        # zlib stream, the member directory, or the meta JSON — all the
        # same verdict
        raise CheckpointCorruptError(
            f"snapshot {path!r} is torn or corrupt: {e!r}"
        ) from e
    if len(manifest) != len(loaded):
        raise CheckpointCorruptError(
            f"snapshot {path!r} manifest covers {len(manifest)} leaves "
            f"but {len(loaded)} are present"
        )
    for i, a in enumerate(loaded):
        if a is None:
            dm = meta["delta"]
            hdr = (f"{np.dtype(dm['dtype']).str}:"
                   f"{tuple(dm['full_shape'])}").encode()
            c = zlib.crc32(hdr)
            c = zlib.crc32(_view(delta[0]), c)
            c = zlib.crc32(_view(delta[1]), c)
        else:
            c = _leaf_crc(a)
        if c != int(manifest[i]):
            what = (meta["leaves"][i]["name"] if meta is not None
                    else str(i))
            raise CheckpointCorruptError(
                f"snapshot {path!r} leaf {what} failed its integrity "
                "check (bytes at rest differ from what save() recorded)"
            )
    return {"meta": meta, "leaves": loaded, "delta": delta,
            "manifest_crc": zlib.crc32(np.asarray(manifest).tobytes())}


def _check_shapes(loaded: list, expected_shapes: list,
                  snap_names: list | None,
                  want_names: list | None) -> None:
    """The config/snapshot agreement check, with NAMED refusals when
    either side knows its leaf names (v2 snapshots / skeletons) — the
    "KVState gained a leaf" class of refusal reports WHICH leaf."""
    if len(loaded) != len(expected_shapes):
        if snap_names is not None and want_names is not None:
            missing = [n for n in want_names if n not in set(snap_names)]
            extra = [n for n in snap_names if n not in set(want_names)]
            if missing or extra:
                parts = []
                if missing:
                    parts.append("snapshot is missing leaf "
                                 + ", ".join(repr(n) for n in missing))
                if extra:
                    parts.append("snapshot carries unexpected leaf "
                                 + ", ".join(repr(n) for n in extra))
                raise ValueError(
                    f"config/snapshot mismatch: {'; '.join(parts)}")
        raise ValueError(
            f"snapshot has {len(loaded)} leaves, config expects "
            f"{len(expected_shapes)} — config/snapshot mismatch"
        )
    for i, (a, shape) in enumerate(zip(loaded, expected_shapes)):
        if tuple(a.shape) != tuple(shape):
            name = None
            if want_names is not None and i < len(want_names):
                name = want_names[i]
            elif snap_names is not None and i < len(snap_names):
                name = snap_names[i]
            what = repr(name) if name is not None else str(i)
            raise ValueError(
                f"leaf {what} shape {tuple(a.shape)} != expected "
                f"{tuple(shape)} — config/snapshot mismatch"
            )


def load_leaves(path: str, expected_shapes: list | None,
                expected_names: list | None = None) -> list:
    """Raw leaf arrays from a FULL snapshot, integrity-verified and
    shape-checked against expectations.

    Raises `CheckpointCorruptError` for a torn/corrupt file (truncated
    zip, unreadable member, missing manifest, digest mismatch) and
    `ValueError` for a well-formed snapshot that does not match the
    expected config (naming the offending leaf when the manifest knows
    names) — or for a delta member, which can only be restored through
    its chain (`load_chain`). `expected_shapes=None` returns the
    integrity-verified leaves with their shapes unchecked."""
    snap = _read_snapshot(path)
    if snap["delta"] is not None:
        raise ValueError(
            f"snapshot {path!r} is a delta chain member (seq "
            f"{snap['meta']['chain']['seq']}) — restore it through its "
            "chain (checkpoint.load_chain), not standalone")
    loaded = snap["leaves"]
    if expected_shapes is None:
        return loaded
    snap_names = ([d["name"] for d in snap["meta"]["leaves"]]
                  if snap["meta"] is not None else None)
    _check_shapes(loaded, expected_shapes, snap_names, expected_names)
    return loaded


def materialize_chain(paths: list) -> dict:
    """Validate a snapshot chain and fold its deltas onto the base full:
    `{"leaves": [arrays], "meta": <last member's meta>, "seq": int,
    "chain": resume card, "timings_s": {"read", "fold"}}`.

    Order among `paths` does not matter (members sort by their recorded
    seq), but the SET must be one contiguous chain: exactly one full at
    seq 0, every delta present, each member's `prev_crc` matching the
    manifest CRC of the member it follows. A torn member raises
    `CheckpointCorruptError`; a gap, duplicate seq, cross-chain mix, or
    broken linkage raises `SnapshotChainError` — never a restore of a
    shortened or reordered history. Deltas fold in place into the full's
    page leaf (the arrays were read for this call alone)."""
    if not paths:
        raise SnapshotChainError("empty snapshot chain")
    t0 = time.perf_counter()
    snaps = []
    for p in paths:
        s = _read_snapshot(p)
        if s["meta"] is None or s["meta"].get("chain") is None:
            raise SnapshotChainError(
                f"snapshot {p!r} carries no chain linkage — a v1 or "
                "standalone full cannot anchor a delta chain")
        s["path"] = p
        snaps.append(s)
    ids = {s["meta"]["chain"]["id"] for s in snaps}
    if len(ids) != 1:
        raise SnapshotChainError(
            f"chain mixes members of different chains: {sorted(ids)}")
    snaps.sort(key=lambda s: int(s["meta"]["chain"]["seq"]))
    seqs = [int(s["meta"]["chain"]["seq"]) for s in snaps]
    if seqs != list(range(len(snaps))):
        raise SnapshotChainError(
            f"chain is incomplete or out of order: have seqs {seqs}, "
            f"expected 0..{len(snaps) - 1} contiguous")
    if snaps[0]["meta"]["kind"] != "full":
        raise SnapshotChainError(
            f"chain member seq 0 ({snaps[0]['path']!r}) is not a full "
            "snapshot")
    prev_crc = None
    for s in snaps:
        want = s["meta"]["chain"].get("prev_crc")
        if s is not snaps[0] and want != prev_crc:
            raise SnapshotChainError(
                f"chain member seq {s['meta']['chain']['seq']} "
                f"({s['path']!r}) does not follow the previous member "
                f"(prev_crc {want} != manifest crc {prev_crc}) — "
                "out-of-order or cross-chain delta")
        prev_crc = s["manifest_crc"]
    t1 = time.perf_counter()
    leaves = list(snaps[0]["leaves"])
    names = [d["name"] for d in snaps[0]["meta"]["leaves"]]
    for s in snaps[1:]:
        if s["meta"]["kind"] != "delta":
            raise SnapshotChainError(
                f"chain member seq {s['meta']['chain']['seq']} is a "
                "second full — a full always starts a NEW chain")
        dm = s["meta"]["delta"]
        di = names.index(dm["leaf"])
        if list(leaves[di].shape) != list(dm["full_shape"]):
            raise SnapshotChainError(
                f"delta seq {s['meta']['chain']['seq']} expects "
                f"{dm['leaf']} shape {dm['full_shape']} but the chain "
                f"carries {list(leaves[di].shape)}")
        full = leaves[di]
        rows, drows = s["delta"]
        full.reshape(-1, full.shape[-1])[np.asarray(rows, np.int64)] = drows
        for i, a in enumerate(s["leaves"]):
            if i != di:
                leaves[i] = a
    return {"leaves": leaves, "meta": snaps[-1]["meta"],
            "seq": seqs[-1],
            # resume card: everything a restored owner needs to keep
            # EXTENDING this chain (next delta's prev_crc is the last
            # member's manifest crc)
            "chain": {"id": next(iter(ids)), "seq": seqs[-1],
                      "crc": prev_crc},
            "timings_s": {"read": t1 - t0,
                          "fold": time.perf_counter() - t1}}


def _leaves_to_state(loaded: list, config: KVConfig, run_recovery: bool,
                     device) -> kv_mod.KVState:
    # names and shapes from a skeleton on the meta device: no pool is
    # allocated to learn them
    named = carry.leaves(strip_admission(kv_mod.init(config, "meta")))
    names = [n for n, _ in named]
    _check_shapes(loaded, [tuple(t.shape) for _, t in named], None, names)
    state = carry.state_from_numpy(dict(zip(names, loaded)), config,
                                   device, consume=True)
    state = transplant_admission(state, config)
    if run_recovery:
        ops = get_index_ops(config.index.kind)
        if ops.recovery is not None:
            ops.recovery(state.index)
    return state


def state_from_leaves(leaves: list, config: KVConfig,
                      run_recovery: bool = True,
                      device="cuda") -> kv_mod.KVState:
    """Rebuild a `KVState` on `device` from already-materialized leaves
    (for callers that folded a chain themselves — `journal.warm_restart`
    materializes once to keep the resume card, then builds the state
    from the same fold). The leaves are consumed: a contiguous one may
    become the state's own buffer on the CPU."""
    return _leaves_to_state(leaves, config, run_recovery, device)


def load(path: str, config: KVConfig, run_recovery: bool = True,
         device="cuda") -> kv_mod.KVState:
    """Restore a snapshot onto `device`; runs the index's Recovery repair
    by default. The admission gate (when the config carries one) starts
    EMPTY (see `strip_admission`)."""
    named = carry.leaves(strip_admission(kv_mod.init(config, "meta")))
    loaded = load_leaves(path, [tuple(t.shape) for _, t in named],
                         [n for n, _ in named])
    return _leaves_to_state(loaded, config, run_recovery, device)


def load_chain(paths: list, config: KVConfig, run_recovery: bool = True,
               device="cuda") -> kv_mod.KVState:
    """Restore a full+deltas snapshot chain onto `device` (see
    `materialize_chain` for the refusal contract). Same admission and
    recovery semantics as `load`."""
    folded = materialize_chain(paths)
    return _leaves_to_state(folded["leaves"], config, run_recovery, device)
