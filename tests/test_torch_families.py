"""PyTorch port: the six index families added last (cuckoo, cuckoo-probing,
level, path, static, HotRing) against the JAX package, verb by verb.

The same numpy-seeded batches go through `pmdfc_tpu.models.<family>` and
`pmdfc_tpu_torch.models.<family>` on states that start equal: `init`,
`insert_batch` at B = 64, 2048 and 8192 up to and past a full table,
`get_batch` and `get_values` after every insert, `delete_batch`,
`set_values`, `scan`. Every result field and every state leaf must be
identical (tolerance 0: integer arithmetic only).

The JAX programs choose between a narrow and a full-width run under
`lax.cond` (cuckoo's kick rounds, path's claim stages, the lean GET's
miss tail) and skip eviction blocks when nothing is left to place. The
port makes cuckoo's choice the same way, with a host read, and runs
path's claim rounds and the miss tail at the batch's width. Spies on the
port's stage points record the width the JAX program runs on the same
data (cuckoo's: the width the port ran; path's and the tail's: computed
by the JAX program's rule from the live lanes there), and each test
asserts that every branch it is there for was taken — so the JAX side
ran its narrow and its full-width code, and the port matched both.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)
import torch

from pmdfc_tpu.config import IndexConfig as JIndexConfig
from pmdfc_tpu.config import IndexKind as JKind
from pmdfc_tpu.models.base import get_index_ops as jops
from pmdfc_tpu_torch.config import IndexConfig as TIndexConfig
from pmdfc_tpu_torch.config import IndexKind as TKind
from pmdfc_tpu_torch.models import cuckoo, level, path
from pmdfc_tpu_torch.models.base import get_index_ops as tops
from pmdfc_tpu_torch.utils import u32
from pmdfc_tpu_torch.utils.hashing import hash_u64

pytestmark = pytest.mark.torch

INV = 0xFFFFFFFF
FAMILIES = ["cuckoo", "ccp", "level", "path", "static", "hotring"]


def _t(a):
    return u32.from_numpy(np.asarray(a, np.uint32), "cpu")


def _np(x):
    """A port tensor as the JAX package's numpy dtype would hold it."""
    if x.dtype == torch.int32:
        return u32.to_numpy(x)
    return x.numpy()


def _same(a, b, what):
    a, b = np.asarray(a), _np(b)
    if a.dtype == np.int32:  # JAX int32 leaves (hot_lane, slots)
        b = b.view(np.int32)
    assert a.shape == b.shape, f"{what}: shape {a.shape} vs {b.shape}"
    bad = np.nonzero((a != b).reshape(len(a), -1).any(axis=1))[0] \
        if a.ndim else ([0] if a != b else [])
    assert not len(bad), f"{what} differs at {len(bad)} rows: {bad[:8]}"


def _same_state(js, ts, what):
    for f in dataclasses.fields(js):
        v = getattr(js, f.name)
        if hasattr(v, "shape"):
            _same(v, getattr(ts, f.name), f"{what}: leaf {f.name}")
        else:  # a static knob
            assert getattr(ts, f.name) == v, f"{what}: {f.name}"


def _same_result(jr, tr, what):
    for f in jr._fields:
        _same(getattr(jr, f), getattr(tr, f), f"{what} {f}")


def _batch(rng, b, live=None):
    """b keys: duplicates, padding, hi >= 2^31, and (given `live`) a
    sixteenth re-puts of live keys (in-place updates)."""
    k = rng.integers(0, 1 << 32, (b, 2), dtype=np.uint32)
    d = max(b // 16, 1)
    k[:d] = k[d:2 * d]
    k[rng.integers(0, b, 4)] = INV
    k[rng.integers(0, b, 8), 0] |= 0x80000000
    if live is not None and len(live):
        k[b // 4:b // 4 + d] = live[rng.integers(0, len(live), d)]
    return k


def _jax_width(b, live, w):
    """The width the JAX program runs a stage of `live` lanes of a b-wide
    batch at, given its narrow width w: w when they fit, else b."""
    return w if w < b and int(live.sum()) <= w else b


class Branches:
    """Records the branches the JAX program takes on the data the port
    sees: path's claim stages (width, first and last round), cuckoo's
    round runs (width) and kicks, and level's lean-GET miss tail (W
    narrow, the batch's width full)."""

    def __init__(self, monkeypatch):
        self.seen = set()
        self.path_w1 = None  # the width of path's level-1 stage in JAX

        def spy(mod, name, tag):
            real = getattr(mod, name)

            def wrapper(*a, **k):
                self.seen.add(tag(*a, **k))
                return real(*a, **k)
            monkeypatch.setattr(mod, name, wrapper)

        def claim(t, cands, keys, v, act, sl, j0, j1):
            b = keys.shape[0]
            if j0 == 2:  # level-0 survivors: W1 = B/4, else all 14 rounds
                w1 = _jax_width(b, act, min(b, max(1024, b // 4)))
                self.path_w1 = w1
                return ("claim", w1, 2, 4 if w1 < b else 16)
            w1 = self.path_w1
            if j0 == 4 and w1 < b:  # level-1 survivors: W2 = B/16
                w2 = min(w1, max(1024, b // 16))
                return ("claim", _jax_width(w1, act, w2), 4, 16)
            return ("claim", b, 0, 2) if j0 == 0 else ("claim", b, 2, 16)

        spy(path, "_claim_rounds", claim)
        spy(cuckoo, "_run_rounds",
            lambda t, p, ck, *a: ("rounds", ck.shape[0]))
        spy(cuckoo, "_kick", lambda *a: ("kick",))
        spy(level, "lean_miss_tail",
            lambda missed, *a: ("tail", _jax_width(
                missed.shape[0], missed, max(1024, missed.shape[0] // 8))))


def _drive(kind, cap, widths, rng, probe=None, **ix):
    """Insert batches of `widths` into both packages, comparing results and
    states after each and a get_batch/get_values of a probe as wide as
    the batch (half live keys, half never inserted) -> (js, ts, live,
    evictions, drops)."""
    jcfg = JIndexConfig(kind=JKind(kind), capacity=cap, **ix)
    tcfg = TIndexConfig(kind=TKind(kind), capacity=cap, **ix)
    jo, to = jops(JKind(kind)), tops(TKind(kind))
    assert jo.num_slots(jcfg) == to.num_slots(tcfg)
    js, ts = jo.init(jcfg), to.init(tcfg, device="cpu")
    _same_state(js, ts, "init")
    live = np.zeros((0, 2), np.uint32)
    ev = drops = 0
    for step, b in enumerate(widths):
        keys = _batch(rng, b, live)
        vals = rng.integers(0, 1 << 32, (b, 2), dtype=np.uint32)
        js, jr = jo.insert_batch(js, jnp.asarray(keys), jnp.asarray(vals))
        ts, tr = to.insert_batch(ts, _t(keys), _t(vals))
        _same_result(jr, tr, f"insert {step} (B={b})")
        _same_state(js, ts, f"insert {step} (B={b})")
        ev += int((~(np.asarray(jr.evicted) == INV).all(-1)).sum())
        drops += int(np.asarray(jr.dropped).sum())
        live = np.concatenate([live, keys])
        p = probe(rng, b, live) if probe else np.concatenate([
            live[rng.integers(0, len(live), b // 2)],
            _batch(rng, b - b // 2)])
        _same_result(jo.get_batch(js, jnp.asarray(p)),
                     to.get_batch(ts, _t(p)), f"get_batch {step}")
        jv, jf = jo.get_values(js, jnp.asarray(p))
        tv, tf = to.get_values(ts, _t(p))
        _same(jv, tv, f"get_values {step} values")
        _same(jf, tf, f"get_values {step} found")
    return js, ts, live, ev, drops


WIDTHS = [64, 2048, 2048, 2048, 2048, 2048, 2048, 8192, 8192]


@pytest.mark.parametrize("kind", FAMILIES)
def test_family_verbs_match_jax(kind, monkeypatch):
    """init, insert_batch at B = 64, 2048 and 8192 from empty to past full
    (so every family updates in place, drops or evicts), get_batch and
    get_values after each, then delete_batch (with repeated keys),
    set_values and scan — port == JAX on every output and leaf."""
    br = Branches(monkeypatch)
    rng = np.random.default_rng(FAMILIES.index(kind))
    js, ts, live, ev, drops = _drive(kind, 1 << 14, WIDTHS, rng)
    jo, to = jops(JKind(kind)), tops(TKind(kind))
    assert drops + ev > 0, "the sequence never filled the table"
    if kind in ("cuckoo", "ccp", "level", "hotring"):
        assert ev > 0, f"{kind} never evicted"
    else:
        assert ev == 0 and drops > 0, f"{kind} evicts or never drops"

    gone = np.concatenate([live[rng.integers(0, len(live), 2000)],
                           live[:24], live[:24]])
    js, jh, jo_vals = jo.delete_batch(js, jnp.asarray(gone))
    ts, th, to_vals = to.delete_batch(ts, _t(gone))
    _same(jh, th, "delete hit")
    _same(jo_vals, to_vals, "delete old values")
    _same_state(js, ts, "delete")
    assert np.asarray(jh).sum() > 0

    n = jo.num_slots(JIndexConfig(kind=JKind(kind), capacity=1 << 14))
    sl = rng.choice(n, 64, replace=False).astype(np.int32)
    sl[:4] = -1
    vals = rng.integers(0, 1 << 32, (64, 2), dtype=np.uint32)
    js = jo.set_values(js, jnp.asarray(sl), jnp.asarray(vals))
    ts = to.set_values(ts, torch.from_numpy(sl), _t(vals))
    _same_state(js, ts, "set_values")
    for a, b in zip(jo.scan(js), to.scan(ts)):
        _same(a, b, "scan")
        assert len(a) == n

    seen = br.seen
    if kind == "cuckoo":
        # round-1 survivors compacted to W = 1024 of 2048 with kicks, and
        # overflowing W at B = 8192 on the full table (rounds at 8192)
        assert {("rounds", 1024), ("kick",), ("rounds", 8192)} <= seen, seen
    if kind == "level":
        # the lean tail: the bottom windows at W = 1024 of 2048 (narrow)
        # or at 8192 (full)
        assert {("tail", 1024), ("tail", 8192)} <= seen, seen


def _path_rows(keys, top):
    """Bank-0 rows of seeds A and B (int64 numpy)."""
    k = _t(keys)
    return [((hash_u64(k[:, 0], k[:, 1], seed=seed) & (top - 1)) >> 3).numpy()
            for seed in (path.SEED_A, path.SEED_B)]


def _path_keys(rng, n, top, want_filled):
    """n keys whose bank-0 rows of BOTH seeds lie in the first half of the
    rows (want_filled) or both in the second."""
    half = top >> 4  # bank-0 rows / 2
    out = np.zeros((0, 2), np.uint32)
    while len(out) < n:
        k = rng.integers(0, 1 << 32, (1 << 15, 2), dtype=np.uint32)
        ra, rb = _path_rows(k, top)
        sel = ((ra < half) & (rb < half)) if want_filled else \
            ((ra >= half) & (rb >= half))
        out = np.concatenate([out, k[sel]])
    return out[:n]


def test_path_claim_stages_match_jax(monkeypatch):
    """Every rung of path's claim ladder at B = 8192 (W1 = 2048, W2 =
    1024): the level-0 survivors fit W1 and the level-1 survivors fit W2
    (stage 2 narrow); they fit W1 but not W2 (stage 2 at W1 — keys whose
    both chains run through rows whose level-0 and level-1 cells are
    taken); they overflow W1 (stage 1 at full width). The first half of
    the bank-0 rows is pre-filled at levels 0-1 in both states."""
    br = Branches(monkeypatch)
    rng = np.random.default_rng(7)
    cap = 1 << 18
    jcfg = JIndexConfig(kind=JKind.PATH, capacity=cap)
    jo, to = jops(JKind.PATH), tops(TKind.PATH)
    js = jo.init(jcfg)
    top = js.top
    table = np.asarray(js.table).copy()
    half = top >> 4
    dummy = rng.integers(0, 1 << 31, (half, 12, 2), dtype=np.uint32)
    table[:half, 0:12] = dummy[..., 0]                  # key hi, lanes 0-11
    table[:half, path.ROW:path.ROW + 12] = dummy[..., 1]
    js = dataclasses.replace(js, table=jnp.asarray(table))
    ts = path.PathState(table=_t(table), top=top)

    batches = [
        _path_keys(rng, 8192, top, False),                       # stage 2 narrow
        np.concatenate([_path_keys(rng, 6692, top, False),
                        _path_keys(rng, 1500, top, True)]),      # stage 2 at W1
        _path_keys(rng, 8192, top, True),                        # stage 1 full
    ]
    for i, keys in enumerate(batches):
        keys = keys[rng.permutation(len(keys))]
        vals = rng.integers(0, 1 << 32, (len(keys), 2), dtype=np.uint32)
        js, jr = jo.insert_batch(js, jnp.asarray(keys), jnp.asarray(vals))
        ts, tr = to.insert_batch(ts, _t(keys), _t(vals))
        _same_result(jr, tr, f"insert {i}")
        _same_state(js, ts, f"insert {i}")
        _same_result(jo.get_batch(js, jnp.asarray(keys)),
                     to.get_batch(ts, _t(keys)), f"get {i}")
    assert {("claim", 2048, 2, 4), ("claim", 1024, 4, 16),
            ("claim", 2048, 4, 16), ("claim", 8192, 2, 16)} <= br.seen, \
        br.seen


@pytest.mark.parametrize("kicks", [1, 2])
def test_cuckoo_kick_budget_matches_jax(kicks, monkeypatch):
    """`max_cuckoo_kicks` counts round 1: with 1 the round-1 survivors drop
    without a kick; with 2, one kick round runs and the victims it carries
    that cannot re-home are evicted, the unplaced originals dropped (the
    default 8 runs in `test_family_verbs_match_jax`)."""
    br = Branches(monkeypatch)
    rng = np.random.default_rng(kicks)
    *_, ev, drops = _drive("cuckoo", 1 << 14, [8192, 8192],
                           rng, max_cuckoo_kicks=kicks)
    assert drops > 0
    assert (("kick",) in br.seen) == (kicks > 1)
    assert (ev > 0) == (kicks > 1)


@pytest.mark.parametrize("kind", FAMILIES)
def test_pool_is_sized_from_the_familys_slots(kind):
    """The pool has one row per slot, and slots differ by family: at the
    serving capacity 2^21, level rounds its top rows up to a power of two
    (3 x 2^20 slots, a 12 GiB pool of 4 KiB pages) and path's slot ids
    are base 15 (15 cells of each 16-lane row)."""
    from pmdfc_tpu_torch import kv as tkv
    from pmdfc_tpu_torch.config import KVConfig

    big_j = JIndexConfig(kind=JKind(kind), capacity=1 << 21)
    big_t = TIndexConfig(kind=TKind(kind), capacity=1 << 21)
    n = tops(TKind(kind)).num_slots(big_t)
    assert n == jops(JKind(kind)).num_slots(big_j)
    want = {"level": 3 << 20, "path": ((1 << 17) + (1 << 13)) * 15}
    assert n == want.get(kind, 1 << 21)
    small = TIndexConfig(kind=TKind(kind), capacity=1 << 10)
    st = tkv.init(KVConfig(index=small, page_words=16, bloom=None), "cpu")
    assert st.pool.pages.shape[0] == tops(TKind(kind)).num_slots(small)
    flat_keys, _ = tops(TKind(kind)).scan(st.index)
    assert flat_keys.shape[0] == st.pool.pages.shape[0]


def test_path_slot_ids_are_base_15():
    """A path slot id is row * 15 + lane: every placed slot lies in
    [0, num_slots), no slot names the pad lane, and scan position == slot
    (what `find_anyway` pairs)."""
    cfg = TIndexConfig(kind=TKind.PATH, capacity=1 << 12)
    ops = tops(TKind.PATH)
    st = ops.init(cfg, device="cpu")
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 1 << 32, (4096, 2), dtype=np.uint32)
    st, res = ops.insert_batch(st, _t(keys), _t(keys))
    sl = res.slots.numpy()
    placed = sl >= 0
    assert placed.sum() > 1000 and sl.max() < ops.num_slots(cfg)
    flat_keys, _ = ops.scan(st)
    assert np.array_equal(u32.to_numpy(flat_keys)[sl[placed]], keys[placed])
