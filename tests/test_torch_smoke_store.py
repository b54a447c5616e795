"""PyTorch port: `chip_smoke.py`'s phase 18 (`store`) rehearsed on the CPU.

The phase runs on the card: (a) the `KV`'s edges on a linear·flat `KV`
(all-ones hi words through padded batches, a churn of four times the
slots, deletes and re-puts, poisoned rows on the GET and compact paths,
the long and the capped extent), (b) a tiered `KV`'s promotions, its
compacted GET and a snapshot restored into a fresh `KV`, (c) a 2 x 2
plane behind the coalescing `NetServer` whose lane 1 is corrupted
mid-soak, MSG_RREPAIR, three `ReplicaGroup`s, the `PMDFC_MESH2D=off`
transcript and an unpaged 2 x 2 plane, (d) breaker-driven
auto-replacement of a killed node, (e) the admission gate's scan flood
on a gated and a gateless tiered `KV`, (f) the slow-primary hedge and the
rolling kill and restore under a `ChaosProxy` on every endpoint of three
nodes. Here it runs at 2^12 slots,
64-word pages and 128-key verbs, with the card-only calls stood in for
as `tests/test_torch_smoke.py` stands them in. Ten planted faults show
the phase fails when a compacted GET returns a poisoned row, when a
recycled pool row serves the evicted key's page, when the corrupted
lane's bytes are served, when a tiered restore loses a promoted key,
when the auto-replacement never fires, when the gate's threshold is
forced to 0, when a GET of the scan flood serves one wrong page, when
(f)'s hedge never fires, when a replica GET of (f)'s soak serves one
wrong page and when a rejoined node lacks a key whose copies all reached
the wire (the last five call part (e) or (f) alone).
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
import torch
from test_torch_smoke import KEYS, smoke  # noqa: F401  (fixture)

import chip_smoke
from pmdfc_tpu_torch import checkpoint as tckpt
from pmdfc_tpu_torch import kv as tkv
from pmdfc_tpu_torch.client import replica as trep
from pmdfc_tpu_torch.ops import pagepool as tpool
from pmdfc_tpu_torch.parallel import shard as tshard

pytestmark = pytest.mark.torch

STORE_TINY = (
    ("STORE_INDEX", dict(capacity=1 << 12)),
    ("STORE_TIER_INDEX", dict(capacity=1 << 12)),
    ("STORE_BLOOM_BITS", 1 << 15),
    ("STORE_PAGE_WORDS", 64),
    ("STORE_GET_B", 1 << 9),
    ("STORE_VERB", 128),
    ("STORE_POISON_EVERY", 64),
    ("STORE_PLANE_INDEX", dict(capacity=1 << 12)),
    ("STORE_PLANE_BLOOM_BITS", 1 << 15),
    ("STORE_CONNS", 4),
    ("STORE_NODE_INDEX", dict(capacity=1 << 12)),
    ("STORE_NODE_BLOOM_BITS", 1 << 15),
    ("STORE_NODE_KEYS", 1 << 10),
    ("STORE_ADMIT_SCAN", 4),
    ("STORE_REPLICA_KEYS", 1 << 10),
)


@pytest.fixture
def store(smoke, monkeypatch, tmp_path):  # noqa: F811
    for name, value in STORE_TINY:
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke, "store_dir", lambda: tmp_path / "store")
    return smoke


def test_store_phase_and_its_kernels_line(store, capsys):
    entries = chip_smoke.run_store(store)
    assert [e["path"] for e in entries] == ["store", "store-tiered",
                                            "store-2x2", "store-admit",
                                            "store-replica"]
    assert [e["name"] for e in entries] == [
        "fused_get_linear_flat", "fused_get_linear_tiered",
        "fused_get_linear_flat", "fused_get_linear_tiered",
        "fused_get_linear_flat"]
    for e in entries:
        assert set(e) == KEYS
        assert e["launches"] > 0 and e["max_abs_err"] == 0
        assert e["bound_by"] == "bytes" and e["library_ms"] is None
    out = capsys.readouterr().out
    for needle in ("with hi 0xFFFFFFFF in padded batches",
                   "misses <= evictions + drops", "== capacity - live",
                   "missed as corrupt on the GET",
                   "a 4-cover cap left", "promotions; get_compact over",
                   "every state leaf equal", "over MSG_STATS equal",
                   "lane 1 corrupted after", "MSG_RREPAIR repaired",
                   "PMDFC_MESH2D=off at connect (lanes 1), delegated 0",
                   "transcript equal to a plain plane's",
                   "an unpaged 2 x 2 plane served",
                   "one repair tick replaced it (auto_replacements 1",
                   "(e) scan flood on linear·tiered, 512 hot rows",
                   "denied 256 of 256 promotions as JAX does",
                   "(f1) slow primary: 3 nodes of 4096 slots",
                   "every key served byte-exact in",
                   "(f2) chaos soak: rates", "faults fired",
                   "of the keys the ring gives them that the other member holds",
                   "never sent again (put lost, repair read lost)",
                   "(f) took",
                   "gates: no wrong byte", "kernel == plain",
                   "phase 18 took"):
        assert needle in out, needle
    json.dumps(entries)


def test_store_fails_when_get_compact_returns_a_poisoned_row(store,
                                                            monkeypatch):
    """The compacted GET's digest gate is blind: every row's sidecar is
    recomputed from its bytes before the gather, so a poisoned row comes
    back as a hit."""
    real = tkv.get_compact

    def blind(state, config, keys, **kw):
        sums = state.pool.sums.clone()
        state.pool.sums.copy_(tpool.page_digest(state.pool.pages))
        try:
            return real(state, config, keys, **kw)
        finally:
            state.pool.sums.copy_(sums)

    monkeypatch.setattr(tkv, "get_compact", blind)
    with pytest.raises(AssertionError, match="get_compact served"):
        chip_smoke.run_store(store)


def test_store_fails_when_a_recycled_row_serves_the_evicted_page(
        store, monkeypatch):
    """The first insert that reuses pool rows writes neither their pages
    nor their digests: each reused row still holds its evicted key's page,
    under a digest that matches it."""
    write_batch, write_sums = tpool.write_batch, tpool.write_sums
    seen: dict = {}
    state = {"armed": True, "skip": None}

    def pages(dst, rows, batch):
        used = seen.setdefault(dst.data_ptr(), torch.zeros(
            dst.shape[0], dtype=torch.bool))
        old = used[rows.clamp(min=0)] & (rows >= 0)
        used[rows[rows >= 0]] = True
        if state["armed"] and bool(old.any()):
            state["armed"], state["skip"] = False, old
            keep = ~old
            return write_batch(dst, rows[keep], batch[keep])
        return write_batch(dst, rows, batch)

    def sums(dst, rows, digs):
        skip, state["skip"] = state["skip"], None
        if skip is not None:
            return write_sums(dst, rows[~skip], digs[~skip])
        return write_sums(dst, rows, digs)

    monkeypatch.setattr(tpool, "write_batch", pages)
    monkeypatch.setattr(tpool, "write_sums", sums)
    with pytest.raises(AssertionError, match="wrong page"):
        chip_smoke.run_store(store)


def test_store_fails_when_the_corrupted_lanes_bytes_are_served(
        store, monkeypatch):
    """The hedged merge takes the last lane's row for every key some lane
    found, whatever that lane's digest gate said: once lane 1 is
    corrupted, its refused (zeroed) rows are served as hits."""
    merge = tshard.ShardedKV._replica_merge

    def last_lane(per, dev0):
        out, found, canon, lane = merge(per, dev0)
        return per[-1][0].to(dev0), found, canon, lane

    monkeypatch.setattr(tshard.ShardedKV, "_replica_merge",
                        staticmethod(last_lane))
    with pytest.raises(AssertionError, match="store \\(c\\).*wrong page"):
        chip_smoke.run_store(store)


def test_store_fails_when_a_tiered_restore_loses_a_promoted_key(
        store, monkeypatch):
    """`checkpoint.load` hands back a tiered state whose first hot row's
    key is deleted from the index."""
    load = tckpt.load

    def lossy(path, config, *args, **kw):
        st = load(path, config, *args, **kw)
        hk = st.pool.hot_keys
        occ = ~(hk == -1).all(dim=1)
        if config.tier is not None and bool(occ.any()):
            key = hk[occ.nonzero().flatten()[:1]]
            st, _ = tkv.delete(st, config, torch.cat(
                [key, torch.full((15, 2), -1, dtype=torch.int32)]))
        return st

    monkeypatch.setattr(tckpt, "load", lossy)
    with pytest.raises(AssertionError, match="promoted"):
        chip_smoke.run_store(store)


def test_store_fails_when_the_auto_replacement_never_fires(store,
                                                           monkeypatch):
    monkeypatch.setattr(trep.ReplicaGroup, "_maybe_auto_replace",
                        lambda self: None)
    with pytest.raises(AssertionError, match="auto-replacement fired 0"):
        chip_smoke.run_store(store)


def test_store_fails_when_the_gate_threshold_is_forced_to_zero(
        store, monkeypatch):
    """`KV.set_admit_threshold` sets 0 whatever it is asked: the gate the
    scan meets admits every candidate, so it denies none."""
    real = tkv.KV.set_admit_threshold
    monkeypatch.setattr(tkv.KV, "set_admit_threshold",
                        lambda self, value: real(self, 0))
    with pytest.raises(AssertionError,
                       match="store \\(e\\): the gate denied 0"):
        chip_smoke.store_admit(store, "CPU rehearsal")


def test_store_fails_when_a_scan_get_serves_a_wrong_page(store,
                                                         monkeypatch):
    """The first GET of the scan flood's keys that hits serves its first
    hit with one word flipped."""
    real = tkv.KV.get
    armed = [True]

    def flipped(self, keys, *a, **kw):
        out, found = real(self, keys, *a, **kw)
        scan = int(keys[0, 1]) >= chip_smoke.NEVER_LO // 2
        if armed[0] and scan and bool(found.any()):
            armed[0] = False
            out[found.nonzero()[0, 0], 0] ^= 1
        return out, found

    monkeypatch.setattr(tkv.KV, "get", flipped)
    with pytest.raises(AssertionError, match="store \\(e\\).*wrong page"):
        chip_smoke.store_admit(store, "CPU rehearsal")


def test_store_fails_when_the_hedge_never_fires(store, monkeypatch):
    """`hedge_ms` forced past the armed delay: the slowed primary answers
    before any hedge is due, so none fires and the GET waits it out."""
    monkeypatch.setattr(chip_smoke, "STORE_HEDGE_MS",
                        chip_smoke.STORE_HEDGE_DELAY_S * 2e3)
    with pytest.raises(AssertionError, match="store \\(f1\\): .* fired 0 "
                                             "hedges"):
        chip_smoke.store_replica(store, "CPU rehearsal")


def test_store_fails_when_a_replica_get_serves_a_wrong_page(store,
                                                           monkeypatch):
    """The first GET of (f)'s soak that hits serves its first hit with one
    word flipped (the group's own digest check passed)."""
    real = trep.ReplicaGroup.get
    calls = [0]

    def flipped(self, keys):
        out, found = real(self, keys)
        calls[0] += 1
        if calls[0] > 2 and found.any() and calls[0] < 1 << 30:
            calls[0] = 1 << 30
            out = out.copy()
            out[found.nonzero()[0][0], 0] ^= 1
        return out, found

    monkeypatch.setattr(trep.ReplicaGroup, "get", flipped)
    with pytest.raises(AssertionError, match="store \\(f2\\) GET at step "
                                             "[0-9]+: 1 hits served a wrong "
                                             "page"):
        chip_smoke.store_replica(store, "CPU rehearsal")


def test_store_fails_when_a_rejoined_node_lacks_a_key_the_wire_delivered(
        store, monkeypatch):
    """Once each rejoined node is healed, one key the ring gives it is
    deleted from it: no copy of that key was lost on the wire, so (f2)'s
    holdings gate must count it as unexplained and fail."""
    real = chip_smoke.replica_heal

    def heal_then_drop(g, i, probe, **kw):
        healed = real(g, i, probe, **kw)
        keys = chip_smoke.fail_keys(chip_smoke.STORE_REPLICA_HI,
                                    np.arange(chip_smoke.STORE_REPLICA_KEYS))
        members = np.asarray(g._members(keys))
        both = np.ones(len(keys), bool)
        for e in range(3):
            mine = (members == e).any(axis=1)
            both[mine] &= g.endpoints[e].get(keys[mine])[1]
        own = keys[both & (members == i).any(axis=1)]
        g.endpoints[i].invalidate(own[:1])
        return healed

    monkeypatch.setattr(chip_smoke, "replica_heal", heal_then_drop)
    with pytest.raises(AssertionError, match="store \\(f2\\): .* and "
                                             "\\{(\\d+: \\d+, )*\\d+: [1-9]"):
        chip_smoke.store_replica(store, "CPU rehearsal")
