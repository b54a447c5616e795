"""PyTorch port: page pool and counting bloom filter against the JAX package.

Exact comparisons throughout: page digests (any width, edge words), the
free-row stack's push-then-pop, pool row scatters/gathers/verification,
bloom counters and the packed MSB-first bit form (byte for byte — it is
what crosses the wire to clients).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)
import torch

from pmdfc_tpu.config import BloomConfig as JBloomConfig
from pmdfc_tpu.ops import bloom as jbloom
from pmdfc_tpu.ops import pagepool as jpool
from pmdfc_tpu_torch.config import BloomConfig as TBloomConfig
from pmdfc_tpu_torch.ops import bloom as tbloom
from pmdfc_tpu_torch.ops import pagepool as tpool
from pmdfc_tpu_torch.utils import u32

pytestmark = pytest.mark.torch

EDGE = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)


def _t(a):
    return u32.from_numpy(np.asarray(a, np.uint32), "cpu")


@pytest.mark.parametrize("width", [64, 1024, 48, 5, 1])
def test_page_digest_matches_jax(width):
    rng = np.random.default_rng(width)
    pages = rng.integers(0, 1 << 32, (40, width), dtype=np.uint32)
    pages[:len(EDGE)] = EDGE[:, None]  # constant edge-word pages
    want = np.asarray(jpool.page_digest(jnp.asarray(pages)))
    got = tpool.page_digest(_t(pages))
    assert got.dtype == torch.int32
    assert np.array_equal(u32.to_numpy(got), want)
    assert np.array_equal(want, jpool.page_digest_np(pages))


def _assert_pool(jp, tp):
    assert np.array_equal(u32.to_numpy(tp.pages), np.asarray(jp.pages))
    assert np.array_equal(u32.to_numpy(tp.sums), np.asarray(jp.sums))
    assert np.array_equal(tp.free.numpy(), np.asarray(jp.free))
    assert int(tp.top) == int(jp.top)


def test_pool_write_read_verify_match_jax():
    rng = np.random.default_rng(5)
    n, w, b = 64, 16, 24
    jp, tp = jpool.init(n, w), tpool.init(n, w, device="cpu")
    _assert_pool(jp, tp)
    rows = rng.choice(n, b, replace=False).astype(np.int32)
    rows[::5] = -1  # -1 writes nothing
    batch = rng.integers(0, 1 << 32, (b, w), dtype=np.uint32)
    digs = jpool.page_digest(jnp.asarray(batch))
    jpages = jpool.write_batch(jp.pages, jnp.asarray(rows), jnp.asarray(batch))
    jsums = jpool.write_sums(jp.sums, jnp.asarray(rows), digs)
    jp = jp.__class__(pages=jpages, sums=jsums, free=jp.free, top=jp.top)
    tpool.write_batch(tp.pages, torch.from_numpy(rows), _t(batch))
    tpool.write_sums(tp.sums, torch.from_numpy(rows), _t(np.asarray(digs)))
    _assert_pool(jp, tp)

    # read back: misses (-1), and rows past the pool clamp as JAX gathers do
    probe = np.concatenate([rows, [-1, n + 3, n - 1]]).astype(np.int32)
    jout = jpool.read_batch(jp.pages, jnp.asarray(probe))
    tout = tpool.read_batch(tp.pages, torch.from_numpy(probe))
    assert np.array_equal(u32.to_numpy(tout), np.asarray(jout))
    # corrupt one written row: verify refuses exactly that one
    bad = int(rows[1])
    jpages = jp.pages.at[bad, 3].set(jp.pages[bad, 3] ^ jnp.uint32(1))
    jp = jp.__class__(pages=jpages, sums=jp.sums, free=jp.free, top=jp.top)
    tp.pages[bad, 3] ^= 1
    jout = jpool.read_batch(jp.pages, jnp.asarray(probe))
    tout = tpool.read_batch(tp.pages, torch.from_numpy(probe))
    jok = np.asarray(jpool.verify_batch(jp, jnp.asarray(probe), jout))
    tok = tpool.verify_batch(tp, torch.from_numpy(probe), tout)
    assert np.array_equal(tok.numpy(), jok)
    assert not jok[1] and jok[2]


def test_recycle_and_alloc_matches_jax():
    """A sequence of push-then-pop rounds: allocation, frees feeding the
    next round's pops, a pop past the free rows (-1), and a push past the
    stack's end (dropped)."""
    rng = np.random.default_rng(9)
    n, b = 32, 16
    jp, tp = jpool.init(n, 4), tpool.init(n, 4, device="cpu")
    live = []
    for rnd in range(8):
        want = rng.random(b) < (0.9 if rnd < 3 else 0.4)
        freed = np.zeros(b, bool)
        freed_rows = np.full(b, -1, np.int32)
        k = min(len(live), int(rng.integers(0, b)))
        if k:
            pick = rng.choice(len(live), k, replace=False)
            freed[:k] = True
            freed_rows[:k] = np.asarray(live)[pick]
            live = [r for i, r in enumerate(live) if i not in set(pick)]
        if rnd == 6:  # push more than the stack holds: the excess drops
            freed[:] = True
            freed_rows[:] = rng.integers(0, n, b)
        jp, jr = jpool.recycle_and_alloc(jp, jnp.asarray(freed),
                                         jnp.asarray(freed_rows),
                                         jnp.asarray(want))
        tp, tr = tpool.recycle_and_alloc(tp, torch.from_numpy(freed),
                                         torch.from_numpy(freed_rows),
                                         torch.from_numpy(want))
        assert np.array_equal(tr.numpy(), np.asarray(jr)), rnd
        assert tr.dtype == torch.int32
        _assert_pool(jp, tp)
        live += [int(r) for r in np.asarray(jr) if r >= 0]


def _keys(rng, n):
    k = rng.integers(0, 1 << 32, (n, 2), dtype=np.uint32)
    k[::9] = 0xFFFFFFFF  # padding keys never touch the counters
    return k


@pytest.mark.parametrize("num_bits,num_hashes", [(1 << 12, 4), (96 * 32, 3)])
def test_bloom_counters_and_packed_bits_match_jax(num_bits, num_hashes):
    rng = np.random.default_rng(num_bits)
    jcfg = JBloomConfig(num_bits=num_bits, num_hashes=num_hashes)
    js = jbloom.init(jcfg)
    ts = tbloom.init(TBloomConfig(num_bits=num_bits, num_hashes=num_hashes),
                     device="cpu")
    inserted = []
    for _ in range(3):
        keys = _keys(rng, 200)
        mask = rng.random(200) < 0.8
        js = jbloom.insert_batch(js, jnp.asarray(keys), jnp.asarray(mask),
                                 num_hashes=num_hashes)
        tbloom.insert_batch(ts, _t(keys), torch.from_numpy(mask),
                            num_hashes=num_hashes)
        inserted.append(keys[mask & (keys != 0xFFFFFFFF).any(axis=1)])
    gone = inserted[0][:50]
    gmask = np.ones(len(gone), bool)
    js = jbloom.delete_batch(js, jnp.asarray(gone), jnp.asarray(gmask),
                             num_hashes=num_hashes)
    tbloom.delete_batch(ts, _t(gone), torch.from_numpy(gmask),
                        num_hashes=num_hashes)
    assert np.array_equal(ts.counters.numpy(), np.asarray(js.counters))
    assert int(ts.counters.min()) >= 0

    probe = np.concatenate([inserted[1][:64], _keys(rng, 64)])
    jq = np.asarray(jbloom.query_batch(js, jnp.asarray(probe),
                                       num_hashes=num_hashes))
    tq = tbloom.query_batch(ts, _t(probe), num_hashes=num_hashes)
    assert np.array_equal(tq.numpy(), jq)
    assert jq[:64].all()

    jpk = np.asarray(jbloom.to_packed_bits(js))
    tpk = u32.to_numpy(tbloom.to_packed_bits(ts))
    assert tpk.dtype == np.uint32 and tpk.tobytes() == jpk.tobytes()
    # MSB-first: counter 0 is bit 31 of word 0
    assert bool(jpk[0] >> 31) == bool(np.asarray(js.counters)[0] > 0)


@pytest.mark.parametrize("num_bits,num_hashes", [(1 << 12, 4), (96 * 32, 3)])
def test_query_packed_matches_jax(num_bits, num_hashes):
    """Membership against the packed client mirror, on torch, against the
    JAX package's `query_packed` over the same packed words: inserted keys
    hit, and the false positives are the same ones."""
    rng = np.random.default_rng(num_hashes)
    ts = tbloom.init(TBloomConfig(num_bits=num_bits, num_hashes=num_hashes),
                     device="cpu")
    keys = _keys(rng, 300)
    tbloom.insert_batch(ts, _t(keys), torch.ones(300, dtype=torch.bool),
                        num_hashes=num_hashes)
    packed = tbloom.to_packed_bits(ts)
    probe = np.concatenate([keys[:100], _keys(rng, 400)])
    want = np.asarray(jbloom.query_packed(
        jnp.asarray(u32.to_numpy(packed)), jnp.asarray(probe),
        num_hashes=num_hashes))
    got = tbloom.query_packed(packed, _t(probe), num_hashes=num_hashes)
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), want)
    live = (keys[:100] != 0xFFFFFFFF).any(axis=1)
    assert want[:100][live].all() and not want[100:].all()
