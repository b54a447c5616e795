"""PyTorch port: `tests/test_client.py`, drill by drill.

Each test carries its JAX drill's name and runs the drill's script on
both packages through a namespace per package (`JAX`, `PORT`; the port's
`KV` with `device="cpu"`). Every drill here is deterministic, so the two
transcripts must be equal: pages, found masks, the client's counters,
the paging simulator's and the replay's rows, parsed traces, generated
key sets and hash words. The JAX drill's own assertions run on both.
"""

from __future__ import annotations

import os
import types

import numpy as np
import pytest
import torch_threads  # noqa: F401 (one torch thread a worker)
from torch_threads import jax_compile_settings  # noqa: F401 (autouse)
from torch_twin import JAX as _JAX
from torch_twin import PORT as _PORT
from torch_twin import counters, registries, same  # noqa: F401
from torch_twin import twin as twin_of

import pmdfc_tpu.bench.gen_input as jgen
import pmdfc_tpu.bench.paging_sim as jpaging
import pmdfc_tpu.bench.replay as jreplay
import pmdfc_tpu.client as jclient
import pmdfc_tpu.utils.hashing as jhash
import pmdfc_tpu.utils.hashing_np as jhnp
import pmdfc_tpu_torch.bench.gen_input as tgen
import pmdfc_tpu_torch.bench.paging_sim as tpaging
import pmdfc_tpu_torch.bench.replay as treplay
import pmdfc_tpu_torch.client as tclient
import pmdfc_tpu_torch.utils.hashing as thash
import pmdfc_tpu_torch.utils.hashing_np as thnp
from pmdfc_tpu_torch.utils import u32

pytestmark = pytest.mark.torch

TESTS = os.path.dirname(os.path.abspath(__file__))


def _jax_h(hi, lo, seed, family):
    import jax.numpy as jnp

    return np.asarray(jhash.h(jnp.asarray(hi), jnp.asarray(lo), seed=seed,
                              family=family))


def _port_h(hi, lo, seed, family):
    return thash.h(u32.from_numpy(hi, "cpu"), u32.from_numpy(lo, "cpu"),
                   seed=seed, family=family).numpy().astype(np.uint32)


JAX = types.SimpleNamespace(
    **vars(_JAX), name="jax", client=jclient, gen=jgen, paging=jpaging,
    replay=jreplay, hnp=jhnp, families=sorted(jhash.FAMILIES), h=_jax_h)
PORT = types.SimpleNamespace(
    **vars(_PORT), name="port", client=tclient, gen=tgen, paging=tpaging,
    replay=treplay, hnp=thnp, families=sorted(thash.FAMILIES), h=_port_h)
PKGS = (JAX, PORT)


def twin(drill, *args):
    return twin_of(drill, *args, pkgs=PKGS)


def _direct(p, capacity=1 << 10, page_words=16, bloom=True):
    c = p.config
    cfg = c.KVConfig(index=c.IndexConfig(capacity=capacity),
                     bloom=c.BloomConfig(num_bits=1 << 14) if bloom else None,
                     paged=True, page_words=page_words)
    return p.client.DirectBackend(p.KV(cfg))


def _unpaged_kv(p, capacity):
    c = p.config
    return p.KV(c.KVConfig(index=c.IndexConfig(capacity=capacity),
                           bloom=None, paged=False))


def _rows(p, out: dict) -> dict:
    """A harness row's counts (times and rates are the host clock's). The
    port's replay row adds `wrong_values` (its gate), held at 0 here."""
    row = {k: v for k, v in out.items()
           if isinstance(v, (bool, int, np.integer))}
    if p is PORT and "wrong_values" in row:
        assert row.pop("wrong_values") == 0
    return row


def test_longkey_construction():
    def drill(p):
        a = p.client.get_longkey(0xABCD, 7)
        b = p.client.get_longkey(0x1_0000_0002, 7)
        assert a == (0xABCD, 7) and b[0] == 2
        return [int(x) for x in a], [int(x) for x in b]

    twin(drill)


def test_cleancache_roundtrip_local_backend():
    def drill(p):
        c = p.client.CleanCacheClient(
            p.client.LocalBackend(page_words=8, capacity=64))
        page = np.arange(8, dtype=np.uint32)
        c.put_page(3, 44, page)
        got = c.get_page(3, 44)
        np.testing.assert_array_equal(got, page)
        assert c.get_page(3, 45) is None
        assert c.counters["hit_gets"] == 1 and c.counters["miss_gets"] == 1
        return np.asarray(got), dict(c.counters)

    twin(drill)


def test_cleancache_bloom_short_circuits_misses():
    def drill(p):
        c = p.client.CleanCacheClient(_direct(p))
        pages = np.tile(np.arange(16, dtype=np.uint32), (4, 1))
        c.put_pages(np.full(4, 9), np.arange(4), pages)
        out0, found0 = c.get_pages(np.full(8, 9), np.arange(100, 108))
        assert not found0.any()
        assert c.counters["bf_short_circuits"] == 8
        assert c.counters["actual_gets"] == 0
        out, found = c.get_pages(np.full(4, 9), np.arange(4))
        assert found.all()
        np.testing.assert_array_equal(out, pages)
        return found0, np.asarray(out), found, dict(c.counters)

    twin(drill)


def test_bloom_refresh_pulls_server_truth():
    def drill(p):
        be = _direct(p)
        c = p.client.CleanCacheClient(be)
        pages = np.tile(np.arange(16, dtype=np.uint32), (2, 1))
        c.put_pages(np.array([1, 1]), np.array([10, 11]), pages)
        be.kv.delete(np.array([[1, 10]], np.uint32))
        _, found = c.get_pages(np.array([1]), np.array([10]))
        assert not found[0] and c.counters["actual_gets"] == 1
        c.refresh_bloom()
        c.refresh_bloom()
        before = c.counters["bf_short_circuits"]
        _, found2 = c.get_pages(np.array([1]), np.array([10]))
        assert not found2[0]
        assert c.counters["bf_short_circuits"] == before + 1
        return found, found2, dict(c.counters), counters(be.kv.stats())

    twin(drill)


def test_swap_client():
    def drill(p):
        s = p.client.SwapClient(
            p.client.LocalBackend(page_words=8, capacity=32))
        page = np.full(8, 7, np.uint32)
        s.store(0, 123, page)
        got = s.load(0, 123)
        np.testing.assert_array_equal(got, page)
        s.invalidate(0, 123)
        assert s.load(0, 123) is None
        return np.asarray(got)

    twin(drill)


def test_paging_sim_seq_read_uses_cleancache():
    def drill(p):
        c = p.client.CleanCacheClient(_direct(p, capacity=1 << 12))
        sim = p.paging.PagingSim(c, ram_pages=64, page_words=16,
                                 put_batch=16)
        out = p.paging.run_job(sim, "seq_read", file_pages=256, ops=512)
        assert out["verify_failures"] == 0 and out["cc_hits"] > 0
        assert out["reads"] == 512
        return _rows(p, out), dict(c.counters), counters(c.backend.kv.stats())

    twin(drill)


def test_paging_sim_writes_never_read_stale():
    def drill(p):
        c = p.client.CleanCacheClient(_direct(p, capacity=1 << 12))
        sim = p.paging.PagingSim(c, ram_pages=32, page_words=16, put_batch=8)
        out = p.paging.run_job(sim, "rand_rw", file_pages=128, ops=600,
                               seed=5)
        assert out["verify_failures"] == 0
        assert out["writes"] > 0 and out["reads"] > 0
        return _rows(p, out), dict(c.counters), counters(c.backend.kv.stats())

    twin(drill)


def test_page_content_versioning():
    def drill(p):
        a = p.paging.page_content(1, 2, 8, version=0)
        b = p.paging.page_content(1, 2, 8, version=1)
        assert not np.array_equal(a, b)
        return np.asarray(a), np.asarray(b)

    twin(drill)


def test_replay_synthetic():
    def drill(p):
        ops, keys = p.replay.synthetic_trace(5000, write_frac=0.5, seed=3)
        kv = _unpaged_kv(p, 1 << 12)
        out = p.replay.replay(kv, ops, keys, batch=512)
        assert out["ops"] == 5000 and out["writes"] > 0
        assert out["read_hits"] > 0
        return ops, keys, _rows(p, out), counters(kv.stats())

    twin(drill)


def test_bundled_fileserver_trace_replays():
    path = os.path.join(TESTS, "data", "fileserver.trace")

    def drill(p):
        ops, keys = p.replay.parse_trace(path)
        assert len(ops) > 5000 and 0 < ops.sum() < len(ops)
        kv = _unpaged_kv(p, 1 << 14)
        out = p.replay.replay(kv, ops, keys, batch=2048)
        assert out["writes"] == int(ops.sum()) and out["read_hits"] > 0
        assert out["read_misses"] + out["read_hits"] == int((ops == 0).sum())
        return ops, keys, _rows(p, out), counters(kv.stats())

    twin(drill)


def test_write_fileserver_trace_deterministic(tmp_path):
    def drill(p):
        a = str(tmp_path / f"{p.name}_a.trace")
        b = str(tmp_path / f"{p.name}_b.trace")
        p.replay.write_fileserver_trace(a, n_events=100, seed=3)
        p.replay.write_fileserver_trace(b, n_events=100, seed=3)
        text = open(a).read()
        assert text == open(b).read()
        ops, keys = p.replay.parse_trace(a)
        assert len(ops) >= 100
        return text, ops, keys

    twin(drill)


def test_parse_trace(tmp_path):
    path = tmp_path / "trace.txt"
    path.write_text("0 1.0 W 42 0 8192 8192\n"
                    "1 2.0 R 42 0 8192 4096\n"
                    "malformed line\n")

    def drill(p):
        ops, keys = p.replay.parse_trace(str(path))
        assert list(ops) == [1, 1, 0]
        np.testing.assert_array_equal(keys[:, 0], [42, 42, 42])
        np.testing.assert_array_equal(keys[:, 1], [2, 3, 2])
        return ops, keys

    twin(drill)


def test_gen_input_patterns(tmp_path):
    def drill(p):
        g = p.gen
        u = g.uniform(100)
        assert len(np.unique(u.view("u4,u4"))) == 100
        o = g.one_to_n(100, run=4)
        flat = (o[:, 0].astype(np.uint64) << np.uint64(32)) | o[:, 1]
        assert list(flat[:10]) == [1, 1, 2, 3, 4, 1, 5, 6, 7, 8]
        assert (flat == 1).sum() == 21
        s = g.sequential(10, start=7)
        assert list(s[:, 1]) == list(range(7, 17))
        r = g.repeated(100, repeat=4)
        _, counts = np.unique(r.view("u4,u4"), return_counts=True)
        assert counts.max() == 4
        z = g.zipf(1000)
        assert len(z) == 1000
        f = tmp_path / f"{p.name}_keys.txt"
        g.save(str(f), u)
        back = g.load(str(f))
        np.testing.assert_array_equal(back, u)
        return u, o, s, r, z, back, f.read_text()

    twin(drill)


def test_hash_families_lockstep_and_distribution():
    rng = np.random.default_rng(3)
    hi = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)

    def drill(p):
        out = {}
        for fam in p.families:
            dev = p.h(hi, lo, 11, fam)
            n = p.hnp.h_np(hi, lo, seed=11, family=fam)
            np.testing.assert_array_equal(dev, n, err_msg=fam)
            counts = np.bincount(n & 0xFF, minlength=256)
            assert counts.max() < 16 * 4096 / 256, fam
            n2 = p.hnp.h_np(hi, lo, seed=12, family=fam)
            assert (n != n2).mean() > 0.99, fam
            out[fam] = (n, n2)
        with pytest.raises(ValueError, match="unknown hash family"):
            p.h(hi, lo, 0, "nope")
        return out

    twin(drill)


def test_hashing_np_matches_jax():
    """The numpy mirror against each package's device hash and packed
    bloom query (`test_torch_client.py` holds the device sides; this is
    the JAX drill's own script on both)."""
    rng = np.random.default_rng(0)
    hi = rng.integers(0, 2**32, 256, dtype=np.uint32)
    lo = rng.integers(0, 2**32, 256, dtype=np.uint32)
    keys = np.stack([hi[:32], lo[:32]], axis=-1)

    def drill(p):
        words = [p.hnp.hash_u64_np(hi, lo, seed=s)
                 for s in (0, 7, 0xC0C0C0C0)]
        c = p.config
        kv = p.KV(c.KVConfig(index=c.IndexConfig(capacity=1 << 10),
                             bloom=c.BloomConfig(num_bits=1 << 12,
                                                 num_hashes=4),
                             page_words=16))
        kv.insert(keys, np.zeros((32, 16), np.uint32))
        packed = np.asarray(kv.packed_bloom()).astype(np.uint32)
        ours = p.hnp.query_packed_np(packed, keys, 4)
        assert ours.all()
        return words, packed, ours

    twin(drill)
