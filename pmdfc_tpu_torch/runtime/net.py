"""TCP messenger — the network transport (tcp_style variant parity; twin
of `pmdfc_tpu/runtime/net.py`, with the same wire format byte for byte,
so a client of either package talks to a server of the other).

The port's differences, all server-side:
- the fast lane's read is ONE call, `FastView.read`, that validates and
  gathers under the KV lock on the device (`kv.FastView`): the pool is
  updated in place, so a validate-then-gather in two steps could serve a
  put's new bytes under the old digest;
- every thread that drives a backend (connection readers, the flush
  loop, the bloom push sender) enters the backend's CUDA device;
- `MSG_PROFILE` captures a bounded `torch.profiler` session (CPU and
  CUDA activity) through the attached device-time profiler
  (`runtime/profiler.py`) into `<dump_dir>/prof_<seq>/trace.json`, where
  the JAX server captures a `jax.profiler` trace; the refusal rules are
  the JAX server's.

Reference: the tcp_style client generation speaks a kernel TCP messaging
layer ported from OCFS2 o2net (`client/tcp_style/tcp.c`), with message
types HOLA/HOLASI/ADIOS/PUTPAGE/SUCCESS/GETPAGE/SENDPAGE/NOTEXIST/
INVALIDATE (`client/tcp_style/tcp.h:36-44`), fixed header frames
(`tcp.h:47-60`), and keepalive / idle-timeout / reconnect-delay machinery
(`tcp.h:30-34`, `tcp.c:648-705`). This module is its userspace
analog: it puts a real process boundary between the client stack and the
KV/engine, so multi-client orchestration (SURVEY §4.6, the 3-VM fio runs)
runs as actual separate processes.

Redesign notes (not a translation):
- Frames carry BATCHES (`keys[B,2]` + `pages[B,W]`), not one 4 KB page per
  message — the framework's deep-batch discipline applies to the wire too.
- Two channels per client, associated by a client id in the HOLA: an **op
  channel** (strict request/reply, serialized client-side) and a **push
  channel** (server→client stream for bloom pushes + heartbeats) — the
  structural analog of the reference's one-sided BF write riding a separate
  MR (`server/rdma_svr.cpp:157-251`).
- **Stamp-echo snapshot discipline**: clocks don't transfer across
  processes, so the false-negative-safe `t_snap` contract of
  `CleanCacheClient.receive_bloom_*` is kept by echoing CLIENT clock
  stamps: every op frame carries the client's `monotonic_ns` send stamp;
  the server samples, per client, the newest APPLIED put stamp *before*
  packing the filter and echoes it in the push header. Because the op
  channel serializes ops, any client put completed before that stamp is
  provably inside the pushed filter (see `tests/test_net.py` race storm).
- Delta sync: the server remembers the last packed filter it sent each
  push channel and ships only changed 8 KB blocks
  (`counting_bloom_filter.h:101-107` `GetUpdatedBlocks` analog).
- Idle timeout = the server's recv timeout on a connection; client
  keepalives (and normal ops) refresh it. A dead peer surfaces as
  `ConnectionError`/`OSError`, which `runtime.failure.ReconnectingClient`
  already degrades to legal clean-cache results.
- Op tracing (`runtime/telemetry.py`): a client that negotiated
  `TRACE_FLAG` in the HOLA handshake stamps a 32-bit trace id into every
  op REQUEST frame's `words` field (unused on requests; replies are
  unchanged). The server recovers it in the staging queue and stamps it
  onto its flush-phase span records, so one verb is followable
  client → wire → fused batch → phase. Old peers interop untraced.
"""

from __future__ import annotations

import collections
import contextlib
import math
import os
import socket
import struct
import threading
import time
import zlib

import numpy as np
import torch

from pmdfc_tpu_torch.config import (ContainmentConfig, NetConfig, QosConfig,
                              containment_enabled, fastpath_enabled,
                              mesh2d_enabled, net_pipe_enabled,
                              profiler_enabled, qos_enabled, ring_enabled)
from pmdfc_tpu_torch.runtime import qos as qos_mod
from pmdfc_tpu_torch.runtime import sanitizer as san
from pmdfc_tpu_torch.runtime import telemetry as tele
from pmdfc_tpu_torch.runtime import timeseries
from pmdfc_tpu_torch.runtime import workload as workload_mod

# INVALID-key sentinel (utils.keys.INVALID_WORD without the jax import):
# pow2 pad rows for fused wire batches — match nothing, place nothing.
_INVALID = 0xFFFFFFFF

MAGIC = 0xFC13
# Reference vocabulary (`client/tcp_style/tcp.h:36-44`) + push extensions.
MSG_HOLA = 0
MSG_HOLASI = 1
MSG_ADIOS = 2
MSG_PUTPAGE = 3
MSG_SUCCESS = 4
MSG_GETPAGE = 5
MSG_SENDPAGE = 6
MSG_NOTEXIST = 7
MSG_INVALIDATE = 8
MSG_KEEPALIVE = 9
MSG_BFPUSH = 10
MSG_BFBLOCKS = 11
MSG_BFPULL = 12
# one-sided (passive-pool) verbs: the client owns the key→row map and the
# wire carries only raw row reads/writes — the RDMA_WRITE/READ-at-offset
# analogs of `client/onesided/pmdfc_rdma.c:708-790`
MSG_GRANT = 13
MSG_WRITEROW = 14
MSG_READROW = 15
# extent verbs (round 4): range registration/resolution over the wire —
# the reference keeps these at the façade (`server/IKV.h:14-16`); here
# they ride the messenger like any page op
MSG_INSEXT = 16
MSG_GETEXT = 17
# stats pull: JSON counter snapshot of the serving backend — the wire
# surface for the tier subsystem's hot/cold/balloon counters (and the
# kv stats they ride with); a monitoring client needs no second port
MSG_STATS = 18
# one-sided fast path (the client-mirrored directory; ROADMAP item 1):
# DIRPULL asks for the server's key→(shard, row, digest) directory
# (count=1 requests a delta against the last snapshot shipped to this
# client), DIRDELTA answers with upserts + tombstones + the directory
# epoch, and FASTREAD is the direct validated row read — served from
# the READER thread by one locked validate-and-gather on the pool
# (`kv.FastView.read`), never staged into the flush queue. A lane
# whose epoch or row digest no longer validates comes back not-ok and
# the client falls back to the verb path (`fastpath_stale`).
MSG_DIRPULL = 19
MSG_DIRDELTA = 20
MSG_FASTREAD = 21
# elastic membership (the placement-ring tier; cluster/ring.py):
# RINGNOTE announces a membership transition — the server bumps its
# one-sided directory epoch (every cached client mirror goes stale and
# falls back to the verb path until its next refresh), gauges the ring
# epoch, and fires a flight-recorder event, so a handoff can never race
# a fast read into serving a moved key's old placement. HANDOFF is a
# migration write: byte-identical payload to PUTPAGE (and fused into
# the same put phase), but accounted separately (`handoff_pages`) so
# the transition's traffic is attributable server-side.
MSG_RINGNOTE = 22
MSG_HANDOFF = 23
# device-side replica plane (2-D mesh, parallel/shard.py): RREPAIR asks
# the serving backend to run one anti-entropy compare-and-copy pass over
# its replica axis (one collective program re-syncs every row whose
# bytes fail their digest on some lane but validate on another); the
# SUCCESS reply's count is the rows repaired. Staged into the coalesced
# aux phase like MSG_STATS — the pass dispatches a device program and
# must serialize with the flush loop, never ride the reader thread.
MSG_RREPAIR = 24
# warm-restart surface (runtime/journal.warm_restart): count selects the
# subcommand — 0 queries the backend's recovery_info() (JSON reply), 1
# flips mark_recovered() (idempotent; reply count echoes whether it was
# recovering). Served unconditionally like MSG_STATS: a 1-D backend with
# no recovering plumbing answers {"recovering": false}.
MSG_RECOVERY = 25
# Blast-radius containment (rungs 7 and 9, negotiated via CONTAIN_FLAG):
# the error verb. A NACK answers ONE op as an explicit, cause-carrying
# legal degraded result — GET → all-miss, PUT → acked drop, INSEXT →
# nothing covered, INVALIDATE → nothing found — instead of rung-3's
# connection drop. `status` echoes the request seq (pipelined matching),
# `count` echoes the op's key count, `words` carries the cause code
# below. Only ever SENT to a connection that negotiated CONTAIN_FLAG;
# a legacy peer keeps exact rung-3 semantics (its conn drops).
MSG_NACK = 26
# MSG_NACK `words` cause codes
NACK_POISON = 1    # bisection isolated this op as a phase-failure culprit
NACK_REFUSED = 2   # staging refused a fingerprinted poison resubmit
NACK_DEADLINE = 3  # the op's end-to-end deadline expired while staged
# On-demand device-time capture (runtime/profiler.py, negotiated via
# PROF_FLAG): `count` requests a bounded device trace duration in
# milliseconds (the server clamps to its ProfilerConfig.trace_max_ms).
# SUCCESS replies a JSON {"path", "duration_ms"} naming the capture dir
# under the flight recorder's dump dir; MSG_NOTEXIST is the refusal (no
# dump dir, capture already live, or cooldown) — refusal is a normal
# answer, never an error. Staged into the coalesced aux phase like
# MSG_STATS: starting a trace must serialize with the flush loop so the
# capture brackets whole launches, but the capture itself is stopped by
# a timer thread — the aux phase never blocks for the trace window.
MSG_PROFILE = 27

CHAN_OP = 0
CHAN_PUSH = 1
# HOLA `status` carries the channel in its low byte; this flag bit on top
# requests the PIPELINED protocol (sequence-tagged frames, windowed). The
# server acks support via HOLASI `count=1`; a client whose request is not
# acked falls back to lockstep on that connection, so mixed fleets and the
# `PMDFC_NET_PIPE=off` compatibility mode interoperate frame-for-frame.
PIPE_FLAG = 0x100
# Second HOLA `status` flag bit: the client understands OP TRACING — when
# the server acks (HOLASI `count` bit 1), every op REQUEST frame carries a
# 32-bit trace id in the (otherwise unused on requests) `words` field.
# Negotiated exactly like PIPE_FLAG so mixed fleets interop: an old server
# never sees the field as anything but padding, an old client never sends
# it, and replies are byte-identical either way (the client matches its
# own spans by seq; the server stamps the id onto its flush-phase spans).
# The op-channel HOLASI additionally stamps the SERVER's monotonic_ns in
# its (previously zero) stamp field: the client brackets it between its
# own send/recv stamps to estimate the peer clock offset tracetool needs
# to merge client+server span dumps onto one timeline. Old peers read or
# send 0 there — the estimate simply stays unavailable.
TRACE_FLAG = 0x200
# Third HOLA `status` flag bit: the client wants the one-sided FAST PATH
# (directory pulls + direct validated row reads). The server acks via
# HOLASI `count` bit 2 only when `PMDFC_FASTPATH` is on AND the serving
# backend exposes a `fast_view` (paged KV/plane backends) — an unacked
# client never sends the new verbs, so old peers and the kill switch
# both interoperate frame-for-frame with the plain verb protocol.
FAST_FLAG = 0x400
# Fourth HOLA `status` flag bit: the client speaks the ELASTIC membership
# verbs (MSG_RINGNOTE/MSG_HANDOFF). The server acks via HOLASI `count`
# bit 3 only when `PMDFC_RING` is on — an unacked client never sends the
# new verbs, so old peers and the kill switch both interoperate
# frame-for-frame with the static-placement protocol (the PMDFC_RING=off
# conformance contract `tests/test_elastic.py` pins).
ELASTIC_FLAG = 0x800
# Fifth HOLA `status` flag bit: the client understands the device-side
# REPLICA plane (2-D serving mesh). The server acks via HOLASI `count`
# bit 4 — and stamps the backend's LANE COUNT into `count` bits 8..15 —
# only when `PMDFC_MESH2D` is on AND the serving backend advertises
# `replica_lanes > 1`. A host ReplicaGroup reads the lane count to
# delegate its rf-way fan-out to the fused plane (one wire verb, one
# device launch, rf lanes); an unrequested/unacked connection never
# sends MSG_RREPAIR and reads lanes=1, so old peers and the kill switch
# interoperate frame-for-frame (the PMDFC_MESH2D=off conformance
# contract `tests/test_mesh2d.py` pins).
REPLICA_FLAG = 0x1000
# Sixth HOLA `status` flag bit: the client speaks CONTAINMENT — it
# accepts MSG_NACK as a legal per-op error answer (rung 7: poison-op
# bisection NACKs the culprit instead of dropping its connection; rung
# 9: deadline-expired staged ops are NACKed before device dispatch) and
# may stamp an end-to-end DEADLINE BUDGET (relative microseconds, 0 =
# none) into the `stamp` field of GETPAGE/GETEXT requests (a field
# those verbs otherwise send as 0, so old servers ignore it and old
# clients send none). The server acks via HOLASI `count` bit 5 only
# when `PMDFC_CONTAINMENT` is on — an unacked client never reads
# MSG_NACK and stamps no budget, so mixed fleets interoperate
# frame-for-frame with rung-3 conn-drop semantics.
CONTAIN_FLAG = 0x2000
# Seventh HOLA `status` flag bit: the client speaks the device-time
# PROFILER verb (MSG_PROFILE). The server acks via HOLASI `count` bit 6
# only when `PMDFC_PROF` is on server-side — an unacked client's
# `server_profile()` returns None without sending (old-peer fallback),
# so mixed fleets and the kill switch interoperate frame-for-frame.
PROF_FLAG = 0x4000

# wire verb -> span op name (telemetry vocabulary)
_OP_NAMES = {
    MSG_PUTPAGE: "put", MSG_GETPAGE: "get", MSG_INVALIDATE: "invalidate",
    MSG_KEEPALIVE: "keepalive", MSG_BFPULL: "bfpull",
    MSG_INSEXT: "ins_ext", MSG_GETEXT: "get_ext", MSG_STATS: "stats",
    MSG_DIRPULL: "dirpull", MSG_FASTREAD: "fastread",
    MSG_RINGNOTE: "ring_note", MSG_HANDOFF: "handoff",
    MSG_RREPAIR: "rrepair", MSG_RECOVERY: "recovery",
    MSG_NACK: "nack", MSG_PROFILE: "profile",
}

# magic, msg_type, status, count, words, stamp, data_len, crc32
# The CRC covers the header (with the crc field zeroed) AND the payload —
# the wire integrity layer: TCP's 16-bit checksum misses ~1/65k corrupted
# segments at scale, and a proxy/middlebox bitflip otherwise deserializes
# into silently wrong pages. A bad frame is indistinguishable from a
# desynchronized stream, so the only safe reaction is ProtocolError →
# drop the connection (ReconnectingClient degrades that to legal misses).
_HDR = struct.Struct("<HHIIIQQI")
_CRC_OFF = _HDR.size - 4  # crc is the trailing u32

KEEPALIVE_DELAY_S = 2.0   # PMNET_KEEPALIVE_DELAY_MS_DEFAULT (tcp.h:32)
IDLE_TIMEOUT_S = 30.0     # PMNET_IDLE_TIMEOUT_MS_DEFAULT (tcp.h:33)


def _device_ctx(be):
    """The backend's CUDA device for the calling thread (a serving thread
    must never run on whatever device its thread happens to default to);
    a no-op for CPU and device-less backends."""
    dev = getattr(be, "device", None)
    if dev is None or torch.device(dev).type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


class ProtocolError(ConnectionError):
    pass


def _as_view(part) -> memoryview:
    """Flat byte view of bytes/bytearray/ndarray WITHOUT copying — the
    scatter-gather framing unit (ndarrays must already be C-contiguous;
    callers `np.ascontiguousarray` where layout is caller-controlled)."""
    m = memoryview(part)
    if m.nbytes == 0:
        return memoryview(b"")  # cast() rejects zero-sized shapes
    if m.format != "B" or m.ndim != 1:
        m = m.cast("B")
    return m


def _sendmsg_all(sock: socket.socket, views: list) -> None:
    """sendmsg() the whole iovec, resuming after short writes. One
    syscall per frame (or per writer-coalesced frame GROUP) instead of
    one `bytes` concatenation per frame — the framing copy that used to
    double every PUT/SENDPAGE payload is gone."""
    total = sum(v.nbytes for v in views)
    sent = sock.sendmsg(views)
    while sent < total:
        total -= sent
        rest = []
        for v in views:
            if sent >= v.nbytes:
                sent -= v.nbytes
            elif sent:
                rest.append(v[sent:])
                sent = 0
            else:
                rest.append(v)
        views = rest
        sent = sock.sendmsg(views)


def _frame_views(msg_type: int, parts=(), status: int = 0, count: int = 0,
                 words: int = 0, stamp: int = 0) -> list:
    """Build one frame as an iovec [header, *payload_views]: the CRC runs
    incrementally across the parts, so multi-part payloads (keys + pages,
    found + hit rows) are never concatenated host-side."""
    views = [v for v in map(_as_view, parts) if v.nbytes]
    dlen = sum(v.nbytes for v in views)
    hdr0 = _HDR.pack(MAGIC, msg_type, status, count, words, stamp, dlen, 0)
    crc = zlib.crc32(hdr0)
    for v in views:
        crc = zlib.crc32(v, crc)
    hdr = hdr0[:_CRC_OFF] + struct.pack("<I", crc)
    return [memoryview(hdr), *views]


def _send_frame(sock: socket.socket, msg_type: int, parts=(),
                status: int = 0, count: int = 0, words: int = 0,
                stamp: int = 0) -> None:
    _sendmsg_all(sock, _frame_views(msg_type, parts, status, count, words,
                                    stamp))


def _send_msg(sock: socket.socket, msg_type: int, payload: bytes = b"",
              status: int = 0, count: int = 0, words: int = 0,
              stamp: int = 0) -> None:
    _send_frame(sock, msg_type, (payload,), status, count, words, stamp)


def _recv_into(sock: socket.socket, view: memoryview) -> None:
    got, n = 0, view.nbytes
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError("peer closed")
        got += r


def _recv_msg(sock: socket.socket, max_payload: int = 1 << 30):
    """Read one frame; the returned payload is a memoryview over a
    freshly-allocated buffer (safe to alias into numpy arrays; never
    reused), so reply/verb assembly pays no bytes() copy."""
    raw = bytearray(_HDR.size)
    _recv_into(sock, memoryview(raw))
    magic, msg_type, status, count, words, stamp, dlen, crc = \
        _HDR.unpack(raw)
    if magic != MAGIC:
        raise ProtocolError(f"bad magic {magic:#x}")
    if dlen > max_payload:
        raise ProtocolError(f"oversized frame {dlen}")
    payload = memoryview(bytearray(dlen)) if dlen else memoryview(b"")
    if dlen:
        _recv_into(sock, payload)
    raw[_CRC_OFF:] = b"\x00\x00\x00\x00"
    want = zlib.crc32(payload, zlib.crc32(raw)) if dlen else zlib.crc32(raw)
    if crc != want:
        raise ProtocolError(
            f"bad frame crc (type={msg_type} len={dlen}): "
            f"{crc:#010x} != {want:#010x}"
        )
    return msg_type, status, count, words, stamp, payload


# full-snapshot marker in a DIRDELTA reply's count field (upsert count
# rides the low 31 bits — a directory larger than 2^31 entries does not
# fit a frame long before it hits this bit)
DIR_FULL = 0x80000000


def _dir_pack(snap: dict) -> dict:
    """Directory snapshot -> the sorted-by-key64 form delta diffing
    wants (kept per client as the shipped baseline, like the bloom
    push's `last` filter copy)."""
    keys = np.asarray(snap["keys"], np.uint32).reshape(-1, 2)
    k64 = ((keys[:, 0].astype(np.uint64) << np.uint64(32))
           | keys[:, 1].astype(np.uint64))
    order = np.argsort(k64, kind="stable")
    return {
        "epoch": int(snap["epoch"]),
        "k64": k64[order],
        "keys": keys[order],
        "shards": np.asarray(snap["shards"], np.uint32)[order],
        "rows": np.asarray(snap["rows"], np.uint32)[order],
        "digs": np.asarray(snap["digs"], np.uint32)[order],
    }


def _dir_diff(last: dict, cur: dict):
    """(upsert_idx into cur, tombstone keys[T, 2]): entries whose
    (shard, row, digest) changed or appeared since `last`, and keys
    that vanished — the sorted-merge delta unit of the directory (the
    `GetUpdatedBlocks` analog at entry granularity)."""
    lk, ck = last["k64"], cur["k64"]
    if len(lk) == 0:
        return np.arange(len(ck)), np.zeros((0, 2), np.uint32)
    pos = np.clip(np.searchsorted(lk, ck), 0, len(lk) - 1)
    in_last = lk[pos] == ck
    same = (in_last
            & (last["shards"][pos] == cur["shards"])
            & (last["rows"][pos] == cur["rows"])
            & (last["digs"][pos] == cur["digs"]))
    if len(ck):
        rpos = np.clip(np.searchsorted(ck, lk), 0, len(ck) - 1)
        gone = ck[rpos] != lk
    else:
        gone = np.ones(len(lk), bool)
    return np.flatnonzero(~same), last["keys"][gone]


def _pack_keys(keys: np.ndarray) -> np.ndarray:
    # a C-contiguous uint32 array IS a wire part (scatter-gather framing);
    # no tobytes() copy
    return np.ascontiguousarray(keys, np.uint32)


def _unpack_keys(payload: bytes, count: int) -> np.ndarray:
    return np.frombuffer(payload, np.uint32, count * 2).reshape(count, 2)


class _BaseServer:
    """Shared TCP server machinery: listen socket, accept loop, connection
    and thread bookkeeping, stop/context-manager lifecycle. Subclasses
    implement `_serve_conn(conn)` (which owns the handshake)."""

    def __init__(self, host: str, port: int, idle_timeout_s: float,
                 thread_prefix: str):
        self.idle_timeout_s = idle_timeout_s
        self._thread_prefix = thread_prefix
        self._lsock = socket.create_server((host, port))
        self.host, self.port = self._lsock.getsockname()[:2]
        self._stop = threading.Event()
        # guarded-by: _conns, _threads, _accept_thread, _clients
        self._lock = san.lock("_BaseServer._lock")
        self._conns: list[socket.socket] = []
        self._threads: list[threading.Thread] = []
        self._accept_thread: threading.Thread | None = None

    def start(self):
        # start-once: a second start() (e.g. `with Server(...).start()`)
        # must not spawn a second accept loop; restart after stop() is not
        # a thing (_stop is never cleared)
        with self._lock:
            if self._accept_thread is not None:
                return self
            t = threading.Thread(target=self._accept_loop, daemon=True,
                                 name=f"{self._thread_prefix}-accept")
            self._accept_thread = t
            self._threads.append(t)
        t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            # shutdown first: on Linux a close() from another thread does
            # not wake the accept loop blocked on the socket, and the join
            # below would wait out its timeout
            self._lsock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._lsock.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
            threads = list(self._threads)
        for c in conns:
            # shutdown BEFORE close: each conn's serve thread is blocked
            # in recv() on it, and on Linux a bare close() from this
            # thread defers the real teardown until that recv returns —
            # the thread would linger (and could even serve one more op
            # after a "kill"), and the peer would wait out its full op
            # timeout instead of seeing the connection die.
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        for t in threads:
            t.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._lsock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True,
                                 name=f"{self._thread_prefix}-conn")
            with self._lock:
                self._conns.append(conn)
                self._threads = [x for x in self._threads if x.is_alive()]
                self._threads.append(t)
            t.start()

    def _drop_conn(self, conn: socket.socket) -> None:
        try:
            # shutdown-first (see stop()): the peer must see the drop
            # immediately, not at its op timeout
            conn.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            conn.close()
        except OSError:
            pass
        with self._lock:
            if conn in self._conns:
                self._conns.remove(conn)

    def _bump(self, key: str, n: int = 1) -> None:
        # `stats` is a per-instance telemetry Scope (registry-backed, the
        # ONE source of truth); bumps are per-metric-locked, so counts
        # from per-connection threads never lose increments
        self.stats.inc(key, n)

    def _serve_conn(self, conn: socket.socket) -> None:
        raise NotImplementedError


class _ConnState:
    """Per-connection state shared between its reader thread, its writer
    thread, and the flush loop. Replies are ENQUEUED (never sent from
    the flush thread): a peer that stops reading blocks only its own
    writer — the shared flush loop must never stall behind one slow
    socket. `out_bytes` caps the undrained backlog; a peer holding more
    than the cap in unread replies is treated as dead."""

    __slots__ = ("sock", "cl", "outq", "out_cv", "out_bytes", "alive",
                 "contain")

    def __init__(self, sock: socket.socket, cl: dict,
                 contain: bool = False):
        self.sock = sock
        self.cl = cl
        self.outq: collections.deque = collections.deque()
        # guarded-by: outq, out_bytes, alive
        self.out_cv = san.condition("_ConnState.out_cv")
        self.out_bytes = 0
        self.alive = True
        # this connection negotiated CONTAIN_FLAG: it accepts MSG_NACK
        # and may stamp deadline budgets (HOLASI count bit 5)
        self.contain = contain


class _StagedOp:
    """One decoded verb in the cross-connection staging queue. `keys`/
    `pages` alias the frame's own receive buffer (fresh per frame), so
    staging is zero-copy; `a`/`b` carry INSEXT's value/length."""

    __slots__ = ("cs", "mt", "seq", "count", "stamp", "trace", "keys",
                 "pages", "a", "b", "span", "t_ns", "tid", "deadline_ns")

    def __init__(self, cs, mt, seq, count, stamp, trace=0, keys=None,
                 pages=None, a=None, b=0):
        self.cs = cs
        self.mt = mt
        self.seq = seq
        self.count = count
        self.stamp = stamp
        # client-minted 32-bit trace id recovered from the frame header's
        # words field (0 = untraced peer) — stamped onto flush-phase spans
        self.trace = trace
        self.keys = keys
        self.pages = pages
        self.a = a
        self.b = b
        # server op span (tracing on): opened at staging by the reader
        # thread, closed by the flush loop when the op's phase completes
        # — queue wait is measured explicitly as its first child
        self.span = None
        self.t_ns = 0
        # QoS tenant id, resolved ONCE at decode time from the key
        # namespace prefix (0 = default tenant / plane off)
        self.tid = 0
        # absolute monotonic_ns end-to-end deadline (0 = none): decoded
        # once at staging from the request's relative µs budget (stamp
        # field, CONTAIN_FLAG connections); the flush loop sheds the op
        # with a NACK if it expires before device dispatch
        self.deadline_ns = 0


class _Waiter:
    """One in-window verb's completion slot (pipelined client)."""

    __slots__ = ("event", "reply", "error")

    def __init__(self):
        self.event = threading.Event()
        self.reply = None
        self.error = None


class NetServer(_BaseServer):
    """Serves a Backend (put/get/invalidate/packed_bloom) over TCP.

    `backend_factory()` is called once per op connection — pass e.g.
    `lambda: EngineBackend(kv_server)` for per-client arena isolation, or
    a closure returning one shared `DirectBackend` (ops on a shared backend
    are serialized by `op_lock`, the single-shared-KV discipline of
    `server/rdma_svr.cpp:1161-1176`).

    **Coalesced mode** (`net=NetConfig(...)`): the factory is called ONCE;
    per-connection reader threads stage decoded verbs into one shared
    queue, and a single flush loop drains puts/deletes/gets from ALL live
    connections into one fused device batch per phase (adaptive timeout +
    settle cutoff + pow2 pad ladder — `RuntimeConfig`'s engine-coalescer
    knobs on the wire tier), then routes per-connection result slices back
    to their sockets. N connections now share one device dispatch per
    flush instead of paying N serialized dispatches — the reference's
    multi-queue poller economics, which the lockstep `op_lock` path
    forfeited. `PMDFC_NET_PIPE=off` forces the legacy path.
    """

    def __init__(self, backend_factory, host: str = "127.0.0.1",
                 port: int = 0, bf_push_s: float = 0.0,
                 bf_block_bytes: int = 8192,
                 idle_timeout_s: float = IDLE_TIMEOUT_S,
                 serialize_ops: bool = True,
                 max_frame_bytes: int = 1 << 26,
                 net: NetConfig | None = None,
                 qos: QosConfig | None = None):
        super().__init__(host, port, idle_timeout_s, "net")
        # bound per-frame preallocation: an unauthenticated connection must
        # not be able to make the server allocate the protocol-wide 1 GiB
        # ceiling per socket (64 MB default fits ~15k 4 KB pages per verb)
        self.max_frame_bytes = max_frame_bytes
        self.backend_factory = backend_factory
        self.bf_push_s = bf_push_s
        self.bf_block_bytes = bf_block_bytes
        # guarded-by: <none>  (pure critical section: serializes backend
        # device programs on the legacy lockstep path)
        self.op_lock = san.lock("NetServer.op_lock") if serialize_ops \
            else None
        # Cross-connection batch scheduler (the reference's multi-queue
        # poller discipline on the wire tier): reader threads stage decoded
        # verbs, ONE flush loop fuses them into per-phase device batches.
        # `PMDFC_NET_PIPE=off` forces the legacy serialized path even when
        # a NetConfig is supplied (the conformance escape hatch).
        self.net = net
        self._coalesce = bool(net is not None and net.coalesce
                              and net_pipe_enabled())
        # seq-echo/pipeline ack: any server mode can serve pipelined
        # clients (echoing the request's seq costs nothing); only the
        # env kill-switch withholds the ack so clients fall back too.
        self._pipe_ok = net_pipe_enabled()
        # one-sided fast path (`PMDFC_FASTPATH`): resolved at
        # construction like the pipe switch; `off` withholds the HOLA
        # ack AND rejects the new verbs, so the wire transcript is
        # verb-for-verb the pre-fast-path protocol
        self._fast_ok = fastpath_enabled()
        # elastic membership verbs (`PMDFC_RING`): same contract — off
        # withholds the HOLASI ack and rejects RINGNOTE/HANDOFF, so the
        # transcript is verb-for-verb the static-placement protocol
        self._elastic_ok = ring_enabled()
        # device-side replica plane (`PMDFC_MESH2D`): off withholds the
        # lane-count ack and rejects MSG_RREPAIR — the 1-D transcript
        self._replica_ok = mesh2d_enabled()
        # device-time profiler verb (`PMDFC_PROF`): off withholds the
        # HOLASI ack and rejects MSG_PROFILE — the pre-profiler
        # transcript, byte-for-byte
        self._prof_ok = profiler_enabled()
        # client_id -> {"stamp": int, "push": socket|None, "last": ndarray|None}
        self._clients: dict[int, dict] = {}
        # registry-backed stats: the same mapping surface the old dict had
        # (`srv.stats["bad_frames"]`), now ONE source of truth with the
        # text exporter / teledump riding along. flush_max is a high-water
        # gauge; the rest are counters.
        self.stats = tele.scope("net", {
            "connects": 0, "ops": 0, "idle_kills": 0, "bad_frames": 0,
            "full_pushes": 0, "delta_pushes": 0, "blocks_pushed": 0,
            "push_cycles": 0, "flushes": 0, "coalesced_ops": 0,
            "serve_errors": 0, "pad_rows": 0,
            # fast-lane accounting: every FASTREAD lane is exactly one
            # of hit/stale, and total reads are DERIVED as hits + stale
            # (a third stored counter raced the other two under its own
            # lock, so a live MSG_STATS snapshot could catch the trio
            # mid-update and fail the bit-exact pin) — the bypass is
            # observable even though it never touches the KV stats
            # vector (zero dispatch)
            "fastpath_hits": 0, "fastpath_stale": 0,
            "dir_pulls": 0, "dir_entries_sent": 0,
            # elastic membership: transition notices received and pages
            # that arrived as migration handoffs (vs organic puts) —
            # the server-side attribution of a transition's traffic
            "ring_notes": 0, "handoff_pages": 0,
            # QoS overload shedding: VERBS answered without a dispatch
            # (edge bucket + ladder; pages ride the backend's miss_shed
            # cause lane, per-tenant split rides the qos.t* scopes)
            "shed_ops": 0,
            # blast-radius containment (rungs 7/9): NACK answers sent,
            # poison resubmits refused at staging (never reached the
            # device), bisection relaunches + the phase failures that
            # triggered them, culprit ops isolated, staged ops shed on
            # an expired end-to-end deadline
            "nacks_sent": 0, "poison_refused": 0, "bisect_launches": 0,
            "bisect_failures": 0, "poison_ops": 0, "deadline_shed": 0})
        self.stats.max("flush_max", 0)
        # current directory epoch as seen by the fast lane (gauge; 0
        # until the first pull/read touches a directory-capable backend)
        self.stats.set("dir_epoch", 0)
        # last membership epoch announced via MSG_RINGNOTE (gauge)
        self.stats.set("ring_epoch", 0)
        # flush-loop instrumentation (histograms ride the same scope but
        # not the mapping view, so the stats key set stays exact)
        self._h_flush_ops = self.stats.hist("flush_ops_hist")
        self._h_dwell = self.stats.hist("flush_dwell_us")
        # queue wait measured explicitly (staging -> phase start): the
        # stage a bare phase_*_us histogram can't see — the one that
        # grows first when the flush loop falls behind fan-in
        self._h_qwait = self.stats.hist("queue_wait_us")
        self._h_phase = {ph: self.stats.hist(f"phase_{ph}_us")
                         for ph in ("put", "ins_ext", "del", "get_ext",
                                    "get", "aux")}
        # workload characterization (`runtime/workload.py`): working-set
        # KMV + keyspace heat count-min, folded in on the host routing
        # path this loop already walks (gated on the tracing tier —
        # sketches are diagnostics, and the kill switch must zero them)
        self.workload = workload_mod.WorkloadSketch()
        self._flush_seq = 0
        self._staged: collections.deque = collections.deque()
        # guarded-by: _staged, and (qos on) the QosPlane lane structure
        # — the per-tenant queues/deficits/cursor that REPLACE _staged
        # inherit its guard (see runtime/qos.py QosPlane docstring)
        self._flush_cv = san.condition("NetServer._flush_cv")
        # multi-tenant QoS plane (`runtime/qos.py`): per-tenant staging
        # lanes drained DRR-fair + token-bucket edge admission + the
        # overload shed ladder. Resolved at construction like every
        # switch — `PMDFC_QOS=off` (or no QosConfig) keeps `_qos` None
        # and the staging path below is byte-identical to the
        # single-FIFO tree: zero new wire bytes either way, tenancy is
        # key-derived so there is no capability ack to withhold. Only
        # meaningful in coalesced mode (the lockstep path has no
        # staging queue to schedule).
        self._qos = (qos_mod.QosPlane(qos, self.stats.prefix)
                     if qos is not None and qos.enabled and qos_enabled()
                     and self._coalesce else None)
        # blast-radius containment (`PMDFC_CONTAINMENT`): resolved at
        # construction like every switch. Off withholds the HOLASI ack
        # (no client sends deadlines or reads NACK) and disables
        # bisection — a phase failure keeps exact rung-3 semantics.
        self._contain_cfg = ContainmentConfig(enabled=containment_enabled())
        self._contain_ok = self._contain_cfg.enabled
        # poison-fingerprint ring: key digests of isolated culprit ops.
        # A resubmitted poison op is REFUSED AT STAGING (answered NACK /
        # legacy legal miss) so it never reaches the device again.
        # Bounded slots + TTL; entries age out so a fixed op (or a hash
        # collision victim) regains service without a restart.
        # guarded-by: _poison_lock
        self._poison_lock = san.lock("NetServer._poison_lock")
        self._poison_ring: collections.OrderedDict[int, float] = \
            collections.OrderedDict()
        self._co_backend = None
        self._flush_thread: threading.Thread | None = None
        # dedicated backend for packing push filters — owned by the server,
        # never borrowed from (and never dying with) a client connection
        self._bloom_backend = None
        # guarded-by: <none>  (serializes push cycles: concurrent cycles
        # would interleave frames on a push socket)
        self._push_cycle_lock = san.lock("NetServer._push_cycle_lock")
        self._push_thread: threading.Thread | None = None
        # packed-directory cache shared by every client's DIRPULL while
        # the backend sits at one (epoch, mutation-seq) point — the pull
        # is a full index scan + digest verify + sort, and N periodic
        # refreshers must not pay it N times per quiet interval
        # guarded-by: _dir_cache
        self._dir_cache_lock = san.lock("NetServer._dir_cache_lock")
        self._dir_cache: tuple | None = None
        # live-settable flush knobs (the autotune controller's dwell/
        # settle hooks, `runtime/autotune.py`): the flush loop re-reads
        # them every cycle, so a set lands within one flush. Seeded from
        # the NetConfig — with no controller attached (or
        # PMDFC_AUTOTUNE=off) they never move and the loop behaves
        # exactly as the static config (the conformance contract).
        # guarded-by: _live_dwell_us, _live_settle_us
        self._knob_lock = san.lock("NetServer._knob_lock")
        self._live_dwell_us = float(net.flush_timeout_us if net
                                    else NetConfig.flush_timeout_us)
        self._live_settle_us = float(net.settle_us if net
                                     else NetConfig.settle_us)

    # -- live flush knobs (autotune hooks) --

    def flush_knobs(self) -> tuple[float, float]:
        """(dwell µs, settle µs) currently live in the flush loop."""
        with self._knob_lock:
            return self._live_dwell_us, self._live_settle_us

    def set_flush_timeout_us(self, v: float) -> float:
        """Live-set the adaptive flush dwell (clamped non-negative);
        picked up by the next flush cycle. Returns the applied value."""
        with self._knob_lock:
            self._live_dwell_us = max(0.0, float(v))
            return self._live_dwell_us

    def set_settle_us(self, v: float) -> float:
        """Live-set the quiet-queue settle cutoff (clamped
        non-negative); picked up by the next flush cycle."""
        with self._knob_lock:
            self._live_settle_us = max(0.0, float(v))
            return self._live_settle_us

    # -- live QoS rate knobs (autotune hooks; plane self-locks) --

    def qos_plane(self):
        """The live QosPlane, or None (plane off / lockstep mode) —
        the controller's probe for "are tenant knobs even available
        here", the `balloon_state` discipline."""
        return self._qos

    def qos_rate(self, tid: int) -> float | None:
        """A tenant's live admission rate (ops/s; 0 = unlimited), or
        None when the plane is off."""
        return self._qos.rate(tid) if self._qos is not None else None

    def set_qos_rate(self, tid: int, v: float) -> float:
        """Live-set a tenant's admission rate; picked up by the very
        next edge admission."""
        return self._qos.set_rate(tid, v)

    # -- lifecycle --

    def start(self) -> "NetServer":
        # windowed time-series: one process-wide low-duty collector
        # (idempotent per registry) samples registry deltas so MSG_STATS
        # ships rate windows and flight dumps carry the trajectory into
        # a failure (`runtime/timeseries.py`). Started UNCONDITIONALLY:
        # tick() itself honors the kill switch, and a live
        # `telemetry.set_enabled(True)` flip after start must find the
        # sampler armed (a v2 serving snapshot without its series block
        # would fail check_teledump).
        timeseries.ensure_collector()
        if self._coalesce and self._co_backend is None:
            # ONE serving backend for every connection: the whole point is
            # fusing verbs from all clients into one device batch per phase
            self._co_backend = self.backend_factory()
            f = threading.Thread(target=self._flush_loop, daemon=True,
                                 name="net-flush")
            self._flush_thread = f
            f.start()
            with self._lock:
                self._threads.append(f)
        super().start()
        if self.bf_push_s > 0 and self._push_thread is None:
            p = threading.Thread(target=self._push_loop, daemon=True,
                                 name="net-bf-sender")
            self._push_thread = p
            p.start()
            with self._lock:
                self._threads.append(p)
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._flush_cv:
            self._flush_cv.notify_all()
        super().stop()
        if self._co_backend is not None \
                and hasattr(self._co_backend, "close"):
            self._co_backend.close()
            self._co_backend = None
        if self._bloom_backend is not None \
                and hasattr(self._bloom_backend, "close"):
            self._bloom_backend.close()
            self._bloom_backend = None

    # -- dispatch --

    def _observe_workload(self, keys: np.ndarray) -> None:
        """Fold one verb's longkeys into the workload sketches (page
        verbs only — the callers pass [B, 2] key batches). One flag test
        when the tracing tier is off."""
        if tele.enabled():
            self.workload.observe(keys)

    def _client(self, cid: int) -> dict:
        with self._lock:
            return self._clients.setdefault(
                cid, {"cid": cid, "stamp": 0, "push": None, "last": None,
                      "ops": 0}
            )

    def _release_client(self, cid: int) -> None:
        """Drop a client record once it has no live channels (a churning
        server must not pin dead clients' packed-filter copies forever)."""
        with self._lock:
            cl = self._clients.get(cid)
            if cl is not None and cl["ops"] <= 0 and cl["push"] is None:
                del self._clients[cid]

    def _serve_conn(self, conn: socket.socket) -> None:
        backend = None
        cid = None
        is_push = False
        op_registered = False
        try:
            conn.settimeout(self.idle_timeout_s)
            try:
                mt, chan_raw, cid32, words, cid64, _ = _recv_msg(
                    conn, max_payload=self.max_frame_bytes)
            except socket.timeout:
                self._bump("idle_kills")
                return
            if mt != MSG_HOLA:
                raise ProtocolError("expected HOLA")
            chan = chan_raw & 0xFF
            # 64-bit id rides in the stamp field (u64); the count field
            # carries the low 32 for older peers. 32 random bits collide
            # at ~2^-32/pair, and a collision silently merges two clients'
            # stamp domains (cross-retiring overlay entries = false
            # negatives), so the id space must make that negligible.
            cid = cid64 or cid32
            cl = self._client(cid)
            if chan == CHAN_PUSH:
                # push channels carry no pages and own no backend
                is_push = True
                _send_msg(conn, MSG_HOLASI, status=0)
                self._bump("connects")
                with self._lock:
                    cl["push"] = conn
                    # a (re)registered channel starts from a clean slate:
                    # the previous baseline may never have been DELIVERED,
                    # and deltas against an unseen baseline would retire
                    # overlay bits the mirror doesn't have (false negative)
                    cl["last"] = None
                self._push_channel_hold(conn)
                return
            # HOLASI count is a capability bitfield: bit 0 = seq-echo
            # (pipelining) ack, bit 1 = trace-field ack. Old clients only
            # ever requested PIPE_FLAG and test `count == 1`-equivalent
            # truthiness on bit 0, so the bitfield stays interoperable.
            pipe_ack = 1 if self._pipe_ok else 0
            if (chan_raw & TRACE_FLAG) and tele.enabled():
                pipe_ack |= 2
            if (chan_raw & ELASTIC_FLAG) and self._elastic_ok:
                pipe_ack |= 8
            # containment ack (bit 5): the connection may be answered
            # MSG_NACK and may stamp deadline budgets — withheld when
            # PMDFC_CONTAINMENT is off so the transcript stays
            # verb-for-verb the rung-3 protocol
            if (chan_raw & CONTAIN_FLAG) and self._contain_ok:
                pipe_ack |= 32
            # profiler ack (bit 6): the connection may send MSG_PROFILE
            # — withheld when PMDFC_PROF is off server-side, so the
            # transcript stays the pre-profiler protocol
            if (chan_raw & PROF_FLAG) and self._prof_ok:
                pipe_ack |= 64
            # HOLASI stamp = this server's monotonic_ns at the exchange:
            # the client brackets it between its send and recv stamps to
            # estimate the clock offset tracetool needs to place server
            # spans on the client timeline. Old clients never read the
            # (previously zero) field; the frame layout is unchanged.
            now_ns = time.monotonic_ns()
            if self._coalesce:
                if words and words != self._co_backend.page_words:
                    _send_msg(conn, MSG_HOLASI, status=1,
                              words=self._co_backend.page_words)
                    return
                if (chan_raw & FAST_FLAG) and self._fast_ok \
                        and self._fast_capable(self._co_backend):
                    pipe_ack |= 4
                pipe_ack |= self._replica_ack(self._co_backend, chan_raw)
                _send_msg(conn, MSG_HOLASI, status=0,
                          words=self._co_backend.page_words,
                          count=pipe_ack, stamp=now_ns)
                self._bump("connects")
                with self._lock:
                    cl["ops"] += 1
                op_registered = True
                with _device_ctx(self._co_backend):
                    self._op_loop_coalesced(
                        _ConnState(conn, cl, contain=bool(pipe_ack & 32)))
                return
            backend = self.backend_factory()
            if words and words != backend.page_words:
                _send_msg(conn, MSG_HOLASI, status=1,
                          words=backend.page_words)
                return
            if (chan_raw & FAST_FLAG) and self._fast_ok \
                    and self._fast_capable(backend):
                pipe_ack |= 4
            pipe_ack |= self._replica_ack(backend, chan_raw)
            _send_msg(conn, MSG_HOLASI, status=0,
                      words=backend.page_words, count=pipe_ack,
                      stamp=now_ns)
            self._bump("connects")
            with self._lock:
                cl["ops"] += 1
            op_registered = True
            with _device_ctx(backend):
                self._op_loop(conn, backend, cl)
        except ProtocolError:
            # corrupted/desynced frame (bad magic, bad crc, unknown op):
            # count it and drop ONLY this connection — the peer's
            # ReconnectingClient degrades and re-attaches
            self._bump("bad_frames")
            tele.rung("bad_frame", server=self.stats.prefix,
                      conn=-1 if cid is None else cid & 0xFFFFFFFF)
        except (ConnectionError, OSError, ValueError):
            # socket.timeout is an OSError and lands here too; the
            # idle-kill accounting happens at the inner recv sites
            pass
        finally:
            self._drop_conn(conn)
            if cid is not None:
                with self._lock:
                    cl = self._clients.get(cid)
                    if cl is not None:
                        if is_push and cl["push"] is conn:
                            cl["push"] = None
                        elif op_registered:
                            cl["ops"] -= 1
                self._release_client(cid)
            if backend is not None and hasattr(backend, "close"):
                backend.close()

    def _replica_ack(self, be, chan_raw: int) -> int:
        """HOLASI bits for the device-replica capability: bit 4 plus the
        backend's lane count in bits 8..15. Zero when the client never
        asked (`REPLICA_FLAG`), `PMDFC_MESH2D` is off, or the backend
        runs a 1-D plane — the connection then speaks the exact 1-D
        protocol and never sees MSG_RREPAIR."""
        if not (chan_raw & REPLICA_FLAG) or not self._replica_ok:
            return 0
        lanes = int(getattr(be, "replica_lanes", 1) or 1)
        if lanes <= 1:
            return 0
        return 16 | ((lanes & 0xFF) << 8)

    # -- one-sided fast lane (reader-side: never staged, no dispatch) --

    def _fast_capable(self, be) -> bool:
        """Whether this backend can actually serve the fast lane (a
        paged pool) — the HOLA ack gate. An unpaged backend's view is
        None and the client keeps the plain verb protocol."""
        fn = getattr(be, "fast_view", None)
        if fn is None:
            return False
        try:
            return fn() is not None
        except Exception:  # noqa: BLE001 — a capability probe must
            return False   # never take the handshake down

    def _serve_fastread(self, be, count: int, stamp: int, payload):
        """Validate + serve one FASTREAD batch against the backend's live
        pool: `(ok[N], hit_rows, page_words, epoch)`. Runs on the
        CONNECTION'S READER thread: no flush-queue wait, no staged
        dispatch. The view's `read` checks the epoch and each lane's
        stored digest and gathers the validated rows in ONE call under
        the KV lock, so no put can land between the check and the
        gather. A lane that fails comes back not-ok and the client
        re-asks through the verb path (never wrong bytes)."""
        n = count
        keys = _unpack_keys(payload, n)
        off = n * 8
        shards = np.frombuffer(payload, np.uint32, n, offset=off)
        rows = np.frombuffer(payload, np.uint32, n, offset=off + 4 * n)
        digs = np.frombuffer(payload, np.uint32, n, offset=off + 8 * n)
        self._observe_workload(keys)
        fn = getattr(be, "fast_view", None)
        fv = fn() if fn is not None else None
        W = be.page_words
        if fv is None:
            ok = np.zeros(n, bool)
            epoch = 0
            hit = np.zeros((0, W), np.uint32)
        else:
            ok, hit, epoch = fv.read(stamp, shards, rows, digs)
            hit = np.ascontiguousarray(hit, np.uint32)
        nh = int(np.count_nonzero(ok))
        self.stats.inc("fastpath_hits", nh)
        self.stats.inc("fastpath_stale", n - nh)
        self.stats.set("dir_epoch", epoch)
        return ok, hit, W, epoch

    def _serve_dirpull(self, be, cl: dict, want_delta: bool):
        """Build one DIRPULL reply: `(parts, count, words, stamp)` or
        None when the backend has no directory (unpaged/scan-less —
        the client gets NOTEXIST and keeps the verb path). The last
        snapshot shipped to this CLIENT is remembered (like the bloom
        push baseline) so a repeat pull ships only changed entries +
        tombstones; a re-registered or first-time client gets the full
        table (`DIR_FULL`)."""
        fn = getattr(be, "directory_snapshot", None)
        self._bump("dir_pulls")
        if fn is None:
            return None
        # (epoch, seq)-keyed cache probe: fast_view() is the cheap
        # mutation-point oracle (itself cached), so an unmutated backend
        # packs ONCE no matter how many clients refresh. The fast_view
        # call runs lock-free here (it takes the KV lock internally);
        # only the cache slot swap sits under the leaf lock.
        fv_fn = getattr(be, "fast_view", None)
        fv = fv_fn() if fv_fn is not None else None
        cur = None
        if fv is not None:
            with self._dir_cache_lock:
                c = self._dir_cache
                if c is not None and c[0] == fv.epoch and c[1] == fv.seq:
                    cur = c[2]
        if cur is None:
            snap = fn(max_entries=max(1, self.max_frame_bytes // 32))
            if snap is None:
                return None
            cur = _dir_pack(snap)
            if fv is not None:
                # a mutation racing between the fv probe and the scan
                # only wastes this slot (the next probe sees a new seq
                # and rebuilds); it can never serve an older directory
                with self._dir_cache_lock:
                    self._dir_cache = (fv.epoch, fv.seq, cur)
        with self._lock:
            last = cl.get("dir_last") if want_delta else None
            cl["dir_last"] = cur
        if last is None:
            up = np.arange(len(cur["k64"]))
            tombs = np.zeros((0, 2), np.uint32)
            full = DIR_FULL
        else:
            up, tombs = _dir_diff(last, cur)
            full = 0
        self._bump("dir_entries_sent", len(up))
        self.stats.set("dir_epoch", cur["epoch"])
        parts = (np.ascontiguousarray(cur["keys"][up]),
                 np.ascontiguousarray(cur["shards"][up]),
                 np.ascontiguousarray(cur["rows"][up]),
                 np.ascontiguousarray(cur["digs"][up]),
                 np.ascontiguousarray(tombs, np.uint32))
        return parts, (len(up) | full), len(tombs), cur["epoch"]

    def _serve_recovery(self, be, subcmd: int, lock):
        """MSG_RECOVERY body, shared by the lockstep loop (which passes
        its backend lock) and the coalesced aux phase (which already
        serializes with the flush loop — lock=None): subcmd 0 queries
        `recovery_info()`, 1 flips `mark_recovered()` (idempotent).
        Backends without the warm-restart surface answer
        `{"recovering": false}` — the verb is unconditional, like
        MSG_STATS."""
        import json as _json

        if subcmd == 1:
            fn = getattr(be, "mark_recovered", None)
            if lock is not None and fn is not None:
                with lock:
                    was = bool(fn())
            else:
                was = bool(fn()) if fn is not None else False
            body = {"recovering": False, "was_recovering": was}
            return _json.dumps(body).encode("utf-8"), int(was)
        fn = getattr(be, "recovery_info", None)
        if lock is not None and fn is not None:
            with lock:
                info = fn()
        else:
            info = fn() if fn is not None else {"recovering": False}
        return (_json.dumps(info).encode("utf-8"),
                int(bool(info.get("recovering"))))

    def _serve_profile(self, duration_ms: int):
        """MSG_PROFILE body, shared by the lockstep loop and the
        coalesced aux phase (both already serialize with dispatch, so
        the capture window brackets whole launches). Starts ONE bounded
        `torch.profiler` session under the flight recorder's dump dir
        via the attached profiler — its own thread stops it, so the
        serving loop never blocks for the capture window. Returns the
        reply payload (JSON bytes) or None = refuse (MSG_NOTEXIST):
        profiler not attached, no dump dir, capture live, or cooldown."""
        import json as _json

        from pmdfc_tpu_torch.runtime import profiler as prof_mod

        p = prof_mod.active()
        if p is None:
            return None
        res = p.start_capture(int(duration_ms) or 200)
        if res is None:
            return None
        return _json.dumps(res).encode("utf-8")

    def _serve_ringnote(self, be, ring_epoch: int, members: int,
                        cid: int) -> int:
        """One membership-transition notice: bump the backend's
        one-sided directory epoch (STRUCTURAL invalidation — every
        cached client mirror stops validating and falls back to the
        verb path until its next refresh), gauge the announced ring
        epoch, and fire the flight-recorder event the transition
        trajectory is keyed on. Returns the new directory epoch (0 for
        directory-less backends — the notice still lands in telemetry).
        Cheap (one lock-held counter bump), so it serves inline on the
        reader thread like the fast lane."""
        fn = getattr(be, "bump_dir_epoch", None)
        new_epoch = int(fn()) if fn is not None else 0
        self._bump("ring_notes")
        self.stats.set("ring_epoch", int(ring_epoch))
        if new_epoch:
            self.stats.set("dir_epoch", new_epoch)
        tele.rung("membership_change", server=self.stats.prefix,
                  ring_epoch=int(ring_epoch), members=int(members),
                  conn=cid & 0xFFFFFFFF, dir_epoch=new_epoch)
        return new_epoch

    def _push_channel_hold(self, conn: socket.socket) -> None:
        """Push channels are server→client; just park until closed. The
        blocking read detects a closed/dead peer (no idle kill here — a
        healthy push channel is legitimately silent)."""
        conn.settimeout(None)
        while not self._stop.is_set():
            mt, *_ = _recv_msg(conn, max_payload=self.max_frame_bytes)
            if mt == MSG_ADIOS:
                return

    def _op_loop(self, conn: socket.socket, backend, cl: dict) -> None:
        # every reply echoes the request's seq (the status field) so a
        # pipelined client can match replies by sequence id; lockstep
        # clients always send seq 0 and the echo is byte-identical to
        # the legacy protocol
        W = backend.page_words
        while not self._stop.is_set():
            try:
                # on op requests the `words` field carries the client's
                # 32-bit trace id (0 = untraced peer; see TRACE_FLAG)
                mt, seq, count, words, stamp, payload = _recv_msg(
                    conn, max_payload=self.max_frame_bytes)
            except socket.timeout:
                self._bump("idle_kills")
                return
            if mt == MSG_ADIOS:
                return
            self._bump("ops")
            if mt == MSG_KEEPALIVE:
                _send_msg(conn, MSG_KEEPALIVE, status=seq)
                continue
            t_op = time.perf_counter()
            lock = self.op_lock
            if mt == MSG_PUTPAGE or (mt == MSG_HANDOFF
                                     and self._elastic_ok):
                keys = _unpack_keys(payload, count)
                self._observe_workload(keys)
                pages = np.frombuffer(
                    payload, np.uint32, count * W, offset=count * 8
                ).reshape(count, W)
                if lock:
                    with lock:
                        backend.put(keys, pages)
                else:
                    backend.put(keys, pages)
                # applied-stamp AFTER the put returns: this put is now
                # provably inside any filter packed later
                with self._lock:
                    cl["stamp"] = max(cl["stamp"], stamp)
                if mt == MSG_HANDOFF:
                    # migration traffic, attributed apart from organic
                    # puts (the transition trajectory's server half)
                    self._bump("handoff_pages", count)
                _send_msg(conn, MSG_SUCCESS, count=count, status=seq)
            elif mt == MSG_RINGNOTE and self._elastic_ok:
                members = (int(np.frombuffer(payload, np.uint32, 1)[0])
                           if len(payload) >= 4 else 0)
                ne = self._serve_ringnote(backend, count, members,
                                          cl["cid"])
                _send_msg(conn, MSG_SUCCESS, count=count, status=seq,
                          stamp=ne)
            elif mt == MSG_GETPAGE:
                keys = _unpack_keys(payload, count)
                self._observe_workload(keys)
                if lock:
                    with lock:
                        pages, found = backend.get(keys)
                else:
                    pages, found = backend.get(keys)
                found = np.asarray(found, bool)
                _send_frame(conn,
                            MSG_SENDPAGE if found.any() else MSG_NOTEXIST,
                            (found.astype(np.uint8),
                             np.ascontiguousarray(pages[found], np.uint32)),
                            count=count, words=W, status=seq)
            elif mt == MSG_INVALIDATE:
                keys = _unpack_keys(payload, count)
                self._observe_workload(keys)
                if lock:
                    with lock:
                        hit = backend.invalidate(keys)
                else:
                    hit = backend.invalidate(keys)
                _send_frame(conn, MSG_SUCCESS,
                            (np.asarray(hit, np.uint8),), count=count,
                            status=seq)
            elif mt == MSG_INSEXT:
                # key[2] + value[2] + length, all u32; count echoes the
                # server-reported uncovered tail (0 = fully indexed)
                key = np.frombuffer(payload, np.uint32, 2)
                val = np.frombuffer(payload, np.uint32, 2, offset=8)
                length = int(np.frombuffer(payload, np.uint32, 1,
                                           offset=16)[0])
                if lock:
                    with lock:
                        uncovered = backend.insert_extent(key, val, length)
                else:
                    uncovered = backend.insert_extent(key, val, length)
                _send_msg(conn, MSG_SUCCESS, count=int(uncovered),
                          status=seq)
            elif mt == MSG_GETEXT:
                keys = _unpack_keys(payload, count)
                if lock:
                    with lock:
                        vals, efound = backend.get_extent(keys)
                else:
                    vals, efound = backend.get_extent(keys)
                efound = np.asarray(efound, bool)
                _send_frame(conn, MSG_SENDPAGE,
                            (efound.astype(np.uint8),
                             np.ascontiguousarray(vals, np.uint32)),
                            count=count, words=2, status=seq)
            elif mt == MSG_STATS:
                # counter snapshot (kv stats + tier counters when the
                # backend exposes them); backends without a stats surface
                # report an empty object, not an error
                import json as _json

                fn = getattr(backend, "stats", None)
                if lock and fn is not None:
                    with lock:
                        snap = fn()
                else:
                    snap = fn() if fn is not None else {}
                if tele.enabled():
                    # the wire surface pmdfc_tpu_torch.tools.teledump
                    # pulls: the whole process registry + workload
                    # sketches ride the backend snapshot
                    # (`pmdfc-telemetry-v2`)
                    snap = dict(snap)
                    snap["telemetry"] = tele.snapshot()
                    snap["workload"] = self.workload.snapshot()
                _send_msg(conn, MSG_SUCCESS,
                          _json.dumps(snap).encode("utf-8"), status=seq)
            elif mt == MSG_FASTREAD and self._fast_ok:
                ok, hit, Wf, epoch = self._serve_fastread(
                    backend, count, stamp, payload)
                _send_frame(conn, MSG_SENDPAGE,
                            (ok.astype(np.uint8), hit),
                            count=count, words=Wf, status=seq, stamp=epoch)
            elif mt == MSG_DIRPULL and self._fast_ok:
                rep = self._serve_dirpull(backend, cl, count == 1)
                if rep is None:
                    _send_msg(conn, MSG_NOTEXIST, status=seq)
                else:
                    parts, cnt, nt, epoch = rep
                    _send_frame(conn, MSG_DIRDELTA, parts, count=cnt,
                                words=nt, status=seq, stamp=epoch)
            elif mt == MSG_RREPAIR and self._replica_ok:
                # device-side replica anti-entropy pass (one collective
                # compare-and-copy over the plane's lane axis); count
                # echoes the rows repaired. 1-D backends answer 0.
                fn = getattr(backend, "replica_repair", None)
                if lock and fn is not None:
                    with lock:
                        repaired = int(fn())
                else:
                    repaired = int(fn()) if fn is not None else 0
                _send_msg(conn, MSG_SUCCESS, count=repaired, status=seq)
            elif mt == MSG_RECOVERY:
                # warm-restart surface: count 0 = query, 1 = mark
                # recovered (idempotent; the replica tier calls it when
                # a rejoined endpoint's repair queue drains)
                body, cnt = self._serve_recovery(backend, count, lock)
                _send_msg(conn, MSG_SUCCESS, body, count=cnt, status=seq)
            elif mt == MSG_PROFILE and self._prof_ok:
                # bounded on-demand device-time capture; refusal
                # (cooldown/no dump dir) is a normal NOTEXIST answer
                body = self._serve_profile(count)
                if body is None:
                    _send_msg(conn, MSG_NOTEXIST, status=seq)
                else:
                    _send_msg(conn, MSG_SUCCESS, body, status=seq)
            elif mt == MSG_BFPULL:
                # echo the client's newest APPLIED-put stamp, sampled
                # BEFORE the pack (same safe retire bound as _push_cycle).
                # It lives in the same clock domain as push-frame stamps;
                # echoing the request stamp (client 'now') would make every
                # later push look stale to the sink until a newer put
                # out-stamped it — silently freezing the push path.
                with self._lock:
                    applied = cl["stamp"]
                packed = backend.packed_bloom()
                if packed is None:
                    _send_msg(conn, MSG_NOTEXIST, stamp=applied, status=seq)
                else:
                    _send_frame(conn, MSG_BFPUSH,
                                (np.ascontiguousarray(packed, np.uint32),),
                                stamp=applied, status=seq)
            else:
                raise ProtocolError(f"unexpected op {mt}")
            tele.record_span(
                "server", _OP_NAMES.get(mt, f"op{mt}"), words, True,
                dur_us=(time.perf_counter() - t_op) * 1e6,
                conn=cl["cid"] & 0xFFFFFFFF, mode="lockstep")

    # -- cross-connection batch scheduler (coalesced mode) --

    def _op_loop_coalesced(self, cs: _ConnState) -> None:
        """Reader half of the scheduler: decode verbs off THIS connection
        into the shared staging queue; the flush loop executes and
        enqueues replies, which this connection's own writer thread
        drains. Keepalives answer from here (enqueued like any reply —
        no backend, no ordering)."""
        W = self._co_backend.page_words
        conn = cs.sock
        wt = threading.Thread(target=self._conn_writer, args=(cs,),
                              daemon=True, name="net-conn-writer")
        wt.start()
        try:
            while not self._stop.is_set():
                try:
                    mt, seq, count, words, stamp, payload = _recv_msg(
                        conn, max_payload=self.max_frame_bytes)
                except socket.timeout:
                    self._bump("idle_kills")
                    return
                if mt == MSG_ADIOS:
                    return
                self._bump("ops")
                if mt == MSG_KEEPALIVE:
                    self._enqueue_reply(
                        cs, _frame_views(MSG_KEEPALIVE, status=seq))
                    continue
                if mt == MSG_FASTREAD and self._fast_ok:
                    # fast lane: validated direct row read served INLINE
                    # on this reader thread — no staging-queue wait, no
                    # flush dwell, no device dispatch (the one-sided
                    # read path; stale lanes fall back via the client)
                    t_op = time.perf_counter()
                    ok, hit, Wf, epoch = self._serve_fastread(
                        self._co_backend, count, stamp, payload)
                    self._enqueue_reply(cs, _frame_views(
                        MSG_SENDPAGE, (ok.astype(np.uint8), hit),
                        status=seq, count=count, words=Wf, stamp=epoch))
                    if tele.enabled():
                        tele.record_span(
                            "server", "fastread", words, True,
                            dur_us=(time.perf_counter() - t_op) * 1e6,
                            conn=cs.cl["cid"] & 0xFFFFFFFF,
                            mode="fastlane")
                    continue
                if mt == MSG_DIRPULL and self._fast_ok:
                    rep = self._serve_dirpull(self._co_backend, cs.cl,
                                              count == 1)
                    if rep is None:
                        self._enqueue_reply(
                            cs, _frame_views(MSG_NOTEXIST, status=seq))
                    else:
                        parts, cnt, nt, epoch = rep
                        self._enqueue_reply(cs, _frame_views(
                            MSG_DIRDELTA, parts, status=seq, count=cnt,
                            words=nt, stamp=epoch))
                    continue
                if mt == MSG_RINGNOTE and self._elastic_ok:
                    # membership notice: one lock-held counter bump —
                    # served inline on the reader like the fast lane
                    # (staging it behind a flush dwell would let fast
                    # reads race the epoch bump)
                    members = (int(np.frombuffer(payload,
                                                 np.uint32, 1)[0])
                               if len(payload) >= 4 else 0)
                    ne = self._serve_ringnote(self._co_backend, count,
                                              members, cs.cl["cid"])
                    self._enqueue_reply(cs, _frame_views(
                        MSG_SUCCESS, status=seq, count=count, stamp=ne))
                    continue
                if mt == MSG_PUTPAGE or (mt == MSG_HANDOFF
                                         and self._elastic_ok):
                    op = _StagedOp(
                        cs, mt, seq, count, stamp, trace=words,
                        keys=_unpack_keys(payload, count),
                        pages=np.frombuffer(
                            payload, np.uint32, count * W, offset=count * 8
                        ).reshape(count, W),
                    )
                elif mt in (MSG_GETPAGE, MSG_INVALIDATE, MSG_GETEXT):
                    op = _StagedOp(cs, mt, seq, count, stamp, trace=words,
                                   keys=_unpack_keys(payload, count))
                elif mt == MSG_INSEXT:
                    op = _StagedOp(
                        cs, mt, seq, count, stamp, trace=words,
                        keys=np.frombuffer(payload, np.uint32, 2),
                        a=np.frombuffer(payload, np.uint32, 2, offset=8),
                        b=int(np.frombuffer(payload, np.uint32, 1,
                                            offset=16)[0]),
                    )
                elif mt in (MSG_STATS, MSG_BFPULL, MSG_RECOVERY) or (
                        mt == MSG_RREPAIR and self._replica_ok) or (
                        mt == MSG_PROFILE and self._prof_ok):
                    op = _StagedOp(cs, mt, seq, count, stamp, trace=words)
                else:
                    raise ProtocolError(f"unexpected op {mt}")
                if self._contain_ok and cs.contain:
                    # end-to-end deadline budget (rung 9): relative µs
                    # in the request's (otherwise-zero on these verbs)
                    # stamp field, pinned to an ABSOLUTE monotonic
                    # deadline once at decode — queue wait and flush
                    # dwell all count against it
                    if mt in (MSG_GETPAGE, MSG_GETEXT) and stamp:
                        op.deadline_ns = (time.monotonic_ns()
                                          + int(stamp) * 1000)
                if self._contain_ok and self._poison_hit(op):
                    # rung 7, staging half: a fingerprinted poison
                    # resubmit is refused on the reader thread — it
                    # never reaches the staging queue or the device
                    self._refuse_op(op)
                    continue
                if self._qos is not None:
                    op.tid = self._qos.resolve(op.keys)
                    if op.mt in (MSG_GETPAGE, MSG_PUTPAGE) \
                            and not self._qos.admit(op.tid, op.count):
                        # EDGE SHED: the tenant's token bucket refused
                        # the verb — answer it right here (all-miss GET
                        # / acked-drop PUT), attribute the pages into
                        # the miss_shed cause lane, and never stage.
                        # Only the two page verbs are sheddable: an
                        # unanswered INVALIDATE/INSEXT/aux would break
                        # protocol semantics, not degrade them.
                        self._qos.note_arrival(op.tid, staged=False)
                        self._shed_op(op, ladder=False)
                        continue
                    self._qos.note_arrival(op.tid, staged=True)
                if tele.enabled():
                    # the server op span opens HERE (staging): queue wait
                    # is inside it, measured explicitly as a child when
                    # the flush loop picks the op up. Cross-thread close
                    # => explicit root parent, no ambient push.
                    op.t_ns = time.monotonic_ns()
                    op.span = tele.span_begin(
                        "server", _OP_NAMES.get(mt, f"op{mt}"),
                        trace=op.trace, parent=0, ambient=False,
                        t0_ns=op.t_ns, conn=cs.cl["cid"] & 0xFFFFFFFF)
                victims = ()
                with self._flush_cv:
                    if self._qos is not None:
                        self._qos.stage(op)
                        # LADDER SHED: depth crossed the threshold —
                        # pick victims under the cv (lane surgery) but
                        # answer them outside it (_flush_cv is a
                        # HOLD_WATCH lock; replies acquire the conn cv)
                        victims = self._qos.shed_overflow(
                            self._sheddable)
                    else:
                        self._staged.append(op)
                    self._flush_cv.notify()
                for v in victims:
                    self._shed_op(v, ladder=True)
        finally:
            # alive flips UNDER the cv (analyzer guarded-write fix): the
            # writer's wait-loop predicate and _enqueue_reply's gate both
            # read it under the cv — a bare write raced them (an enqueue
            # could slip in between the flag write and the notify, leaving
            # the writer to push one frame into a conn being torn down)
            with cs.out_cv:
                cs.alive = False
                cs.out_cv.notify_all()
            wt.join(timeout=5)

    @staticmethod
    def _sheddable(op: _StagedOp) -> bool:
        """Shed eligibility: only the page verbs have a degraded-but-
        legal answer (all-miss / acked-drop). Everything else —
        INVALIDATE (a dropped delete resurrects data), extents, aux,
        HANDOFF (migration must be loss-free) — rides out the
        overload."""
        return op.mt in (MSG_GETPAGE, MSG_PUTPAGE)

    def _shed_op(self, op: _StagedOp, ladder: bool) -> None:
        """Answer one shed op WITHOUT a device dispatch and attribute
        it: a shed GET is the exact all-miss frame a served empty GET
        produces; a shed PUT is the exact MSG_SUCCESS ack (the client
        sees a put that was immediately evicted — a legal cache
        outcome). Pages land in the backend's miss_shed lane via
        `account_shed` so `misses == Σ causes` holds on every stats
        surface; backends without the hook (plain pools) still get the
        per-tenant scope counters."""
        gets = op.count if op.mt == MSG_GETPAGE else 0
        puts = op.count if op.mt == MSG_PUTPAGE else 0
        if op.mt == MSG_GETPAGE:
            W = self._co_backend.page_words
            self._reply(op, MSG_NOTEXIST,
                        (np.zeros(op.count, np.uint8),
                         np.zeros((0, W), np.uint32)),
                        count=op.count, words=W)
        else:
            self._reply(op, MSG_SUCCESS, count=op.count)
        self._qos.note_shed_verbs(op.tid, int(bool(gets)),
                                  int(bool(puts)), ladder=ladder)
        fn = getattr(self._co_backend, "account_shed", None)
        if fn is not None:
            fn(gets, puts)
        self._bump("shed_ops")
        if op.span is not None:
            tele.span_end(op.span, ok=False, err="shed")
            op.span = None

    def _staged_depth_locked(self) -> int:
        """Staging depth under the flush cv, whichever structure holds
        it (the QoS lanes replace `_staged` when the plane is on)."""
        return (self._qos.depth() if self._qos is not None
                else len(self._staged))

    def _drain_locked(self, n: int) -> list:
        if self._qos is not None:
            return self._qos.drain(n)
        out = []
        while self._staged and len(out) < n:
            out.append(self._staged.popleft())
        return out

    def _flush_loop(self) -> None:
        """The flush thread: `_flush_cycles` on the serving backend's
        device."""
        with _device_ctx(self._co_backend):
            self._flush_cycles()

    def _flush_cycles(self) -> None:
        """Flush half of the scheduler: adaptive dwell from the first
        staged op (`flush_timeout_us`), early settle cutoff when the
        queue goes quiet (`settle_us`), hard cap at `flush_ops` — the
        engine coalescer's knobs, applied to the wire tier. Dwell and
        settle are re-read from the live knob fields every cycle so the
        autotune controller's sets land within one flush (with no
        controller they hold the NetConfig values verbatim)."""
        cfg = self.net
        while True:
            dwell_us_live, settle_us_live = self.flush_knobs()
            dwell_s = dwell_us_live / 1e6
            settle_s = max(settle_us_live / 1e6, 1e-4)
            with self._flush_cv:
                while not self._staged_depth_locked() \
                        and not self._stop.is_set():
                    self._flush_cv.wait(0.2)
                if self._stop.is_set() \
                        and not self._staged_depth_locked():
                    return
                batch = self._drain_locked(cfg.flush_ops)
            t0 = time.monotonic()
            while len(batch) < cfg.flush_ops and not self._stop.is_set():
                left = dwell_s - (time.monotonic() - t0)
                if left <= 0:
                    break
                with self._flush_cv:
                    if not self._staged_depth_locked():
                        self._flush_cv.wait(min(settle_s, left))
                    more = self._drain_locked(cfg.flush_ops - len(batch))
                if not more:
                    break  # settle cutoff: the queue went quiet
                batch.extend(more)
            # dwell = first-drain to serve-start: how long ops sat in the
            # staging queue accumulating batch mates
            dwell_us = (time.monotonic() - t0) * 1e6
            self._h_dwell.observe(dwell_us)
            # cadence-sampled continuous-profiling gauges (one flush =
            # one sample): queue depth at serve start + last dwell —
            # the levels an operator watches drift before a p99 does
            with self._flush_cv:
                backlog = self._staged_depth_locked()
            self.stats.set("staging_depth", backlog + len(batch))
            self.stats.max("staging_depth_max", backlog + len(batch))
            self.stats.set("flush_dwell_last_us", round(dwell_us, 1))
            try:
                self._serve_coalesced(batch)
            except Exception:  # noqa: BLE001 — one bad batch must never
                # kill the scheduler for every live connection
                import traceback

                traceback.print_exc()
                self._bump("serve_errors")
                # no dangling open spans, even on the scheduler's
                # catch-all path: an exception in a phase's REPLY
                # assembly escapes past _spans without closing the
                # ambient flush span — unwinding here keeps the flush
                # thread's span stack sane for every later flush
                tele.unwind_ambient(err="serve_error")
                for o in batch:
                    if o.span is not None:
                        tele.span_end(o.span, ok=False,
                                      err="serve_error")
                        o.span = None
                    self._kill_op_conn(o)

    def _pad_fused(self, keys: np.ndarray, pages: np.ndarray | None = None):
        """Pow2 pad ladder for fused widths (floor `pad_floor`): padded
        rows carry the INVALID key sentinel — they match nothing and
        place nothing, so the compiled-shape set stays bounded without
        changing results.

        Mesh-plane backends (`routes_per_shard`) skip the global pad:
        their router re-bins the batch by owning shard and pads PER
        SHARD up its own ladder — padding here first would only inflate
        the routed width (the fused-pad/routing co-design of the
        serving plane)."""
        cfg = self.net
        n = len(keys)
        if not cfg.pad_pow2 or n == 0 or getattr(
                self._co_backend, "routes_per_shard", False):
            return (keys, pages) if pages is not None else keys
        w = max(cfg.pad_floor, 1 << (n - 1).bit_length())
        if w <= n:
            return (keys, pages) if pages is not None else keys
        self.stats.inc("pad_rows", w - n)  # pow2-ladder waste, in rows
        pk = np.full((w, 2), _INVALID, np.uint32)
        pk[:n] = keys
        if pages is None:
            return pk
        pp = np.zeros((w, pages.shape[1]), np.uint32)
        pp[:n] = pages
        return pk, pp

    def _enqueue_reply(self, cs: _ConnState, frame: list) -> bool:
        """Queue one reply frame for the connection's writer. Returns
        False (and kills the connection) when the peer's undrained
        backlog exceeds the cap — a peer that stopped reading must cost
        only itself, never the shared flush thread (which is why no
        reply is ever SENT from the flush loop)."""
        nbytes = sum(v.nbytes for v in frame)
        cap = 2 * self.max_frame_bytes + (1 << 20)
        with cs.out_cv:
            if not cs.alive:
                return False
            if cs.out_bytes + nbytes > cap:
                cs.alive = False
            else:
                cs.outq.append(frame)
                cs.out_bytes += nbytes
                cs.out_cv.notify()
                return True
        self._drop_conn(cs.sock)
        return False

    def _conn_writer(self, cs: _ConnState) -> None:
        """Per-connection reply writer: the only thread that sends on
        this socket in coalesced mode (reader keepalives and flush-loop
        results both arrive through the queue, so frames never
        interleave)."""
        while True:
            with cs.out_cv:
                while not cs.outq and cs.alive \
                        and not self._stop.is_set():
                    cs.out_cv.wait(0.2)
                if not cs.outq:
                    return  # dead or stopping, nothing left to drain
                frames = [cs.outq.popleft()
                          for _ in range(len(cs.outq))]
                cs.out_bytes -= sum(sum(v.nbytes for v in fr)
                                    for fr in frames)
            try:
                views: list = []
                for fr in frames:
                    if len(views) + len(fr) > 512:
                        _sendmsg_all(cs.sock, views)
                        views = []
                    views.extend(fr)
                if views:
                    _sendmsg_all(cs.sock, views)
            except (ConnectionError, OSError):
                with cs.out_cv:
                    cs.alive = False
                self._drop_conn(cs.sock)
                return

    def _reply(self, o: _StagedOp, mt: int, parts=(), count: int = 0,
               words: int = 0, stamp: int = 0) -> None:
        if not o.cs.alive:
            return
        self._enqueue_reply(
            o.cs, _frame_views(mt, parts, status=o.seq, count=count,
                               words=words, stamp=stamp))

    def _kill_op_conn(self, o: _StagedOp) -> None:
        with o.cs.out_cv:
            if not o.cs.alive:
                # idempotent: a concurrent phase (or the reader's own
                # teardown) already dropped this connection — a second
                # drop/notify must not re-close a possibly-reused fd
                return
            o.cs.alive = False        # under the cv, like every reader
            o.cs.out_cv.notify_all()  # writer exits now, not at its tick
        self._drop_conn(o.cs.sock)

    def _phase_failed(self, ops: list, phase: str = "?",
                      exc: BaseException | None = None) -> None:
        """A fused phase raised server-side and containment could not
        (or was not negotiated to) answer it: the legal reaction is
        dropping the involved connections — their clients degrade to
        misses/drops and reconnect (ladder rung 3). The flight recorder
        captures WHICH phase took WHICH connections down AND the
        exception itself (repr in the rung, traceback routed through
        the recorder — bare stderr only when telemetry is off)."""
        import sys
        import traceback

        if exc is None:
            exc = sys.exc_info()[1]
        if tele.enabled():
            # the traceback belongs in the flight ring next to the rung
            # (a post-mortem artifact), not interleaved on stderr
            tb = ("".join(traceback.format_exception(exc))[-2000:]
                  if exc is not None else "")
            tele.record_event("phase_traceback", phase=phase, tb=tb)
        else:
            traceback.print_exc()
        self._bump("serve_errors")
        for o in ops:
            if o.span is not None:
                # close the op's tree node as FAILED (the open-span-
                # closure contract chaos drills pin: a dropped conn's
                # staged verbs must not leave dangling open spans)
                tele.span_end(o.span, ok=False, phase=phase,
                              flush=self._flush_seq, err="phase_failure")
                o.span = None
            else:
                tele.record_span("server", _OP_NAMES.get(o.mt, f"op{o.mt}"),
                                 o.trace, False, phase=phase,
                                 conn=o.cs.cl["cid"] & 0xFFFFFFFF,
                                 flush=self._flush_seq)
            self._kill_op_conn(o)
        tele.rung("phase_failure", server=self.stats.prefix, phase=phase,
                  ops=len(ops), flush=self._flush_seq,
                  error="" if exc is None else repr(exc)[:300],
                  conns=sorted({o.cs.cl["cid"] & 0xFFFFFFFF for o in ops}))

    # -- blast-radius containment (ladder rungs 7 and 9) --

    @staticmethod
    def _poison_digest(o: _StagedOp) -> int:
        """Fingerprint of one op for the poison ring: CRC32 of its key
        batch seeded with the verb, so a resubmission of the SAME op is
        what matches (a GET for a poisoned PUT's keys is not refused)."""
        return zlib.crc32(o.keys.tobytes(), o.mt & 0xFF) & 0xFFFFFFFF

    def _poison_mark(self, o: _StagedOp) -> None:
        """Ring in an isolated culprit's fingerprint (bounded slots +
        TTL): its resubmission is refused at STAGING — the poison never
        reaches the device twice — and ages out once the TTL passes, so
        a fixed op (or a hash-collision victim) regains service without
        a restart."""
        if o.keys is None:
            return
        dg = self._poison_digest(o)
        cfg = self._contain_cfg
        with self._poison_lock:
            self._poison_ring[dg] = time.monotonic() + cfg.fingerprint_ttl_s
            self._poison_ring.move_to_end(dg)
            while len(self._poison_ring) > cfg.fingerprint_slots:
                self._poison_ring.popitem(last=False)

    def _poison_hit(self, o: _StagedOp) -> bool:
        if o.keys is None:
            return False
        with self._poison_lock:
            if not self._poison_ring:
                return False
            exp = self._poison_ring.get(self._poison_digest(o))
            if exp is None:
                return False
            if time.monotonic() >= exp:
                del self._poison_ring[self._poison_digest(o)]
                return False
            return True

    _NACK_ERRS = {NACK_POISON: "nack:poison", NACK_REFUSED: "nack:refused",
                  NACK_DEADLINE: "nack:deadline"}

    def _nack_op(self, o: _StagedOp, cause: int, phase: str = "",
                 exc: BaseException | None = None) -> None:
        """Answer one op with the negotiated error verb — an explicit,
        cause-carrying LEGAL degraded result (the client maps it to
        all-miss / acked-drop / nothing-found) on a connection that
        stays alive. Only ever called for `cs.contain` connections."""
        self._reply(o, MSG_NACK, count=o.count, words=cause)
        self._bump("nacks_sent")
        if cause == NACK_DEADLINE:
            self._bump("deadline_shed")
            if o.mt == MSG_GETPAGE:
                # the pages the client will read as misses: attributed
                # into the miss_deadline cause lane so misses == Σ causes
                fn = getattr(self._co_backend, "account_deadline", None)
                if fn is not None:
                    fn(o.count, 0)
        err = self._NACK_ERRS.get(cause, "nack")
        if o.span is not None:
            tele.span_end(o.span, ok=False, err=err,
                          flush=self._flush_seq,
                          **({"phase": phase} if phase else {}))
            o.span = None
        else:
            tele.record_span("server", _OP_NAMES.get(o.mt, f"op{o.mt}"),
                             o.trace, False, err=err,
                             conn=o.cs.cl["cid"] & 0xFFFFFFFF)

    def _refuse_op(self, op: _StagedOp) -> None:
        """Staging-time refusal of a fingerprinted poison resubmit: the
        op is answered on the READER thread and never staged, so it can
        never take a fused batch down twice. Negotiated connections get
        the cause-carrying NACK; legacy peers get the legal degraded
        answer their protocol already understands (all-miss / acked
        drop / nothing found) — refusing is a degradation, not an
        error, so no connection drops."""
        self._bump("poison_refused")
        if op.cs.contain:
            self._reply(op, MSG_NACK, count=op.count, words=NACK_REFUSED)
            self._bump("nacks_sent")
        elif op.mt == MSG_GETPAGE:
            W = self._co_backend.page_words
            self._reply(op, MSG_NOTEXIST,
                        (np.zeros(op.count, np.uint8),
                         np.zeros((0, W), np.uint32)),
                        count=op.count, words=W)
        elif op.mt in (MSG_PUTPAGE, MSG_HANDOFF):
            self._reply(op, MSG_SUCCESS, count=op.count)
        elif op.mt == MSG_INVALIDATE:
            self._reply(op, MSG_SUCCESS,
                        (np.zeros(op.count, np.uint8),), count=op.count)
        elif op.mt == MSG_GETEXT:
            self._reply(op, MSG_SENDPAGE,
                        (np.zeros(op.count, np.uint8),
                         np.zeros((op.count, 2), np.uint32)),
                        count=op.count, words=2)
        else:  # MSG_INSEXT: nothing covered
            self._reply(op, MSG_SUCCESS, count=int(op.b))
        if tele.enabled():
            tele.record_span("server", _OP_NAMES.get(op.mt, f"op{op.mt}"),
                             op.trace, False, err="nack:refused",
                             conn=op.cs.cl["cid"] & 0xFFFFFFFF)

    def _phase_guard(self, ops: list, phase: str, serve, begin,
                     spans) -> None:
        """Run one fused phase with rung-7 containment: `serve(ops)`
        must launch and REPLY for exactly `ops` (any subset relaunches
        correctly). On failure the batch is retried in halves —
        bounded ≤⌈log₂ b⌉ FAILED relaunches per culprit — until the
        culpable op(s) are isolated; healthy ops complete normally on
        live connections."""
        t0, t0_ns, fs = begin(phase, len(ops))
        try:
            serve(ops)
        except Exception as e:  # noqa: BLE001 — contain, never unwind
            tele.span_end(fs, ok=False)
            if not self._contain_ok or not self._contain_cfg.bisect:
                self._phase_failed(ops, phase, exc=e)
            elif len(ops) <= 1:
                self._isolated(ops, phase, e)
            else:
                self._bump("bisect_failures")
                mid = len(ops) // 2
                for half in (ops[:mid], ops[mid:]):
                    self._bump("bisect_launches")
                    self._phase_guard(half, phase, serve, begin, spans)
        else:
            spans(ops, phase, t0, t0_ns, fs)

    def _isolated(self, ops: list, phase: str,
                  exc: BaseException) -> None:
        """Terminal bisection state: `ops` (typically one) are the
        culprits. Fingerprint them (resubmits refused at staging), NACK
        negotiated connections — their conns STAY ALIVE — and give
        legacy peers exact rung-3 semantics, scoped to the culprit's
        connection only."""
        nacked, legacy = [], []
        for o in ops:
            self._poison_mark(o)
            (nacked if o.cs.contain else legacy).append(o)
        self._bump("poison_ops", len(ops))
        for o in nacked:
            self._nack_op(o, NACK_POISON, phase=phase, exc=exc)
        if nacked:
            tele.rung("nack", server=self.stats.prefix, phase=phase,
                      cause="poison", ops=len(nacked),
                      flush=self._flush_seq, error=repr(exc)[:300],
                      conns=sorted({o.cs.cl["cid"] & 0xFFFFFFFF
                                    for o in nacked}))
        if legacy:
            self._phase_failed(legacy, phase, exc=exc)

    def _serve_coalesced(self, batch: list) -> None:
        """Execute one fused flush. Phase order mirrors the engine driver
        (`runtime/server.py`): puts → extent inserts → deletes → extent
        gets → gets — a client that pipelines put→get of one key within
        a flush sees its own write; cross-CLIENT conflicts inside one
        flush are unordered, the same contract as the engine tier."""
        be = self._co_backend
        W = be.page_words
        if self._contain_ok:
            # rung 9: shed already-expired staged ops BEFORE any device
            # dispatch — dead work must never burn a flush slot. Only
            # CONTAIN_FLAG connections ever carry a deadline, so every
            # shed op has a NACK-speaking peer.
            now_ns = time.monotonic_ns()
            expired = [o for o in batch
                       if o.deadline_ns and now_ns >= o.deadline_ns]
            if expired:
                batch = [o for o in batch
                         if not (o.deadline_ns and now_ns >= o.deadline_ns)]
                for o in expired:
                    self._nack_op(o, NACK_DEADLINE)
                tele.rung("deadline_shed", server=self.stats.prefix,
                          ops=len(expired), flush=self._flush_seq + 1)
        self.stats.inc("flushes")
        self.stats.inc("coalesced_ops", len(batch))
        self.stats.max("flush_max", len(batch))
        self._h_flush_ops.observe(len(batch))
        self._flush_seq += 1
        fseq = self._flush_seq
        if tele.enabled():
            # workload sketches ride the flush loop's existing touch of
            # every request (no extra pass, no device work)
            kk = [o.keys for o in batch
                  if o.keys is not None
                  and o.mt in (MSG_PUTPAGE, MSG_HANDOFF, MSG_GETPAGE,
                               MSG_INVALIDATE)]
            if kk:
                self.workload.observe(
                    np.concatenate(kk) if len(kk) > 1 else kk[0])

        def _phase_begin(phase: str, n_ops: int):
            """(perf t0, monotonic t0_ns, ambient flush-phase span).
            The flush span stays open across the backend call so the
            mesh plane's per-shard program spans nest under it."""
            return (time.perf_counter(), time.monotonic_ns(),
                    tele.span_begin("server", f"flush:{phase}",
                                    flush=fseq, phase=phase, ops=n_ops))

        def _spans(ops: list, phase: str, t0: float, t0_ns: int,
                   fs) -> None:
            """Close this phase's span tree for every involved op: the
            op span (opened at staging) gets its queue-wait child
            (staging → phase start, measured explicitly) and its phase
            child (cross-linked to the flush span by flush seq) — the
            flush-side half of the client→wire→queue→phase→shard
            trace."""
            if not tele.enabled():
                tele.span_end(fs)  # unwind ambient even if toggled off
                return
            dur = (time.perf_counter() - t0) * 1e6
            self._h_phase[phase].observe(dur)
            tele.span_end(fs, ok=True)
            t1_ns = time.monotonic_ns()
            for o in ops:
                if o.span is not None:
                    # lean completed-node records (no Span alloc, no
                    # ambient traffic): this runs per op per flush
                    tele.record_tree_span(
                        "server", "queue_wait", o.trace, o.span.sid,
                        o.t_ns, t0_ns)
                    self._h_qwait.observe((t0_ns - o.t_ns) / 1e3)
                    tele.record_tree_span(
                        "server", "phase", o.trace, o.span.sid,
                        t0_ns, t1_ns, phase=phase, flush=fseq)
                    tele.span_end(o.span, ok=True, t1_ns=t1_ns,
                                  phase=phase, flush=fseq)
                    o.span = None
                else:
                    tele.record_span(
                        "server", _OP_NAMES.get(o.mt, f"op{o.mt}"),
                        o.trace, True, dur_us=dur, phase=phase,
                        flush=fseq, conn=o.cs.cl["cid"] & 0xFFFFFFFF)

        # migration handoffs fuse into the SAME put phase (one device
        # batch), distinguished only in accounting: the transition's
        # bulk traffic is attributable without costing a second dispatch.
        # Every fused phase serves through a SUBSET-RELAUNCHABLE closure
        # behind `_phase_guard`: a phase failure bisects to the culprit
        # op(s) instead of taking every involved connection down.
        puts = [o for o in batch if o.mt in (MSG_PUTPAGE, MSG_HANDOFF)]

        def _serve_put(ops: list) -> None:
            keys = np.concatenate([o.keys for o in ops])
            pages = np.concatenate([o.pages for o in ops])
            if len(keys):
                pk, pp = self._pad_fused(keys, pages)
                be.put(pk, pp)
            for o in ops:
                # applied-stamp AFTER the fused put returns: this
                # put is provably inside any filter packed later
                with self._lock:
                    o.cs.cl["stamp"] = max(o.cs.cl["stamp"], o.stamp)
                if o.mt == MSG_HANDOFF:
                    self._bump("handoff_pages", o.count)
                self._reply(o, MSG_SUCCESS, count=o.count)

        if puts:
            self._phase_guard(puts, "put", _serve_put,
                              _phase_begin, _spans)

        def _serve_ins(ops: list) -> None:
            for o in ops:
                uncovered = be.insert_extent(o.keys, o.a, o.b)
                self._reply(o, MSG_SUCCESS, count=int(uncovered))

        for o in (o for o in batch if o.mt == MSG_INSEXT):
            self._phase_guard([o], "ins_ext", _serve_ins,
                              _phase_begin, _spans)

        def _serve_del(ops: list) -> None:
            keys = np.concatenate([o.keys for o in ops])
            hit = (np.asarray(be.invalidate(self._pad_fused(keys)),
                              bool)[:len(keys)]
                   if len(keys) else np.zeros(0, bool))
            lo = 0
            for o in ops:
                h = hit[lo:lo + o.count]
                lo += o.count
                self._reply(o, MSG_SUCCESS, (h.astype(np.uint8),),
                            count=o.count)

        dels = [o for o in batch if o.mt == MSG_INVALIDATE]
        if dels:
            self._phase_guard(dels, "del", _serve_del,
                              _phase_begin, _spans)

        def _serve_gext(ops: list) -> None:
            keys = np.concatenate([o.keys for o in ops])
            vals, ef = be.get_extent(self._pad_fused(keys))
            vals = np.asarray(vals, np.uint32)
            ef = np.asarray(ef, bool)
            lo = 0
            for o in ops:
                f = ef[lo:lo + o.count]
                v = np.ascontiguousarray(vals[lo:lo + o.count])
                lo += o.count
                self._reply(o, MSG_SENDPAGE,
                            (f.astype(np.uint8), v),
                            count=o.count, words=2)

        gexts = [o for o in batch if o.mt == MSG_GETEXT]
        if gexts:
            self._phase_guard(gexts, "get_ext", _serve_gext,
                              _phase_begin, _spans)

        fused_fn = getattr(be, "get_fused", None)

        def _serve_get(ops: list) -> None:
            fused = None
            keys = np.concatenate([o.keys for o in ops])
            if len(keys) and fused_fn is not None:
                # mesh plane: reply rows gather straight out of the
                # ROUTED buffer per connection slice (hit rows only,
                # one fancy-index per frame) — the full request-order
                # page matrix is never materialized
                fused = fused_fn(keys)
                found = np.asarray(fused.found, bool)
            elif len(keys):
                pages, found = be.get(self._pad_fused(keys))
                pages = np.asarray(pages)
                found = np.asarray(found, bool)
            else:
                pages = np.zeros((0, W), np.uint32)
                found = np.zeros(0, bool)
            lo = 0
            for o in ops:
                f = found[lo:lo + o.count]
                if fused is not None:
                    hitrows = fused.hit_rows(lo, lo + o.count)
                else:
                    hitrows = np.ascontiguousarray(
                        pages[lo:lo + o.count][f], np.uint32)
                lo += o.count
                self._reply(o,
                            MSG_SENDPAGE if f.any() else MSG_NOTEXIST,
                            (f.astype(np.uint8), hitrows),
                            count=o.count, words=W)

        gets = [o for o in batch if o.mt == MSG_GETPAGE]
        if gets:
            self._phase_guard(gets, "get", _serve_get,
                              _phase_begin, _spans)

        for o in (o for o in batch
                  if o.mt in (MSG_STATS, MSG_BFPULL, MSG_RREPAIR,
                              MSG_RECOVERY, MSG_PROFILE)):
            t0, t0_ns, fs = _phase_begin("aux", 1)
            try:
                if o.mt == MSG_RECOVERY:
                    body, cnt = self._serve_recovery(be, o.count, None)
                    self._reply(o, MSG_SUCCESS, (body,), count=cnt)
                elif o.mt == MSG_PROFILE:
                    # bounded capture start, serialized with the flush
                    # loop so the trace brackets whole launches; the
                    # stop rides a timer thread — no dwell added here
                    body = self._serve_profile(o.count)
                    if body is None:
                        self._reply(o, MSG_NOTEXIST)
                    else:
                        self._reply(o, MSG_SUCCESS, (body,))
                elif o.mt == MSG_RREPAIR:
                    # replica anti-entropy: a device dispatch like any
                    # phase, so it runs HERE (serialized with the flush
                    # loop's programs), never on a reader thread
                    fn = getattr(be, "replica_repair", None)
                    repaired = int(fn()) if fn is not None else 0
                    self._reply(o, MSG_SUCCESS, count=repaired)
                elif o.mt == MSG_STATS:
                    import json as _json

                    fn = getattr(be, "stats", None)
                    snap = fn() if fn is not None else {}
                    if tele.enabled():
                        snap = dict(snap)
                        snap["telemetry"] = tele.snapshot()
                        snap["workload"] = self.workload.snapshot()
                    self._reply(o, MSG_SUCCESS,
                                (_json.dumps(snap).encode("utf-8"),))
                else:
                    # same applied-stamp echo contract as the lockstep
                    # BFPULL (sampled BEFORE the pack)
                    with self._lock:
                        applied = o.cs.cl["stamp"]
                    packed = be.packed_bloom()
                    if packed is None:
                        self._reply(o, MSG_NOTEXIST, stamp=applied)
                    else:
                        self._reply(
                            o, MSG_BFPUSH,
                            (np.ascontiguousarray(packed, np.uint32),),
                            stamp=applied)
            except Exception as e:  # noqa: BLE001
                tele.span_end(fs, ok=False)
                if self._contain_ok and o.cs.contain:
                    # aux is already per-op (blast radius = one conn):
                    # containment just upgrades the drop to a NACK the
                    # peer maps to a legal empty answer, conn alive
                    self._nack_op(o, NACK_POISON, phase="aux", exc=e)
                else:
                    self._phase_failed([o], "aux", exc=e)
            else:
                _spans([o], "aux", t0, t0_ns, fs)

    # -- server→client bloom push (`rdpma_bf_sender` analog) --

    def push_bloom_now(self) -> dict:
        """One push cycle over every registered push channel: full filter
        first time, changed blocks after (`GetUpdatedBlocks` delta unit).
        Serialized — concurrent cycles would interleave frames on a push
        socket and corrupt the stream."""
        with self._push_cycle_lock:
            return self._push_cycle()

    def _push_cycle(self) -> dict:
        out = {"full": 0, "delta": 0, "blocks": 0}
        # sample every client's applied-stamp BEFORE the (single) pack:
        # any put applied before its sampled stamp is also applied before
        # the later pack, so the echoed stamp stays a safe retire bound
        with self._lock:
            targets = [
                (cid, d["push"], d["stamp"], d["last"])
                for cid, d in self._clients.items()
                if d["push"] is not None
            ]
        if not targets:
            return out
        # lazy dedicated backend — only built once a push channel exists
        if self._bloom_backend is None:
            self._bloom_backend = self.backend_factory()
        with _device_ctx(self._bloom_backend):
            packed = self._bloom_backend.packed_bloom()
        if packed is None:
            return out
        packed = np.asarray(packed, np.uint32)
        # delta unit: the configured block, shrunk (by gcd) to divide the
        # packed length exactly — a filter smaller than one block degrades
        # to word-granular deltas rather than dying on a ragged reshape
        wpb = math.gcd(max(1, self.bf_block_bytes // 4), len(packed))
        for cid, psock, stamp, last in targets:
            try:
                if last is None or last.shape != packed.shape:
                    _send_frame(psock, MSG_BFPUSH, (packed,), stamp=stamp)
                    out["full"] += 1
                    self._bump("full_pushes")
                else:
                    diff = (last ^ packed).reshape(-1, wpb)
                    idx = np.flatnonzero((diff != 0).any(axis=1))
                    if len(idx) == 0:
                        continue
                    _send_frame(
                        psock, MSG_BFBLOCKS,
                        (np.ascontiguousarray(idx, np.uint32),
                         np.ascontiguousarray(packed.reshape(-1, wpb)[idx])),
                        count=len(idx), words=wpb, stamp=stamp)
                    out["delta"] += 1
                    out["blocks"] += len(idx)
                    self._bump("delta_pushes")
                    self._bump("blocks_pushed", len(idx))
                with self._lock:
                    cl = self._clients.get(cid)
                    # identity guard on success too: if the channel
                    # reconnected mid-cycle (its "last" reset to None), a
                    # send into the DEAD socket's buffer must not record a
                    # baseline the new channel never received
                    if cl is not None and cl["push"] is psock:
                        cl["last"] = packed
            except (ConnectionError, OSError):
                with self._lock:
                    cl = self._clients.get(cid)
                    # identity guard: the channel may have RECONNECTED since
                    # this cycle sampled it — deregister only our dead socket
                    if cl is not None and cl["push"] is psock:
                        cl["push"] = None
                self._release_client(cid)
        self._bump("push_cycles")
        return out

    def _push_loop(self) -> None:
        while not self._stop.wait(self.bf_push_s):
            try:
                self.push_bloom_now()
            except Exception:  # noqa: BLE001 — the sender must outlive any
                pass           # single bad cycle (pushes are best-effort)


class _WindowGate:
    """Adjustable counting gate over the pipeline window — the
    `BoundedSemaphore` it replaces could not resize, and the autotune
    controller needs the in-flight verb cap live-settable. Semantics
    match the semaphore's: `acquire(timeout)` blocks while `limit`
    verbs are outstanding, `release` is over-release tolerant (the
    teardown path may release a slot the failure path already gave
    back). Shrinking the limit below the current occupancy never
    revokes granted slots — new acquires simply wait until the window
    drains under the new cap."""

    def __init__(self, limit: int):
        # guarded-by: _limit, _active
        self._cv = san.condition("_WindowGate._cv")
        self._limit = max(1, int(limit))
        self._active = 0

    def acquire(self, timeout: float | None = None) -> bool:
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        with self._cv:
            while self._active >= self._limit:
                left = None if deadline is None \
                    else deadline - time.monotonic()
                if left is not None and left <= 0:
                    return False
                self._cv.wait(left)
            self._active += 1
            return True

    def release(self) -> None:
        with self._cv:
            if self._active > 0:
                self._active -= 1
            self._cv.notify()

    def set_limit(self, n: int) -> int:
        with self._cv:
            self._limit = max(1, int(n))
            # widening may unblock waiters immediately; narrowing just
            # changes the admission predicate they re-check
            self._cv.notify_all()
            return self._limit

    @property
    def limit(self) -> int:
        with self._cv:
            return self._limit

    @property
    def active(self) -> int:
        with self._cv:
            return self._active


class TcpBackend:
    """Client Backend over the TCP messenger.

    Same batched surface as the other backends (`put/get/invalidate/
    packed_bloom`); any transport failure closes the connection and raises
    `ConnectionError` — `ReconnectingClient` turns that into legal degraded
    results and retries the connection later.

    `bloom_sink` (optional): an object with `receive_bloom_full` /
    `receive_bloom_blocks` (i.e. a `CleanCacheClient`) that consumes
    server pushes arriving on the push channel. Echoed stamps are this
    client's own `monotonic_ns` values, converted back to seconds, so the
    sink's snapshot-staleness logic works unchanged across the process
    boundary.

    **Pipelined protocol** (default; `pipeline=False` or
    `PMDFC_NET_PIPE=off` for lockstep): op frames carry a sequence id
    (echoed in the reply header), up to `window` verbs may be
    outstanding at once, and a writer/reader thread pair owns the
    socket — concurrent threads sharing one backend overlap their
    round trips instead of convoying behind a single lockstep verb.
    Replies match by sequence id; an unmatched/duplicated/misshaped
    reply, or a verb missing its per-verb deadline (`op_timeout_s`),
    drops the connection and fails every in-window verb with
    `ConnectionError` — `ReconnectingClient` degrades those to legal
    misses/drops and journaled invalidates, exactly the lockstep
    failure path.
    """

    def __init__(self, host: str, port: int, page_words: int = 1024,
                 bloom_sink=None, op_timeout_s: float = IDLE_TIMEOUT_S,
                 keepalive_s: float | None = KEEPALIVE_DELAY_S,
                 client_id: int | None = None,
                 max_frame_bytes: int = 1 << 26,
                 pipeline: bool | None = None, window: int = 32,
                 directory: bool = False, dir_max_entries: int = 1 << 20,
                 deadline_ms: float = 0.0):
        self.page_words = page_words
        self.op_timeout_s = op_timeout_s
        # end-to-end deadline budget stamped on read verbs (0 = none);
        # only honored once the connection negotiates CONTAIN_FLAG
        self.deadline_ms = max(0.0, float(deadline_ms))
        # bound every reply read: a buggy/malicious SERVER must not be able
        # to make this client pre-allocate the 1 GiB _recv_msg default
        # (VERDICT-r3 weak 5 — the same bound servers already apply)
        self.max_frame_bytes = max_frame_bytes
        # guarded-by: _closed
        self._lock = san.lock("TcpBackend._lock")
        self._closed = False
        self._stop = threading.Event()
        self.client_id = (
            client_id if client_id is not None
            else ((os.getpid() << 32)
                  ^ int.from_bytes(os.urandom(8), "little"))
            & 0xFFFFFFFFFFFFFFFF
        )
        # env overrides the param (the compatibility kill-switch), the
        # param overrides the default; actual mode still needs the
        # server's handshake ack (old/foreign servers get lockstep)
        self._want_pipe = net_pipe_enabled(
            default=True if pipeline is None else bool(pipeline))
        self.window = max(1, int(window))
        self.pipelined = False
        # op tracing: request the TRACE_FLAG capability when the tracing
        # tier is live; `traced` holds the negotiated outcome. Per-verb
        # latency + window occupancy ride the process-shared client scope
        # (per-connection scopes would explode under sweep churn).
        self.traced = False
        # peer-clock offset estimated during the HOLA exchange (None
        # until the op handshake answers with a server stamp)
        self.clock_offset_ns: int | None = None
        # one-sided fast path: request the capability only when a
        # directory was asked for AND the kill switch allows — an
        # unrequested/unacked connection sends none of the new verbs
        # (the PMDFC_FASTPATH=off conformance contract)
        self._want_fast = bool(directory) and fastpath_enabled()
        self.fastpath = False
        self.directory = None
        # elastic membership verbs (PMDFC_RING): requested whenever the
        # ring tier is on — an unrequested/unacked connection sends
        # none of them (the PMDFC_RING=off conformance contract)
        self._want_elastic = ring_enabled()
        self.elastic = False
        # device-side replica plane (PMDFC_MESH2D): the server's lane
        # count (1 = no fused replication) — a ReplicaGroup reads this
        # to delegate its fan-out; unacked connections stay at 1 and
        # never send MSG_RREPAIR (the conformance contract)
        self._want_replica = mesh2d_enabled()
        self.replica_lanes = 1
        # blast-radius containment (PMDFC_CONTAINMENT): when acked, the
        # server may answer any op MSG_NACK (mapped below to the legal
        # degraded result — never an exception, so ReconnectingClient
        # never retries NACKed work) and this client may stamp deadline
        # budgets. Unrequested/unacked connections keep the rung-3
        # conn-drop protocol verb-for-verb.
        self._want_contain = containment_enabled()
        self.nack = False
        # device-time profiler verb (PMDFC_PROF): when acked, this
        # client may request bounded on-demand captures (MSG_PROFILE);
        # unacked (old peer / kill switch) server_profile() returns
        # None without sending a frame.
        self._want_prof = profiler_enabled()
        self.prof = False
        self._dir_max_entries = dir_max_entries
        self._tele = tele.scope("net.client", unique=False)
        self._h_verbs: dict[int, tele.Histogram] = {}
        self._occ_sample = 0
        self._sock = self._handshake(host, port, CHAN_OP)
        if self.fastpath:
            # function-local import (cleancache idiom): client.directory
            # must stay importable without dragging the client package
            # into this module's import graph
            from pmdfc_tpu_torch.client.directory import DirectoryCache

            self.directory = DirectoryCache(dir_max_entries)
        self._last_op = time.monotonic()
        self._push_sock = None
        self._threads: list[threading.Thread] = []
        if self.pipelined:
            self._inflight: dict[int, _Waiter] = {}
            # guarded-by: _inflight, _seq
            self._infl_lock = san.lock("TcpBackend._infl_lock")
            self._seq = 0
            self._window_sem = _WindowGate(self.window)
            self._outq: collections.deque = collections.deque()
            # guarded-by: _outq
            self._out_cv = san.condition("TcpBackend._out_cv")
            # deadlines are per-verb (waiter waits); the reader blocks
            # indefinitely — an idle pipelined channel must not die at
            # op_timeout_s the way a pending lockstep read would
            self._sock.settimeout(None)
            r = threading.Thread(target=self._pipe_reader, daemon=True,
                                 name="net-pipe-reader")
            w = threading.Thread(target=self._pipe_writer, daemon=True,
                                 name="net-pipe-writer")
            r.start()
            w.start()
            self._threads += [r, w]
        if bloom_sink is not None:
            try:
                self._push_sock = self._handshake(host, port, CHAN_PUSH)
            except BaseException:
                # don't leak the live op channel (and its server-side
                # client record) when the second handshake fails
                if self.pipelined:
                    self._pipe_fail(ConnectionError("push handshake failed"))
                self._sock.close()
                raise
            t = threading.Thread(target=self._push_reader,
                                 args=(bloom_sink,), daemon=True,
                                 name="net-push-reader")
            t.start()
            self._threads.append(t)
        if keepalive_s:
            k = threading.Thread(target=self._keepalive_loop,
                                 args=(keepalive_s,), daemon=True,
                                 name="net-keepalive")
            k.start()
            self._threads.append(k)

    def _handshake(self, host: str, port: int, chan: int) -> socket.socket:
        sock = socket.create_connection((host, port),
                                        timeout=self.op_timeout_s)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        want_pipe = self._want_pipe and chan == CHAN_OP
        want_trace = chan == CHAN_OP and tele.enabled()
        want_fast = self._want_fast and chan == CHAN_OP
        want_elastic = self._want_elastic and chan == CHAN_OP
        want_replica = self._want_replica and chan == CHAN_OP
        want_contain = self._want_contain and chan == CHAN_OP
        want_prof = self._want_prof and chan == CHAN_OP
        t_send = time.monotonic_ns()
        _send_msg(sock, MSG_HOLA,
                  status=(chan | (PIPE_FLAG if want_pipe else 0)
                          | (TRACE_FLAG if want_trace else 0)
                          | (FAST_FLAG if want_fast else 0)
                          | (ELASTIC_FLAG if want_elastic else 0)
                          | (REPLICA_FLAG if want_replica else 0)
                          | (CONTAIN_FLAG if want_contain else 0)
                          | (PROF_FLAG if want_prof else 0)),
                  count=self.client_id & 0xFFFFFFFF,
                  words=self.page_words, stamp=self.client_id)
        mt, status, count, _, srv_ns, _ = _recv_msg(
            sock, max_payload=self.max_frame_bytes)
        t_recv = time.monotonic_ns()
        if mt != MSG_HOLASI or status != 0:
            sock.close()
            raise ProtocolError(
                f"handshake rejected (type={mt} status={status})"
            )
        # HOLASI count is a capability bitfield: bit 0 acks seq-echo
        # (pipelining), bit 1 acks the trace field. No ack (an old
        # server, or the respective kill switch) ⇒ the capability is off
        # on this connection.
        if want_pipe:
            self.pipelined = bool(count & 1)
        if want_trace and chan == CHAN_OP:
            self.traced = bool(count & 2)
        if want_fast:
            self.fastpath = bool(count & 4)
        if want_elastic:
            self.elastic = bool(count & 8)
        if want_replica and (count & 16):
            # the server's device-replica lane count rides bits 8..15
            self.replica_lanes = max(1, (count >> 8) & 0xFF)
        if want_contain:
            self.nack = bool(count & 32)
        if want_prof:
            self.prof = bool(count & 64)
        if chan == CHAN_OP and srv_ns:
            # clock offset from the HOLA exchange: the server stamped
            # its monotonic_ns between our send and recv, so the
            # midpoint estimate is off by at most rtt/2 — enough to
            # place server spans on this client's timeline (tracetool).
            # An old server stamps 0 -> no estimate, offset stays None.
            self.clock_offset_ns = srv_ns - (t_send + t_recv) // 2
            tele.clock_event(self.client_id & 0xFFFFFFFF,
                             self.clock_offset_ns, t_recv - t_send)
        return sock

    # -- op channel --

    def _roundtrip(self, msg_type: int, payload, count: int,
                   stamp: int = 0):
        return self._roundtrip_parts(msg_type, (payload,), count, stamp)

    def _roundtrip_parts(self, msg_type: int, parts, count: int,
                         stamp: int = 0):
        """One verb, either wire mode, wrapped in its client span: a
        32-bit trace id is minted when the connection negotiated
        TRACE_FLAG (riding the request's words field), per-verb latency
        feeds the shared client histograms, and a verb that dies with
        the connection is recorded as a FAILED span — the client half of
        the end-to-end trace."""
        # join the op already in flight when one is (a replica attempt's
        # ambient trace), mint otherwise — one trace id follows the
        # whole client→hedge→wire→server walk
        trace = ((tele.current_trace() or tele.mint_trace())
                 if (self.traced and tele.enabled()) else 0)
        name = _OP_NAMES.get(msg_type, f"op{msg_type}")
        # the wire span: one timed tree node per verb, nested under the
        # caller's ambient span (a replica attempt, when one is open) —
        # the client half of the client→hedge→wire→queue→phase trace
        sp = tele.span_begin("client", name, trace=trace,
                             conn=self.client_id & 0xFFFFFFFF)
        t0 = time.perf_counter()
        try:
            if self.pipelined:
                reply = self._pipe_roundtrip(msg_type, parts, count,
                                             stamp, trace)
            else:
                reply = self._lockstep_roundtrip(msg_type, parts, count,
                                                 stamp, trace)
        except Exception as e:
            # a verb that died with its connection closes its span as
            # FAILED (the chaos drills pin this: no dangling open spans)
            tele.span_end(sp, ok=False, err=type(e).__name__)
            raise
        dur = (time.perf_counter() - t0) * 1e6
        # per-verb latency histogram, cached per msg type: the scope's
        # name->metric lookup (lock + f-string) is too dear per verb
        h = self._h_verbs.get(msg_type)
        if h is None:
            h = self._h_verbs[msg_type] = self._tele.hist(f"{name}_us")
        h.observe(dur)
        if reply[0] == MSG_NACK and self.nack:
            # a negotiated NACK is a completed round trip but a FAILED
            # op: its span closes FAILED with the server's cause, and
            # the per-cause counters feed teletop's containment block
            cause = {NACK_POISON: "poison", NACK_REFUSED: "refused",
                     NACK_DEADLINE: "deadline"}.get(reply[3], "unknown")
            self._tele.inc("nacks")
            self._tele.inc(f"nacks_{cause}")
            tele.span_end(sp, ok=False, err=f"nack:{cause}")
        else:
            tele.span_end(sp, ok=True)
        return reply

    def _lockstep_roundtrip(self, msg_type: int, parts, count: int,
                            stamp: int = 0, trace: int = 0):
        with self._lock:
            if self._closed:
                raise ConnectionError("backend closed")
            try:
                _send_frame(self._sock, msg_type, parts, count=count,
                            stamp=stamp, words=trace)
                reply = _recv_msg(self._sock,
                                  max_payload=self.max_frame_bytes)
            except (ConnectionError, OSError, struct.error):
                self._teardown_locked()
                raise ConnectionError("transport failure") from None
            self._last_op = time.monotonic()
            return reply

    # -- pipelined op channel --

    def _pipe_roundtrip(self, msg_type: int, parts, count: int,
                        stamp: int = 0, trace: int = 0):
        if self._closed:
            raise ConnectionError("backend closed")
        if not self._window_sem.acquire(timeout=self.op_timeout_s):
            # the window never drained within a full verb deadline: the
            # stream is wedged — fail the connection, not just this op
            self._pipe_fail(ConnectionError("window stalled past deadline"))
            raise ConnectionError("window stalled past deadline")
        # the per-verb deadline starts once the verb OWNS a window slot:
        # time spent queued behind a full window (its own op_timeout_s
        # budget above) must not be billed to the server's response, or
        # oversubscribed-but-progressing streams get spuriously dropped
        deadline = time.monotonic() + self.op_timeout_s
        try:
            w = _Waiter()
            with self._infl_lock:
                if self._closed:
                    raise ConnectionError("backend closed")
                seq = (self._seq + 1) & 0xFFFFFFFF
                while seq == 0 or seq in self._inflight:
                    seq = (seq + 1) & 0xFFFFFFFF
                self._seq = seq
                self._inflight[seq] = w
                occ = len(self._inflight)
            # sampled 1-in-16: occupancy is a distribution diagnostic,
            # not an exact count — don't tax every verb for it
            self._occ_sample += 1
            if self._occ_sample & 0xF == 0:
                self._tele.observe("window_occupancy", occ)
            frame = _frame_views(msg_type, parts, status=seq, count=count,
                                 stamp=stamp, words=trace)
            with self._out_cv:
                self._outq.append(frame)
                self._out_cv.notify()
            if self._closed and not w.event.is_set():
                # lost the race with a concurrent teardown that had
                # already drained the inflight map: fail fast instead of
                # waiting out a deadline nobody will answer
                with self._infl_lock:
                    self._inflight.pop(seq, None)
                if not w.event.is_set():
                    raise ConnectionError("backend closed")
            if not w.event.wait(max(0.0, deadline - time.monotonic())):
                # per-verb deadline: an unanswered seq means the stream
                # can no longer be trusted — drop the connection (every
                # in-window verb fails; ReconnectingClient degrades)
                with self._infl_lock:
                    self._inflight.pop(seq, None)
                self._pipe_fail(ConnectionError("op deadline expired"))
                raise ConnectionError("op deadline expired")
            if w.error is not None:
                raise w.error
            self._last_op = time.monotonic()
            return w.reply
        finally:
            # over-release tolerant by the gate's own contract (the
            # BoundedSemaphore it replaced needed a ValueError guard)
            self._window_sem.release()

    def set_window(self, n: int) -> int:
        """Live-set the pipeline window (the autotune controller's
        hook): verbs already in flight keep their slots; new verbs
        admit under the new cap. A no-op cap change on a lockstep
        connection (window applies only when pipelined). Returns the
        applied value."""
        n = max(1, int(n))
        self.window = n
        if self.pipelined:
            return self._window_sem.set_limit(n)
        return n

    def _pipe_reader(self) -> None:
        try:
            while not self._stop.is_set():
                mt, seq, count, words, stamp, payload = _recv_msg(
                    self._sock, max_payload=self.max_frame_bytes)
                with self._infl_lock:
                    w = self._inflight.pop(seq, None)
                if w is None:
                    # a reply nobody is waiting for: a duplicated frame
                    # upstream, or a reply outliving its deadline — the
                    # stream is desynchronized either way
                    raise ProtocolError(f"unmatched reply seq {seq} "
                                        f"(type={mt})")
                w.reply = (mt, seq, count, words, stamp, payload)
                w.event.set()
        except ProtocolError as e:
            self._pipe_fail(e)
        except (ConnectionError, OSError, struct.error, ValueError) as e:
            self._pipe_fail(e)

    def _pipe_writer(self) -> None:
        while True:
            with self._out_cv:
                while not self._outq and not self._stop.is_set():
                    self._out_cv.wait()
                if not self._outq:
                    return  # stopped and drained
                frames = [self._outq.popleft()
                          for _ in range(len(self._outq))]
                self._out_cv.notify_all()  # close() waits for the drain
            try:
                # coalesce queued frames into few sendmsg syscalls
                # (bounded well under IOV_MAX)
                views: list = []
                for fr in frames:
                    if len(views) + len(fr) > 512:
                        _sendmsg_all(self._sock, views)
                        views = []
                    views.extend(fr)
                if views:
                    _sendmsg_all(self._sock, views)
            except (ConnectionError, OSError) as e:
                self._pipe_fail(e)
                return

    def _pipe_fail(self, exc: BaseException) -> None:
        """Fail the pipelined connection: close both channels, wake and
        fail every in-window waiter (idempotent; safe from any thread)."""
        with self._lock:
            first = not self._closed
            self._closed = True
            self._stop.set()
        if first:
            for s in (self._sock, self._push_sock):
                if s is not None:
                    # shutdown-first: threads blocked in recv()/send()
                    # must wake NOW, not at their timeout
                    try:
                        s.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    try:
                        s.close()
                    except OSError:
                        pass
        with self._infl_lock:
            waiters = list(self._inflight.values())
            self._inflight.clear()
        for w in waiters:
            if w.error is None:
                w.error = (exc if isinstance(exc, ProtocolError)
                           else ConnectionError(f"transport failure: {exc}"))
            w.event.set()
        with self._out_cv:
            self._outq.clear()
            self._out_cv.notify_all()

    def _proto_fail(self, msg: str):
        """A reply that parses but is WRONG (unexpected type, echoed count
        that doesn't match the request, misshaped payload) means the
        request/reply stream is desynchronized — e.g. a duplicated or
        reordered frame upstream. The only safe reaction is to drop the
        connection (the next op reconnects cleanly) and raise; returning
        best-effort data from a desynced stream would serve wrong pages.
        """
        exc = ProtocolError(msg)
        if self.pipelined:
            self._pipe_fail(exc)
            raise exc
        with self._lock:
            self._teardown_locked()
        raise exc

    def put(self, keys: np.ndarray, pages: np.ndarray) -> None:
        stamp = time.monotonic_ns()
        # scatter-gather: keys and pages travel as separate iovec parts —
        # no host-side concatenation of the (potentially MB-scale) payload
        if self.directory is not None:
            # overlay rule: the put is about to change these keys'
            # rows/digests server-side — their cached entries must not
            # answer another fast read (dropped BEFORE the send so a
            # concurrent get cannot race the wire)
            self.directory.drop(np.asarray(keys, np.uint32))
        mt, _, count, *_ = self._roundtrip_parts(
            MSG_PUTPAGE,
            (np.ascontiguousarray(keys, np.uint32),
             np.ascontiguousarray(pages, np.uint32)),
            len(keys), stamp)
        if mt == MSG_NACK and self.nack:
            return  # negotiated NACK: an acked drop (legal cache outcome)
        if mt != MSG_SUCCESS or count != len(keys):
            self._proto_fail(f"put reply {mt} count={count}")

    def get(self, keys: np.ndarray):
        """Batched GET. With a warm directory (fast path negotiated +
        refreshed), cached keys go as ONE `MSG_FASTREAD` — served from
        the server's reader thread with zero staging/dispatch — and
        only uncached or stale-validated lanes pay the verb path. The
        merge is exact: a fast lane answers only when its row digest
        validated (a hit by construction), everything else re-asks
        through `MSG_GETPAGE`, so results are bit-identical to the
        plain verb path."""
        dc = self.directory
        if dc is None:
            return self._get_verb(np.asarray(keys, np.uint32))
        keys = np.asarray(keys, np.uint32).reshape(-1, 2)
        mask, shards, rows, digs, epoch = dc.lookup(keys)
        if not mask.any():
            return self._get_verb(keys)
        ok, hit, srv_epoch = self._fast_read(
            keys[mask], shards, rows, digs, epoch)
        dc.note_result(keys[mask], ok, srv_epoch)
        resolved = mask.copy()
        resolved[mask] = ok
        out = np.zeros((len(keys), self.page_words), np.uint32)
        found = np.zeros(len(keys), bool)
        out[resolved] = hit
        found[resolved] = True
        rest = ~resolved
        if rest.any():
            o2, f2 = self._get_verb(np.ascontiguousarray(keys[rest]))
            out[rest] = o2
            found[rest] = f2
        return out, found

    def _deadline_stamp(self) -> int:
        """Relative end-to-end budget (µs) stamped into read-verb
        request frames — 0 (= none) unless the connection negotiated
        containment AND a budget is configured. Old servers read the
        field as the padding those verbs always carried."""
        if not self.nack or self.deadline_ms <= 0.0:
            return 0
        return max(1, int(self.deadline_ms * 1000.0))

    def _get_verb(self, keys: np.ndarray):
        mt, _, count, words, _, payload = self._roundtrip(
            MSG_GETPAGE, _pack_keys(keys), len(keys),
            stamp=self._deadline_stamp()
        )
        if mt == MSG_NACK and self.nack:
            # negotiated NACK (poison / refusal / deadline): the legal
            # all-miss answer, on a connection that stays alive
            return (np.zeros((len(keys), self.page_words), np.uint32),
                    np.zeros(len(keys), bool))
        if mt not in (MSG_SENDPAGE, MSG_NOTEXIST) or count != len(keys):
            self._proto_fail(f"get reply {mt} count={count}")
        try:
            found = np.frombuffer(payload, np.uint8, count).astype(bool)
            out = np.zeros((count, words or self.page_words), np.uint32)
            n = int(found.sum())
            if n:
                out[found] = np.frombuffer(
                    payload, np.uint32, n * words, offset=count
                ).reshape(n, words)
        except ValueError:
            self._proto_fail(f"get reply misshaped ({len(payload)} bytes)")
        return out, found

    def _fast_read(self, keys: np.ndarray, shards: np.ndarray,
                   rows: np.ndarray, digs: np.ndarray, epoch: int):
        """One validated direct-row-read batch: `(ok[N], hit_rows
        [sum(ok), W], server_epoch)`. Keys ride along for the server's
        workload sketches (the fast lane must stay observable)."""
        n = len(rows)
        mt, _, count, words, stamp, payload = self._roundtrip_parts(
            MSG_FASTREAD,
            (np.ascontiguousarray(keys, np.uint32),
             np.ascontiguousarray(shards, np.uint32),
             np.ascontiguousarray(rows, np.uint32),
             np.ascontiguousarray(digs, np.uint32)),
            n, stamp=epoch)
        if mt != MSG_SENDPAGE or count != n:
            self._proto_fail(f"fastread reply {mt} count={count}")
        try:
            ok = np.frombuffer(payload, np.uint8, n).astype(bool)
            nh = int(ok.sum())
            hit = np.frombuffer(
                payload, np.uint32, nh * words, offset=n
            ).reshape(nh, words) if nh else \
                np.zeros((0, words or self.page_words), np.uint32)
        except ValueError:
            self._proto_fail(
                f"fastread reply misshaped ({len(payload)} bytes)")
        return ok, hit, int(stamp)

    def dir_refresh(self) -> bool:
        """Pull the server's directory (delta when one was applied
        before): the client half of `MSG_DIRPULL`/`MSG_DIRDELTA`. False
        when no directory is negotiated or the backend has none (the
        verb path keeps serving either way)."""
        dc = self.directory
        if dc is None:
            return False
        want_delta = dc.wants_delta()
        mt, _, count, words, stamp, payload = self._roundtrip(
            MSG_DIRPULL, b"", 1 if want_delta else 0, stamp=dc.epoch)
        if mt == MSG_NOTEXIST:
            return False
        if mt != MSG_DIRDELTA:
            self._proto_fail(f"dirpull reply {mt}")
        full = bool(count & DIR_FULL)
        nu = count & (DIR_FULL - 1)
        nt = words
        try:
            keys = _unpack_keys(payload, nu)
            off = nu * 8
            shards = np.frombuffer(payload, np.uint32, nu, offset=off)
            rows = np.frombuffer(payload, np.uint32, nu, offset=off + 4 * nu)
            digs = np.frombuffer(payload, np.uint32, nu, offset=off + 8 * nu)
            tombs = np.frombuffer(
                payload, np.uint32, nt * 2, offset=off + 12 * nu
            ).reshape(nt, 2)
        except ValueError:
            self._proto_fail(
                f"dirpull reply misshaped ({len(payload)} bytes)")
        dc.apply(full, int(stamp), keys, shards, rows, digs, tombs)
        return True

    def ring_note(self, epoch: int, members: int = 0):
        """Announce a membership transition (`MSG_RINGNOTE`): the server
        bumps its one-sided directory epoch and gauges the ring epoch.
        Returns the server's new directory epoch (0 = directory-less
        backend), or None when the connection never negotiated the
        elastic capability. Our own cached directory is marked dirty
        immediately — the epoch we mirrored is invalid the moment the
        server acks, and waiting for the next fast read to discover it
        would waste the stale round trip."""
        if not self.elastic:
            return None
        mt, _, _, _, stamp, _ = self._roundtrip(
            MSG_RINGNOTE, np.uint32(members).tobytes(), int(epoch))
        if mt == MSG_NACK and self.nack:
            return None  # acked drop; the next fast read resyncs
        if mt != MSG_SUCCESS:
            self._proto_fail(f"ring_note reply {mt}")
        if self.directory is not None:
            self.directory.mark_dirty()
        return int(stamp)

    def replica_repair(self) -> int:
        """Ask the server to run one device-side replica anti-entropy
        pass (`MSG_RREPAIR`: a collective compare-and-copy over the
        serving plane's lane axis). Returns rows repaired; 0 when the
        connection never negotiated the replica capability (the verb is
        never sent — old peers and PMDFC_MESH2D=off interop)."""
        if self.replica_lanes <= 1:
            return 0
        mt, _, count, *_ = self._roundtrip(MSG_RREPAIR, b"", 0)
        if mt == MSG_NACK and self.nack:
            return 0  # acked drop; anti-entropy retries next sweep
        if mt != MSG_SUCCESS:
            self._proto_fail(f"rrepair reply {mt}")
        return int(count)

    def handoff(self, keys: np.ndarray, pages: np.ndarray) -> None:
        """Migration handoff write: byte-identical payload to `put`
        (and fused into the same server put phase), accounted
        server-side as `handoff_pages`. Falls back to a plain put on a
        connection without the elastic capability."""
        if not self.elastic:
            return self.put(keys, pages)
        stamp = time.monotonic_ns()
        if self.directory is not None:
            self.directory.drop(np.asarray(keys, np.uint32))
        mt, _, count, *_ = self._roundtrip_parts(
            MSG_HANDOFF,
            (np.ascontiguousarray(keys, np.uint32),
             np.ascontiguousarray(pages, np.uint32)),
            len(keys), stamp)
        if mt == MSG_NACK and self.nack:
            return  # acked drop; the migration driver re-sends later
        if mt != MSG_SUCCESS or count != len(keys):
            self._proto_fail(f"handoff reply {mt} count={count}")

    def invalidate(self, keys: np.ndarray) -> np.ndarray:
        if self.directory is not None:
            self.directory.drop(np.asarray(keys, np.uint32))
        mt, _, count, _, _, payload = self._roundtrip(
            MSG_INVALIDATE, _pack_keys(keys), len(keys)
        )
        if mt == MSG_NACK and self.nack:
            return np.zeros(len(keys), bool)  # nothing found (legal)
        if mt != MSG_SUCCESS or count != len(keys):
            self._proto_fail(f"invalidate reply {mt} count={count}")
        try:
            return np.frombuffer(payload, np.uint8, count).astype(bool)
        except ValueError:
            self._proto_fail(
                f"invalidate reply misshaped ({len(payload)} bytes)")

    def insert_extent(self, key, value, length: int) -> int:
        """Register [key, key+length) as one wire op; returns the
        uncovered tail the server reported (0 = fully indexed)."""
        payload = (np.asarray(key, np.uint32).tobytes()
                   + np.asarray(value, np.uint32).tobytes()
                   + np.uint32(length).tobytes())
        mt, _, uncovered, *_ = self._roundtrip(MSG_INSEXT, payload, 0)
        if mt == MSG_NACK and self.nack:
            return int(length)  # acked drop: nothing indexed
        if mt != MSG_SUCCESS:
            self._proto_fail(f"insert_extent reply {mt}")
        return int(uncovered)

    def get_extent(self, keys: np.ndarray):
        """Batched cover resolution -> (values[B, 2], found[B])."""
        keys = np.asarray(keys, np.uint32)
        mt, _, count, _, _, payload = self._roundtrip(
            MSG_GETEXT, _pack_keys(keys), len(keys),
            stamp=self._deadline_stamp()
        )
        if mt == MSG_NACK and self.nack:
            # negotiated NACK: the legal nothing-covered answer
            return (np.zeros((len(keys), 2), np.uint32),
                    np.zeros(len(keys), bool))
        if mt != MSG_SENDPAGE or count != len(keys):
            self._proto_fail(f"get_extent reply {mt} count={count}")
        try:
            found = np.frombuffer(payload, np.uint8, count).astype(bool)
            vals = np.frombuffer(payload, np.uint32, count * 2,
                                 offset=count).reshape(count, 2).copy()
        except ValueError:
            self._proto_fail(
                f"get_extent reply misshaped ({len(payload)} bytes)")
        return vals, found

    def server_stats(self) -> dict:
        """Pull the server-side counter snapshot (kv stats + tier
        hot/cold/balloon counters when the tiered pool is active)."""
        import json as _json

        mt, _, _, _, _, payload = self._roundtrip(MSG_STATS, b"", 0)
        if mt == MSG_NACK and self.nack:
            return {}
        if mt != MSG_SUCCESS:
            self._proto_fail(f"stats reply {mt}")
        try:
            return _json.loads(bytes(payload).decode("utf-8"))
        except (UnicodeDecodeError, ValueError):
            self._proto_fail(f"stats reply misshaped ({len(payload)} bytes)")

    def stats(self) -> dict:
        """Uniform backend stats surface (the name every other backend
        answers to, so aggregators like `ReplicaGroup` need no special
        case); same wire pull as `server_stats`, which stays as the
        explicit this-is-a-roundtrip name."""
        return self.server_stats()

    def server_profile(self, duration_ms: int = 200):
        """Ask the server to run a bounded on-device profiler capture
        (`MSG_PROFILE`). Returns `{"path", "duration_ms"}` on success,
        None when the peer predates the verb (no PROF ack), refused the
        capture (no dump dir, one already live, or cooldown), or shed
        the request under overload."""
        import json as _json

        if not self.prof:
            return None  # old peer (or kill switch): verb not spoken
        mt, _, _, _, _, payload = self._roundtrip(
            MSG_PROFILE, b"", max(0, int(duration_ms)))
        if mt == MSG_NOTEXIST:
            return None  # refusal: capture live / cooldown / no dir
        if mt == MSG_NACK and self.nack:
            return None
        if mt != MSG_SUCCESS:
            self._proto_fail(f"profile reply {mt}")
        try:
            return _json.loads(bytes(payload).decode("utf-8"))
        except (UnicodeDecodeError, ValueError):
            self._proto_fail(
                f"profile reply misshaped ({len(payload)} bytes)")

    def recovery_info(self) -> dict:
        """Warm-restart status of the remote backend (`MSG_RECOVERY`
        query): at minimum `{"recovering": bool}`."""
        import json as _json

        mt, _, _, _, _, payload = self._roundtrip(MSG_RECOVERY, b"", 0)
        if mt == MSG_NACK and self.nack:
            return {"recovering": False}
        if mt != MSG_SUCCESS:
            self._proto_fail(f"recovery reply {mt}")
        try:
            return _json.loads(bytes(payload).decode("utf-8"))
        except (UnicodeDecodeError, ValueError):
            self._proto_fail(
                f"recovery reply misshaped ({len(payload)} bytes)")

    def mark_recovered(self) -> bool:
        """Flip the remote backend out of its recovering serving state
        (`MSG_RECOVERY` subcmd 1, idempotent). Returns whether it WAS
        recovering — the replica tier calls this once a rejoined
        endpoint's repair queue drains."""
        mt, _, count, *_ = self._roundtrip(MSG_RECOVERY, b"", 1)
        if mt == MSG_NACK and self.nack:
            return False  # acked drop; idempotent — caller retries
        if mt != MSG_SUCCESS:
            self._proto_fail(f"recovery reply {mt}")
        return bool(count)

    def packed_bloom(self) -> np.ndarray | None:
        mt, _, _, _, stamp, payload = self._roundtrip(MSG_BFPULL, b"", 0)
        if mt == MSG_NACK and self.nack:
            return None  # acked drop: no snapshot this pull
        if mt not in (MSG_NOTEXIST, MSG_BFPUSH):
            self._proto_fail(f"bloom pull reply {mt}")
        # the server echoes this client's applied-put stamp for the pulled
        # snapshot; expose it so the sink's staleness ordering runs in ONE
        # clock domain (0 = no put applied yet -> unstamped snapshot)
        self.bloom_pull_t_snap = stamp / 1e9 if stamp else None
        if mt == MSG_NOTEXIST:
            return None
        return np.frombuffer(payload, np.uint32).copy()

    # -- push channel --

    def _push_reader(self, sink) -> None:
        sock = self._push_sock
        sock.settimeout(None)
        try:
            while not self._stop.is_set():
                mt, _, count, words, stamp, payload = _recv_msg(
                    sock, max_payload=self.max_frame_bytes)
                t_snap = stamp / 1e9 if stamp else None
                if mt == MSG_BFPUSH:
                    sink.receive_bloom_full(
                        np.frombuffer(payload, np.uint32).copy(),
                        t_snap=t_snap,
                    )
                elif mt == MSG_BFBLOCKS:
                    idx = np.frombuffer(payload, np.uint32, count)
                    blocks = np.frombuffer(
                        payload, np.uint32, count * words, offset=count * 4
                    ).reshape(count, words)
                    sink.receive_bloom_blocks(idx, blocks, words,
                                              t_snap=t_snap)
        except (ConnectionError, OSError, struct.error):
            return

    def _keepalive_loop(self, interval: float) -> None:
        while not self._stop.wait(interval):
            if self.pipelined:
                if self._closed:
                    return
                if time.monotonic() - self._last_op < interval:
                    continue
                try:
                    self._pipe_roundtrip(MSG_KEEPALIVE, (), 0)
                except (ConnectionError, OSError, struct.error):
                    return
                continue
            with self._lock:
                if self._closed:
                    return
                idle = time.monotonic() - self._last_op
                if idle < interval:
                    continue
                try:
                    _send_msg(self._sock, MSG_KEEPALIVE)
                    mt, *_ = _recv_msg(self._sock,
                                       max_payload=self.max_frame_bytes)
                    self._last_op = time.monotonic()
                except (ConnectionError, OSError, struct.error):
                    self._teardown_locked()
                    return

    # -- lifecycle --

    def _teardown_locked(self) -> None:
        self._closed = True
        self._stop.set()
        for s in (self._sock, self._push_sock):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass

    def close(self) -> None:
        if self.pipelined:
            with self._lock:
                if self._closed:
                    return
            # graceful: queue ADIOS, give the writer a moment to drain,
            # then tear down (failing any op still in the window)
            with self._out_cv:
                self._outq.append(_frame_views(MSG_ADIOS))
                self._out_cv.notify()
                deadline = time.monotonic() + 0.5
                while self._outq and time.monotonic() < deadline:
                    self._out_cv.wait(0.05)
            self._pipe_fail(ConnectionError("backend closed"))
            return
        with self._lock:
            if self._closed:
                return
            try:
                _send_msg(self._sock, MSG_ADIOS)
            except (ConnectionError, OSError):
                pass
            self._teardown_locked()

    def __enter__(self) -> "TcpBackend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class PoolServer(_BaseServer):
    """Serves a `PassivePool` over TCP — the one-sided operating mode with
    a real network between client and memory node.

    Reference: the one-sided server registers one big MR, sends
    `{baseaddr, rkey, size}`, and never touches the data path again
    (`server/onesided/rdma_svr.cpp:22-103,178`). Here the MR handshake is
    `MSG_GRANT` (a disjoint row range per request) and the one-sided verbs
    are `MSG_WRITEROW`/`MSG_READROW` — the server side is a raw batched
    scatter/gather on the pool, no index, no bloom, no request ordering.
    """

    def __init__(self, pool, host: str = "127.0.0.1", port: int = 0,
                 idle_timeout_s: float = IDLE_TIMEOUT_S,
                 max_frame_bytes: int = 1 << 26):
        super().__init__(host, port, idle_timeout_s, "pool")
        self.max_frame_bytes = max_frame_bytes
        self.pool = pool
        # guarded-by: <none>  (serializes pool device programs)
        self._op_lock = san.lock("PoolServer._op_lock")
        self.stats = tele.scope("pool", {
            "connects": 0, "ops": 0, "idle_kills": 0,
            "bad_rows": 0, "bad_frames": 0})
        # registry mirror of the PassivePool's bare counters: the pool
        # object itself stays numpy-plain (the passive node has no
        # telemetry on its data path by design), so the SERVER gauges
        # them after each verb — teledump/teletop see writes/reads and
        # grant occupancy like every other serving surface
        self._sync_pool_gauges()

    def _serve_conn(self, conn: socket.socket) -> None:
        # a connection thread runs the pool's verbs on the pool's device
        with _device_ctx(self.pool):
            self._serve_pool_conn(conn)

    def _sync_pool_gauges(self) -> None:
        p = self.pool
        self.stats.set("pool_writes", p.writes)
        self.stats.set("pool_reads", p.reads)
        self.stats.set("pool_granted_rows", p.granted_rows)
        self.stats.set("pool_num_rows", p.num_rows)

    def _valid_rows(self, rows: np.ndarray) -> np.ndarray:
        """Out-of-range rows (a client ignoring its grant) become -1 —
        read-as-zero / write-dropped, uniformly across pool modes, instead
        of an IndexError killing the connection thread."""
        ok = (rows >= 0) & (rows < self.pool.num_rows)
        self._bump("bad_rows", int((~ok & (rows != -1)).sum()))
        return np.where(ok, rows, np.int32(-1))

    def _serve_pool_conn(self, conn: socket.socket) -> None:
        W = self.pool.page_words
        try:
            conn.settimeout(self.idle_timeout_s)
            try:
                mt, _, _, words, _, _ = _recv_msg(
                    conn, max_payload=self.max_frame_bytes)
            except socket.timeout:
                self._bump("idle_kills")
                return
            if mt != MSG_HOLA:
                raise ProtocolError("expected HOLA")
            if words and words != W:
                _send_msg(conn, MSG_HOLASI, status=1, words=W)
                return
            # HOLASI carries pool size in count (the {size} of the MR
            # handshake; rows are the offsets)
            _send_msg(conn, MSG_HOLASI, status=0, words=W,
                      count=self.pool.num_rows)
            self._bump("connects")
            while not self._stop.is_set():
                try:
                    mt, status, count, words, stamp, payload = _recv_msg(
                    conn, max_payload=self.max_frame_bytes)
                except socket.timeout:
                    self._bump("idle_kills")
                    return
                if mt == MSG_ADIOS:
                    return
                self._bump("ops")
                if mt == MSG_KEEPALIVE:
                    _send_msg(conn, MSG_KEEPALIVE)
                elif mt == MSG_GRANT:
                    try:
                        with self._op_lock:
                            lo, hi = self.pool.grant(count)
                    except Exception:  # noqa: BLE001 — exhausted pool
                        _send_msg(conn, MSG_GRANT, status=1)
                        continue
                    self._sync_pool_gauges()
                    _send_msg(conn, MSG_GRANT,
                              np.array([lo, hi], np.uint32).tobytes())
                elif mt == MSG_WRITEROW:
                    rows = self._valid_rows(
                        np.frombuffer(payload, np.int32, count)
                    )
                    pages = np.frombuffer(
                        payload, np.uint32, count * W, offset=count * 4
                    ).reshape(count, W)
                    with self._op_lock:
                        self.pool.write_rows(rows, pages)
                    self._sync_pool_gauges()
                    _send_msg(conn, MSG_SUCCESS, count=count)
                elif mt == MSG_READROW:
                    rows = self._valid_rows(
                        np.frombuffer(payload, np.int32, count)
                    )
                    with self._op_lock:
                        out = self.pool.read_rows(rows)
                    self._sync_pool_gauges()
                    _send_frame(conn, MSG_SENDPAGE,
                                (np.ascontiguousarray(out, np.uint32),),
                                count=count, words=W)
                elif mt == MSG_STATS:
                    # stats parity with NetServer: the pool's counters +
                    # the process registry snapshot ride one wire pull,
                    # so teledump/teletop monitor a passive node too
                    import json as _json

                    with self._op_lock:
                        snap = dict(self.pool.stats())
                    self._sync_pool_gauges()
                    if tele.enabled():
                        snap["telemetry"] = tele.snapshot()
                    _send_msg(conn, MSG_SUCCESS,
                              _json.dumps(snap).encode("utf-8"))
                else:
                    raise ProtocolError(f"unexpected pool op {mt}")
        except ProtocolError:
            self._bump("bad_frames")
        except (ConnectionError, OSError, ValueError):
            pass
        finally:
            self._drop_conn(conn)


class RemotePool:
    """Client-side proxy with the `PassivePool` surface `OneSidedBackend`
    uses (`grant`/`write_rows`/`read_rows`/`page_words`/`num_rows`) — the
    one-sided client stack works over the wire unchanged."""

    def __init__(self, host: str, port: int, page_words: int = 1024,
                 op_timeout_s: float = IDLE_TIMEOUT_S,
                 keepalive_s: float | None = KEEPALIVE_DELAY_S,
                 max_frame_bytes: int = 1 << 26):
        self.page_words = page_words
        self.op_timeout_s = op_timeout_s
        # reply reads are server-controlled; bound them like TcpBackend does
        self.max_frame_bytes = max_frame_bytes
        # guarded-by: _closed, _last_op
        self._lock = san.lock("RemotePool._lock")
        self._closed = False
        self._stop = threading.Event()
        self._sock = socket.create_connection((host, port),
                                              timeout=op_timeout_s)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            _send_msg(self._sock, MSG_HOLA, words=page_words)
            mt, status, count, words, _, _ = _recv_msg(
                self._sock, max_payload=max_frame_bytes)
        except BaseException:
            self._sock.close()  # no fd leak on a failed handshake
            raise
        if mt != MSG_HOLASI or status != 0:
            self._sock.close()
            raise ProtocolError(
                f"pool handshake rejected (type={mt} status={status})"
            )
        self.num_rows = count
        self._last_op = time.monotonic()
        if keepalive_s:
            k = threading.Thread(target=self._keepalive_loop,
                                 args=(keepalive_s,), daemon=True,
                                 name="pool-keepalive")
            k.start()

    def _keepalive_loop(self, interval: float) -> None:
        """A quiet proxy (a client holding its key→row map between bursts)
        must not be idle-killed by the server — same discipline as
        `TcpBackend._keepalive_loop`."""
        while not self._stop.wait(interval):
            with self._lock:
                if self._closed:
                    return
                if time.monotonic() - self._last_op < interval:
                    continue
                try:
                    _send_msg(self._sock, MSG_KEEPALIVE)
                    _recv_msg(self._sock, max_payload=self.max_frame_bytes)
                    self._last_op = time.monotonic()
                except (ConnectionError, OSError, struct.error):
                    self._teardown_locked()
                    return

    def _roundtrip(self, msg_type: int, payload, count: int):
        return self._roundtrip_parts(msg_type, (payload,), count)

    def _roundtrip_parts(self, msg_type: int, parts, count: int):
        with self._lock:
            if self._closed:
                raise ConnectionError("pool proxy closed")
            try:
                _send_frame(self._sock, msg_type, parts, count=count)
                reply = _recv_msg(self._sock,
                                  max_payload=self.max_frame_bytes)
            except (ConnectionError, OSError, struct.error):
                self._teardown_locked()
                raise ConnectionError("transport failure") from None
            self._last_op = time.monotonic()
            return reply

    def _proto_fail(self, msg: str):
        """Same contract as `TcpBackend._proto_fail`: a wrong (vs merely
        failed) reply means stream desync — drop the connection, raise."""
        with self._lock:
            self._teardown_locked()
        raise ProtocolError(msg)

    def grant(self, n_rows: int) -> tuple[int, int]:
        mt, status, _, _, _, payload = self._roundtrip(MSG_GRANT, b"",
                                                       n_rows)
        if mt != MSG_GRANT:
            self._proto_fail(f"grant reply {mt}")
        if status != 0:
            raise RuntimeError("pool grant refused (exhausted)")
        try:
            lo, hi = np.frombuffer(payload, np.uint32, 2)
        except ValueError:
            self._proto_fail(f"grant reply misshaped ({len(payload)} bytes)")
        return int(lo), int(hi)

    def write_rows(self, rows: np.ndarray, pages: np.ndarray) -> None:
        mt, _, count, *_ = self._roundtrip_parts(
            MSG_WRITEROW,
            (np.ascontiguousarray(rows, np.int32),
             np.ascontiguousarray(pages, np.uint32)),
            len(rows))
        if mt != MSG_SUCCESS or count != len(rows):
            self._proto_fail(f"write_rows reply {mt} count={count}")

    def server_stats(self) -> dict:
        """Pull the pool node's counter snapshot (writes/reads/grant
        occupancy + the server-process telemetry when enabled) — stats
        parity with `TcpBackend.server_stats`, so teletop/monitoring
        clients speak to a passive node with the same verb."""
        import json as _json

        mt, _, _, _, _, payload = self._roundtrip(MSG_STATS, b"", 0)
        if mt != MSG_SUCCESS:
            self._proto_fail(f"pool stats reply {mt}")
        try:
            return _json.loads(bytes(payload).decode("utf-8"))
        except (UnicodeDecodeError, ValueError):
            self._proto_fail(
                f"pool stats reply misshaped ({len(payload)} bytes)")

    def stats(self) -> dict:
        """Uniform backend stats surface (`TcpBackend.stats` parity)."""
        return self.server_stats()

    def read_rows(self, rows: np.ndarray) -> np.ndarray:
        mt, _, count, words, _, payload = self._roundtrip(
            MSG_READROW, np.ascontiguousarray(rows, np.int32).tobytes(),
            len(rows),
        )
        if mt != MSG_SENDPAGE or count != len(rows):
            self._proto_fail(f"read_rows reply {mt} count={count}")
        try:
            return np.frombuffer(payload, np.uint32,
                                 count * words).reshape(count, words).copy()
        except ValueError:
            self._proto_fail(
                f"read_rows reply misshaped ({len(payload)} bytes)")

    def _teardown_locked(self) -> None:
        self._closed = True
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            try:
                _send_msg(self._sock, MSG_ADIOS)
            except (ConnectionError, OSError):
                pass
            self._teardown_locked()

    def __enter__(self) -> "RemotePool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
