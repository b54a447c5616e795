"""crashbox — real-process SIGKILL harness for durability drills (twin of
`tools/crashbox.py`).

The torn-tail story in `runtime/journal.py` is only honest if the writer
actually dies mid-write: in-process "crashes" (dropping a KV on the floor)
never tear a record, because CPython flushes the file object on GC. This
harness runs a real `NetServer` over a journal-attached `KV` in a CHILD
process and lets the parent `kill -9` it between two acked RPCs — the only
way to manufacture a genuinely torn journal tail or an un-fsynced pending
window.

The child is started from the `spawn` context: CUDA cannot be forked, and a
spawned child owns a fresh runtime, its own CUDA context on `device`, and
its own file descriptors. Everything it is given (the `KVConfig`, the
journal config, the device name) is pickled across.

Parent-side surface:

    box = Crashbox(kv_cfg, journal_dir, journal_cfg, device="cuda")
    hello = box.start()               # {"port", "replay", ...} once serving
    ... drive TcpBackend("127.0.0.1", box.port) ...
    box.snapshot(path, delta=True)    # chain link cut in the child
    box.kill()                        # SIGKILL — no atexit, no flush
    # warm restart: a NEW Crashbox with chain_paths= replays the tail

The hello card carries the serving port, the warm-restart report (with its
`timings_s` split) and the child's peak RSS. The control pipe carries
snapshot / stats / recovery_info / mark_recovered / serving / stop
commands, so drills cut chain links and read server-side counters
mid-storm without a second wire protocol; `serving` returns the child's
fused-GET launches by variant, the GET phases its `NetServer` served and
the server's counters. `kill()` bypasses the pipe entirely — that is the
point. A child that fails to start sends its traceback and `start()`
raises it.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import resource
import signal
import time
import traceback


def _peak_rss_bytes() -> int:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def _child_main(conn, kv_cfg, journal_cfg, journal_dir, chain_paths,
                device) -> None:
    """Child body: serve a journal-attached KV until killed. Imports stay
    inside: the child starts from a fresh interpreter."""
    try:
        from pmdfc_tpu_torch.client.backends import DirectBackend
        from pmdfc_tpu_torch.ops import fused
        from pmdfc_tpu_torch.runtime import profiler
        from pmdfc_tpu_torch.runtime.journal import Journal, warm_restart
        from pmdfc_tpu_torch.runtime.net import NetServer

        t0 = time.perf_counter()
        if chain_paths:
            kv, replay = warm_restart(kv_cfg, list(chain_paths), journal_dir,
                                      journal_config=journal_cfg,
                                      device=device)
        else:
            from pmdfc_tpu_torch.kv import KV

            kv = KV(kv_cfg, device=device,
                    journal=Journal(journal_dir, journal_cfg))
            replay = {"records": 0, "pages": 0, "truncated_bytes": 0}
        profiler.block_ready(kv.device)
        restore_s = time.perf_counter() - t0
        shared = DirectBackend(kv)
        phases: list[int] = []  # the padded width of every GET phase
        real_get = shared.get

        def get(keys):
            phases.append(len(keys))
            return real_get(keys)

        shared.get = get
        srv = NetServer(lambda: shared).start()
    except Exception:
        conn.send({"error": traceback.format_exc()})
        raise
    conn.send({"port": srv.port, "replay": replay, "restore_s": restore_s,
               "device": str(kv.device), "pid": os.getpid(),
               "peak_rss_bytes": _peak_rss_bytes()})
    try:
        while True:
            try:
                cmd = conn.recv()
            except EOFError:
                break
            op = cmd[0]
            try:
                if op == "snapshot":
                    t0 = time.perf_counter()
                    rep = kv.snapshot(cmd[1], delta=bool(cmd[2]))
                    rep.update(seconds=time.perf_counter() - t0,
                               peak_rss_bytes=_peak_rss_bytes())
                    conn.send(rep)
                elif op == "stats":
                    conn.send(kv.stats())
                elif op == "recovery_info":
                    conn.send(kv.recovery_info())
                elif op == "mark_recovered":
                    conn.send(kv.mark_recovered())
                elif op == "serving":
                    profiler.block_ready(kv.device)
                    conn.send({"launches": dict(fused.launches),
                               "get_phases": list(phases),
                               "server": dict(srv.stats),
                               "journal": dict(kv._journal.counters)
                               if kv._journal is not None else None,
                               "peak_rss_bytes": _peak_rss_bytes()})
                elif op == "stop":
                    conn.send(True)
                    break
                else:  # unknown command: fail loudly, not silently
                    conn.send({"error": f"unknown crashbox op {cmd!r}"})
            except Exception:
                conn.send({"error": traceback.format_exc()})
    finally:
        srv.stop()
        if kv._journal is not None:
            kv._journal.close()


class Crashbox:
    """One killable child serving a journal-attached KV over TCP."""

    def __init__(self, kv_cfg, journal_dir: str, journal_cfg=None,
                 chain_paths=(), start_timeout_s: float = 120.0,
                 device="cuda"):
        self._ctx = mp.get_context("spawn")
        self._parent, self._child = self._ctx.Pipe()
        self._proc = self._ctx.Process(
            target=_child_main,
            args=(self._child, kv_cfg, journal_cfg, str(journal_dir),
                  tuple(str(p) for p in chain_paths), str(device)),
            daemon=True)
        self._timeout = float(start_timeout_s)
        self.port: int | None = None
        self.replay: dict | None = None

    def start(self) -> dict:
        """Launch the child; blocks until it is serving. Returns the
        hello card: `{"port", "replay" (warm-restart report), "restore_s",
        "device", "pid", "peak_rss_bytes"}`. A child that fails or is not
        serving within the start timeout is killed and this raises."""
        self._proc.start()
        self._child.close()  # parent keeps only its end
        try:
            if not self._parent.poll(self._timeout):
                raise TimeoutError(
                    f"crashbox child not serving after {self._timeout:.0f}s")
            hello = self._parent.recv()
        except BaseException:
            self.kill()
            raise
        if "error" in hello:
            self.kill()
            raise RuntimeError(f"crashbox child failed to start:\n"
                               f"{hello['error']}")
        self.port = hello["port"]
        self.replay = hello["replay"]
        return hello

    def _command(self, *cmd):
        self._parent.send(cmd)
        if not self._parent.poll(self._timeout):
            raise TimeoutError(f"crashbox child stuck on {cmd[0]!r}")
        out = self._parent.recv()
        if isinstance(out, dict) and "error" in out:
            raise RuntimeError(out["error"])
        return out

    def snapshot(self, path: str, delta: bool = False) -> dict:
        return self._command("snapshot", str(path), delta)

    def stats(self) -> dict:
        return self._command("stats")

    def recovery_info(self) -> dict:
        return self._command("recovery_info")

    def mark_recovered(self) -> bool:
        return self._command("mark_recovered")

    def serving(self) -> dict:
        return self._command("serving")

    @property
    def pid(self) -> int | None:
        return self._proc.pid

    def alive(self) -> bool:
        return self._proc.is_alive()

    def kill(self) -> None:
        """SIGKILL — no flush, no atexit, no goodbye. The journal tail
        is whatever the kernel had; that is the drill."""
        if self._proc.pid is not None and self._proc.is_alive():
            os.kill(self._proc.pid, signal.SIGKILL)
        self._proc.join(timeout=30.0)
        self._parent.close()

    def stop(self) -> None:
        """Graceful shutdown (clean-exit control arm of the drill)."""
        if not self._proc.is_alive():
            self._parent.close()
            return
        try:
            self._command("stop")
        except (OSError, EOFError, TimeoutError):
            pass
        self._proc.join(timeout=30.0)
        if self._proc.is_alive():  # pragma: no cover — stuck child
            self.kill()
        else:
            self._parent.close()

    def __enter__(self) -> "Crashbox":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        if self._proc.is_alive():
            self.kill()
