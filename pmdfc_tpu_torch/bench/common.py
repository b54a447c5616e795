"""Shared backend construction for the port's bench harnesses (twin of
`pmdfc_tpu/bench/common.py`).

One place builds the client-side Backend from CLI-ish parameters, so the
harnesses do not each hand-roll the KVConfig/backend matrix, and one
place stamps and appends their evidence rows.

Left out of the JAX module, as nothing of them applies to torch:
`jax_versions`, `enable_compile_cache` (the persistent XLA compile cache
and its hardening; the port's one kernel is built by `nvcc` into
`build/` at its first launch) and `pin_cpu` (the JAX platform pin; the
port's harnesses take `--device cpu` instead). `device` defaults to
`cuda` here, as every entry point of the port does.
"""

from __future__ import annotations


def stamp_live_device(out: dict, backend: str, device=None) -> None:
    """Stamp the evidence row with where the workload ACTUALLY ran: the
    host-dict `local` backend never touches a device; otherwise the
    torch device type (`cuda`/`cpu`) and, on a card, its name."""
    if backend == "local":
        out["device"] = "local-host"
        out["device_kind"] = "host-dict"
        return
    import torch

    dev = torch.device(device if device is not None else "cuda")
    out["device"] = dev.type
    out["device_kind"] = (torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else "cpu")


def append_history(path: str | None, record: dict) -> None:
    """Append one UTC-timestamped JSON line to the evidence log at `path`.

    No-op when `path` is falsy; an OSError is reported to stderr, never
    raised. The log is ON-CHIP evidence: a record stamped with another
    device than `cuda` is skipped (silently when honestly stamped, with
    a message when it carries no stamp), except rows carrying
    `host_evidence: True` (transport-tier benches whose subject is the
    wire or the instrumentation), which still need a stamp."""
    if not path:
        return
    import datetime
    import json
    import sys

    dev = record.get("device")
    if dev is None:
        print("[bench] refusing history append: record carries no "
              "device stamp", file=sys.stderr)
        return
    if dev != "cuda" and not record.get("host_evidence"):
        return
    try:
        with open(path, "a") as f:
            f.write(json.dumps({
                "ts": datetime.datetime.now(
                    datetime.timezone.utc).isoformat(),
                **record,
            }) + "\n")
    except OSError as e:
        print(f"[bench] history append to {path} failed: {e}",
              file=sys.stderr)


def build_backend(kind: str, page_words: int, capacity: int,
                  bloom_bits: int = 1 << 22, device: str = "cuda",
                  tier=None):
    """Backend of `kind` in {"local", "direct", "engine"} -> `(backend,
    closer)`; call `closer()` at teardown (stops the KVServer for the
    engine path; no-op otherwise). `tier` (a `TierConfig`, optionally
    carrying an `AdmitConfig`) selects the tiered page store for the
    direct and engine paths; the host `local` backend ignores it."""
    if kind == "local":
        from pmdfc_tpu_torch.client import LocalBackend

        return LocalBackend(page_words, capacity), lambda: None

    from pmdfc_tpu_torch.config import BloomConfig, IndexConfig, KVConfig

    cfg = KVConfig(
        index=IndexConfig(capacity=capacity),
        bloom=BloomConfig(num_bits=bloom_bits),
        paged=True, page_words=page_words, tier=tier,
    )
    if kind == "direct":
        from pmdfc_tpu_torch.client import DirectBackend
        from pmdfc_tpu_torch.kv import KV

        return DirectBackend(KV(cfg, device=device)), lambda: None
    if kind == "engine":
        from pmdfc_tpu_torch.client import EngineBackend
        from pmdfc_tpu_torch.runtime import Engine, KVServer

        # warm the flush ladder BEFORE admitting clients: a kernel that
        # fails to build or launch raises here, not inside the driver
        eng = Engine(arena_pages=1 << 10, page_bytes=page_words * 4)
        server = KVServer(cfg, engine=eng, device=device)
        server.warmup(max_width=1 << 10)
        server.start()
        backend = EngineBackend(server, timeout_us=120_000_000)

        def closer():
            backend.close()
            server.stop()

        return backend, closer
    raise ValueError(f"unknown backend kind {kind!r}")


def smoke_sizes(parser, args, **sizes) -> None:
    """`--smoke`'s sizes, as the JAX harness sets them, except that a
    flag given explicitly on the command line keeps its value (a smoke
    run can be shortened further)."""
    for k, v in sizes.items():
        if getattr(args, k) == parser.get_default(k):
            setattr(args, k, v)


def timed_ms(fn, device, reps: int = 1) -> float:
    """Mean milliseconds per call of `fn` over `reps` calls: on a card the
    device's time between two CUDA events (the calls' work queued between
    them, then a synchronize), on the CPU the host clock."""
    import time

    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    with torch.cuda.device(dev):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps


def launches_per_get(device) -> int:
    """Fused-GET kernel launches one GET program makes per shard on
    `device`: one on a card; none on the CPU, where the kernel's wrapper
    runs its plain version."""
    import torch

    return 1 if torch.device(device).type == "cuda" else 0
