"""Dataset generators for the KV benchmarks (twin of
`pmdfc_tpu/bench/gen_input.py`: the same datasets, byte for byte).

Reference: `server/gen_input.cpp` emits key datasets where each base key
appears 1..N times (duplicate-ratio patterns), and `server/util/input_gen.cpp`
uniform keys; `test_KV -d <dataset>` consumes them. Same patterns here, as
numpy arrays or files.
"""

from __future__ import annotations

import argparse

import numpy as np


def _split_u64(flat: np.ndarray) -> np.ndarray:
    """u64[N] -> canonical [N, 2] uint32 (hi, lo) key layout."""
    flat = np.asarray(flat, np.uint64)
    return np.stack(
        [(flat >> np.uint64(32)).astype(np.uint32),
         (flat & np.uint64(0xFFFFFFFF)).astype(np.uint32)],
        axis=-1,
    )


def uniform(n: int, key_bits: int = 48, seed: int = 42) -> np.ndarray:
    """DISTINCT uniform-looking u64 keys as [N, 2] uint32 (hi, lo).

    Built by passing `seed·0x9E3779B9 + arange(n) (mod 2^key_bits)` through
    two xorshift-multiply rounds, each invertible mod 2^key_bits, so the map
    is a bijection and keys are distinct by construction (within one seed) —
    duplicate keys make `failedSearch` accounting ambiguous (one eviction
    explains two probe misses of the same key). The reference's rand()-based
    datasets carry that ambiguity; we remove it at the source. Different
    seeds give differently-offset windows of the same permutation and may
    overlap for very large n.
    """
    mask = np.uint64((1 << key_bits) - 1)
    x = (np.uint64(seed * 0x9E3779B9) + np.arange(n, dtype=np.uint64)) & mask
    # xorshift-multiply rounds, each invertible mod 2^key_bits ⇒ bijection
    half = np.uint64(key_bits // 2)
    for mult in (0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9):
        x = (x * np.uint64(mult)) & mask   # odd multiplier: invertible
        x = x ^ (x >> half)                # xorshift: invertible
    return _split_u64(x)


def one_to_n(n: int, run: int, hot_key: int = 1) -> np.ndarray:
    """The reference's `input_1toN` pattern (`server/gen_input.cpp`): the
    HOT key (1) interleaved between runs of `run` sequential keys —
    `[1, i..i+run-1, 1, i+run.., ...]`. Stresses a single scorching bucket
    plus sequential fill (the hotring / update-in-place case)."""
    blocks = max(1, -(-n // (run + 1)))  # ceil: [:n] truncates, never short
    seq = np.arange(1, blocks * run + 1, dtype=np.uint64).reshape(blocks, run)
    hot = np.full((blocks, 1), hot_key, np.uint64)
    flat = np.concatenate([hot, seq], axis=1).reshape(-1)[:n]
    return _split_u64(flat)


def sequential(n: int, start: int = 1) -> np.ndarray:
    """`input_sort`: plain ascending keys (ref gen_input.cpp commented-out
    pattern; also the pure-sequential fill case)."""
    return _split_u64(np.arange(start, start + n, dtype=np.uint64))


def repeated(n: int, repeat: int, seed: int = 42) -> np.ndarray:
    """Each base key appears `repeat` times, shuffled — stresses
    update-in-place and duplicate handling (kept from round 1; the faithful
    reference pattern is `one_to_n`)."""
    base = uniform(max(1, n // repeat), seed=seed)
    out = np.repeat(base, repeat, axis=0)[:n]
    rng = np.random.default_rng(seed + 1)
    return out[rng.permutation(len(out))]


def zipf(n: int, a: float = 1.2, universe_bits: int = 24,
         seed: int = 42) -> np.ndarray:
    """Skewed popularity — hot-key stress for the hotness-aware indexes."""
    rng = np.random.default_rng(seed)
    lo = (rng.zipf(a, n) % (1 << universe_bits)).astype(np.uint32)
    return np.stack([np.ones(n, np.uint32), lo], axis=-1)


def save(path: str, keys: np.ndarray) -> None:
    """One u64 per line, the reference's dataset file format
    (`server/test_KV.cpp:184-197`)."""
    flat = (keys[:, 0].astype(np.uint64) << 32) | keys[:, 1]
    np.savetxt(path, flat, fmt="%d")


def load(path: str) -> np.ndarray:
    return _split_u64(np.loadtxt(path, dtype=np.uint64, ndmin=1))


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("out")
    p.add_argument("--n", type=int, default=1_000_000)
    p.add_argument("--pattern", default="uniform",
                   choices=("uniform", "one_to_n", "sequential", "repeated",
                            "zipf"))
    p.add_argument("--repeat", type=int, default=4,
                   help="run length (one_to_n) / repeat count (repeated)")
    args = p.parse_args()
    if args.pattern == "uniform":
        keys = uniform(args.n)
    elif args.pattern == "one_to_n":
        keys = one_to_n(args.n, args.repeat)
    elif args.pattern == "sequential":
        keys = sequential(args.n)
    elif args.pattern == "repeated":
        keys = repeated(args.n, args.repeat)
    else:
        keys = zipf(args.n)
    save(args.out, keys)
    print(f"wrote {len(keys)} keys to {args.out}")


if __name__ == "__main__":
    main()
