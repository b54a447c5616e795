"""Device-side batched primitives: bloom filter, page pool, and the fused
GET (CUDA kernel in `csrc/`, built on first launch by `_build`)."""
