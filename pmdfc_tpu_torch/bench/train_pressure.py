"""Model training under memory pressure — the BERT fine-tuning analog
(twin of `pmdfc_tpu/bench/train_pressure.py`).

Reference: `client/BERT/run.py` fine-tunes TF-hub BERT on IMDB as the
"real application" pressure workload: a memory-hungry training job whose
dataset pages constantly evict through the cleancache path while the
accelerator crunches (`SURVEY.md §4.5`). The analog trains a small MLP
classifier (`MLP`, an `nn.Module` with bf16 matmuls and f32 accumulation,
SGD) whose TRAINING CORPUS lives behind the paging simulator: every
epoch streams example pages through a RAM cache sized well below the
corpus, so steady-state faults hit the clean cache (or "disk") exactly
like the reference's cgroup-squeezed BERT run. The corpus is synthetic
pages: nothing is downloaded.

Pages double as data: an example's features are derived from its page
words (deterministic content, so every fetch also verifies integrity), and
its label is a threshold on the first feature — learnable, so falling loss
is evidence the paged-in bytes are the right bytes.

The KV behind the client and the model are the port's, on `--device`
(default `cuda`); the weights come from a `torch.Generator` seeded by
`--seed` (`params_from_jax` starts the model from given weights instead).

Run: `python -m pmdfc_tpu_torch.bench.train_pressure --steps 200
--device cpu`
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


class _RoundGrad(torch.autograd.Function):
    """Identity forward; the backward rounds the gradient to bf16."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).float()


def _round(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


class _RowsBf16(torch.autograd.Function):
    """[H] -> [B, H] broadcast of a bf16 bias; the backward sums the B
    rows as XLA reduces bf16 on the CPU: in windows of 32 rows, each
    window's running sum rounded to bf16 after every add, then the
    windows' sums in order, rounded the same way."""

    @staticmethod
    def forward(ctx, v, rows: int):
        return v.expand(rows, -1)

    @staticmethod
    def backward(ctx, g):
        def run(rows):
            acc = torch.zeros_like(g[0])
            for r in rows:
                acc = _round(acc + r)
            return acc

        return run([run(g[lo:lo + 32]) for lo in range(0, len(g), 32)]), None


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to bf16, kept in f32; its gradient is rounded too."""
    return t.to(torch.bfloat16).float()


class MLP(torch.nn.Module):
    """Two-layer classifier with bf16 matmuls and f32 accumulation: the
    JAX harness's `loss_fn` (`x.bf16 @ w1.bf16 + b1.bf16`, ReLU, then
    `(h.bf16 @ w2.bf16).f32 + b2`) as XLA computes it — products of
    bf16-rounded operands accumulated in f32; the first layer's sum
    rounded to bf16 as its bf16 add does, the second's left in f32
    (XLA drops the bf16 rounding of a product it widens again) while its
    gradient is still rounded to bf16, as the transposed cast rounds it."""

    def __init__(self, feat_dim: int, hidden: int,
                 generator: torch.Generator | None = None, device="cpu"):
        super().__init__()
        f32 = dict(dtype=torch.float32, device=device)
        self.w1 = torch.nn.Parameter(
            torch.randn(feat_dim, hidden, generator=generator,
                        dtype=torch.float32).to(device)
            / np.sqrt(feat_dim))
        self.b1 = torch.nn.Parameter(torch.zeros(hidden, **f32))
        self.w2 = torch.nn.Parameter(
            torch.randn(hidden, 2, generator=generator,
                        dtype=torch.float32).to(device)
            / np.sqrt(hidden))
        self.b2 = torch.nn.Parameter(torch.zeros(2, **f32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = _bf16(_bf16(_bf16(x) @ _bf16(self.w1))
                  + _RowsBf16.apply(_bf16(self.b1), len(x)))
        h = _bf16(torch.maximum(a, torch.zeros_like(a)))
        return _RoundGrad.apply(h @ _bf16(self.w2)) + self.b2


def params_from_jax(model: MLP, params: dict) -> MLP:
    """Load JAX-shaped weights (`{"w1", "b1", "w2", "b2"}` as numpy) into
    `model`, so both harnesses can start from the same weights."""
    with torch.no_grad():
        for name in ("w1", "b1", "w2", "b2"):
            p = getattr(model, name)
            p.copy_(torch.from_numpy(np.asarray(params[name],
                                                np.float32)).to(p.device))
    return model


def train_step(model: MLP, x: torch.Tensor, y: torch.Tensor, lr: float):
    """One SGD step -> (loss, acc) as floats."""
    logits = model(x)
    logp = torch.log_softmax(logits, dim=-1)
    loss = -logp.gather(1, y[:, None]).mean()
    acc = (logits.argmax(-1) == y).float().mean()
    model.zero_grad(set_to_none=True)
    loss.backward()
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(p - lr * p.grad)
    return float(loss.detach()), float(acc)


def features_and_label(page: np.ndarray, oid: int, index: int,
                       feat_dim: int):
    """Features from page words (centered to [-1, 1]); the label is a
    threshold on the first feature, so it is learnable from the content —
    and ONLY from correct content: corrupt paged-in bytes decorrelate the
    label and keep the loss at chance."""
    words = page[:feat_dim].astype(np.float64)
    x = (words % 251) / 125.5 - 1.0
    y = int(page[0] % 251 >= 125)
    return x.astype(np.float32), y


def run(args, init_params: dict | None = None) -> dict:
    from pmdfc_tpu_torch.bench.common import build_backend, stamp_live_device
    from pmdfc_tpu_torch.bench.paging_sim import PagingSim
    from pmdfc_tpu_torch.client import CleanCacheClient
    from pmdfc_tpu_torch.kv import resolve_device

    dev = resolve_device(args.device)
    backend, closer = build_backend("direct", args.page_words,
                                    args.capacity, bloom_bits=1 << 20,
                                    device=args.device)
    client = CleanCacheClient(backend)
    sim = PagingSim(client, args.ram_pages, args.page_words)

    oid = 42
    # materialize the corpus once ("download the dataset"): write faults
    for i in range(args.corpus_pages):
        sim.write(oid, i)

    gen = torch.Generator().manual_seed(args.seed)
    model = MLP(args.feat_dim, args.hidden, generator=gen, device=dev)
    if init_params is not None:
        params_from_jax(model, init_params)

    rng = np.random.default_rng(0)
    losses, accs = [], []
    fetch_s = 0.0
    t0 = time.perf_counter()
    for _ in range(args.steps):
        idxs = rng.integers(args.corpus_pages, size=args.batch)
        xb = np.empty((args.batch, args.feat_dim), np.float32)
        yb = np.empty((args.batch,), np.int64)
        tf0 = time.perf_counter()
        for j, i in enumerate(idxs):
            i = int(i)
            sim.read(oid, i)  # fault through RAM → cleancache → disk
            page = sim.ram[(oid, i)][0]
            xb[j], yb[j] = features_and_label(page, oid, i, args.feat_dim)
        fetch_s += time.perf_counter() - tf0
        loss, acc = train_step(model, torch.from_numpy(xb).to(dev),
                               torch.from_numpy(yb).to(dev), args.lr)
        losses.append(loss)
        accs.append(acc)
    wall = time.perf_counter() - t0

    head = float(np.mean(losses[: max(1, len(losses) // 10)]))
    tail = float(np.mean(losses[-max(1, len(losses) // 10):]))
    out = dict(sim.stats)
    out.update(
        metric="train_under_pressure",
        steps=args.steps,
        secs=round(wall, 3),
        steps_per_sec=round(args.steps / wall, 2),
        fetch_frac=round(fetch_s / wall, 3),
        loss_first=round(head, 4),
        loss_last=round(tail, 4),
        acc_last=round(float(np.mean(accs[-max(1, len(accs) // 10):])), 4),
        learned=bool(tail < head * 0.9),
        client=client.stats(),
        losses=losses,
    )
    closer()
    stamp_live_device(out, "direct", args.device)
    return out


def main(argv=None) -> int:
    from pmdfc_tpu_torch.bench.common import smoke_sizes

    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--corpus-pages", type=int, default=2048)
    p.add_argument("--ram-pages", type=int, default=256)
    p.add_argument("--page-words", type=int, default=256)
    p.add_argument("--feat-dim", type=int, default=128)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--capacity", type=int, default=1 << 14)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--smoke", action="store_true",
                   help="a short run over a small corpus")
    args = p.parse_args(argv)
    if args.smoke:
        smoke_sizes(p, args, steps=40, corpus_pages=256, ram_pages=64,
                    capacity=1 << 12)
    out = run(args)
    out.pop("losses")
    print(json.dumps(out), file=sys.stdout)
    return 0 if out["verify_failures"] == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
