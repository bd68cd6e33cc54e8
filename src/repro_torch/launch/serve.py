"""Serving driver: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Batched request serving with the slot-based continuous-batching engine on
``cuda:0`` (raises without CUDA): submits synthetic requests, decodes until
drained, reports latency percentiles and throughput.  The same flags and
report lines as ``python -m repro.launch.serve``; the weights are drawn
from ``torch.Generator(seed 0)`` on the card.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config
from ..serve import Engine, Request, ServeConfig
from ..serve.engine import default_device


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS), required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    args = ap.parse_args()

    cfg = get_config(args.arch, reduced=args.reduced)
    dev = default_device()  # cuda:0, or raise
    eng = Engine(cfg, ServeConfig(max_slots=args.slots, max_len=args.max_len),
                 device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(0)
    reqs = []
    t0 = time.monotonic()
    for i in range(args.requests):
        r = Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab, args.prompt_len,
                                        dtype=np.int32),
                    max_new_tokens=args.max_new_tokens,
                    temperature=args.temperature)
        reqs.append(r)
        eng.submit(r)
    eng.run_until_drained()
    wall = time.monotonic() - t0

    ttfts = sorted(r.t_first - r.t_submit for r in reqs)
    lats = sorted(r.t_done - r.t_submit for r in reqs)
    total_tokens = sum(len(r.out_tokens) for r in reqs)
    pct = lambda xs, p: xs[min(len(xs) - 1, int(p * len(xs)))]  # noqa: E731
    print(f"requests={len(reqs)} tokens={total_tokens} wall={wall:.2f}s "
          f"tok/s={total_tokens / wall:,.1f}")
    print(f"ttft p50={pct(ttfts, .5) * 1e3:.1f}ms p95={pct(ttfts, .95) * 1e3:.1f}ms | "
          f"latency p50={pct(lats, .5) * 1e3:.1f}ms p95={pct(lats, .95) * 1e3:.1f}ms")


if __name__ == "__main__":
    main()
