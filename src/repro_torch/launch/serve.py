"""Serving launcher: batched generation through the ServingEngine — the
port's counterpart of the JAX package's ``launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \\
        [--no-reduced] --requests 6 --max-new 16 [--quant-bits 8] \\
        [--device cpu]

``--reduced`` (the default) serves the architecture family at CPU
scale; ``--no-reduced`` serves the full config on one card.  The JAX
package's flag is ``store_true`` with default True, so it cannot be
turned off although its docstring serves full configs without it; here
it is a ``BooleanOptionalAction``, default True.  Params are drawn from a
``torch.Generator`` seeded 0 on the device; every prefill's attention
runs the flash kernel on the card.  The device is the card unless
``--device cpu`` is given (a host without a card raises otherwise).
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Tuple

import torch

from ..device import DEFAULT_DEVICE, resolve_device

__all__ = ["requests_for", "serve", "main"]


def requests_for(n: int, vocab: int, max_new: int) -> list:
    """The CLI's ``n`` requests: request ``i`` has the prompt
    ``[(7 i + j) % vocab for j < 3 + i % 4]`` and ``max_new`` tokens to
    make, as the JAX package's launcher builds them."""
    from ..serving.engine import Request
    return [Request(rid=i, prompt=[(7 * i + j) % vocab
                                   for j in range(3 + i % 4)],
                    max_new=max_new)
            for i in range(n)]


def serve(cfg, params, *, requests: int = 6, batch_size: int = 4,
          max_new: int = 16, quant_bits: int = 0, temperature: float = 0.0,
          device=DEFAULT_DEVICE) -> Tuple[Dict[int, List[int]], float]:
    """The CLI's ``requests`` served on ``params`` (the bundle's tree of
    ``cfg``) by a :class:`~repro_torch.serving.ServingEngine` on
    ``device`` -> ``({rid: tokens}, seconds)``, the seconds those of
    ``serve`` alone (synchronized on the card)."""
    from ..models.zoo import get_model
    from ..serving import ServingEngine
    device = resolve_device(device)
    eng = ServingEngine(get_model(cfg), batch_size=batch_size,
                        temperature=temperature, quant_bits=quant_bits)
    eng.load(params, device=device)
    reqs = requests_for(requests, cfg.vocab, max_new)
    t0 = time.perf_counter()
    results = eng.serve(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return results, time.perf_counter() - t0


def main(argv=None) -> Dict[int, List[int]]:
    """Parse ``argv`` (``sys.argv[1:]`` when None), serve the requests,
    print each request's tokens and the rate; return ``{rid: tokens}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--quant-bits", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)

    from ..configs import get_config
    from ..models.zoo import get_model

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = get_model(cfg).init(
        torch.Generator(device=device).manual_seed(0), device=device)
    results, dt = serve(cfg, params, requests=args.requests,
                        batch_size=args.batch_size, max_new=args.max_new,
                        quant_bits=args.quant_bits,
                        temperature=args.temperature, device=device)
    toks = sum(len(v) for v in results.values())
    for rid in sorted(results):
        print(f"req {rid}: {results[rid]}")
    print(f"\n{toks} tokens in {dt:.1f}s "
          f"({toks / dt:.1f} tok/s, quant={args.quant_bits or 'fp'})")
    return results


if __name__ == "__main__":
    main()
