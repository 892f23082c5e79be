"""Batched serving example on the PyTorch port: prefill and lockstep
greedy decode with KV caches through the ``ServingEngine``, on a reduced
config (``examples/serve_llm.py``'s flow through ``repro_torch``).

  PYTHONPATH=src python examples/torch_serve_llm.py --arch qwen3-8b \
      [--device cpu]

It runs on the CUDA card (the flash attention, WKV or selective-scan
kernels of the arch) unless ``--device cpu`` is given (their plain
PyTorch twins).  The weights are drawn from seed 0, the prompts (8 + 2i
tokens for request i) from seed 1.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.dit import resolve_device  # noqa: E402
from repro_torch.serve import Request, ServingEngine  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_arch(args.arch).reduced()
    model = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                        device=device)
    engine = ServingEngine(cfg, model, batch_size=args.batch, max_seq=128)
    gen = torch.Generator().manual_seed(1)
    reqs = [Request(prompt=torch.randint(0, cfg.vocab_size, (8 + 2 * i,),
                                         generator=gen),
                    max_new_tokens=args.new_tokens)
            for i in range(args.batch)]
    outs = engine.generate(reqs)
    for i, o in enumerate(outs):
        print(f"request {i} ({reqs[i].prompt.shape[0]} prompt toks) -> {o}")
    print(f"served {args.batch} requests x {args.new_tokens} tokens "
          f"(batched lockstep decode, {cfg.name})")
    return dict(cfg=cfg, model=model, requests=reqs, outs=outs)


if __name__ == "__main__":
    main()
