"""The CI-sized serving run (counterpart of ``benchmarks/serve_smoke.py``):
table9 at 12 requests and batch 1 and 4, table10_slo at 40 requests a
trace, written to one JSON file.  Its numbers are in hardware-independent
units (evals per sample, virtual-clock latencies), reproducible run to
run and equal on the card and the CPU.  ``meta`` holds the torch version,
the device and, on the card, ``nvidia-smi``'s name and power limit.

    PYTHONPATH=src python -m repro_torch.benchmarks.serve_smoke \\
        [--device cpu] [--out BENCH_serve.json]
"""
import json

from . import table9_batched, table10_slo
from .common import meta, parser, resolve_device


def main(out: str = "BENCH_serve.json", device="cuda"):
    device = resolve_device(device)
    payload = {
        "meta": meta(device),
        "table9_batched": table9_batched.main(requests=12,
                                              batch_sizes=(1, 4),
                                              device=device),
        "table10_slo": table10_slo.main(n_requests=40, rate=380.0,
                                        device=device),
    }
    with open(out, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
    print(f"wrote {out}")
    return payload


if __name__ == "__main__":
    ap = parser(__doc__)
    ap.add_argument("--out", default="BENCH_serve.json")
    args = ap.parse_args()
    main(args.out, device=resolve_device(args.device))
