"""Table 14: the hand-written kernel families, their parity with the plain
versions and the tuning seam's provenance, one row a family on the
tensor's device (counterpart of ``benchmarks/table14_kernels.py``).

Each row carries:

* ``parity_ok``: the kernel (on the card; on the CPU the ops run the plain
  versions, so the row checks the dispatch) matches its plain version in
  ``kernels/ref.py`` at the pinned shape within ``tol``; gated on the
  current run alone by ``check_counts``;
* ``config_source`` / ``config_params``: where the family's configuration
  came from (``table``, ``heuristic`` or ``override``) and what it
  resolved to at that shape, so an artifact records whether the run used
  tuned or shipped geometry; ``check_counts`` requires both;
* ``max_abs_diff``, ``tol`` and an informational wall median
  (``t_fused_s``).

The probe shapes are JAX's (big enough to cross tile boundaries, not a
multiple of any tile), plus a scan shape of its own: the JAX package has
no scan family.

    PYTHONPATH=src python -m repro_torch.benchmarks.table14_kernels \\
        [--device cpu] [--out BENCH_torch.json]
"""
import torch

from repro_torch.kernels import ops, tuning

from .common import emit, merge_out, parser, resolve_device, timeit

ELEM_SHAPE = (3, 129)                # ddim_fused: 387 elements
FLASH_SHAPE = (1, 2, 48, 80, 16)     # (b, h, sq, sk, d), causal
RWKV_SHAPE = (1, 2, 36, 8, 12)       # (b, h, t, dk, dv), t % 16 != 0
SCAN_SHAPE = (1, 37, 40, 16)         # (b, t, din, n), t % 64 != 0
# f32 limits: JAX's 5e-5; the scan's recurrence 1e-4 (the card tests')
TOL = {"elementwise": 5e-5, "flash": 5e-5, "rwkv6": 5e-5,
       "selective_scan": 1e-4}


def _probe(shape, seed, device, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(device)


def probes(device):
    """``{family: (kernel call, plain call, tuning shape)}`` at the pinned
    shapes on ``device``."""
    x, eps = _probe(ELEM_SHAPE, 0, device), _probe(ELEM_SHAPE, 1, device)
    out = {"elementwise": (
        lambda: ops.ddim_fused(x, eps, 0.98, 0.19),
        lambda: ops.ddim_fused(x, eps, 0.98, 0.19, use_kernel=False),
        (x.numel(),))}
    b, h, sq, sk, d = FLASH_SHAPE
    q, k, v = (_probe((b, h, s, d), 2 + i, device)
               for i, s in enumerate((sq, sk, sk)))
    out["flash"] = (lambda: ops.attention(q, k, v, causal=True),
                    lambda: ops.attention(q, k, v, causal=True,
                                          use_kernel=False),
                    (sq, sk, d))
    b, h, t, dk, dv = RWKV_SHAPE
    r, kk = _probe((b, h, t, dk), 5, device), _probe((b, h, t, dk), 6, device)
    vv = _probe((b, h, t, dv), 7, device)
    w = _probe((b, h, t, dk), 8, device, 0.1)
    u = _probe((h, dk), 9, device)
    out["rwkv6"] = (lambda: ops.rwkv6_wkv(r, kk, vv, w, u)[0],
                    lambda: ops.rwkv6_wkv(r, kk, vv, w, u,
                                          use_kernel=False)[0],
                    (t, dk))
    b, t, din, n = SCAN_SHAPE
    xs = _probe((b, t, din), 10, device)
    dt = torch.nn.functional.softplus(_probe((b, t), 11, device) - 1.0)
    a = -torch.exp(_probe((din, n), 12, device, 0.5))
    args = (xs, dt, _probe((b, t, n), 13, device),
            _probe((b, t, n), 14, device), a, _probe((din,), 15, device),
            _probe((b, din, n), 16, device, 0.5))
    out["selective_scan"] = (
        lambda: ops.selective_scan(*args)[0],
        lambda: ops.selective_scan(*args, use_kernel=False)[0],
        (t, din, n))
    return out


def run_rows(device="cuda"):
    device = resolve_device(device)
    backend = tuning.backend_of(device)
    rows = []
    for kernel, (fused, plain, shape) in probes(device).items():
        cfg = tuning.config(kernel, None, device, torch.float32, shape)
        got, want = fused(), plain()
        diff = float((got.float() - want.float()).abs().max())
        tol = TOL[kernel]
        parity_ok = diff <= tol
        t_fused = timeit(fused, device=device)
        name = f"table14/{backend}/{kernel}"
        emit(name, t_fused * 1e6,
             f"parity_ok={parity_ok};diff={diff:.2e};"
             f"config={cfg.source}:{dict(cfg.params)}")
        rows.append(dict(
            name=name, kernel=kernel, backend=backend, dtype="float32",
            compiled=device.type == "cuda", parity_ok=parity_ok,
            max_abs_diff=diff, tol=tol, config_source=cfg.source,
            config_params=dict(cfg.params), t_fused_s=t_fused))
    return rows


def main(out=None, device="cuda"):
    device = resolve_device(device)
    rows = run_rows(device)
    merge_out(out, rows, "pinned_kernels",
              {"elementwise_shape": list(ELEM_SHAPE),
               "flash_shape": list(FLASH_SHAPE),
               "rwkv6_shape": list(RWKV_SHAPE),
               "scan_shape": list(SCAN_SHAPE), "tol": TOL}, device)
    return rows


if __name__ == "__main__":
    ap = parser(__doc__)
    ap.add_argument("--out", default=None,
                    help="the JSON artifact to append the rows into")
    args = ap.parse_args()
    main(out=args.out, device=resolve_device(args.device))
