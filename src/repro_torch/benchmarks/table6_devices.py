"""Table 6 (Appendix D): device scaling of the block-sharded sampler
(counterpart of ``benchmarks/table6_devices.py``).

Wall seconds per sample of ``make_sharded_sampler`` at 1, 2 and 4 ranks
of a gloo group of CPU processes (``launch.mesh.spawn_ranks``, a
``file://`` store in a temporary directory), whatever ``--device`` says:
N=100, B=20, ``tol=1e-4``, JAX's 16-dim toy ``tanh(x @ W) * (0.4 + 3e-4
t)`` in f32 with its ``W`` and ``x0`` (``toy_inputs.npz``: the draws of
the JAX emitter's subprocess).  Each rank times its calls after a
barrier; the row is rank 0's median of 3 after a warm-up.  On the card
one more row runs world size 1 on NCCL (one card holds one rank).

The ``mesh_t2d2m2`` row is JAX's ``MESH_CODE`` on 8 gloo ranks: a reduced
DiT (``srds-dit-cifar`` with 2 layers, d 32, 2 heads of 16, d_ff 64, patch
2, f32; the port's adaLN-zero init from seed 0) patch-sharded over
``model`` (K/V all-gathered), its K=4 lanes of 8x8x3 latents over
``data`` and N=8 in 4 Parareal blocks over ``time``
(``make_sharded_sampler(..., data_axis="data")``, per-sample gating),
against ``srds_sample`` on one process: ``iterations``, ``max_abs_diff``
within ``tol`` (JAX's 5e-5) and ``t_mesh_s``, rank 0's median of 3 after a
warm-up.  ``--out F`` appends that row to the JSON artifact that
``check_counts`` gates.

    PYTHONPATH=src python -m repro_torch.benchmarks.table6_devices \\
        [--device cpu] [--out BENCH_torch.json]
"""
import dataclasses
import time

import torch

from repro_torch.core import SolverConfig, SRDSConfig, make_schedule

from .common import emit, merge_out, parser, resolve_device, toy_array

WORLDS = (1, 2, 4)
N, BLOCKS, TOL = 100, 20, 1e-4
MESH_SHAPE = (2, 2, 2)           # (time, data, model), 8 gloo ranks
MESH_ROW = "table6/mesh_t%dd%dm%d" % MESH_SHAPE
MESH_TOL = 5e-5                  # JAX's shape-dependent-GEMM carve-out
MESH_DIT = dict(num_layers=2, d_model=32, num_heads=2, num_kv_heads=2,
                head_dim=16, d_ff=64, patch_size=2, dtype="float32")
MESH_N, MESH_BLOCKS, MESH_K = 8, 4, 4


def scaling_rank(rank, world, device_type, repeats=3):
    """One rank: the sampler's median wall seconds and iterations."""
    import torch.distributed as dist

    from repro_torch.core.pipelined import make_sharded_sampler
    from repro_torch.launch.mesh import make_srds_mesh
    dev = torch.device(device_type, rank) if device_type == "cuda" \
        else torch.device("cpu")
    w, x0 = toy_array("table6_w", dev), toy_array("x0_table6", dev)

    def model_fn(x, t):
        return torch.tanh(x @ w) * (0.4 + 3e-4 * t[:, None])

    mesh = make_srds_mesh(world, device_type=device_type)
    samp = make_sharded_sampler(mesh, "time", model_fn,
                                make_schedule("ddpm_linear", N),
                                SolverConfig("ddim"),
                                SRDSConfig(tol=TOL, num_blocks=BLOCKS))
    res = samp(x0)
    ts = []
    for _ in range(repeats):
        dist.barrier()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        res = samp(x0)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ts.append(time.perf_counter() - t0)
    return dict(t=sorted(ts)[len(ts) // 2], iters=int(res.iterations),
                backend=str(dist.get_backend()))


def mesh_rank(rank, world, repeats=3):
    """One rank of the (time, data, model) DiT row: the mesh sampler's
    iterations, its max |diff| against ``srds_sample`` on this process,
    and its median wall seconds."""
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.configs.srds_dit import dit_denoiser
    from repro_torch.core import srds_sample
    from repro_torch.core.pipelined import make_sharded_sampler
    from repro_torch.launch.mesh import make_srds_mesh
    from repro_torch.models.dit import init_dit

    cfg = dataclasses.replace(get_arch("srds-dit-cifar"), **MESH_DIT)
    model = init_dit(cfg, torch.Generator().manual_seed(0), device="cpu")
    mesh = make_srds_mesh(*MESH_SHAPE, device_type="cpu")
    den = dit_denoiser(cfg, model, shard_axis="model", mesh=mesh)
    sched = make_schedule("ddpm_linear", MESH_N)
    solver = SolverConfig("ddim")
    x0 = torch.randn((MESH_K, 8, 8, cfg.in_channels),
                     generator=torch.Generator().manual_seed(1))
    cfg_s = SRDSConfig(num_blocks=MESH_BLOCKS, per_sample=True)
    ref = srds_sample(dit_denoiser(cfg, model), sched, solver, x0, cfg_s)
    samp = make_sharded_sampler(mesh, "time", den, sched, solver, cfg_s,
                                data_axis="data")
    res = samp(x0)
    diff = float((ref.sample - res.sample).abs().max())
    ts = []
    for _ in range(repeats):
        dist.barrier()
        t0 = time.perf_counter()
        res = samp(x0)
        ts.append(time.perf_counter() - t0)
    return dict(t=sorted(ts)[len(ts) // 2],
                iters=int(res.iterations.max()), max_abs_diff=diff)


def mesh_row():
    """The (time, data, model) DiT row, in JAX's fields."""
    from repro_torch.launch.mesh import spawn_ranks
    t, d, m = MESH_SHAPE
    r = spawn_ranks(mesh_rank, t * d * m, device_type="cpu")[0]
    ok = r["max_abs_diff"] <= MESH_TOL
    emit(MESH_ROW, r["t"] * 1e6,
         f"iters={r['iters']};max_abs_diff={r['max_abs_diff']:.2e};"
         f"within_tol={ok}")
    return dict(name=MESH_ROW, devices=t * d * m, mesh_time=t, mesh_data=d,
                mesh_model=m, iterations=r["iters"],
                max_abs_diff=r["max_abs_diff"], tol=MESH_TOL,
                within_tol=bool(ok), t_mesh_s=r["t"])


def main(device="cuda", worlds=WORLDS, out: str = None):
    from repro_torch.launch.mesh import spawn_ranks
    device = resolve_device(device)
    rows = []
    legs = [(d, "cpu") for d in worlds]
    if device.type == "cuda":
        legs.append((1, "cuda"))
    for d, device_type in legs:
        r = spawn_ranks(scaling_rank, d, device_type,
                        device_type=device_type)[0]
        name = f"table6/devices{d}" + ("_nccl" if device_type == "cuda"
                                       else "")
        emit(name, r["t"] * 1e6,
             f"iters={r['iters']};wallclock_s={r['t']:.3f};"
             f"backend={r['backend']}")
        rows.append(dict(name=name, devices=d, backend=r["backend"],
                         iterations=r["iters"], t_s=r["t"]))
    rows.append(mesh_row())
    merge_out(out, rows[-1:], "pinned_table6",
              {"mesh": dict(zip(("time", "data", "model"), MESH_SHAPE)),
               "tol": MESH_TOL, "arch": "srds-dit-cifar/reduced",
               "seed": 0, "num_steps": MESH_N}, device)
    return rows


if __name__ == "__main__":
    ap = parser(__doc__)
    ap.add_argument("--out", default=None,
                    help="JSON artifact to append the mesh row into")
    args = ap.parse_args()
    main(device=resolve_device(args.device), out=args.out)
