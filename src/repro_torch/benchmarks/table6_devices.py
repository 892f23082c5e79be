"""Table 6 (Appendix D): device scaling of the block-sharded sampler
(counterpart of ``benchmarks/table6_devices.py``'s scaling rows).

Wall seconds per sample of ``make_sharded_sampler`` at 1, 2 and 4 ranks
of a gloo group of CPU processes (``launch.mesh.spawn_ranks``, a
``file://`` store in a temporary directory), whatever ``--device`` says:
N=100, B=20, ``tol=1e-4``, JAX's 16-dim toy ``tanh(x @ W) * (0.4 + 3e-4
t)`` in f32 with its ``W`` and ``x0`` (``toy_inputs.npz``: the draws of
the JAX emitter's subprocess).  Each rank times its calls after a
barrier; the row is rank 0's median of 3 after a warm-up.  On the card
one more row runs world size 1 on NCCL (one card holds one rank).  The
``mesh_t2d2m2`` row, the DiT over a (time, data, model) mesh with its
patch-sharded attention, waits for ROADMAP A10(b) and prints that in
place of its fields.

    PYTHONPATH=src python -m repro_torch.benchmarks.table6_devices \\
        [--device cpu]
"""
import time

import torch

from repro_torch.core import SolverConfig, SRDSConfig, make_schedule

from .common import emit, parser, resolve_device, toy_array

WORLDS = (1, 2, 4)
N, BLOCKS, TOL = 100, 20, 1e-4
MESH_ROW = "table6/mesh_t2d2m2"


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


def main(device="cuda", worlds=WORLDS):
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
    emit(MESH_ROW, -1, "A10(b)")
    rows.append(dict(name=MESH_ROW, waits_for="A10(b)"))
    return rows


if __name__ == "__main__":
    main(device=resolve_device(parser(__doc__).parse_args().device))
