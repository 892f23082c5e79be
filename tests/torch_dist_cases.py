"""The rank bodies of ``tests/test_torch_pipelined.py``: each runs in a
process of a gloo group started by ``repro_torch.launch.mesh.spawn_ranks``
and returns plain numpy results for the test process to check (this
module imports no JAX, so the ranks start quickly).

One spawn per world size runs every case of that size.  The toy model is
the f64 ``tanh(x @ W) * (0.5 + 0.001 t)`` of ``tests/conftest.py`` with
``W`` drawn by numpy (``weights()``), so the JAX side can take the same
weights.
"""
import numpy as np
import torch

N = 64
DIM = 6


def weights():
    return np.random.default_rng(0).standard_normal((DIM, DIM)) * 0.3


def x0():
    return np.random.default_rng(1).standard_normal((2, DIM))


def xb():
    """Four lanes of very different scale: they converge at different
    refinements."""
    return (np.random.default_rng(3).standard_normal((4, DIM))
            * np.linspace(0.4, 2.0, 4)[:, None])


XB_TOLS = np.array([1e-2, 1e-4, 1e-6, 1e-3], np.float32)
SCALE = np.linspace(0.5, 1.5, DIM)


def matmul_model(x, t):
    w = torch.from_numpy(weights())
    return torch.tanh(x @ w) * (0.5 + 0.001 * t[:, None])


def elementwise_model(x, t):
    scale = torch.from_numpy(SCALE)
    return torch.tanh(x * scale) * (0.5 + 0.001 * t[:, None])


def schedule(n):
    import repro_torch.core as C
    return C.make_schedule("ddpm_linear", n).astype(np.float64)


def _res(r):
    return dict(sample=r.sample.numpy(), iterations=r.iterations.numpy(),
                final_delta=r.final_delta.numpy(),
                delta_history=r.delta_history.numpy())


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def _host_reads(fn):
    """``fn()``'s result and the reads of a tensor's value into the host
    it made (``bool``, ``item``, ``tolist``, ``numpy``)."""
    count = [0]
    saved = {}
    for name in ("__bool__", "item", "tolist", "numpy"):
        orig = getattr(torch.Tensor, name)
        saved[name] = orig

        def wrapped(self, *a, _orig=orig, **kw):
            count[0] += 1
            return _orig(self, *a, **kw)
        setattr(torch.Tensor, name, wrapped)
    try:
        out = fn()
    finally:
        for name, orig in saved.items():
            setattr(torch.Tensor, name, orig)
    return out, count[0]


def sharded(rank, world, with_data_axis):
    """Every case of the block-sharded driver at this world size, and the
    port's single-program runs they are held to."""
    import repro_torch.core as C
    from repro_torch.core.pipelined import make_sharded_sampler
    from repro_torch.launch.mesh import make_srds_mesh

    mesh = make_srds_mesh(world, device_type="cpu")
    sched, solver = schedule(N), C.SolverConfig("ddim")
    x = torch.from_numpy(x0())
    out = {"seq": C.sample_sequential(matmul_model, sched, solver,
                                      x).numpy()}

    def run(model, cfg, *a, straggler_fn=None, **kw):
        return make_sharded_sampler(mesh, "time", model, sched, solver, cfg,
                                    straggler_fn=straggler_fn)(*a, **kw)

    for tol in (0.0, 1e-4):
        for nb in (8, 16):               # 16: several blocks a rank
            cfg = C.SRDSConfig(tol=tol, num_blocks=nb)
            out[f"sharded/tol{tol}/b{nb}"] = _res(run(matmul_model, cfg, x))
            out[f"single/tol{tol}/b{nb}"] = _res(C.srds_sample(
                matmul_model, sched, solver, x, cfg))
    # truncation redistributes the live suffix (elementwise model: the
    # suffix's batch shape cannot move a bit)
    out["seq_elem"] = C.sample_sequential(elementwise_model, sched, solver,
                                          x).numpy()
    for tol in (0.0, 1e-4):
        for nb in (8, 16):
            for trunc in (False, True):
                cfg = C.SRDSConfig(tol=tol, num_blocks=nb, truncate=trunc)
                out[f"trunc{trunc}/tol{tol}/b{nb}"] = _res(
                    run(elementwise_model, cfg, x))
    out["window/exact_prefix"] = _res(run(
        elementwise_model, C.SRDSConfig(tol=1e-4, num_blocks=8,
                                        window=C.ExactPrefix()), x))
    out["window/residual"] = _res(run(
        elementwise_model, C.SRDSConfig(tol=1e-4, num_blocks=8,
                                        window=C.ResidualWindow(1e-3)), x))

    # stragglers: blocks 3 and 5 drop their fresh solve at odd refinements
    def strag(p):
        m = np.zeros(8, bool)
        m[[3, 5]] = p % 2 == 1
        return m

    for tol in (0.0, 1e-6):
        cfg = C.SRDSConfig(tol=tol, num_blocks=8, max_iters=24)
        out[f"straggler/tol{tol}"] = _res(run(matmul_model, cfg, x,
                                              straggler_fn=strag))
        out[f"no_straggler/tol{tol}"] = _res(run(matmul_model, cfg, x))
    out["refused/trunc_straggler"] = _error(lambda: run(
        matmul_model, C.SRDSConfig(tol=0.0, num_blocks=8, truncate=True), x,
        straggler_fn=lambda p: np.zeros(8, bool)))
    out["refused/accel_straggler"] = _error(lambda: run(
        matmul_model, C.SRDSConfig(num_blocks=8, accel=C.AndersonAccel()),
        x, straggler_fn=strag))
    # B = world / 2 blocks (1 at two ranks) do not split over the ranks
    out["refused/indivisible"] = _error(lambda: run(
        matmul_model, C.SRDSConfig(num_blocks=max(world // 2, 1)), x))

    # per-sample gating with a (K,) runtime tol, against K single runs
    b = torch.from_numpy(xb())
    tols = torch.from_numpy(XB_TOLS)
    cfg = C.SRDSConfig(per_sample=True, num_blocks=8)
    out["per_sample/sharded"] = _res(run(matmul_model, cfg, b, tols))
    out["per_sample/lanes"] = [_res(C.srds_sample(
        matmul_model, sched, solver, b[i:i + 1],
        C.SRDSConfig(num_blocks=8, tol=float(XB_TOLS[i]))))
        for i in range(b.shape[0])]

    # host reads: no more than the single program's
    cfg = C.SRDSConfig(tol=1e-4, num_blocks=8)
    _, out["reads/sharded"] = _host_reads(lambda: run(matmul_model, cfg, x))
    _, out["reads/single"] = _host_reads(lambda: C.srds_sample(
        matmul_model, sched, solver, x, cfg))
    if with_data_axis:
        out.update(data_axis(rank, world))
    # table6's rank body: its scaling row's sampler at this world size
    from repro_torch.benchmarks import table6_devices
    out["table6"] = table6_devices.scaling_rank(rank, world, "cpu",
                                                repeats=1)
    return out


def data_axis(rank, world):
    """``data_axis`` on a (world/2, 2, 1) mesh: the lanes split over
    ``data`` in contiguous chunks, and the refusals."""
    import repro_torch.core as C
    from repro_torch.core.pipelined import make_sharded_sampler
    from repro_torch.launch.mesh import make_srds_mesh

    mesh = make_srds_mesh(world // 2, 2, device_type="cpu")
    sched, solver = schedule(N), C.SolverConfig("ddim")
    b = torch.from_numpy(xb())
    cfg = C.SRDSConfig(per_sample=True, num_blocks=8)
    samp = make_sharded_sampler(mesh, "time", elementwise_model, sched,
                                solver, cfg, data_axis="data")
    out = {"data/coords": (mesh.get_local_rank("time"),
                           mesh.get_local_rank("data"))}
    out["data/vector_tol"] = _res(samp(b, torch.from_numpy(XB_TOLS)))
    out["data/scalar_tol"] = _res(samp(b, 1e-4))
    out["data/single_vector"] = _res(C.srds_sample(
        elementwise_model, sched, solver, b, cfg,
        tol=torch.from_numpy(XB_TOLS)))
    out["data/single_scalar"] = _res(C.srds_sample(
        elementwise_model, sched, solver, b, cfg,
        tol=torch.full((4,), 1e-4)))
    cfg_t = C.SRDSConfig(per_sample=True, num_blocks=8, truncate=True)
    out["data/truncated"] = _res(make_sharded_sampler(
        mesh, "time", elementwise_model, sched, solver, cfg_t,
        data_axis="data")(b, torch.from_numpy(XB_TOLS)))
    out["data/refused_joint"] = _error(lambda: make_sharded_sampler(
        mesh, "time", elementwise_model, sched, solver,
        C.SRDSConfig(num_blocks=8), data_axis="data"))
    out["data/refused_k"] = _error(lambda: samp(
        b[:3], torch.from_numpy(XB_TOLS[:3])))
    return out


# the wavefront's cases, also run by the JAX package's sampler
WAVEFRONT = {
    "tol1e-4": dict(n=25, tol=1e-4),
    "tol0": dict(n=25, tol=0.0),
    "per_sample": dict(n=25, tol=1e-4, per_sample=True),
    "fixed_budget": dict(n=25, tol=0.0, fixed_budget=True),
    "short_blocks": dict(n=10, tol=0.0),
}


def wavefront_x(case):
    x = x0()
    if WAVEFRONT[case].get("per_sample"):
        x = x * np.array([[0.4], [2.0]])
    return x


def wavefront(rank, world):
    """Every wavefront case at this world size (one block a rank), with
    its host reads, the sharded driver at B = world, and the refusals."""
    import repro_torch.core as C
    from repro_torch.core import pipelined
    from repro_torch.core.pipelined import (make_pipelined_sampler,
                                            make_sharded_sampler)
    from repro_torch.launch.mesh import make_srds_mesh

    mesh = make_srds_mesh(world, device_type="cpu")
    solver = C.SolverConfig("ddim")
    out = {}
    reads = [0]
    flag = pipelined._host_flag

    def counted(t):
        reads[0] += 1
        return flag(t)
    pipelined._host_flag = counted
    for case, kw in WAVEFRONT.items():
        sched = schedule(kw["n"])
        x = torch.from_numpy(wavefront_x(case))
        cfg = C.SRDSConfig(tol=kw["tol"],
                           per_sample=kw.get("per_sample", False),
                           window=C.FixedBudget() if kw.get("fixed_budget")
                           else None)
        reads[0] = 0
        res, steps, evals = make_pipelined_sampler(
            mesh, "time", matmul_model, sched, solver, cfg)(x)
        out[f"wf/{case}"] = dict(_res(res), supersteps=steps, evals=evals,
                                 flag_reads=reads[0])
        out[f"seq/{case}"] = C.sample_sequential(matmul_model, sched,
                                                 solver, x).numpy()
        out[f"single/{case}"] = _res(C.srds_sample(
            matmul_model, sched, solver, x,
            C.SRDSConfig(tol=kw["tol"], num_blocks=world,
                         per_sample=kw.get("per_sample", False))))
    pipelined._host_flag = flag
    sched = schedule(25)
    x = torch.from_numpy(x0())
    out["sharded/tol1e-4"] = _res(make_sharded_sampler(
        mesh, "time", matmul_model, sched, solver,
        C.SRDSConfig(tol=1e-4, num_blocks=world))(x))
    out["refused/accel"] = _error(lambda: make_pipelined_sampler(
        mesh, "time", matmul_model, sched, solver,
        C.SRDSConfig(accel=C.AndersonAccel()))(x))
    out["refused/n"] = _error(lambda: make_pipelined_sampler(
        mesh, "time", matmul_model, schedule(world * 2 + 1), solver,
        C.SRDSConfig())(x))
    # table3's wavefront leg at N = 5 * world on this group
    from repro_torch.benchmarks import table3_pipelined
    out["table3"] = table3_pipelined.wavefront_rank(rank, world, 5 * world)
    return out
