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


# --------------------------------------------------------------------------
# the model-parallel DiT, the mesh-sharded engine and the compressed step
# (tests/test_torch_model_parallel.py)
# --------------------------------------------------------------------------

# table6's reduced DiT (JAX's MESH_CODE): srds-dit-cifar cut to 2 layers,
# d 32, 2 heads of 16, d_ff 64, patch 2, f32, on 4 x 8 x 8 x 3 latents
MP_DIT = dict(num_layers=2, d_model=32, num_heads=2, num_kv_heads=2,
              head_dim=16, d_ff=64, patch_size=2, dtype="float32")
MP_SHAPE = (8, 8, 3)
MP_N, MP_BLOCKS, MP_K = 8, 4, 4
MP_REQ_TOL = 1e-3
MP_TREE_SEED = 5
# the f64 toy of JAX's block-axis engine tests
TOY_SCALE = np.linspace(0.5, 1.5, 6)
TOY_TOLS = (1e-2, 1e-4, 1e-5)
# the compressed step: reduced qwen3-8b, global batch 4 x 16, 3 steps
DP_ARCH, DP_BATCH, DP_SEQ, DP_STEPS, DP_LR = "qwen3-8b", 4, 16, 3, 1e-3
DP_GRAD_SHAPES = {"a": (5, 7), "b": (11,), "c": (3, 2, 4)}


def mp_cfg():
    import dataclasses
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch("srds-dit-cifar"), **MP_DIT)


def mp_tree():
    """The reduced DiT's JAX-layout tree, every leaf drawn nonzero (an
    adaLN-zero init predicts eps == 0 and would compare zeros)."""
    from repro_torch.models.dit import random_jax_tree
    return random_jax_tree(mp_cfg(), seed=MP_TREE_SEED)


def mp_x0():
    return np.random.default_rng(7).standard_normal(
        (MP_K,) + MP_SHAPE).astype(np.float32)


def toy_requests(n):
    return [(i, TOY_TOLS[i % 3]) for i in range(n)]


def dp_batches():
    """The compressed step's token batches, one a step."""
    rng = np.random.default_rng(11)
    return [rng.integers(0, 256, (DP_BATCH, DP_SEQ)).astype(np.int32)
            for _ in range(DP_STEPS)]


def dp_grads(rank):
    """Per-rank gradient dicts (and carries) for the collective alone."""
    rng = np.random.default_rng(100 + rank)
    g = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in DP_GRAD_SHAPES.items()}
    ef = {k: (0.01 * rng.standard_normal(s)).astype(np.float32)
          for k, s in DP_GRAD_SHAPES.items()}
    return g, ef


def lse_inputs(rank):
    rng = np.random.default_rng(200 + rank)
    return (rng.standard_normal((3, 4, 8)).astype(np.float32),
            rng.standard_normal((3, 4)).astype(np.float32))


def _table_noise(table):
    """A ``noise_fn`` handing out JAX's draws by seed."""
    def noise_fn(seed, shape, dtype, device):
        return torch.from_numpy(np.array(table[int(seed)])).to(
            device=device, dtype=dtype)
    return noise_fn


def _serve(den, noise, reqs, shape, dtype, **kw):
    """Serve ``reqs`` ((seed, tol) pairs) and return each response's
    fields plus the engine's eval counters."""
    from repro_torch.serve import DiffusionSamplingEngine, SampleRequest
    eng = DiffusionSamplingEngine(den, shape, device="cpu", dtype=dtype,
                                  noise_fn=_table_noise(noise), **kw)
    rids = [eng.submit(SampleRequest(seed=s, tol=t)) for s, t in reqs]
    out = eng.drain()
    st = eng.stats()
    return dict(
        sample=np.stack([out[r].sample for r in rids]),
        iterations=np.array([out[r].iterations for r in rids]),
        delta_history=[np.asarray(out[r].delta_history) for r in rids],
        model_evals=np.array([out[r].model_evals for r in rids]),
        physical_evals=st["physical_evals"],
        effective_evals=st["effective_evals"])


def _toy_model(x, t):
    scale = torch.from_numpy(TOY_SCALE)
    return torch.tanh(x * scale) * (0.5 + 0.001 * t[:, None])


def model_parallel(rank, world, dit_noise, toy_noise):
    """8 ranks: the reduced DiT over a (2, 2, 2) mesh in ``srds_sample``,
    the sharded driver and the engine, the port's single-process runs
    they are held to, the f64 toy engine over block and data dims, and
    the refusals."""
    import repro_torch.core as C
    from repro_torch.configs.srds_dit import dit_denoiser
    from repro_torch.core.pipelined import make_sharded_sampler
    from repro_torch.launch.mesh import make_srds_mesh, make_test_mesh
    from repro_torch.models.dit import load_jax_params
    from repro_torch.parallel import collectives

    mesh = make_srds_mesh(2, 2, 2, device_type="cpu")
    cfg = mp_cfg()
    model = load_jax_params(cfg, mp_tree(), device="cpu")
    den = dit_denoiser(cfg, model, shard_axis="model", mesh=mesh)
    ref_fn = dit_denoiser(cfg, model)
    sched = C.make_schedule("ddpm_linear", MP_N)
    solver = C.SolverConfig("ddim")
    x0 = torch.from_numpy(mp_x0())
    cfg_s = C.SRDSConfig(num_blocks=MP_BLOCKS, per_sample=True)
    out = {"coords": tuple(mesh.get_local_rank(a)
                           for a in ("time", "data", "model"))}
    out["single/srds"] = _res(C.srds_sample(ref_fn, sched, solver, x0,
                                            cfg_s))
    g0 = collectives.all_gather_dim.calls
    out["mp/srds"] = _res(C.srds_sample(den, sched, solver, x0, cfg_s))
    out["mp/srds_gathers"] = collectives.all_gather_dim.calls - g0
    out["mp/sharded"] = _res(make_sharded_sampler(
        mesh, "time", den, sched, solver, cfg_s, data_axis="data")(x0))
    reqs = [(i, MP_REQ_TOL) for i in range(4)]
    kw = dict(solver=solver, num_steps=MP_N, batch_size=MP_K,
              num_blocks=MP_BLOCKS)
    out["engine/single"] = _serve(ref_fn, dit_noise, reqs, MP_SHAPE,
                                  torch.float32, **kw)
    out["engine/single_fixed"] = _serve(ref_fn, dit_noise, reqs, MP_SHAPE,
                                        torch.float32, truncate=False, **kw)
    out["engine/data"] = _serve(den, dit_noise, reqs, MP_SHAPE,
                                torch.float32, mesh=mesh, data_axis="data",
                                **kw)
    out["engine/time_data"] = _serve(den, dit_noise, reqs, MP_SHAPE,
                                     torch.float32, mesh=mesh, axis="time",
                                     data_axis="data", **kw)
    # refusals on the mesh
    out["refused/rows"] = _error(lambda: den(torch.zeros((1, 6, 8, 3)),
                                             torch.zeros(1)))
    out["refused/batch"] = _error(lambda: _serve(
        den, dit_noise, reqs, MP_SHAPE, torch.float32, mesh=mesh,
        data_axis="data", **dict(kw, batch_size=3)))
    out["refused/blocks"] = _error(lambda: _serve(
        den, dit_noise, reqs[:1], MP_SHAPE, torch.float32, mesh=mesh,
        axis="time", **dict(kw, num_blocks=1)))
    out["refused/same_dim"] = _error(lambda: make_sharded_sampler(
        mesh, "model", den, sched, solver, cfg_s))

    # JAX's block-axis engine cases on the f64 toy
    toy = dict(solver=solver, num_steps=64, batch_size=2)
    mesh8 = make_test_mesh((8,), ("time",), device_type="cpu")
    mesh42 = make_test_mesh((4, 2), ("time", "data"), device_type="cpu")
    for n, name, mkw in ((5, "toy/plain5", {}),
                         (6, "toy/plain6", {}),
                         (5, "toy/time", dict(mesh=mesh8, axis="time")),
                         (5, "toy/data", dict(mesh=mesh42,
                                              data_axis="data")),
                         (6, "toy/time_data", dict(mesh=mesh42, axis="time",
                                                   data_axis="data"))):
        out[name] = _serve(_toy_model, toy_noise, toy_requests(n), (6,),
                           torch.float64, **toy, **mkw)
    out["refused/toy_blocks"] = _error(lambda: _serve(
        _toy_model, toy_noise, toy_requests(1), (6,), torch.float64,
        mesh=mesh8, axis="time", **dict(toy, num_blocks=4)))
    out["refused/toy_batch"] = _error(lambda: _serve(
        _toy_model, toy_noise, toy_requests(1), (6,), torch.float64,
        mesh=mesh42, data_axis="data", **dict(toy, batch_size=3)))
    return out


def dp_cfg():
    from repro_torch.configs import get_arch
    return get_arch(DP_ARCH).reduced()


def jax_leaves(cfg, tree):
    """``{port parameter name: numpy leaf}`` of a JAX-layout tree
    (``blocks`` leaves split by layer)."""
    from repro_torch.models.transformer import jax_leaf_names
    out = {}
    for name, path, layer in jax_leaf_names(cfg):
        leaf = tree
        for part in path.split("/"):
            leaf = leaf[part]
        out[name] = np.asarray(leaf if layer is None else leaf[layer])
    return out


# the compressed step's runs from each carried JAX state: the step itself
# and two controls, each rank taking the other rank's half of the batch
# and the optimizer applying the negated mean
DP_RUNS = ("step", "swapped", "negated")


def compressed(rank, world, tree, jsteps):
    """2 ranks: ``compressed_psum_mean`` and ``lse_combine`` on per-rank
    draws, then the compressed step on reduced qwen3-8b, each step started
    from JAX's state entering it (parameters, optimizer state, this rank's
    carry) and run as itself and as its two controls (``DP_RUNS``): the
    loss and grad norm, the parameters, this rank's carry and the quanta
    (the group's scale of each tensor) it came out with."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.parallel import collectives
    from repro_torch.train import (init_error_feedback,
                                   make_dp_train_step_compressed)

    mesh = make_test_mesh((world,), ("data",), device_type="cpu")
    group = mesh.get_group("data")
    out = {}
    g, ef = dp_grads(rank)
    for name, carry in (("zero", {k: np.zeros_like(v) for k, v in
                                  ef.items()}), ("carry", ef)):
        mean, new = collectives.compressed_psum_mean(
            {k: torch.from_numpy(v) for k, v in g.items()}, group,
            {k: torch.from_numpy(v) for k, v in carry.items()})
        out[f"psum/{name}"] = ({k: v.numpy() for k, v in mean.items()},
                               {k: v.numpy() for k, v in new.items()})
    o, lse = lse_inputs(rank)
    out["lse"] = collectives.lse_combine(torch.from_numpy(o),
                                         torch.from_numpy(lse),
                                         group).numpy()

    real = collectives.compressed_psum_mean
    seen = {}

    def recorded(grads, grp, carry, scale_groups):
        """The step's collective, its quanta kept and, for the negated
        control, its mean negated."""
        s = {k: float(collectives._scale(grads[k].float() + carry[k]))
             for k in grads}
        shared = {}
        for k, key in scale_groups.items():
            shared[key] = max(shared.get(key, 0.0), s[k])
        keys = sorted(shared)
        vals = torch.tensor([shared[k] for k in keys])
        dist.all_reduce(vals, op=dist.ReduceOp.MAX, group=grp)
        top = dict(zip(keys, vals.tolist()))
        seen["quanta"] = {k: top[scale_groups[k]] for k in grads}
        mean, new = real(grads, grp, carry, scale_groups=scale_groups)
        if seen["run"] == "negated":
            mean = {k: -v for k, v in mean.items()}
        return mean, new

    collectives.compressed_psum_mean = recorded
    try:
        cfg = dp_cfg()
        step = make_dp_train_step_compressed(cfg, AdamWConfig(lr=DP_LR),
                                             mesh, loss_kind="lm")
        steps = []
        for i, toks in enumerate(dp_batches()):
            t = torch.from_numpy(toks).long()
            runs = {}
            for run in DP_RUNS:
                params = tree if i == 0 else jsteps[i - 1]["params"]
                model = tf.load_jax_params(cfg, params, device="cpu",
                                           trainable=True)
                if i == 0:
                    opt = init_opt_state(dict(model.named_parameters()))
                    ef = init_error_feedback(model)
                else:
                    opt = tf.load_jax_opt_state(model, jsteps[i - 1]["opt"])
                    ef = {k: torch.from_numpy(v.copy()) for k, v in
                          jax_leaves(cfg, jsteps[i - 1]["ef"][rank]).items()}
                b = t if run != "swapped" else torch.roll(
                    t, DP_BATCH // world, 0)
                seen["run"] = run
                model, opt, ef, m = step(model, opt, ef,
                                         {"tokens": b, "labels": b})
                runs[run] = dict(
                    loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                    params={k: v.detach().numpy().copy()
                            for k, v in model.named_parameters()},
                    carry={k: v.numpy().copy() for k, v in ef.items()},
                    quanta=seen["quanta"])
            steps.append(runs)
        out["steps"] = steps
        out["refused/batch"] = _error(lambda: step(
            model, opt, ef, {"tokens": t[:3], "labels": t[:3]}))
    finally:
        collectives.compressed_psum_mean = real
    return out
