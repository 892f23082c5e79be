"""The rank bodies of ``tests/test_torch_moe_parallel.py``: each runs in a
process of a gloo group started by ``repro_torch.launch.mesh.spawn_ranks``
and returns numpy results (this module imports no JAX).

The configs are reduced f32 ``arctic-480b`` (4 experts, top 2, the dense
residual MLP) and a narrow kimi (16 experts, top 8, no dense residual,
GELU).  Parameters are JAX trees (numpy leaves) at
``ParallelCtx(model_parallel=m)``'s padding, handed in by the test
process.  Each rank takes its rows of the global batch (its ``data``
index's), as the port's data streams hand them out.
"""
import dataclasses

import numpy as np
import torch

ARCH = "arctic-480b"
NARROW = "kimi-16x8"
B = 4                      # global batch: 2 rows a data rank
S = 16
PROMPTS = (16, 11, 16, 7)
NEW = (5, 4, 3, 5)
STEP_LR = 3e-3
# ParallelCtx fields of each forward case: capacity 1.25 drops
# assignments, 8.0 keeps them all (and then equals moe_local), chunk 12
# leaves a last chunk of 8 tokens padded to 12, the fixed-capacity form
CASES = {
    "cap1.25": dict(moe_capacity=1.25),
    "cap8": dict(moe_capacity=8.0),
    "chunk12": dict(moe_capacity=1.25, moe_chunk=12),
    "fixed": dict(moe_capacity=1.25, moe_fixed_capacity=True),
}
NARROW_CASES = ("cap1.25",)


def cfg_of(name):
    from repro_torch.configs import get_arch
    if name == NARROW:
        return dataclasses.replace(
            get_arch("kimi-k2-1t-a32b").reduced(), name="kimi-16x8-reduced",
            moe_experts=16, moe_top_k=8, moe_dense_residual=False,
            act="gelu")
    return get_arch(name).reduced()


def cases_of(name):
    return CASES if name == ARCH else {k: CASES[k] for k in NARROW_CASES}


def tokens(seed=0, b=B, s=S, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


def requests():
    rng = np.random.default_rng(7)
    return [(rng.integers(1, 256, (n,)), k) for n, k in zip(PROMPTS, NEW)]


def step_batches(n=2):
    """The global (B, S) token batches of the step tests."""
    return [tokens(seed=30 + i) for i in range(n)]


def _rows(mesh, t):
    from repro_torch.data.pipeline import _host_slice
    start, per = _host_slice(t.shape[0], mesh, ("data",))
    return t[start:start + per]


def _ctx(mesh, **kw):
    from repro_torch.parallel.sharding import mesh_shape
    from repro_torch.models.transformer import ParallelCtx
    return ParallelCtx(mesh=mesh, model_parallel=mesh_shape(mesh)["model"],
                       **kw)


def _load(name, tree, ctx, trainable=False):
    from repro_torch.models import transformer as tf
    return tf.load_jax_params(cfg_of(name), tree, device="cpu",
                              trainable=trainable, parallel=ctx)


def _whole_logits(lg, mesh):
    """Every rank's rows and vocabulary columns joined."""
    from repro_torch.parallel.collectives import all_gather_dim
    lg = all_gather_dim(lg.contiguous(), -1, mesh.get_group("model"))
    return all_gather_dim(lg.contiguous(), 0, mesh.get_group("data"))


def logits_and_aux(cfg, model, batch):
    """JAX's ``forward_train`` pair: the port's logits and
    ``forward_hidden``'s aux."""
    from repro_torch.models import transformer as tf
    _, aux, _ = tf.forward_hidden(cfg, model, batch)
    return tf.forward_train(cfg, model, batch), aux


def _forward(name, tree, mesh, **kw):
    from repro_torch.models import transformer as tf
    cfg = cfg_of(name)
    model = _load(name, tree, _ctx(mesh, **kw))
    toks = torch.from_numpy(_rows(mesh, tokens())).long()
    with torch.no_grad():
        lg, aux = logits_and_aux(cfg, model, {"tokens": toks})
    return _whole_logits(lg, mesh).numpy(), float(aux)


def _serve(name, model, ctx):
    from repro_torch.serve import Request, ServingEngine
    eng = ServingEngine(cfg_of(name), model, batch_size=B,
                        max_seq=max(PROMPTS) + max(NEW), parallel=ctx)
    return eng.generate([Request(prompt=p, max_new_tokens=k)
                         for p, k in requests()])


def per_expert_slots(a_e, e_local, d_sz):
    """The control of risk 3: slots counted per expert, not per
    destination rank."""
    import torch.nn.functional as F
    onehot = F.one_hot(a_e, e_local * d_sz)
    pos = torch.sum((torch.cumsum(onehot, dim=0) - 1) * onehot, dim=1)
    return a_e // e_local, pos


def forward_serve(rank, world, trees, shape):
    """On a ``shape`` (data, model) mesh, with ``use_ep``: every case's
    logits (gathered) and aux with ``sp`` off and, at model 2, on; the
    non-EP path (experts gathered, the global Switch loss); the served
    tokens; the per-expert-slot control; the all-to-all count of one
    forward."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.parallel import collectives as coll
    mesh = make_test_mesh(shape, device_type="cpu")
    out = {}
    sps = (False, True) if shape[1] > 1 else (False,)
    for name, tree in trees.items():
        for case, kw in cases_of(name).items():
            for sp in sps:
                out[f"fwd/{name}/{case}/sp{int(sp)}"] = _forward(
                    name, tree, mesh, use_ep=True, sp=sp, **kw)
    out["fwd/noep"] = _forward(ARCH, trees[ARCH], mesh)
    model = _load(ARCH, trees[ARCH], _ctx(mesh, use_ep=True))
    toks = torch.from_numpy(_rows(mesh, tokens())).long()
    coll.reset_calls()
    with torch.no_grad():
        tf.forward_train(cfg_of(ARCH), model, {"tokens": toks})
    out["a2a_calls"] = coll.CALLS["all_to_all"]
    real = moe.slots
    moe.slots = per_expert_slots
    try:
        out["ctrl/per_expert_pos"] = _forward(ARCH, trees[ARCH], mesh,
                                              use_ep=True, moe_capacity=1.25)
    finally:
        moe.slots = real
    ctx = _ctx(mesh, use_ep=True)
    with torch.no_grad():
        out["serve"] = _serve(ARCH, _load(ARCH, trees[ARCH], ctx), ctx)
    return out


def _whole_state(model, opt):
    from repro_torch.parallel.sharding import full_tensor
    from repro_torch.train.steps import zero1_specs
    mesh = model.parallel.mesh
    zs = zero1_specs(model)
    params = {n: full_tensor(n, p, model.specs[n], mesh).numpy().copy()
              for n, p in model.named_parameters()}
    mom = {k: {n: full_tensor(n, t, zs[k][n], mesh).numpy().copy()
               for n, t in opt[k].items()} for k in ("m", "v")}
    return params, mom


def _step_model(tree, mesh, jopt=None):
    from repro_torch.launch.train import mesh_ctx
    from repro_torch.models import transformer as tf
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import make_train_step
    from repro_torch.train.steps import zero1_slices
    cfg = cfg_of(ARCH)
    ctx = mesh_ctx(mesh, cfg)
    model = tf.load_jax_params(cfg, tree, device="cpu", trainable=True,
                               parallel=ctx)
    z = zero1_slices(model)
    opt = (init_opt_state(dict(model.named_parameters()), zero1=z)
           if jopt is None else tf.load_jax_opt_state(model, jopt, zero1=z))
    step = make_train_step(cfg, AdamWConfig(lr=STEP_LR), loss_kind="lm",
                           parallel=ctx)
    return model, opt, step


def world4(rank, world, trees, jsteps):
    """(data 2, model 2): :func:`forward_serve`'s cases and :func:`train`'s
    steps, in one group."""
    out = forward_serve(rank, world, trees, (2, 2))
    out["train"] = train(rank, world, trees[ARCH], jsteps)
    return out


def train(rank, world, tree, jsteps):
    """On (data 2, model 2) with JAX's launcher context (``use_ep``,
    ``sp``, ZeRO-1): each step from JAX's state entering it (the tree,
    then JAX's state after the step before), its loss, aux, grad norm,
    parameters and moments; then the control with the experts' gradients
    summed over ``data`` too, on the first step."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.train import steps as tsteps
    mesh = make_test_mesh((2, 2), device_type="cpu")
    out = {"steps": []}
    batches = step_batches()
    for i, toks in enumerate(batches):
        if i == 0:
            model, opt, step = _step_model(tree, mesh)
        else:
            model, opt, step = _step_model(jsteps[i - 1]["params"], mesh,
                                           jsteps[i - 1]["opt"])
        t = torch.from_numpy(_rows(mesh, toks)).long()
        model, opt, m = step(model, opt, {"tokens": t, "labels": t})
        params, mom = _whole_state(model, opt)
        out["steps"].append(dict(loss=m["loss"].item(), aux=m["aux"].item(),
                                 grad_norm=m["grad_norm"].item(),
                                 params=params, mom=mom))
    real = tsteps.batch_summed
    tsteps.batch_summed = lambda model, axis: list(model.specs)
    try:
        model, opt, step = _step_model(tree, mesh)
        t = torch.from_numpy(_rows(mesh, batches[0])).long()
        model, opt, m = step(model, opt, {"tokens": t, "labels": t})
        out["ctrl/summed"] = dict(grad_norm=m["grad_norm"].item(),
                                  params=_whole_state(model, opt)[0])
    finally:
        tsteps.batch_summed = real
    return out
