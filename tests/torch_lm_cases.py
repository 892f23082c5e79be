"""The rank bodies of ``tests/test_torch_lm_parallel.py`` and
``tests/test_torch_lm_parallel_train.py`` and ``tests/test_torch_fsdp.py``: each runs in a process of a
gloo group started by ``repro_torch.launch.mesh.spawn_ranks`` and returns
numpy results (this module imports no JAX).

The configs are the reduced f32 ``qwen3-8b``, ``rwkv6-1.6b`` and
``hymba-1.5b`` (hymba's window cut to 8 so that a 16-token prompt wraps
its ring), plus a narrow hymba of 25 q / 5 KV heads, whose padded 26/13
heads put rank 1's q heads mid-group at ``model`` 2.  Parameters are JAX
trees (numpy leaves) at ``ParallelCtx(model_parallel=M)``'s padding,
handed in by the test process.
"""
import dataclasses

import numpy as np
import torch

ARCHS = ("qwen3-8b", "rwkv6-1.6b", "hymba-1.5b")
NARROW = "hymba-25-5"
M = 2                      # the model dim of every mesh here
S = 16                     # sequence length of the forward and the prompts
B = 4                      # batch (2 rows a data rank at data 2)
WINDOW = 8
PROMPTS = (16, 11, 16, 7)  # ragged prompt lengths of the served requests
NEW = (5, 4, 3, 5)         # new tokens a request
STEP_LR = 3e-3
STEP_SEQ = 16


def cfg_of(name):
    from repro_torch.configs import get_arch
    if name == NARROW:
        return dataclasses.replace(get_arch("hymba-1.5b").reduced(),
                                   name="hymba-25-5-reduced", num_heads=25,
                                   num_kv_heads=5, head_dim=8,
                                   window=WINDOW)
    cfg = get_arch(name).reduced()
    if cfg.block == "hymba":
        cfg = dataclasses.replace(cfg, window=WINDOW)
    return cfg


def tokens(seed=0, b=B, s=S, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


def requests():
    rng = np.random.default_rng(7)
    return [(rng.integers(1, 256, (n,)), k) for n, k in zip(PROMPTS, NEW)]


def _ctx(mesh, **kw):
    from repro_torch.models.transformer import ParallelCtx
    return ParallelCtx(mesh=mesh, model_parallel=M, **kw)


def _load(name, tree, ctx, trainable=False):
    from repro_torch.models import transformer as tf
    return tf.load_jax_params(cfg_of(name), tree, device="cpu",
                              trainable=trainable, parallel=ctx)


def _vocab_gather(t, mesh):
    from repro_torch.parallel.collectives import all_gather_dim
    return all_gather_dim(t.contiguous(), -1, mesh.get_group("model"))


def _serve(name, model, ctx=None):
    from repro_torch.serve import Request, ServingEngine
    eng = ServingEngine(cfg_of(name), model, batch_size=B,
                        max_seq=max(PROMPTS) + max(NEW), parallel=ctx)
    return eng.generate([Request(prompt=p, max_new_tokens=k)
                         for p, k in requests()])


def _decode_logits(name, model, toks, steps=3):
    """Prefill ``toks`` and ``steps`` greedy decode steps: every step's
    logits (B, vocab)."""
    from repro_torch.models import transformer as tf
    cfg = cfg_of(name)
    logits, cache = tf.prefill(cfg, model, {"tokens": toks},
                               cache_len=toks.shape[1] + steps)
    out = [logits]
    for i in range(steps):
        tok = out[-1][:, :cfg.vocab_size].argmax(-1)
        logits, cache = tf.decode_step(cfg, model, {"tokens": tok[:, None]},
                                       cache, toks.shape[1] + i)
        out.append(logits)
    return torch.stack(out).numpy()


def forward_serve(rank, world, trees, shape):
    """On a ``shape`` (data, model) mesh: ``forward_train``'s logits with
    ``sp`` off and on (gathered over the vocabulary) for every config,
    its controls (the contiguous ``w_in`` cut, the misaligned KV slice of
    the 25/5 hymba), the prefill and decode logits of the flash-decoding
    cache and their control (partials summed without their weights), the
    served tokens, and the K/V gather in place of the input gather on one
    attention layer (risk 3)."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import layers
    from repro_torch.models import transformer as tf
    from repro_torch.parallel import collectives, sharding
    mesh = make_test_mesh(shape, device_type="cpu")
    toks = torch.from_numpy(tokens()).long()
    out = {}
    with torch.no_grad():
        for name, tree in trees.items():
            cfg = cfg_of(name)
            for sp in (False, True):
                model = _load(name, tree, _ctx(mesh, sp=sp))
                lg = tf.forward_train(cfg, model, {"tokens": toks})
                out[f"fwd/{name}/sp{int(sp)}"] = _vocab_gather(
                    lg, mesh).numpy()
            model = _load(name, tree, _ctx(mesh))
            out[f"decode/{name}"] = _decode_logits(name, model, toks)
            out[f"serve/{name}"] = _serve(name, model)
        # controls
        real_halves = sharding.HALVES
        sharding.HALVES = ()
        try:
            model = _load("hymba-1.5b", trees["hymba-1.5b"], _ctx(mesh))
            out["ctrl/w_in_cut"] = _vocab_gather(tf.forward_train(
                cfg_of("hymba-1.5b"), model, {"tokens": toks}), mesh).numpy()
        finally:
            sharding.HALVES = real_halves
        real_select = layers.select_kv

        def misaligned(t, share):
            # q head j of the rank paired with KV head kv_start + j // group
            # (a contiguous run from the rank's first KV head), not
            # (q0 + j) // group
            if share.kv_index is None:
                return real_select(t, share)
            g = share.hq // share.hkv
            idx = [share.kv_start + j // g for j in range(share.hq_l)]
            return t.index_select(2, torch.tensor(idx))

        layers.select_kv = misaligned
        try:
            model = _load(NARROW, trees[NARROW], _ctx(mesh))
            out["ctrl/kv_slice"] = _vocab_gather(tf.forward_train(
                cfg_of(NARROW), model, {"tokens": toks}), mesh).numpy()
        finally:
            layers.select_kv = real_select
        real_combine = collectives.lse_combine

        def unweighted(o, lse, group):
            import torch.distributed as dist
            o = o.clone()
            dist.all_reduce(o, group=group)
            return o

        collectives.lse_combine = unweighted
        try:
            model = _load("qwen3-8b", trees["qwen3-8b"], _ctx(mesh))
            out["ctrl/unweighted"] = _decode_logits("qwen3-8b", model, toks)
        finally:
            collectives.lse_combine = real_combine
        out["ctrl/kv_gather"] = kv_gather_layer(trees["qwen3-8b"], mesh)
        out["merge"] = decode_merge(mesh)
    return out


def decode_merge(mesh):
    """One decode token's attention over a cache of 24 slots split over
    ``model``: the flash-decoding merge (each rank's local softmax,
    ``lse_combine``) beside the heads-layout softmax over the whole cache
    and the partials summed without their weights (the control), for a
    causal mask at position 17 and a window of 5 at position 13 (keys 9
    to 13, on both ranks' slots)."""
    from repro_torch.models.layers import decode_partials
    from repro_torch.parallel.collectives import lse_combine
    group = mesh.get_group("model")
    r, m = mesh.get_local_rank("model"), group.size()
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.standard_normal((2, 1, 8, 16)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 24, 2, 16)).astype(
        np.float32)) for _ in range(2))
    c = 24 // m
    out = {}
    for window, pos in ((None, 17), (5, 13)):
        kpos = torch.arange(24)
        valid = kpos <= pos
        if window is not None:
            valid = valid & (kpos > pos - window)
        whole, _ = decode_partials(q, k, v, valid, 16)
        part = slice(r * c, (r + 1) * c)
        o, lse = decode_partials(q, k[:, part], v[:, part], valid[part], 16)
        o = torch.where(torch.isfinite(lse)[..., None], o, 0.0)
        merged = lse_combine(o, lse, group)
        summed = o.clone()
        import torch.distributed as dist
        dist.all_reduce(summed, group=group)
        out[window] = (merged.numpy(), whole.numpy(), summed.numpy())
    return out


def kv_gather_layer(tree, mesh):
    """Risk 3 on qwen3's first attention layer (all heads on every rank,
    the sequence split over ``model``): this rank's rows of the causal
    output with the input gathered along the sequence (the port's ``sp``
    path) and with only K/V gathered (the DiT's ``kv_gather``, queries
    right-aligned to the keys): ``(gathered, kv)``."""
    from repro_torch.models import layers
    from repro_torch.models.transformer import ParallelCtx
    from repro_torch.parallel.collectives import all_gather_dim
    cfg = cfg_of("qwen3-8b")
    model = _load("qwen3-8b", tree, ParallelCtx(model_parallel=M))
    group = mesh.get_group("model")
    r, m = mesh.get_local_rank("model"), mesh.get_group("model").size()
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32))
    n = S // m
    x_loc = x[:, r * n:(r + 1) * n]
    hq, hkv = cfg.padded_heads(M)
    kw = dict(num_heads=hq, num_kv_heads=hkv, head_dim=cfg.resolved_head_dim,
              theta=cfg.rope_theta, qk_norm=True, causal=True)
    p = model.blocks[0]["attn"]
    full, _ = layers.attention_full(p, all_gather_dim(x_loc, 1, group), **kw)
    kvg, _ = layers.attention_full(
        p, x_loc, positions=r * n + torch.arange(n), **kw,
        kv_gather=lambda t: all_gather_dim(t, 1, group))
    return full[:, r * n:(r + 1) * n].numpy(), kvg.numpy()


def collectives_case(rank, world):
    """The tensor-parallel operators on ``world`` ranks: each one's output
    and its input's gradient under a seeded upstream gradient, beside the
    same from the single-process function of every rank's draws
    (``want``)."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel import collectives as coll
    mesh = make_test_mesh((world,), ("model",), device_type="cpu")
    g = mesh.get_group("model")
    rng = np.random.default_rng(11)

    def draw(n):
        return [torch.from_numpy(rng.standard_normal((2, n, 6)))
                for _ in range(world)]

    short, long_, up_s, up_l = draw(4), draw(4 * world), draw(4), \
        draw(4 * world)
    whole = torch.cat(short, 1)

    def chunk(t, r):
        return t[:, r * 4:(r + 1) * 4]

    def pad(t, r):
        z = torch.zeros((2, 4 * world, 6), dtype=t.dtype)
        z[:, r * 4:(r + 1) * 4] = t
        return z

    # name: (fn, inputs a rank, upstream a rank, y want, dx want, and the
    # control: dx with the backward's collective left out)
    ops = {
        "copy_to": (lambda x: coll.copy_to(x, g), short, up_s,
                    short[rank], sum(up_s), up_s[rank]),
        "reduce_from": (lambda x: coll.reduce_from(x, g), short, up_s,
                        sum(short), up_s[rank], sum(up_s)),
        "joined": (lambda x: torch.cat(coll.joined(
            (x[..., :2], x[..., 2:]), "reduce_both", g), -1), short, up_s,
            sum(short), sum(up_s), up_s[rank]),
        "gather_seq": (lambda x: coll.gather_seq(x, 1, g), short, up_l,
                       whole, chunk(sum(up_l), rank),
                       chunk(up_l[rank], rank)),
        "scatter_seq": (lambda x: coll.scatter_seq(x, 1, g), long_, up_s,
                        chunk(sum(long_), rank), torch.cat(up_s, 1),
                        pad(up_s[rank], rank)),
        "gather_split": (lambda x: coll.gather_split(x, 1, g), short,
                         [up_l[0]] * world, whole, chunk(up_l[0], rank),
                         chunk(world * up_l[0], rank)),
        "split": (lambda x: coll.split(x, 1, g), [long_[0]] * world, up_s,
                  chunk(long_[0], rank), torch.cat(up_s, 1),
                  pad(up_s[rank], rank)),
    }
    out = {}
    for name, (fn, xs, ups, y_want, dx_want, ctrl) in ops.items():
        x = xs[rank].clone().requires_grad_(True)
        y = fn(x)
        (dx,) = torch.autograd.grad(y, x, ups[rank])
        out[name] = (y.detach().numpy(), dx.numpy(), y_want.numpy(),
                     dx_want.numpy(), ctrl.numpy())
    kv = torch.from_numpy(rng.standard_normal((3, 2, 8, 4, 5)))
    mine = kv[:, :, :, rank * 2:(rank + 1) * 2].contiguous()
    out["heads_to_seq"] = (coll.heads_to_seq(mine, 2, 3, g).numpy(),
                           kv[:, :, rank * 4:(rank + 1) * 4].numpy())
    return out


# --------------------------------------------------------------------------
# the sharded train step, data, checkpoint, launcher
# --------------------------------------------------------------------------

STEP_ARCH = "qwen3-8b"
STEP_ARCHS = ("qwen3-8b", "rwkv6-1.6b", "hymba-1.5b")


def step_batches(n=3):
    """The global (B, STEP_SEQ) token batches of the step tests."""
    return [tokens(seed=20 + i, s=STEP_SEQ) for i in range(n)]


def _step_model(name, tree, mesh, jopt=None, remat=False,
                policy="dots", fsdp=False):
    """The sharded model, optimizer state and step on ``mesh`` (JAX's
    launcher context: ``sp``, ZeRO-1, ``remat_policy``, ``fsdp``), from
    JAX's tree and optimizer state (or fresh moments); ``remat`` the
    step's."""
    from repro_torch.launch.train import mesh_ctx
    from repro_torch.models import transformer as tf
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import make_train_step
    from repro_torch.train.steps import zero1_slices
    ctx = dataclasses.replace(mesh_ctx(mesh), remat_policy=policy,
                              fsdp=fsdp)
    model = tf.load_jax_params(cfg_of(name), tree, device="cpu",
                               trainable=True, parallel=ctx)
    z = zero1_slices(model)
    opt = (init_opt_state(dict(model.named_parameters()), zero1=z)
           if jopt is None else tf.load_jax_opt_state(model, jopt, zero1=z))
    step = make_train_step(cfg_of(name), AdamWConfig(lr=STEP_LR),
                           loss_kind="lm", parallel=ctx, remat=remat)
    return model, opt, step


# (remat, remat_policy) of the remat steps: the plain step first
REMAT_RUNS = ((False, "dots"), (True, "dots"), (True, "nothing"))


def _rows(mesh, t):
    from repro_torch.data.pipeline import _host_slice
    start, per = _host_slice(t.shape[0], mesh, ("data",))
    return t[start:start + per]


def _whole_state(model, opt):
    """Every parameter and moment whole (gathered), by the port's names."""
    from repro_torch.parallel.sharding import full_tensor
    from repro_torch.train.steps import zero1_specs
    mesh = model.parallel.mesh
    zs = zero1_specs(model)
    params = {n: full_tensor(n, p, model.specs[n], mesh).numpy().copy()
              for n, p in model.named_parameters()}
    mom = {k: {n: full_tensor(n, t, zs[k][n], mesh).numpy().copy()
               for n, t in opt[k].items()} for k in ("m", "v")}
    return params, mom


def _controls(model, batch):
    """The step's two controls on this rank: the loss as the mean of the
    data ranks' own means with unequal valid counts (against the global
    sum over the global count), and the grad norm counting the leaves
    replicated over ``model`` once a rank (against the port's)."""
    import torch.distributed as dist
    from repro_torch.models.transformer import model_partial_grads
    from repro_torch.parallel.tensor_parallel import TensorParallel
    from repro_torch.train import losses
    from repro_torch.train.steps import sharded_global_norm
    cfg, ctx = model.cfg, model.parallel
    mesh = ctx.mesh
    tp = TensorParallel(cfg, ctx)
    x, _, _ = losses.forward_hidden(cfg, model, batch)
    x = tp.enter(x)[:, :-1]
    r = mesh.get_local_rank("data")
    valid = torch.ones(x.shape[:2], dtype=torch.bool)
    valid[:, :1 + 5 * r] = False                  # unequal counts
    s, n = losses._chunked_ce(x, batch["labels"][:, 1:], valid,
                              model["unembed"]["w"], cfg.vocab_size, tp=tp)
    s, n = s.detach(), n.detach()
    glob = losses._batch_sum(s, mesh, ("data",)) / losses._batch_sum(
        n, mesh, ("data",))
    per_rank = (s / n).clone()
    dist.all_reduce(per_rank, group=mesh.get_group("data"))
    per_rank = per_rank / mesh.get_group("data").size()
    loss, _ = losses.lm_loss(cfg, model, batch)
    params = dict(model.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    from repro_torch.train.steps import _sum_over
    _sum_over(grads, model_partial_grads(model),
              mesh.get_group("model"), False)
    _sum_over(grads, list(grads), mesh.get_group("data"), False)
    right = sharded_global_norm(model, grads)
    # the control: every leaf's sum of squares summed over model
    sq = torch.stack([torch.sum(torch.square(g.float()))
                      for g in grads.values()])
    dist.all_reduce(sq, group=mesh.get_group("model"))
    return dict(loss_global=float(glob), loss_per_rank=float(per_rank),
                norm=float(right), norm_m_times=float(torch.sqrt(sq.sum())))


def train4(rank, world, trees, jsteps, ckpt_dir):
    """4 ranks, a (data 2, model 2) mesh: for every arch 3 sharded steps
    (``sp``, ZeRO-1), each from JAX's state entering it (the loss, the
    grad norm, every parameter and moment whole after it), the step's
    controls; for qwen3 the port's own 3 steps with a checkpoint after
    the second; the data ranks' batch slices; the production mesh's and
    ``build("pod1")``'s errors; ``mesh_ctx``'s fields."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data import DataConfig, make_stream
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
    from repro_torch.launch.train import build, mesh_ctx
    from repro_torch.train.steps import train_state_specs
    mesh = make_test_mesh((2, 2), device_type="cpu")
    out = {}
    for name in STEP_ARCHS:
        runs = []
        for i, toks in enumerate(step_batches()):
            t = _rows(mesh, torch.from_numpy(toks).long())
            batch = {"tokens": t, "labels": t}
            tree = trees[name] if i == 0 else jsteps[name][i - 1]["params"]
            jopt = None if i == 0 else jsteps[name][i - 1]["opt"]
            model, opt, step = _step_model(name, tree, mesh, jopt)
            if i == 0:
                out[f"ctrl/{name}"] = _controls(model, batch)
                model, opt, step = _step_model(name, tree, mesh, jopt)
            model, opt, m = step(model, opt, batch)
            params, mom = _whole_state(model, opt)
            runs.append(dict(loss=float(m["loss"]),
                             grad_norm=float(m["grad_norm"]),
                             params=params, mom=mom))
        out[f"steps/{name}"] = runs
    # the port's own trajectory, checkpointed after step 2
    model, opt, step = _step_model(STEP_ARCH, trees[STEP_ARCH], mesh)
    ckpt = Checkpointer(ckpt_dir, mesh=mesh,
                        shardings=train_state_specs(model))
    for i, toks in enumerate(step_batches()):
        t = _rows(mesh, torch.from_numpy(toks).long())
        model, opt, _ = step(model, opt, {"tokens": t, "labels": t})
        if i == 1:
            ckpt.save_async(2, {"params": dict(model.named_parameters()),
                                "opt": opt})
            ckpt.wait()
            out["saved"] = _whole_state(model, opt)
    ckpt.close()
    out["uninterrupted"] = _whole_state(model, opt)
    # data: this rank's rows of the global batch
    stream = make_stream(cfg_of(STEP_ARCH), DataConfig(global_batch=B,
                                                       seq_len=STEP_SEQ),
                         device="cpu", mesh=mesh, batch_axes=("data",))
    out["data"] = (mesh.get_local_rank("data"),
                   stream.batch(3)["tokens"].numpy())
    errs = []
    for fn in (lambda: make_production_mesh(device_type="cpu"),
               lambda: build(STEP_ARCH, mesh_kind="pod1", reduced=True,
                             device="cpu")):
        try:
            fn()
            errs.append(None)
        except ValueError as e:
            errs.append(str(e))
    out["errors"] = errs
    ctx = mesh_ctx(mesh)
    out["ctx"] = dict(batch_axes=ctx.batch_axes, sp=ctx.sp,
                      model_parallel=ctx.model_parallel, use_ep=ctx.use_ep,
                      fsdp=ctx.fsdp)
    return out


def train2(rank, world, trees, ckpt_dir):
    """2 ranks, a (data 1, model 2) mesh: the (2, 2) checkpoint restored
    (every leaf whole) and the third step taken from it; for every arch
    the first step from JAX's tree (``sp``, ZeRO-1) plain and with
    ``remat`` at each policy (:data:`REMAT_RUNS`)."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.train.steps import train_state_specs
    mesh = make_test_mesh((1, 2), device_type="cpu")
    model, opt, step = _step_model(STEP_ARCH, trees[STEP_ARCH], mesh)
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    ckpt = Checkpointer(ckpt_dir, mesh=mesh,
                        shardings=train_state_specs(model))
    _, at, _ = ckpt.restore({"params": dict(model.named_parameters()),
                             "opt": opt})
    ckpt.close()
    restored = _whole_state(model, opt)
    t = torch.from_numpy(step_batches()[2]).long()
    model, opt, _ = step(model, opt, {"tokens": t, "labels": t})
    out = dict(step=at, restored=restored, next=_whole_state(model, opt))
    t = _rows(mesh, torch.from_numpy(step_batches()[0]).long())
    for name in STEP_ARCHS:
        for remat, policy in REMAT_RUNS:
            model, opt, step = _step_model(name, trees[name], mesh,
                                           remat=remat, policy=policy)
            model, opt, m = step(model, opt, {"tokens": t, "labels": t})
            params, mom = _whole_state(model, opt)
            out[f"remat/{name}/{int(remat)}/{policy}"] = dict(
                loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                params=params, mom=mom)
    return out


# --------------------------------------------------------------------------
# FSDP (tests/test_torch_fsdp.py)
# --------------------------------------------------------------------------

FSDP_ARCHS = ("qwen3-8b", "rwkv6-1.6b", "hymba-1.5b")
FSDP_MESHES = ((2, 2), (4, 1))
# (remat, remat_policy) of the FSDP steps
FSDP_REMAT = ((False, "dots"), (True, "dots"))
# the train cell whose collectives the dry run predicts: (B, S)
COLL_SHAPE = (4, 16)


def fsdp4(rank, world, trees):
    """4 ranks: on (data 2, model 2) and (data 4, model 1), for every arch
    of :data:`FSDP_ARCHS` the first step from JAX's tree with and
    without FSDP at each :data:`FSDP_REMAT` (the loss, the grad norm,
    every parameter and moment whole after it, the FSDP leaves' local
    shapes), the FSDP step with the sharded gradients also all-reduced
    over ``data`` (the control), and the prefill and decode logits of
    both models on the rank's rows; on (2, 2) the collectives of the dry
    run's train cell at :data:`COLL_SHAPE`, run on these gloo ranks with
    the dry run's own context and step.  Rank 0 returns its results, the
    others nothing."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.train import steps
    out = {}
    for shape in FSDP_MESHES:
        mesh = make_test_mesh(shape, device_type="cpu")
        t = _rows(mesh, torch.from_numpy(step_batches()[0]).long())
        batch = {"tokens": t, "labels": t}
        for name in FSDP_ARCHS:
            for remat, policy in FSDP_REMAT:
                for fsdp in (False, True):
                    model, opt, step = _step_model(name, trees[name], mesh,
                                                   remat=remat,
                                                   policy=policy, fsdp=fsdp)
                    if fsdp and not remat:
                        out[("local", shape, name)] = {
                            n: tuple(p.shape)
                            for n, p in model.named_parameters()
                            if n in model.fsdp_dims}
                        out[("dims", shape, name)] = dict(model.fsdp_dims)
                        with torch.no_grad():
                            out[("decode", shape, name)] = _decode_logits(
                                name, model, t)
                    elif not remat:
                        with torch.no_grad():
                            out[("decode", shape, name, "plain")] = \
                                _decode_logits(name, model, t)
                    model, opt, m = step(model, opt, batch)
                    params, mom = _whole_state(model, opt)
                    out[(shape, name, remat, fsdp)] = dict(
                        loss=float(m["loss"]),
                        grad_norm=float(m["grad_norm"]),
                        params=params, mom=mom)
            # the control: the sharded gradients summed over data again
            model, opt, step = _step_model(name, trees[name], mesh,
                                           fsdp=True)
            keep = steps.batch_summed
            steps.batch_summed = lambda model, axis: list(model.specs)
            try:
                model, opt, m = step(model, opt, batch)
            finally:
                steps.batch_summed = keep
            params, mom = _whole_state(model, opt)
            out[(shape, name, "control")] = dict(
                loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                params=params, mom=mom)
        if shape == (2, 2):
            cfg = cfg_of(STEP_ARCH)
            cell = ShapeConfig("cell", COLL_SHAPE[1], COLL_SHAPE[0], "train")
            for fsdp in (False, True):
                par = dataclasses.replace(dryrun.build_parallel(cfg, mesh),
                                          fsdp=fsdp)
                trace = dryrun.trace_cell(cfg, cell, par, "cpu")
                out[("collectives", fsdp)] = {
                    k: dict(v) for k, v in trace["ledger"].collectives.items()}
    return out if rank == 0 else {}
