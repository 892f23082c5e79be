"""The port's tensor-, sequence- and data-parallel language models on CPU
gloo groups, against the JAX package and the port's own single process:
the LM sharding rules (``parallel.sharding``), the tensor-parallel
collectives (``parallel.collectives``), ``forward_train`` with ``sp`` off
and on, and the serving engine on the flash-decoding cache.

The rank bodies live in ``tests/torch_lm_cases.py`` (no JAX there).  One
``spawn_ranks`` per mesh: (data 1, model 2) and (data 2, model 2), each
running every case of its mesh; 2 ranks for the collectives.  JAX's side
runs once, in one subprocess with 32 fake devices: its rule tables on
meshes (2, 4) and (2, 16) for the full configs, and ``forward_train``,
``prefill``/``decode_step`` and ``ServingEngine`` with
``ParallelCtx(model_parallel=2)`` on the reduced ones (f32,
``use_kernel=False``), from the same trees (JAX's init at that padding,
every leaf moved by a numpy draw).

Tolerances: ``forward_train``'s logits within ``REL_L2`` (1e-5) of JAX's
and of the port's single process, relative L2 over the real vocabulary
(read against the single process: 4.4e-7 to 8.9e-7); the prefill and
decode logits the same (read: 5.4e-7 to 1.7e-6, the model's own
sharded sums included); one decode token's flash-decoding merge against
the heads-layout softmax on the same inputs within ``MERGE_REL_L2``
(1e-6); served tokens equal.  Each control misses its check by orders of
magnitude.
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_lm_cases as cases
from conftest import REPO
from repro_torch.launch import mesh as tmesh

pytestmark = pytest.mark.distributed

REL_L2 = 1e-5
# the flash-decoding merge against the heads-layout softmax on the same
# attention inputs, relative L2
MERGE_REL_L2 = 1e-6
ALL = cases.ARCHS + (cases.NARROW,)

JAX_CODE = r"""
import dataclasses as dc
import pickle
import sys
import jax
import jax.numpy as jnp
import numpy as np
from repro.compat import make_mesh
from repro.configs import get_arch
from repro.launch.specs import cache_specs, param_specs
from repro.configs.base import ShapeConfig
from repro.models import transformer as jtf
from repro.parallel.sharding import (batch_shardings, cache_shardings,
                                     opt_state_shardings, param_shardings)
from repro.serve.engine import Request, ServingEngine
import torch_lm_cases as C

assert len(jax.devices()) == 32
with open(sys.argv[1], "rb") as f:
    trees, jcfgs = pickle.load(f)
out = {}

def flat(tree):
    return {jax.tree_util.keystr(p): tuple(
        e if not isinstance(e, list) else tuple(e) for e in s.spec)
        for p, s in jax.tree_util.tree_leaves_with_path(tree)}

for arch in C.ARCHS:
    cfg = get_arch(arch)
    for shape in ((2, 4), (2, 16)):
        mesh = make_mesh(shape, ("data", "model"))
        par = jtf.ParallelCtx(mesh=mesh, model_parallel=shape[1])
        ps = param_specs(cfg, par)
        opt = {"m": ps, "v": ps,
               "step": jax.ShapeDtypeStruct((), jnp.int32)}
        key = f"{arch}/{shape}"
        out[f"rules/param/{key}"] = flat(param_shardings(cfg, mesh, ps, par))
        out[f"rules/fsdp/{key}"] = flat(param_shardings(cfg, mesh, ps, par,
                                                        fsdp=True))
        out[f"rules/opt/{key}"] = flat(opt_state_shardings(cfg, mesh, opt,
                                                           par))
        b = {"tokens": jax.ShapeDtypeStruct((8, 128), jnp.int32),
             "labels": jax.ShapeDtypeStruct((3, 128), jnp.int32)}
        out[f"rules/batch/{key}"] = flat(batch_shardings(mesh, b,
                                                         par.batch_axes))
        cs = cache_specs(cfg, ShapeConfig("d", 128, 8, "decode"), par)
        out[f"rules/cache/{key}"] = [tuple(s.spec) for s in
                                     jax.tree.leaves(cache_shardings(
                                         cfg, mesh, cs, par))]
        out[f"rules/cache_shapes/{key}"] = [tuple(s.shape) for s in
                                            jax.tree.leaves(cs)]

par = jtf.ParallelCtx(model_parallel=C.M)
toks = jnp.asarray(C.tokens())
for name, jcfg in jcfgs.items():
    params = jax.tree.map(jnp.asarray, trees[name])
    lg, _, _ = jtf.forward_train(jcfg, params, {"tokens": toks},
                                 parallel=par, use_kernel=False)
    out[f"fwd/{name}"] = np.asarray(lg)
    logits, cache = jtf.prefill(jcfg, params, {"tokens": toks},
                                parallel=par, use_kernel=False)
    if jcfg.block == "attn_mlp":
        cache = tuple(jnp.pad(c, ((0, 0), (0, 0), (0, 3), (0, 0), (0, 0)))
                      for c in cache)
    steps = [logits]
    for i in range(3):
        tok = jnp.argmax(steps[-1][:, :jcfg.vocab_size], -1).astype(
            jnp.int32)
        logits, cache = jtf.decode_step(jcfg, params, {"tokens": tok[:, None]},
                                        cache, jnp.int32(C.S + i),
                                        parallel=par, use_kernel=False)
        steps.append(logits)
    out[f"decode/{name}"] = np.stack([np.asarray(s) for s in steps])
    eng = ServingEngine(jcfg, params, batch_size=C.B,
                        max_seq=max(C.PROMPTS) + max(C.NEW), parallel=par,
                        use_kernel=False)
    out[f"serve/{name}"] = eng.generate(
        [Request(prompt=jnp.asarray(p, jnp.int32), max_new_tokens=k)
         for p, k in C.requests()])
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
print("JAX LM PARALLEL OK")
"""


def jax_cfg(name):
    """JAX's config of ``cases.cfg_of(name)``."""
    from repro.configs import get_arch as jget_arch
    pc = cases.cfg_of(name)
    base = "hymba-1.5b" if name == cases.NARROW else name
    return dataclasses.replace(
        jget_arch(base).reduced(), name=pc.name, num_heads=pc.num_heads,
        num_kv_heads=pc.num_kv_heads, head_dim=pc.head_dim, window=pc.window)


def jax_trees():
    """JAX's init of every config at ``model_parallel`` 2, every leaf
    moved by a numpy draw (so no zero-init leaf hides a path): numpy f32
    leaves."""
    import jax
    from repro.models import transformer as jtf
    rng = np.random.default_rng(0)
    out = {}
    for name in ALL:
        tree = jtf.init_params(jax_cfg(name), jax.random.PRNGKey(1),
                               jtf.ParallelCtx(model_parallel=cases.M))
        out[name] = jax.tree.map(
            lambda x: (np.asarray(x, np.float32) + 0.05 * rng.standard_normal(
                x.shape).astype(np.float32)), tree)
    return out


class _JaxRun:
    def __init__(self, tmp):
        self.trees = jax_trees()
        src, self.dst = str(tmp / "trees.pkl"), str(tmp / "jax_out.pkl")
        with open(src, "wb") as f:
            pickle.dump((self.trees, {n: jax_cfg(n) for n in ALL}), f)
        env = dict(os.environ,
                   XLA_FLAGS="--xla_force_host_platform_device_count=32",
                   PYTHONPATH=os.pathsep.join(
                       [os.path.join(REPO, "src"),
                        os.path.join(REPO, "tests")]))
        self.proc = subprocess.Popen(
            [sys.executable, "-c", JAX_CODE, src, self.dst],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        self.out = None

    def get(self):
        if self.out is None:
            out, err = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0, f"stdout={out}\nstderr={err}"
            with open(self.dst, "rb") as f:
                self.out = pickle.load(f)
        return self.out


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    run = _JaxRun(tmp_path_factory.mktemp("jax_lm"))
    yield run
    if run.proc.poll() is None:
        run.proc.kill()
        run.proc.communicate()


@pytest.fixture(scope="module")
def mesh12(jax_run):
    return tmesh.spawn_ranks(cases.forward_serve, 2, jax_run.trees, (1, 2),
                             device_type="cpu")


@pytest.fixture(scope="module")
def mesh22(jax_run):
    return tmesh.spawn_ranks(cases.forward_serve, 4, jax_run.trees, (2, 2),
                             device_type="cpu")


@pytest.fixture(scope="module")
def single(jax_run):
    """The port's single process at ``model_parallel`` 2 (no mesh): the
    same cases as a rank's."""
    from repro_torch.models import transformer as tf
    toks = torch.from_numpy(cases.tokens()).long()
    out = {}
    with torch.no_grad():
        for name in ALL:
            cfg = cases.cfg_of(name)
            model = tf.load_jax_params(
                cfg, jax_run.trees[name], device="cpu",
                parallel=tf.ParallelCtx(model_parallel=cases.M))
            out[f"fwd/{name}"] = tf.forward_train(cfg, model,
                                                  {"tokens": toks}).numpy()
            out[f"decode/{name}"] = cases._decode_logits(name, model, toks)
            out[f"serve/{name}"] = cases._serve(name, model)
    return out


def _norm(spec):
    """A spec with one-name tuples written as the name (JAX's
    ``PartitionSpec`` prints ``P(("data",))`` as ``P("data")``)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def rel_l2(got, want, vocab=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if vocab is not None:
        got, want = got[..., :vocab], want[..., :vocab]
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# --------------------------------------------------------------------------
# rules
# --------------------------------------------------------------------------

def _port_specs(arch, shape):
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf
    from repro_torch.parallel import sharding
    cfg = get_arch(arch)
    mesh = dict(zip(("data", "model"), shape))
    par = tf.ParallelCtx(model_parallel=shape[1])
    model = tf.TransformerLM(cfg, device="meta", parallel=par)
    shapes = {n: p for n, p in model.named_parameters()}
    return cfg, mesh, par, shapes, sharding


def _jax_key(name):
    """The JAX tree path of a port parameter name, as ``keystr`` prints
    it, and whether it sits under ``blocks`` (a stacked leaf)."""
    parts = name.split(".")
    blocks = parts[0] == "blocks"
    if blocks:
        parts = ["blocks"] + parts[2:]
    return "".join(f"['{p}']" for p in parts), blocks


def _held_to_jax(port, jax_specs):
    seen = set()
    for name, spec in port.items():
        key, blocks = _jax_key(name)
        want = jax_specs[key]
        if blocks:
            assert want[0] is None, (name, want)   # the stacked axis
            want = want[1:]
        want = tuple(want) + (None,) * (len(spec) - len(want))
        assert spec == want, (name, spec, want)
        seen.add(key)
    assert seen == set(jax_specs), set(jax_specs) - seen


@pytest.mark.parametrize("shape", [(2, 4), (2, 16)])
@pytest.mark.parametrize("arch", cases.ARCHS)
def test_param_and_opt_rules_match_jax(jax_run, arch, shape):
    """Every leaf's spec of the full config equals JAX's
    ``param_shardings`` (plain and ``fsdp``) and ``opt_state_shardings``
    with the stacked axis's leading None dropped; the port reads its
    shapes from a meta-device model."""
    cfg, mesh, par, shapes, sh = _port_specs(arch, shape)
    out = jax_run.get()
    key = f"{arch}/{shape}"
    _held_to_jax(sh.param_shardings(cfg, mesh, shapes, par),
                 out[f"rules/param/{key}"])
    _held_to_jax(sh.param_shardings(cfg, mesh, shapes, par, fsdp=True),
                 out[f"rules/fsdp/{key}"])
    opt = sh.opt_state_shardings(cfg, mesh, {"m": shapes, "v": shapes},
                                 par)
    jopt = out[f"rules/opt/{key}"]
    for k in ("m", "v"):
        _held_to_jax(opt[k], {p[len(f"['{k}']"):]: s for p, s in
                              jopt.items() if p.startswith(f"['{k}']")})
    assert opt["step"] == () and jopt["['step']"] == ()


@pytest.mark.parametrize("shape", [(2, 4), (2, 16)])
@pytest.mark.parametrize("arch", cases.ARCHS)
def test_batch_and_cache_rules_match_jax(jax_run, arch, shape):
    """``batch_shardings`` (a divisible and an indivisible batch) and
    ``cache_shardings`` on the full config's decode cache (batch 8, 128
    positions) equal JAX's; the port's cache has JAX's shapes."""
    from repro_torch.models import transformer as tf
    cfg, mesh, par, _, sh = _port_specs(arch, shape)
    out = jax_run.get()
    key = f"{arch}/{shape}"
    b = {"tokens": torch.empty((8, 128)), "labels": torch.empty((3, 128))}
    jb = out[f"rules/batch/{key}"]
    got = sh.batch_shardings(mesh, b, par.batch_axes)
    assert {k: _norm(v) for k, v in got.items()} == {
        "tokens": _norm(jb["['tokens']"]), "labels": _norm(jb["['labels']"])}
    cache = tf.make_dense_cache(cfg, 8, 128, device="meta", parallel=par)
    names = getattr(cache, "_fields", ("k", "v"))
    leaves = dict(zip(names, cache))
    assert [tuple(t.shape) for t in cache] == \
        out[f"rules/cache_shapes/{key}"]
    got = sh.cache_shardings(cfg, mesh, leaves, par)
    assert [_norm(got[n]) for n in names] == [
        _norm(s) for s in out[f"rules/cache/{key}"]]


def test_rules_drop_indivisible_axes_and_keep_hymba_halves():
    """An axis whose size does not divide its dim is dropped (the reduced
    qwen3's 2 KV heads at model 4 stay replicated: ``kv_shardable`` is
    False at 2 % 4), and hymba's ``w_in`` is cut into each half's part:
    rank r of m holds ``[z_r | xs_r]``, not the contiguous ``1/m`` of the
    whole, which would give rank 0 all of ``z`` (the control)."""
    from repro_torch.models import transformer as tf
    from repro_torch.parallel import sharding
    cfg = cases.cfg_of("qwen3-8b")
    par = tf.ParallelCtx(model_parallel=4)
    shapes = tf.global_shapes(cfg, par)
    specs = sharding.param_shardings(cfg, {"data": 2, "model": 4}, shapes,
                                     par)
    assert specs["blocks.0.attn.wk"] == (None, None)
    assert specs["blocks.0.attn.wq"] == (None, "model")
    fake = {"data": 1, "model": 2}
    w = torch.arange(4 * 8).reshape(4, 8)    # z = cols 0-3, xs = cols 4-7

    class Mesh:
        mesh_dim_names = ("data", "model")

        def __init__(self, r):
            self.r = r
            self.mesh = torch.empty(1, 2)

        def get_local_rank(self, name):
            return self.r if name == "model" else 0

    parts = [sharding.local_part("blocks.0.ssm.w_in", w, (None, "model"),
                                 Mesh(r)) for r in range(2)]
    assert torch.equal(parts[0], w[:, [0, 1, 4, 5]])
    assert torch.equal(parts[1], w[:, [2, 3, 6, 7]])
    contiguous = sharding.local_part("blocks.0.attn.wq", w, (None, "model"),
                                     Mesh(0))
    assert torch.equal(contiguous, w[:, :4])          # all of z: the miss
    assert not torch.equal(contiguous, parts[0])
    assert sharding.mesh_shape(fake) == fake


# --------------------------------------------------------------------------
# the collectives (2 ranks)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def coll2():
    return tmesh.spawn_ranks(cases.collectives_case, 2, device_type="cpu")


@pytest.mark.parametrize("op", ["copy_to", "reduce_from", "joined",
                                "gather_seq", "scatter_seq", "gather_split",
                                "split"])
def test_tensor_parallel_operator_forward_and_backward(coll2, op):
    """Each operator's output and its input's gradient on both ranks equal
    the single-process function of every rank's draws (f64, to 1e-12;
    ``joined``: two parts through one all-reduce both ways);
    the gradient with the backward's collective left out (the control)
    does not."""
    for out in coll2:
        y, dx, y_want, dx_want, ctrl = out[op]
        np.testing.assert_allclose(y, y_want, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(dx, dx_want, rtol=1e-12, atol=1e-12)
        assert not np.allclose(ctrl, dx_want)


def test_heads_to_seq_moves_heads_to_sequence(coll2):
    """One all-to-all turns each rank's heads over the whole sequence into
    its part of the sequence with every head, bitwise."""
    for out in coll2:
        got, want = out["heads_to_seq"]
        assert np.array_equal(got, want)


# --------------------------------------------------------------------------
# forward_train (sp off and on), (data 1, model 2) and (data 2, model 2)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sp", [0, 1])
@pytest.mark.parametrize("name", ALL)
@pytest.mark.parametrize("mesh", ["mesh12", "mesh22"])
def test_forward_train_matches_jax_and_single_process(
        request, jax_run, single, mesh, name, sp):
    """The ranks' vocabulary shards, gathered, equal JAX's
    ``forward_train`` with ``ParallelCtx(model_parallel=2)`` and the
    port's single process within ``REL_L2``; every rank holds the same
    bits."""
    ranks = request.getfixturevalue(mesh)
    got = ranks[0][f"fwd/{name}/sp{sp}"]
    for r in ranks[1:]:
        assert np.array_equal(r[f"fwd/{name}/sp{sp}"], got)
    vocab = cases.cfg_of(name).vocab_size
    assert rel_l2(got, jax_run.get()[f"fwd/{name}"], vocab) <= REL_L2
    assert rel_l2(got, single[f"fwd/{name}"], vocab) <= REL_L2


def test_forward_controls_miss(mesh12, jax_run):
    """hymba's ``w_in`` cut contiguously, and the 25/5 hymba's q heads on
    rank 1 paired with a contiguous run of KV heads (rank 1 starts
    mid-group), each miss JAX's logits by far."""
    out = jax_run.get()
    for key, name in (("ctrl/w_in_cut", "hymba-1.5b"),
                      ("ctrl/kv_slice", cases.NARROW)):
        rel = rel_l2(mesh12[0][key], out[f"fwd/{name}"],
                     cases.cfg_of(name).vocab_size)
        assert rel > 100 * REL_L2, (key, rel)


def test_sequence_parallel_needs_the_input_gather(mesh12):
    """Risk 3: the causal attention of a sequence shard with only K/V
    gathered (queries right-aligned to keys) is right on the last shard
    alone; the port gathers the normed input instead."""
    first, last = (mesh12[r]["ctrl/kv_gather"] for r in (0, 1))
    np.testing.assert_allclose(last[1], last[0], rtol=1e-5, atol=1e-6)
    assert np.abs(first[1] - first[0]).max() > 1e-2


# --------------------------------------------------------------------------
# serving: the flash-decoding cache
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ALL)
@pytest.mark.parametrize("mesh", ["mesh12", "mesh22"])
def test_flash_decoding_matches_heads_layout_and_jax(
        request, jax_run, single, mesh, name):
    """The prefill's and three greedy decode steps' logits over the
    flash-decoding cache (sequence or ring slots over ``model``, every
    head; ``lse_combine`` merging the ranks' partials) equal the port's
    single process (the heads-layout cache) and JAX's within ``REL_L2``;
    every rank holds the same bits."""
    ranks = request.getfixturevalue(mesh)
    vocab = cases.cfg_of(name).vocab_size
    got = ranks[0][f"decode/{name}"]
    for r in ranks[1:]:
        assert np.array_equal(r[f"decode/{name}"], got)
    assert rel_l2(got, single[f"decode/{name}"], vocab) <= REL_L2
    assert rel_l2(got, jax_run.get()[f"decode/{name}"], vocab) <= REL_L2


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("mesh", ["mesh12", "mesh22"])
def test_flash_decoding_merge_equals_heads_layout(request, mesh, window):
    """``lse_combine``'s first caller: one token's attention over the
    ranks' cache slots, merged, equals the softmax over the whole cache
    within ``MERGE_REL_L2``; the partials summed without their weights
    (the control) miss it."""
    for r in request.getfixturevalue(mesh):
        merged, whole, summed = r["merge"][window]
        assert rel_l2(merged, whole) <= MERGE_REL_L2
        assert rel_l2(summed, whole) > 1e-2


def test_unweighted_partials_miss(mesh12, single):
    """The control end to end: the decode partials summed without their
    softmax weights miss the heads-layout decode's logits."""
    vocab = cases.cfg_of("qwen3-8b").vocab_size
    got = mesh12[0]["ctrl/unweighted"][1:]
    assert rel_l2(got, single["decode/qwen3-8b"][1:], vocab) > 1e-2


@pytest.mark.parametrize("name", ALL)
@pytest.mark.parametrize("mesh", ["mesh12", "mesh22"])
def test_served_tokens_equal_single_process_and_jax(request, jax_run,
                                                    single, mesh, name):
    """``ServingEngine(parallel=...)`` on every rank returns the single
    process's greedy tokens and JAX's ``ServingEngine(parallel=
    ParallelCtx(model_parallel=2))``'s, for a ragged batch."""
    ranks = request.getfixturevalue(mesh)
    for r in ranks:
        assert r[f"serve/{name}"] == single[f"serve/{name}"]
    assert single[f"serve/{name}"] == jax_run.get()[f"serve/{name}"]


# --------------------------------------------------------------------------
# world size 1: the sharded path is the plain path, bitwise
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh11(tmp_path_factory):
    """A gloo group of one rank in this process and its (1, 1) mesh."""
    import torch.distributed as dist
    tmesh.init_process_group(str(tmp_path_factory.mktemp("store11")), 0, 1,
                             device_type="cpu")
    try:
        yield tmesh.make_test_mesh((1, 1), device_type="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("sp", [False, True])
@pytest.mark.parametrize("name", ALL)
def test_world_one_equals_plain_bitwise(mesh11, name, sp):
    """At a (1, 1) mesh every collective is issued and returns its input's
    bits: ``forward_train``, the prefill and decode logits over the
    flash-decoding cache and the served tokens equal the plain path's
    (no mesh) bitwise; the plain model with one weight moved by one ulp
    (the control) does not."""
    from repro_torch.models import transformer as tf
    from repro_torch.parallel import collectives as coll
    cfg = cases.cfg_of(name)
    gen = torch.Generator().manual_seed(3)
    sharded = tf.init_params(cfg, gen, device="cpu", parallel=tf.ParallelCtx(
        mesh=mesh11, sp=sp))
    plain = tf.init_params(cfg, torch.Generator().manual_seed(3),
                           device="cpu")
    toks = torch.from_numpy(cases.tokens()).long()
    calls = sum(coll.CALLS.values())
    with torch.no_grad():
        got = tf.forward_train(cfg, sharded, {"tokens": toks})
        want = tf.forward_train(cfg, plain, {"tokens": toks})
        assert sum(coll.CALLS.values()) > calls       # collectives issued
        assert torch.equal(got, want)
        assert np.array_equal(cases._decode_logits(name, sharded, toks),
                              cases._decode_logits(name, plain, toks))
        assert cases._serve(name, sharded) == cases._serve(name, plain)
        w = plain["ln_f"]["scale"]
        w.copy_(torch.nextafter(w, torch.full_like(w, np.inf)))
        ctrl = tf.forward_train(cfg, plain, {"tokens": toks})
    assert not torch.equal(got, ctrl)


def test_parallel_ctx_fields_and_unported_users(mesh11):
    """The port's ``ParallelCtx`` has JAX's fields and defaults; every
    field has its user (the MoE, remat and FSDP fields no longer raise: a
    forward with ``remat=True`` returns the forward's result at either
    policy, and at world size 1 an FSDP model's forward, prefill and
    decode logits are the plain model's bitwise, each of its sharded
    leaves gathered);
    ``kv_cache_dtype`` float8 stores ``torch.float8_e4m3fn``; a chunked
    attention (``attn_chunk_kv``) equals the plain one."""
    from repro.models import transformer as jtf
    from repro_torch.models import transformer as tf
    jf = {f.name: f.default for f in dataclasses.fields(jtf.ParallelCtx)}
    tfields = {f.name: f.default for f in dataclasses.fields(tf.ParallelCtx)}
    assert tfields == jf
    cfg = cases.cfg_of("qwen3-8b")
    model = tf.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    toks = torch.from_numpy(cases.tokens()).long()
    # the MoE fields have their user (they raised before)
    for kw in (dict(use_ep=True), dict(moe_chunk=4)):
        tf.check_ctx(tf.ParallelCtx(**kw))
    tf.check_ctx(tf.ParallelCtx(fsdp=True))
    fsdp = tf.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu", parallel=tf.ParallelCtx(
                              mesh=mesh11, fsdp=True))
    assert fsdp.fsdp_dims and all(fsdp.specs[n][d] == "data"
                                  for n, d in fsdp.fsdp_dims.items())
    with torch.no_grad():
        assert torch.equal(tf.forward_train(cfg, fsdp, {"tokens": toks}),
                           tf.forward_train(cfg, model, {"tokens": toks}))
    assert np.array_equal(cases._decode_logits("qwen3-8b", fsdp, toks),
                          cases._decode_logits("qwen3-8b", model, toks))
    tf.check_ctx(tf.ParallelCtx(remat_policy="nothing"))
    want = tf.forward_hidden(cfg, model, {"tokens": toks})[0]
    for policy in ("dots", "nothing"):
        got = tf.forward_hidden(cfg, model, {"tokens": toks}, remat=True,
                                parallel=tf.ParallelCtx(
                                    remat_policy=policy))[0]
        assert torch.equal(got, want)
    c = tf.make_dense_cache(cfg, 2, 8, device="cpu",
                            parallel=tf.ParallelCtx(
                                kv_cache_dtype="float8_e4m3fn"))
    assert c[0].dtype == torch.float8_e4m3fn and c[0].shape[2] == 8
    chunked = tf.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu",
                             parallel=tf.ParallelCtx(attn_chunk_kv=5))
    with torch.no_grad():
        a = tf.forward_train(cfg, chunked, {"tokens": toks})
        b = tf.forward_train(cfg, model, {"tokens": toks})
    assert rel_l2(a.numpy(), b.numpy()) <= 1e-6


def test_chunked_attention_matches_jax():
    """``ref.attention_chunked`` against JAX's ``attention_chunked`` on the
    same inputs: causal GQA, a window, a key count the chunk does not
    divide (f32, 1e-6)."""
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 4, 13, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, 2, 13, 8)).astype(np.float32)
            for _ in range(2))
    for kw in (dict(causal=True), dict(causal=True, window=4),
               dict(causal=False)):
        # the plain reference's tile is the subject under test, so the
        # literal is intentional  # reprolint: disable=RL010
        want = np.asarray(jref.attention_chunked(
            *(jnp.asarray(t) for t in (q, k, v)), chunk=5, **kw))
        # reprolint: disable=RL010
        got = ref.attention_chunked(*(torch.from_numpy(t) for t in (q, k, v)),
                                    chunk=5, **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
