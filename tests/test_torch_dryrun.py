"""The port's dry run (``repro_torch.launch.{specs,dryrun,dryrun_all}``),
its roofline twin (``repro_torch.benchmarks.roofline``), the lint marker
(``repro_torch.analysis.markers``) and the chunked prefill MLP (ROADMAP
C25), against the JAX package.

One port subprocess runs every dry-run cell of this module (the fake
process group is process-wide): the per-rank bytes of reduced configs on
a fake (2, 4) mesh with and without FSDP, a reduced dense LM's train cell
at (1, 1) under both remat policies and at (2, 4), the reduced DiT's
``sample`` cell at (2, 4) and three cut CLI cells.  One JAX subprocess
with 8 fake devices sums JAX's ``NamedSharding.shard_shape`` bytes of the
same configs, with no compile.  The specs are compared in this process
(``jax.eval_shape``, no lowering).  Everything is exact but the chunked
MLP (1e-6 relative in f32, bf16's 2e-2).
"""
import math
import os
import pickle
import subprocess
import sys

import pytest
import torch

import torch_dryrun_cases as cases
from conftest import REPO

pytestmark = pytest.mark.distributed

PORT_CODE = r"""
import pickle
import sys
import dataclasses
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
import torch_dryrun_cases as T

out = {}
b, s = T.BYTES_SHAPE
cell = ShapeConfig("cell", s, b, "train")
for arch in T.BYTES_ARCHS:
    cfg = T.bytes_cfg(get_arch, arch)
    for fsdp in (False, True):
        r = dryrun.dry_run(cfg, "cell", cell, "2x4", {"fsdp": fsdp})
        out[("bytes", arch, fsdp)] = r["resident_bytes"]
b, s = T.FLOP_SHAPE
cell = ShapeConfig("cell", s, b, "train")
cfg = T.flop_cfg(get_arch)
for mesh, policy in (("1x1", "dots"), ("1x1", "nothing"), ("2x4", "dots")):
    r = dryrun.dry_run(cfg, "cell", cell, mesh, {"remat_policy": policy})
    out[("flops", mesh, policy)] = r
out["sample"] = dryrun.dry_run(T.sample_cfg(), "sample", None, "2x4",
                               sample_blocks=4)
cli = sys.argv[2]
for args in (["--arch", "qwen3-8b", "--shape", "train_4k"],
             ["--arch", "qwen3-8b", "--shape", "train_4k", "--override",
              "fsdp=True", "--tag", "fsdp"],
             ["--arch", "srds-dit-sd2", "--shape", "sample"]):
    dryrun.main(args + ["--mesh", "pod1", "--out", cli] + T.CLI_CUT)
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
print("PORT DRYRUN OK")
"""

JAX_CODE = r"""
import pickle
import sys
import math
import jax
from repro.compat import make_mesh
from repro.configs import get_arch
from repro.launch import specs as sp
from repro.models.transformer import ParallelCtx
from repro.optim.adamw import init_opt_state
from repro.parallel.sharding import opt_state_shardings, param_shardings
import torch_dryrun_cases as T

assert len(jax.devices()) == 8
mesh = make_mesh((2, 4), ("data", "model"))


def nbytes(specs, shardings):
    leaves = jax.tree.leaves(specs)
    shs = jax.tree.leaves(shardings,
                          is_leaf=lambda x: hasattr(x, "shard_shape"))
    return sum(math.prod(s.shard_shape(x.shape)) * x.dtype.itemsize
               for x, s in zip(leaves, shs))


out = {}
for arch in T.BYTES_ARCHS:
    cfg = T.bytes_cfg(get_arch, arch)
    for fsdp in (False, True):
        par = ParallelCtx(mesh=mesh, batch_axes=("data",),
                          model_axis="model", data_axis="data",
                          use_ep=cfg.moe_experts > 0, sp=True,
                          model_parallel=4, moe_chunk=8_192, fsdp=fsdp)
        p = sp.param_specs(cfg, par)
        o = jax.eval_shape(init_opt_state, p)
        out[(arch, fsdp)] = dict(
            params=nbytes(p, param_shardings(cfg, mesh, p, par, fsdp=fsdp)),
            opt=nbytes(o, opt_state_shardings(cfg, mesh, o, par)))
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
print("JAX BYTES OK")
"""


def _env(devices=None):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(REPO, "src"), os.path.join(REPO, "tests")]))
    if devices:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    return env


class _Sub:
    def __init__(self, code, args, dst, devices=None):
        self.dst = dst
        self.proc = subprocess.Popen([sys.executable, "-c", code, *args],
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True,
                                     env=_env(devices), cwd=str(REPO))
        self.out = None

    def get(self):
        if self.out is None:
            out, err = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0, f"stdout={out}\nstderr={err}"
            with open(self.dst, "rb") as f:
                self.out = pickle.load(f)
        return self.out

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


@pytest.fixture(scope="module")
def cli_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("dryrun_cli"))


@pytest.fixture(scope="module")
def port(tmp_path_factory, cli_dir):
    dst = str(tmp_path_factory.mktemp("dryrun_port") / "out.pkl")
    run = _Sub(PORT_CODE, [dst, cli_dir], dst)
    yield run
    run.close()


@pytest.fixture(scope="module")
def jax_bytes(tmp_path_factory, port):
    dst = str(tmp_path_factory.mktemp("dryrun_jax") / "out.pkl")
    run = _Sub(JAX_CODE, [dst], dst, devices=8)
    yield run
    run.close()


# --------------------------------------------------------------------------
# specs, cells and --list against JAX
# --------------------------------------------------------------------------

def _jax_arch_names():
    from repro.configs import arch_names
    return arch_names()


def _flat(tree):
    """A spec tree's leaves as ``(shape, dtype name)``, with its keys
    (dict keys, or a NamedTuple's fields, or positions)."""
    if isinstance(tree, dict):
        return {k: _flat(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        keys = getattr(tree, "_fields", range(len(tree)))
        return {k: _flat(v) for k, v in zip(keys, tree)}
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


def _jflat(tree):
    if isinstance(tree, dict):
        return {k: _jflat(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        keys = getattr(tree, "_fields", range(len(tree)))
        return {k: _jflat(v) for k, v in zip(keys, tree)}
    return (tuple(tree.shape), str(tree.dtype))


@pytest.mark.parametrize("arch", _jax_arch_names())
def test_specs_equal_jax(arch):
    """For every shape cell of ``arch`` (its ``sample`` cell for a DiT),
    the port's ``batch_specs``, ``cache_specs`` and ``input_specs`` have
    JAX's keys, shapes and dtypes, at JAX's dry-run padding
    (``model_parallel`` 16), and ``param_specs`` hold JAX's element
    total."""
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_arch as jget, shape_cells as jcells
    from repro.launch import specs as jsp
    from repro.models.transformer import ParallelCtx as JCtx
    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.launch import specs as sp
    from repro_torch.models.transformer import ParallelCtx
    jcfg, cfg = jget(arch), get_arch(arch)
    jpar, par = JCtx(model_parallel=16), ParallelCtx(model_parallel=16)
    jp = jsp.param_specs(jcfg, jpar)
    p = sp.param_specs(cfg, par)
    assert sum(math.prod(x.shape) for x in p.values()) == sum(
        math.prod(x.shape) for x in __import__("jax").tree.leaves(jp))
    assert all(t.device.type == "meta" for t in p.values())
    shapes = (["train_4k"] if cfg.family == "dit"
              else [s.name for s in jcells(jcfg)])
    for name in shapes:
        got = _flat(sp.batch_specs(cfg, SHAPES[name]))
        assert got == _jflat(jsp.batch_specs(jcfg, JSHAPES[name])), name
        if cfg.family == "dit":
            continue
        got = _flat(sp.input_specs(cfg, SHAPES[name], par))
        want = _jflat(jsp.input_specs(jcfg, JSHAPES[name], jpar))
        assert got == want, name
        got = _flat(sp.cache_specs(cfg, SHAPES[name], par))
        assert got == _jflat(jsp.cache_specs(jcfg, JSHAPES[name], jpar))


def test_cells_and_list_equal_jax():
    """``dryrun_all.all_cells`` over both meshes, its ``ASSIGNED`` and
    ``DIT`` lists, and ``python -m repro_torch.launch.dryrun --list``'s
    output equal the JAX package's."""
    from repro.launch import dryrun_all as jall
    from repro_torch.launch import dryrun_all
    assert dryrun_all.all_cells(["pod1", "pod2"]) == jall.all_cells(
        ["pod1", "pod2"])
    assert (dryrun_all.ASSIGNED, dryrun_all.DIT) == (jall.ASSIGNED,
                                                     jall.DIT)
    outs = []
    for mod in ("repro_torch.launch.dryrun", "repro.launch.dryrun"):
        r = subprocess.run([sys.executable, "-m", mod, "--list"],
                           capture_output=True, text=True, env=_env(),
                           timeout=300, cwd=str(REPO))
        assert r.returncode == 0, r.stderr
        outs.append(r.stdout)
    assert outs[0] == outs[1] and outs[0].count("\n") == len(
        _jax_arch_names())


# --------------------------------------------------------------------------
# the dry run's counts
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("arch", cases.BYTES_ARCHS)
def test_rank_bytes_equal_jax_shardings(port, jax_bytes, arch, fsdp):
    """Rank 0's parameter and optimizer-state bytes of a reduced bf16
    config on a (2, 4) mesh equal the sum over JAX's ``param_shardings`` / ``opt_state_shardings``
    of ``shard_shape`` x itemsize (FSDP: the parameters shrink, the
    moments do not: ZeRO-1 already split them)."""
    got = port.get()[("bytes", arch, fsdp)]
    want = jax_bytes.get()[(arch, fsdp)]
    assert got["param_bytes"] == want["params"]
    assert got["opt_bytes"] == want["opt"]
    if fsdp:
        plain = port.get()[("bytes", arch, False)]
        assert got["param_bytes"] < plain["param_bytes"]
        assert got["opt_bytes"] == plain["opt_bytes"]


def spelled_flops(cfg, b, s, policy):
    """The train cell's matrix-product FLOPs from the config: the
    projections, the SwiGLU MLP and attention's two products per layer,
    the unembedding over the ``s - 1`` predicting positions; the backward
    (autograd of the plain path, ``use_kernel=False``) twice each
    product; rematerialization adds the layers' forward
    again: attention's products under ``"dots"`` (the projections are
    kept), everything under ``"nothing"`` but the layer's last product,
    the MLP's down projection, whose output no op saves (the
    non-reentrant checkpoint stops its recompute once every saved tensor
    is back: ``torch.utils.checkpoint``'s early stop)."""
    d, ff, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    t = b * s
    proj = 2 * t * d * (hq * hd) * 2 + 2 * t * d * (hkv * hd) * 2
    mlp = 3 * 2 * t * d * ff
    attn = 2 * b * hq * s * s * hd
    layer_fwd = proj + mlp + 2 * attn
    layer_bwd = 2 * (proj + mlp + 2 * attn)
    unembed = 2 * b * (s - 1) * d * cfg.vocab_size
    recompute = 2 * attn if policy == "dots" else layer_fwd - 2 * t * ff * d
    return (cfg.num_layers * (layer_fwd + layer_bwd + recompute)
            + 3 * unembed)


@pytest.mark.parametrize("policy", ["dots", "nothing"])
def test_train_flops_equal_the_config(port, policy):
    """At (1, 1) the train cell counts exactly :func:`spelled_flops`; on
    (2, 4) eight times rank 0's count is the (1, 1) count (heads, ``d_ff``
    and vocabulary divide); ``model_flops_global`` is JAX's formula."""
    from repro.configs import get_arch as jget
    from repro_torch.configs import get_arch
    cfg = cases.flop_cfg(get_arch)
    b, s = cases.FLOP_SHAPE
    one = port.get()[("flops", "1x1", policy)]
    assert one["flops_per_device"] == spelled_flops(cfg, b, s, policy)
    if policy == "dots":
        eight = port.get()[("flops", "2x4", "dots")]
        assert 8 * eight["flops_per_device"] == one["flops_per_device"]
        assert eight["devices"] == 8 and eight["mesh"] == "2x4"
    jcfg = cases.flop_cfg(jget)
    assert one["roofline"]["model_flops_global"] == \
        6 * jcfg.active_param_count() * b * s
    r = one["roofline"]
    assert r["dominant"] == max(("compute_s", "memory_s", "collective_s"),
                                key=r.get)


def test_sample_cell_has_block_traffic(port):
    """The DiT's ``sample`` cell on (2, 4) with 4 Parareal blocks moves
    blocks between their owners (all-gathers or permutes; JAX's
    test_dryrun_srds_sample_cell), and its patch rows over ``model``
    (the K/V all-gathers)."""
    r = port.get()["sample"]
    c = r["collectives"]
    assert c["collective-permute"]["count"] > 0 or \
        c["all-gather"]["count"] > 0
    assert r["sample_form"] == "tp" and r["flops_per_device"] > 0
    assert r["roofline"]["model_flops_global"] is None


def test_cli_cells_write_jax_keys_and_the_roofline_reads_them(port,
                                                              cli_dir):
    """The CLI's qwen3-8b train cell on pod1 (plain and
    ``--override fsdp=True``) and srds-dit-sd2's sample cell (depth, batch
    and sequence cut) write JAX's keys with H100 roofline terms; the
    port's roofline twin and the JAX package's format the same rows and
    write the same table."""
    sys.path.insert(0, str(REPO))
    try:
        from benchmarks import roofline as jroof
    finally:
        sys.path.remove(str(REPO))
    from repro_torch.benchmarks import roofline
    from repro_torch.launch import mesh
    port.get()
    names = sorted(os.listdir(cli_dir))
    assert names == ["qwen3-8b__train_4k__pod1.json",
                     "qwen3-8b__train_4k__pod1__fsdp.json",
                     "srds-dit-sd2__sample__pod1.json"]
    keys = {"arch", "shape", "mesh", "devices", "flops_per_device",
            "bytes_accessed_per_device", "memory_analysis", "collectives",
            "collective_bytes_per_device", "roofline", "compile_s", "tag"}
    cells = roofline.load_cells(cli_dir)
    assert cells == jroof.load_cells(cli_dir)
    for c in cells:
        assert keys <= set(c)
        assert c["devices"] == 256 and c["mesh"] == "16x16"
        assert set(c["memory_analysis"]) == {
            "argument_bytes", "output_bytes", "temp_bytes",
            "generated_code_bytes"}
        assert set(c["collectives"]) == {
            "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
            "collective-permute"}
        r = c["roofline"]
        assert r["compute_s"] == c["flops_per_device"] / mesh.PEAK_FLOPS_BF16
        assert r["memory_s"] == \
            c["bytes_accessed_per_device"] / mesh.HBM_BW
        assert r["collective_s"] == \
            c["collective_bytes_per_device"] / mesh.NVLINK_BW
        assert roofline.fmt_row(c) == jroof.fmt_row(c)
    plain, fsdp = cells[0], cells[1]
    assert fsdp["memory_analysis"]["argument_bytes"] < \
        plain["memory_analysis"]["argument_bytes"]
    assert fsdp["collectives"]["reduce-scatter"]["count"] > \
        plain["collectives"]["reduce-scatter"]["count"]
    md = [os.path.join(cli_dir, f"{k}.md") for k in ("port", "jax")]
    roofline.main(["--dir", cli_dir, "--md", md[0]])
    argv = sys.argv
    sys.argv = ["roofline", "--dir", cli_dir, "--md", md[1]]
    try:
        jroof.main()
    finally:
        sys.argv = argv
    with open(md[0]) as a, open(md[1]) as b:
        assert a.read() == b.read()
    for p in md:
        os.remove(p)


def test_production_meshes_on_a_fake_group():
    """pod1 and pod2 at rank 0 of a fake group of 256 and 512 ranks (in a
    subprocess: the group is process-wide): JAX's shapes and dim names,
    the (pod, data) batch axes on two pods."""
    code = ("from repro_torch.launch import dryrun\n"
            "from repro_torch.configs import get_arch\n"
            "for name, shape in (('pod1', (16, 16)), ('pod2', (2, 16, 16))):\n"
            "    with dryrun.fake_mesh(name) as mesh:\n"
            "        assert tuple(mesh.mesh.shape) == shape\n"
            "        par = dryrun.build_parallel(get_arch('arctic-480b'), mesh)\n"
            "        assert par.model_parallel == 16 and par.use_ep and par.sp\n"
            "        assert par.batch_axes == (('pod', 'data') if name == 'pod2'"
            " else ('data',))\n"
            "print('MESH OK')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=_env(), timeout=300, cwd=str(REPO))
    assert r.returncode == 0 and "MESH OK" in r.stdout, r.stderr


# --------------------------------------------------------------------------
# the marker and the chunked MLP
# --------------------------------------------------------------------------

def test_hot_loop_marker_and_rl003(tmp_path):
    """``markers.hot_loop`` sets ``__reprolint_hot_loop__`` and returns the
    function; a file that imports it from
    ``repro_torch.analysis.markers`` and reads a tensor with ``.item()``
    inside the marked body is flagged by RL003, the same body unmarked
    is not; the serving loop's bodies carry the marker."""
    from repro_torch.analysis import lint_paths, markers
    from repro_torch.serve import diffusion

    def f():
        return 1

    assert markers.hot_loop(f) is f and f.__reprolint_hot_loop__
    assert diffusion.hot_loop is markers.hot_loop
    body = ("    def step(self, tok):\n"
            "        resid = torch.stack(tok.parts)\n"
            "        return resid.max().item()\n")
    d = tmp_path / "src" / "repro_torch" / "serve"
    d.mkdir(parents=True)
    marked = d / "marked.py"
    marked.write_text("import torch\n"
                      "from repro_torch.analysis.markers import hot_loop\n"
                      "class E:\n    @hot_loop\n" + body)
    plain = d / "plain.py"
    plain.write_text("import torch\nclass E:\n" + body)
    rules = {str(p): {f.code for f in lint_paths(
        [str(p)], root=str(tmp_path)).findings} for p in (marked, plain)}
    assert rules == {str(marked): {"RL003"}, str(plain): set()}


def _count_mm(fn):
    from torch.utils._python_dispatch import TorchDispatchMode
    n = [0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.mm.default:
                n[0] += 1
            return func(*args, **(kwargs or {}))

    with Count():
        out = fn()
    return out, n[0]


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-6),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_chunked_mlp_equals_the_whole_batch(monkeypatch, act, dtype, rtol):
    """C25: without a gradient the MLP runs its rows in chunks of
    ``MLP_CHUNK_ROWS`` (here 7: 3 x 10 rows give chunks of 7, 7, 7, 7
    and a ragged 2) into one output, equal to the whole batch's within
    ``rtol`` (relative to the largest output); with a gradient recorded
    the whole batch runs (3 or 2 products, not 5 times as many)."""
    from repro_torch.models import layers
    g = torch.Generator().manual_seed(0)
    d, ff = 16, 40
    p = {"w_up": torch.randn(d, ff, generator=g).to(dtype),
         "w_down": torch.randn(ff, d, generator=g).to(dtype)}
    if act == "swiglu":
        p["w_gate"] = torch.randn(d, ff, generator=g).to(dtype)
    x = torch.randn(3, 10, d, generator=g).to(dtype)
    whole, n_whole = _count_mm(lambda: layers.apply_mlp(p, x, act))
    monkeypatch.setattr(layers, "MLP_CHUNK_ROWS", 7)
    with torch.no_grad():
        got, n_chunked = _count_mm(lambda: layers.apply_mlp(p, x, act))
    per = len(p)
    assert n_whole == per and n_chunked == 5 * per
    assert got.shape == whole.shape and got.dtype == whole.dtype
    err = float((got.float() - whole.float()).abs().max())
    assert err <= rtol * float(whole.float().abs().max())
    xg = x.clone().requires_grad_(True)
    out, n_grad = _count_mm(lambda: layers.apply_mlp(p, xg, act))
    assert n_grad == per and out.grad_fn is not None
