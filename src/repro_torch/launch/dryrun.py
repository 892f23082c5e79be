"""The dry run (counterpart of ``repro.launch.dryrun``): one rank of the
production mesh runs one step of a cell on meta tensors, in one process,
and writes what it would cost on an H100.

    python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k --mesh pod1
    python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k --mesh pod1 --override fsdp=True
    python -m repro_torch.launch.dryrun --arch srds-dit-sd2 --shape sample --mesh pod1
    python -m repro_torch.launch.dryrun --list

It writes ``<out>/<arch>__<shape>__<mesh>[__<tag>].json`` with JAX's keys,
so either package's roofline table reads either file.

How.  A fake process group (``torch.testing._internal.distributed.
fake_pg``, backend ``"fake"``) at rank 0 of the mesh's world size stands
in for the cluster: :func:`repro_torch.launch.mesh.make_production_mesh`'s
``DeviceMesh`` of ``(data 16, model 16)`` (``pod1``) or ``(pod 2, data 16,
model 16)`` (``pod2``) is built over it, and every collective returns at
once.  Parameters, moments, inputs and caches are tensors on the
``meta`` device (:data:`TRACE_DEVICE`: shapes and dtypes, no memory),
this rank's parts by the port's sharding rules, so no value is ever read
on the host.  Every cell runs ``use_kernel=False`` (as JAX lowers), the
plain path, whose ops are the same on the card's tensors.  (Not
``FakeTensorMode`` on fake CUDA tensors: autograd aborts on one in a
CPU-only build, and a fake op dispatches about four times slower than a
meta one.)  The cell is the port's
own entry point: a train cell one ``make_train_step(..., remat=True)``
step (forward, backward, AdamW), prefill :func:`transformer.prefill`,
decode one :func:`transformer.decode_step` on a full cache, and a DiT's
``sample`` cell the block-sharded SRDS sampler
(:func:`repro_torch.core.pipelined.make_sharded_sampler`, the Parareal
blocks over ``data``) over the patch-sharded DiT (over ``model``) at
JAX's sizes, ``fixed_iters`` so no value steers the loop.

What it counts, one rank's, over the whole cell (:class:`CostLedger`, one
``TorchDispatchMode`` under ``FlopCounterMode``):

* ``flops_per_device``: ``FlopCounterMode``'s total, the matrix products
  (``mm``, ``addmm``, ``bmm``, ``baddbmm``, convolutions, attention ops),
  forward, backward and the recompute of a rematerialized layer.  XLA's
  cost analysis also counts elementwise work; this count does not, and
  it counts no FLOP for ``torch._grouped_mm`` (the MoE experts), which
  has no formula there.
* ``bytes_accessed_per_device``: every dispatched op's input and output
  bytes, summed (views and allocations excluded): an unfused upper bound,
  where XLA's counts a fused program.
* ``memory_analysis``: ``argument_bytes`` the storages resident before the
  cell (parameters, moments, inputs, cache), ``temp_bytes`` the peak of
  every other storage alive at once (a storage from its op's output to
  its last reference; each rounded up to the CUDA caching allocator's
  512-byte block), ``output_bytes`` the returned tensors' new storages,
  ``generated_code_bytes`` None.
* ``collectives``: by JAX's kind, the count and the output bytes (JAX's
  approximation) of every ``c10d`` op dispatched on the rank, whichever
  code issued it; a ``recv`` is one ``collective-permute`` (its ``send``
  pair is not counted again).
* ``roofline``: the three terms at H100 constants
  (:data:`repro_torch.launch.mesh.PEAK_FLOPS_BF16`, ``HBM_BW``,
  ``NVLINK_BW``: every byte at NVLink's rate, a lower bound for a
  collective across nodes), the dominant one, ``model_flops_global``
  (6, or 2 outside training, x ``active_param_count`` x tokens) and
  ``useful_fraction``.
* ``compile_s``: the seconds the cell's trace took.  JAX lowers a scanned
  layer stack, whose body XLA counts once, and extrapolates from two
  unrolled probes at 1 and 2 layers; the port has no scan and counts
  every layer, so it has no probes.

The ``sample`` cell of ``srds-dit-cifar`` runs JAX's no-TP form (the
denoiser whole on every rank, a batch of 16 over ``data`` x ``model``):
its 32 image rows do not split over 16 model ranks at patch 4.
``--override model_axis=None`` asks for that form on any DiT.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import weakref
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import SHAPES, get_arch, shape_cells
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import (HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16,
                                     make_production_mesh, make_test_mesh,
                                     production_shape)
from repro_torch.models.transformer import ParallelCtx

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# the c10d ops by JAX's collective kind (``send`` is counted by its recv)
C10D_KINDS = {"allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
              "_allgather_base_": "all-gather", "allgather_": "all-gather",
              "allgather_into_tensor_coalesced_": "all-gather",
              "_reduce_scatter_base_": "reduce-scatter",
              "reduce_scatter_": "reduce-scatter",
              "reduce_scatter_tensor_coalesced_": "reduce-scatter",
              "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
              "recv_": "collective-permute"}
BLOCK = 512                    # the CUDA caching allocator's smallest block
# the sample cell's sizes (JAX's)
SAMPLE_BLOCKS = 16
DEFAULT_OUT = "experiments/dryrun_torch"
# the traced tensors' device: shapes and dtypes, no memory (module docstring)
TRACE_DEVICE = torch.device("meta")


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _rounded(n: int) -> int:
    return -(-n // BLOCK) * BLOCK


class CostLedger(TorchDispatchMode):
    """Counts, for every op dispatched while it is on: the bytes the op
    reads and writes, each ``c10d`` collective by kind (count and output
    bytes), and the storages alive (each from its op to its last
    reference).  :meth:`resident` marks the storages that were there
    before (the arguments).  Works on real and on meta tensors."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.collectives = {c: {"count": 0, "bytes": 0.0}
                            for c in COLLECTIVES}
        self.live = weakref.WeakKeyDictionary()   # storage -> (bytes, arg)
        self.arg_bytes = 0
        self.temp = 0
        self.temp_peak = 0

    def _track(self, t: torch.Tensor, arg: bool) -> None:
        st = t.untyped_storage()
        if st in self.live:
            return
        n = _rounded(st.nbytes())
        self.live[st] = (n, arg)
        if arg:
            self.arg_bytes += n
        else:
            self.temp += n
            self.temp_peak = max(self.temp_peak, self.temp)
        weakref.finalize(st, self._release, n, arg)

    def _release(self, n: int, arg: bool) -> None:
        if arg:
            self.arg_bytes -= n
        else:
            self.temp -= n

    def resident(self, *trees) -> int:
        """Mark every tensor of ``trees`` as an argument; returns the
        bytes of their storages not marked before (exact, not rounded)."""
        n = 0
        for t in _tensors(trees):
            if t.untyped_storage() not in self.live:
                n += t.untyped_storage().nbytes()
            self._track(t, True)
        return n

    def new_bytes(self, tree) -> int:
        """The bytes of ``tree``'s storages that are not arguments."""
        seen, n = set(), 0
        for t in _tensors(tree):
            st = t.untyped_storage()
            key = id(st)
            if key in seen or self.live.get(st, (0, False))[1]:
                continue
            seen.add(key)
            n += _rounded(st.nbytes())
        return n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "c10d":
            kind = C10D_KINDS.get(func._opname)
            if kind is not None:
                c = self.collectives[kind]
                c["count"] += 1
                c["bytes"] += float(sum(_nbytes(t)
                                        for t in _tensors(args[0])))
            return out
        name = func._opname
        if func.is_view or name.startswith(("empty", "new_empty")) \
                or name in ("detach", "alias", "lift_fresh"):
            for t in _tensors(out):
                self._track(t, False)
            return out
        outs = _tensors(out)
        self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
        self.bytes += sum(_nbytes(t) for t in outs)
        for t in outs:
            self._track(t, False)
        return out


# --------------------------------------------------------------------------
# the mesh
# --------------------------------------------------------------------------

def mesh_spec(mesh_name: str):
    """``(shape, dim names)`` of ``pod1``, ``pod2`` or a small ``DxM``
    (``data`` x ``model``, e.g. ``2x4``)."""
    if mesh_name in ("pod1", "pod2"):
        return production_shape(multi_pod=mesh_name == "pod2")
    d, m = (int(v) for v in mesh_name.split("x"))
    return (d, m), ("data", "model")


@contextlib.contextmanager
def fake_mesh(mesh_name: str):
    """The mesh ``mesh_name`` at rank 0 of a fake process group of its
    size (the default group for the duration; none may be running)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape, axes = mesh_spec(mesh_name)
    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake process group: "
                           "another default group is running")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        # the tensors are meta: the mesh's device type touches no card
        if mesh_name in ("pod1", "pod2"):
            yield make_production_mesh(multi_pod=mesh_name == "pod2",
                                       device_type="cpu")
        else:
            yield make_test_mesh(shape, axes, device_type="cpu")
    finally:
        dist.destroy_process_group()


def build_parallel(cfg: ArchConfig, mesh) -> ParallelCtx:
    """JAX's ``build_parallel``: batch over ``("pod", "data")`` on two
    pods, expert parallelism for MoE, ``sp``, the mesh's model-parallel
    degree, MoE chunks of 8192 tokens."""
    names = tuple(mesh.mesh_dim_names)
    return ParallelCtx(
        mesh=mesh,
        batch_axes=("pod", "data") if "pod" in names else ("data",),
        model_axis="model", data_axis="data",
        use_ep=cfg.moe_experts > 0, sp=True,
        model_parallel=dict(zip(names, mesh.mesh.shape))["model"],
        moe_chunk=8_192)


def parse_override(text: str):
    """``k=v`` as JAX's CLI parses it: ``True``/``False``/``None``, an
    integer, else the string."""
    k, v = text.split("=")
    if v in ("True", "False", "None"):
        return k, {"True": True, "False": False, "None": None}[v]
    return k, int(v) if v.isdigit() else v


def train_step_for(cfg: ArchConfig, par: ParallelCtx):
    """The train cell's step: JAX's optimizer (warm-up cosine from 3e-4
    over 100 / 10,000 steps), ``remat=True`` and ``use_kernel=False``."""
    from repro_torch.optim import AdamWConfig, warmup_cosine
    from repro_torch.train import make_train_step
    opt_cfg = AdamWConfig(schedule=warmup_cosine(3e-4, 100, 10_000),
                          bf16_grad_sync=par.bf16_grad_sync)
    return make_train_step(cfg, opt_cfg, parallel=par, remat=True,
                           loss_kind="lm", use_kernel=False)


# --------------------------------------------------------------------------
# the cells
# --------------------------------------------------------------------------

def _local_batch(cfg, shape, par, dev):
    """This rank's rows of the cell's batch, zeros on ``dev``."""
    from repro_torch.parallel.sharding import _axes_size, batch_shardings
    b_specs = sp.batch_specs(cfg, shape)
    specs = batch_shardings(par.mesh, b_specs, par.batch_axes)
    n = _axes_size(par.mesh, par.batch_axes)
    out = {}
    for k, t in b_specs.items():
        rows = t.shape[0] // n if specs[k][0] is not None else t.shape[0]
        out[k] = torch.zeros((rows,) + tuple(t.shape[1:]), dtype=t.dtype,
                             device=dev)
    return out


def _on_device(tree, dev):
    """A meta tree's tensors as zeros on ``dev``."""
    if isinstance(tree, torch.Tensor):
        return torch.zeros(tree.shape, dtype=tree.dtype, device=dev)
    if isinstance(tree, tuple):
        parts = [_on_device(t, dev) for t in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") \
            else tuple(parts)
    raise TypeError(type(tree))


def _measure(ledger: CostLedger, res: dict, fn, outputs=None) -> dict:
    """``fn()`` under ``ledger`` and ``FlopCounterMode``: ``res`` with the
    counts, the trace's seconds and the bytes of the new storages among
    ``fn``'s outputs (``outputs(out)`` picks them)."""
    from torch.utils.flop_counter import FlopCounterMode
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc, ledger:
        out = fn()
    res.update(trace_s=time.perf_counter() - t0,
               flops=float(fc.get_total_flops()), ledger=ledger,
               output_bytes=ledger.new_bytes(
                   out if outputs is None else outputs(out)),
               argument_bytes=ledger.arg_bytes)
    return res


def trace_cell(cfg: ArchConfig, shape: Optional[ShapeConfig], par:
               ParallelCtx, dev, *,
               sample_blocks: int = SAMPLE_BLOCKS) -> dict:
    """Run one cell on this rank, its tensors made on ``dev`` (zeros),
    under a :class:`CostLedger` and ``FlopCounterMode``: on ``meta`` (the
    dry run), or on real tensors of a real group (a test's yardstick).
    Returns the raw counts."""
    from repro_torch.models import transformer as tf
    ledger = CostLedger()
    if shape is None:
        return _trace_sample(cfg, par, ledger, dev, sample_blocks)
    model = tf.TransformerLM(cfg, device=dev,
                             trainable=shape.kind == "train", parallel=par)
    params = dict(model.named_parameters())
    res = {"param_bytes": ledger.resident(params)}
    batch = _local_batch(cfg, shape, par, dev)
    if shape.kind == "train":
        from repro_torch.optim import init_opt_state
        from repro_torch.train.steps import zero1_slices
        opt = init_opt_state(params, zero1=zero1_slices(model))
        res["opt_bytes"] = ledger.resident(opt)
        res["input_bytes"] = ledger.resident(batch)
        step = train_step_for(cfg, par)
        return _measure(ledger, res, lambda: step(model, opt, batch)[2])
    if shape.kind == "prefill":
        res["input_bytes"] = ledger.resident(batch)
        return _measure(ledger, res, lambda: tf.prefill(
            cfg, model, batch, parallel=par, use_kernel=False))
    cache = _on_device(sp.cache_specs(cfg, shape, par), dev)
    res["input_bytes"] = ledger.resident(batch, cache)
    return _measure(ledger, res, lambda: tf.decode_step(
        cfg, model, batch, cache, shape.seq_len - 1, parallel=par,
        use_kernel=False))


def _trace_sample(cfg, par, ledger, dev, num_blocks) -> dict:
    """The DiT's ``sample`` cell (module docstring): JAX's batch 8 (16 in
    the no-TP form), ``ddpm_linear`` over ``num_blocks**2`` steps, DDIM,
    tol 1e-3, 4 refinements with ``fixed_iters``."""
    from repro_torch.core import SolverConfig, SRDSConfig, make_schedule
    from repro_torch.core.pipelined import make_sharded_sampler
    from repro_torch.models.dit import DiT, make_denoiser
    mesh = par.mesh
    size = sp.dit_image_size(cfg)
    m = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))["model"]
    tp = par.model_axis is not None and (size // m) % cfg.patch_size == 0
    model = DiT(cfg, device=dev)
    res = {"param_bytes": ledger.resident(dict(model.named_parameters())),
           "sample_form": "tp" if tp else "no-tp"}
    if tp:
        den = make_denoiser(model, shard_axis="model", mesh=mesh,
                            use_kernel=False)
        batch, data_axis = 8, None
    else:
        den = make_denoiser(model, use_kernel=False)
        batch, data_axis = 16, "model"
    sched = make_schedule("ddpm_linear", num_blocks * num_blocks)
    scfg = SRDSConfig(tol=1e-3, num_blocks=num_blocks, max_iters=4,
                      fixed_iters=True, use_fused_update=False,
                      per_sample=data_axis is not None)
    sampler = make_sharded_sampler(
        mesh, "data", den, sched, SolverConfig("ddim",
                                               use_fused_kernel=False),
        scfg, data_axis=data_axis)
    x0 = torch.zeros((batch, size, size, cfg.in_channels),
                     dtype=torch.float32, device=dev)
    res["input_bytes"] = ledger.resident(x0)
    return _measure(ledger, res, lambda: sampler(x0),
                    lambda out: (out.sample, out.iterations))


def roofline_terms(flops: float, nbytes: float, coll_bytes: float) -> dict:
    terms = {"compute_s": flops / PEAK_FLOPS_BF16,
             "memory_s": nbytes / HBM_BW,
             "collective_s": coll_bytes / NVLINK_BW}
    return dict(terms, dominant=max(terms, key=terms.get))


def analyze(cfg: ArchConfig, shape_name: str, shape: Optional[ShapeConfig],
            mesh, trace: dict) -> dict:
    """JAX's result dict from :func:`trace_cell`'s counts."""
    n_dev = mesh.mesh.numel()
    led = trace["ledger"]
    flops = trace["flops"]
    coll = {k: dict(v) for k, v in led.collectives.items()}
    coll_bytes = sum(v["bytes"] for v in coll.values())
    if shape is not None:
        tokens = shape.global_batch * (1 if shape.is_decode
                                       else shape.seq_len)
        mult = 6 if shape.kind == "train" else 2
        model_flops = mult * cfg.active_param_count() * tokens
    else:
        model_flops = None
    resident = {k: trace[k] for k in ("param_bytes", "opt_bytes",
                                      "input_bytes") if k in trace}
    out = {
        "arch": cfg.name, "shape": shape_name,
        "mesh": "x".join(str(s) for s in mesh.mesh.shape),
        "devices": n_dev,
        "flops_per_device": flops,
        "bytes_accessed_per_device": float(led.bytes),
        "memory_analysis": {
            "argument_bytes": trace["argument_bytes"],
            "output_bytes": trace["output_bytes"],
            "temp_bytes": led.temp_peak,
            "generated_code_bytes": None,
        },
        "resident_bytes": resident,
        "collectives": coll,
        "collective_bytes_per_device": coll_bytes,
        "roofline": dict(roofline_terms(flops, led.bytes, coll_bytes),
                         model_flops_global=model_flops,
                         useful_fraction=(model_flops / (flops * n_dev))
                         if model_flops and flops else None),
        "compile_s": trace["trace_s"],
    }
    if "sample_form" in trace:
        out["sample_form"] = trace["sample_form"]
    return out


def cell_config(arch: str, shape_name: str, *, layers=None, batch=None,
                seq=None):
    """``(cfg, shape)`` of a cell, with an optional depth, global batch
    or sequence cut (``shape`` None for ``sample``)."""
    cfg = get_arch(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if shape_name == "sample":
        return cfg, None
    shape = SHAPES[shape_name]
    if batch is not None:
        shape = dataclasses.replace(shape, global_batch=batch)
    if seq is not None:
        shape = dataclasses.replace(shape, seq_len=seq)
    return cfg, shape


def dry_run(cfg: ArchConfig, shape_name: str, shape: Optional[ShapeConfig],
            mesh_name: str, overrides: Optional[dict] = None, *,
            sample_blocks: int = SAMPLE_BLOCKS) -> dict:
    """One cell at rank 0 of ``mesh_name`` (``pod1``, ``pod2`` or
    ``DxM``) on meta tensors: the result dict (JAX's keys)."""
    with fake_mesh(mesh_name) as mesh:
        par = build_parallel(cfg, mesh)
        if overrides:
            par = dataclasses.replace(par, **{k: v for k, v in
                                              overrides.items()
                                              if hasattr(par, k)})
        trace = trace_cell(cfg, shape, par, TRACE_DEVICE,
                           sample_blocks=sample_blocks)
        result = analyze(cfg, shape_name, shape, mesh, trace)
    result["overrides"] = {k: repr(v) for k, v in (overrides or {}).items()}
    return result


def run_cell(arch: str, shape_name: str, mesh_name: str, out_dir: str,
             tag: str = "", overrides: Optional[dict] = None, *,
             layers=None, batch=None, seq=None) -> dict:
    """:func:`dry_run` of a named cell, written to
    ``<out_dir>/<arch>__<shape>__<mesh>[__<tag>].json``."""
    cfg, shape = cell_config(arch, shape_name, layers=layers, batch=batch,
                             seq=seq)
    result = dry_run(cfg, shape_name, shape, mesh_name, overrides)
    result["tag"] = tag
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    path = os.path.join(out_dir,
                        f"{arch}__{shape_name}__{mesh_name}{suffix}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    mem = result["memory_analysis"]
    peak = (mem["argument_bytes"] + mem["temp_bytes"]) / 2 ** 30
    print(f"[dryrun] OK {arch} x {shape_name} x {mesh_name} "
          f"trace={result['compile_s']:.1f}s "
          f"dominant={result['roofline']['dominant']} "
          f"peak={peak:.2f}GiB/dev")
    print(json.dumps({k: result[k] for k in
                      ("flops_per_device", "bytes_accessed_per_device",
                       "collective_bytes_per_device")}, indent=1))
    print("memory_analysis:", json.dumps(mem))
    return result


def list_cells() -> str:
    """JAX's ``--list``: every arch with its runnable shapes."""
    from repro_torch.configs import arch_names
    lines = []
    for a in arch_names():
        cfg = get_arch(a)
        cells = ([s.name for s in shape_cells(cfg)]
                 if cfg.family != "dit" else ["sample"])
        lines.append(f"{a}: {cells}")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=False)
    ap.add_argument("--shape", default="train_4k",
                    help="train_4k|prefill_32k|decode_32k|long_500k|sample")
    ap.add_argument("--mesh", default="pod1",
                    help="pod1|pod2, or DxM (data x model) for a small mesh")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--tag", default="")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--override", action="append", default=[],
                    help="ParallelCtx overrides, e.g. fsdp=True "
                         "remat_policy=nothing")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth")
    ap.add_argument("--batch", type=int, default=None,
                    help="the shape's global batch instead of its own")
    ap.add_argument("--seq", type=int, default=None,
                    help="the shape's sequence length instead of its own")
    args = ap.parse_args(argv)
    if args.list:
        print(list_cells())
        return 0
    if args.arch is None:
        ap.error("--arch is required (or --list)")
    overrides = dict(parse_override(o) for o in args.override)
    run_cell(args.arch, args.shape, args.mesh, args.out, args.tag,
             overrides or None, layers=args.layers, batch=args.batch,
             seq=args.seq)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
