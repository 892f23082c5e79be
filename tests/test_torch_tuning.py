"""The port's tuning seam (``repro_torch.kernels.tuning``) on the CPU.

Its helpers against JAX's ``repro.kernels.tuning`` on the same inputs
(seeded numpy draws and edge cases), its tables refused where JAX's are,
the resolution order, the routing of every family's knobs into the
wrappers' geometry (``launch_geometry``, no launch), ``_build``'s targets
under defines, and the sources' macro defaults against the heuristic
tier.  No kernel is launched here; the card's tests of non-default
candidates are in ``tests/test_torch_cuda.py``.
"""
import inspect
import json
import os
import re

import numpy as np
import pytest
import torch

from repro.kernels import tuning as jt
from repro_torch.kernels import (_build, elementwise, flash_attention, ops,
                                 rwkv6_scan, selective_scan, tuning)

RNG_SEED = 30


def _table(backend="cpu", entries=()):
    return {"version": tuning.TABLE_SCHEMA_VERSION, "backend": backend,
            "entries": list(entries)}


# ---- helpers equal JAX's --------------------------------------------------

def test_next_pow2_and_buckets_equal_jax():
    rng = np.random.default_rng(RNG_SEED)
    ns = [0, 1, 2, 3, 4, 5, 127, 128, 129, 1 << 20, (1 << 20) + 1,
          *rng.integers(1, 1 << 24, 200).tolist()]
    assert [tuning.next_pow2(n) for n in ns] == [jt.next_pow2(n) for n in ns]
    for kernel in jt.KERNELS:
        assert tuning.bucket_for(kernel, None) == jt.bucket_for(kernel, None)
        for rank in (1, 2, 3, 5):
            for _ in range(40):
                shape = tuple(rng.integers(0, 5000, rank).tolist())
                assert tuning.bucket_for(kernel, shape) == \
                    jt.bucket_for(kernel, shape), (kernel, shape)


def test_divisor_helpers_equal_jax():
    rng = np.random.default_rng(RNG_SEED + 1)
    pairs = [(48, 32), (64, 32), (7, 32), (13, 4), (1, 1), (100, 256),
             (100, 64), (7, 2), *zip(rng.integers(1, 4096, 200).tolist(),
                                     rng.integers(1, 300, 200).tolist())]
    for n, cap in pairs:
        assert tuning.pick_chunk(n, cap) == jt.pick_chunk(n, cap)
        assert tuning.sample_tile_rows(n, cap) == jt.sample_tile_rows(n, cap)
    assert tuning.pick_chunk(96) == jt.pick_chunk(96)


def _refused(fn):
    try:
        fn()
    except (jt.TuningTableError, tuning.TuningTableError):
        return True
    return False


@pytest.mark.parametrize("mutate", [
    lambda d: d.update(version=99),
    lambda d: d.pop("version"),
    lambda d: d.pop("backend"),
    lambda d: d.update(backend=3),
    lambda d: d.update(entries={"not": "a list"}),
    lambda d: d["entries"].append("an entry"),
    lambda d: d["entries"].append({"kernel": "conv", "dtype": "float32",
                                   "bucket": [8], "params": {"x": 1}}),
    lambda d: d["entries"].append({"kernel": "flash", "bucket": [8],
                                   "params": {"x": 1}}),
    lambda d: d["entries"].append({"kernel": "flash", "dtype": "float32",
                                   "bucket": [8], "params": {}}),
    lambda d: d["entries"].append({"kernel": "flash", "dtype": "float32",
                                   "bucket": [0], "params": {"x": 8}}),
    lambda d: d["entries"].append({"kernel": "flash", "dtype": "float32",
                                   "bucket": 8, "params": {"x": 8}}),
    lambda d: d["entries"].append({"kernel": "flash", "dtype": "float32",
                                   "bucket": [8], "params": {"x": True}}),
    lambda d: d["entries"].append({"kernel": "flash", "dtype": "float32",
                                   "bucket": [8], "params": {"x": -2}}),
    lambda d: d["entries"].append({"kernel": "rwkv6", "dtype": "float32",
                                   "bucket": [8], "params": {"x": 1.5}}),
], ids=lambda f: "")
def test_validate_table_refuses_what_jax_refuses(mutate):
    """Each malformed payload raises in both packages (the port also
    refuses parameters its kernels do not have; JAX's ``x`` is no
    parameter of either, so every mutation is a refusal on both)."""
    d = _table()
    mutate(d)
    assert _refused(lambda: jt.validate_table(json.loads(json.dumps(d))))
    assert _refused(lambda: tuning.validate_table(json.loads(json.dumps(d))))
    assert jt.validate_table(_table()) and tuning.validate_table(_table())


@pytest.mark.parametrize("params, msg", [
    ({"fwd_stages": 3, "block_q": 64}, "unknown parameter"),
    ({"fwd_stages": 5}, "outside"),
    ({"fwd_block_n": 128}, "outside"),
    ({"fwd_stages": 0}, "positive int"),
])
def test_port_refuses_params_its_kernels_do_not_take(params, msg):
    d = _table(entries=[{"kernel": "flash", "dtype": "bfloat16",
                         "bucket": [8, 8, 8], "params": params}])
    with pytest.raises(tuning.TuningTableError, match=msg):
        tuning.validate_table(d)
    with pytest.raises(tuning.TuningTableError):
        tuning.KernelTuner(tables={"sm90": d})


# ---- resolution order -----------------------------------------------------

def test_heuristics_are_the_shipped_constants():
    t = tuning.KernelTuner(tables={"cpu": _table(), "sm90": _table("sm90")})
    for backend in tuning.BACKENDS:
        el = t.resolve("elementwise", backend=backend, shape=(4096,))
        assert el.source == "heuristic"
        assert dict(el.params) == {
            "ddim_threads": elementwise.DDIM_THREADS,
            "resid_threads": elementwise.RESID_THREADS,
            "resid_max_cluster": elementwise.RESID_MAX_CLUSTER,
            "resid_slice_per_block": elementwise.RESID_SLICE_PER_BLOCK}
        assert dict(el.params) == {"ddim_threads": 256,
                                   "resid_threads": 1024,
                                   "resid_max_cluster": 8,
                                   "resid_slice_per_block": 4096}
        sc = t.resolve("selective_scan", backend=backend,
                       shape=(2048, 1600, 16)).params
        assert (sc["channels"], sc["stages"], sc["bwd_channels"],
                sc["segment_chunks"], sc["max_segments"], sc["bwd_sub"],
                sc["bwd_max_threads"], sc["bwd_min_blocks"],
                sc["bwd_replay_min_blocks"]) == (64, 4, 32, 2, 32, 8, 128,
                                                  3, 4)
        fl = t.resolve("flash", backend=backend, dtype=torch.bfloat16,
                       shape=(1024, 1024, 72)).params
        assert dict(fl) == {"fwd_block_n": 64, "fwd_stages": 2,
                            "bwd_block_n": 64, "bwd_stages": 2}
        rw = t.resolve("rwkv6", backend=backend, shape=(2048, 64)).params
        assert dict(rw) == {"dv_sum_threads": 256, "fwd_cols": 32,
                            "bwd_rows": 16}
    # the unknown backend falls back to the same row
    assert t.resolve("rwkv6", backend="rocm").source == "heuristic"


def test_table_hit_unknown_key_fallback_and_override_merge():
    entry = {"kernel": "selective_scan", "dtype": "float32",
             "bucket": [2048, 2048, 16],
             "params": {"channels": 32, "bwd_sub": 4}}
    t = tuning.KernelTuner(tables={"sm90": _table("sm90", [entry])},
                           overrides={"selective_scan": {"stages": 2}})
    bare = tuning.KernelTuner(tables={"sm90": _table("sm90", [entry])})
    hit = bare.resolve("selective_scan", backend="sm90",
                       shape=(1100, 1600, 16))
    assert hit.source == "table"
    assert (hit.params["channels"], hit.params["bwd_sub"],
            hit.params["stages"]) == (32, 4, 4)
    assert hit.key == ("sm90", "selective_scan", "float32",
                       (2048, 2048, 16))
    for miss in (dict(shape=(1, 1600, 16)), dict(shape=(1100, 1600, 16),
                                                  dtype=torch.bfloat16)):
        got = bare.resolve("selective_scan", backend="sm90", **miss)
        assert got.source == "heuristic" and got.params["channels"] == 64
    assert bare.resolve("selective_scan", backend="cpu",
                        shape=(1100, 1600, 16)).source == "heuristic"
    both = t.resolve("selective_scan", backend="sm90", shape=(1100, 1600, 16))
    assert both.source == "override"
    assert (both.params["stages"], both.params["channels"]) == (2, 32)
    call = t.resolve("selective_scan", backend="sm90",
                     shape=(1100, 1600, 16), overrides={"stages": 3})
    assert call.params["stages"] == 3 and call.source == "override"
    with pytest.raises(ValueError, match="unknown kernel"):
        t.resolve("conv", backend="cpu")
    with pytest.raises(ValueError, match="backend"):
        t.resolve("flash", backend=None)
    with pytest.raises(ValueError, match="unknown parameter"):
        tuning.KernelTuner(overrides={"flash": {"block_q": 64}})
    with pytest.raises(ValueError, match="outside"):
        t.resolve("elementwise", backend="cpu",
                  overrides={"ddim_threads": 300})


def test_missing_table_is_empty_and_malformed_file_fails_loudly(tmp_path):
    t = tuning.KernelTuner(table_dir=str(tmp_path))
    assert t.resolve("flash", backend="sm90",
                     shape=(8, 8, 8)).source == "heuristic"
    assert t.table("sm90") is None
    (tmp_path / "sm90.json").write_text("{not json")
    with pytest.raises(tuning.TuningTableError, match="JSON"):
        tuning.KernelTuner(table_dir=str(tmp_path)).resolve(
            "flash", backend="sm90", shape=(8, 8, 8))
    (tmp_path / "sm90.json").write_text(json.dumps(_table("sm90", [
        {"kernel": "flash", "dtype": "float32", "bucket": [8, 8, 8],
         "params": {}}])))
    with pytest.raises(tuning.TuningTableError, match="params"):
        tuning.KernelTuner(table_dir=str(tmp_path)).resolve(
            "flash", backend="sm90", shape=(8, 8, 8))


def test_process_default_tuner_install_and_reset():
    custom = tuning.KernelTuner(tables={"cpu": _table()},
                                overrides={"flash": {"fwd_stages": 3}})
    try:
        tuning.set_tuner(custom)
        assert tuning.get_tuner() is custom
        assert tuning.resolve("flash", backend="cpu").params[
            "fwd_stages"] == 3
        assert flash_attention.launch_geometry(
            64, 64, 64, torch.bfloat16)["fwd_defines"] == (
                "FLASH_FWD_STAGES=3",)
    finally:
        tuning.set_tuner(None)
    assert tuning.get_tuner() is not custom
    assert flash_attention.launch_geometry(
        64, 64, 64, torch.bfloat16)["fwd_defines"] == ()


def test_committed_tables_validate():
    """Every committed table (``sm90.json`` once the measured sweep has
    written one) validates, and each entry names the card's backend."""
    names = sorted(os.listdir(tuning.TABLE_DIR)) \
        if os.path.isdir(tuning.TABLE_DIR) else []
    for name in names:
        with open(os.path.join(tuning.TABLE_DIR, name)) as f:
            payload = tuning.validate_table(json.load(f), name)
        assert name == f"{payload['backend']}.json"
        assert payload["backend"] in tuning.BACKENDS
        assert tuning.KernelTuner().table(payload["backend"]) is not None


def test_backend_of_is_the_tensor_device():
    assert tuning.backend_of(torch.zeros(1)) == "cpu"
    assert tuning.backend_of(torch.device("cpu")) == "cpu"
    assert tuning.backend_of("cpu") == "cpu"


# ---- each family's routing -------------------------------------------------

def _pin(kernel, params):
    return tuning.KernelTuner(tables={"cpu": _table()},
                              overrides={kernel: params})


def _tabled(kernel, dtype, bucket, params):
    return tuning.KernelTuner(tables={"cpu": _table("cpu", [
        {"kernel": kernel, "dtype": dtype, "bucket": list(bucket),
         "params": params}])})


def test_elementwise_geometry_follows_the_tuner():
    shape, f32 = (2, 64, 64, 4), torch.float32
    base = elementwise.launch_geometry("ddim_fused", shape, f32)
    assert base["config"].source == "heuristic"
    assert base["geometry"] == {
        **dict(zip(("n_vec", "blocks"), elementwise.ddim_geometry(
            32768, 16384, False, 4, True))), "threads": 256}
    pinned = elementwise.launch_geometry(
        "ddim_fused", shape, f32,
        tuner=_pin("elementwise", {"ddim_threads": 64}))
    assert pinned["geometry"]["threads"] == 64
    assert pinned["geometry"]["blocks"] == 4 * base["geometry"]["blocks"]
    res = elementwise.launch_geometry("parareal_update_residual", shape, f32,
                                      batch_dims=1)
    assert res["geometry"] == dict(zip(
        ("cluster", "per_block", "threads", "vector"),
        elementwise.resid_geometry(16384, 4, True)))
    assert (res["geometry"]["cluster"], res["geometry"]["threads"]) == \
        (4, 1024)
    tabled = elementwise.launch_geometry(
        "parareal_update_residual", shape, f32, batch_dims=1,
        tuner=_tabled("elementwise", "float32", (16384,),
                      {"resid_threads": 256, "resid_max_cluster": 2,
                       "resid_slice_per_block": 8192}))
    assert tabled["config"].source == "table"
    assert (tabled["geometry"]["cluster"], tabled["geometry"]["threads"],
            tabled["geometry"]["per_block"]) == (2, 256, 2048)
    upd = elementwise.launch_geometry("parareal_update", shape, f32)
    assert upd["config"].key[3] == (32768,)
    assert upd["geometry"]["cluster"] == 8


def test_flash_defines_follow_the_tuner():
    base = flash_attention.launch_geometry(1024, 1024, 72, torch.bfloat16)
    assert base["config"].source == "heuristic"
    assert (base["fwd_defines"], base["bwd_defines"]) == ((), ())
    tabled = flash_attention.launch_geometry(
        1000, 1000, 72, torch.bfloat16,
        tuner=_tabled("flash", "bfloat16", (1024, 1024, 128),
                      {"fwd_stages": 4, "bwd_stages": 3}))
    assert tabled["fwd_defines"] == ("FLASH_FWD_STAGES=4",)
    assert tabled["bwd_defines"] == ("FLASH_BWD_STAGES=3",)
    other = flash_attention.launch_geometry(
        1000, 1000, 72, torch.float32,
        tuner=_tabled("flash", "bfloat16", (1024, 1024, 128),
                      {"fwd_stages": 4}))
    assert other["config"].source == "heuristic"


def test_rwkv6_geometry_follows_the_tuner():
    base = rwkv6_scan.launch_geometry(4, 32, 2048, 64, 64, torch.bfloat16)
    assert base["fwd_grid"] == (128, 2) and base["bwd_grid"] == (128, 4)
    assert base["dv_sum"]["threads"] == 256 and base["defines"] == ()
    pinned = rwkv6_scan.launch_geometry(
        4, 32, 2048, 64, 64, torch.bfloat16,
        tuner=_pin("rwkv6", {"dv_sum_threads": 64}))
    assert pinned["dv_sum"] == {"threads": 64,
                                "blocks": 4 * base["dv_sum"]["blocks"]}


def test_scan_geometry_follows_the_tuner():
    base = selective_scan.launch_geometry(2, 2048, 1600, 16)
    assert base["fwd"] == selective_scan.geometry(2, 1600, 16)
    assert base["bwd"] == selective_scan.bwd_geometry(2, 2048, 1600, 16)
    assert (base["stages"], base["sub"], base["defines"]) == (4, 8, ())
    tuner = _tabled("selective_scan", "float32", (2048, 2048, 16),
                    {"channels": 32, "bwd_channels": 16,
                     "segment_chunks": 4, "max_segments": 4, "bwd_sub": 4,
                     "bwd_min_blocks": 2})
    got = selective_scan.launch_geometry(2, 2048, 1600, 16, tuner=tuner)
    assert got["config"].source == "table"
    assert got["fwd"].channels == 32 and got["fwd"].grid == (50, 2)
    assert got["bwd"].channels == 16 and got["bwd"].segments == 4
    assert got["defines"] == ("SCAN_BWD_MIN_BLOCKS=2", "SCAN_BWD_SUB=4")
    assert selective_scan.launch_geometry(
        2, 37, 1600, 16, tuner=tuner)["config"].source == "heuristic"


def test_every_op_takes_a_tuner():
    for fn in (ops.attention, ops.rwkv6_wkv, ops.selective_scan,
               ops.ddim_fused, ops.parareal_update_residual,
               ops.parareal_update):
        param = inspect.signature(fn).parameters.get("tuner")
        assert param is not None and param.default is None, fn.__name__


def test_ops_with_a_tuner_run_the_plain_version_on_cpu():
    """On a CPU tensor an op given a tuner still runs the plain version,
    with the same result as without one."""
    tuner = _pin("selective_scan", {"channels": 32})
    rng = np.random.default_rng(RNG_SEED)
    x = torch.from_numpy(rng.standard_normal((2, 5, 8)).astype(np.float32))
    args = (x, torch.rand(2, 5), torch.randn(2, 5, 4), torch.randn(2, 5, 4),
            -torch.rand(8, 4), torch.randn(8))
    got = ops.selective_scan(*args, tuner=tuner)
    want = ops.selective_scan(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    y = torch.from_numpy(rng.standard_normal((3, 16)).astype(np.float32))
    assert torch.equal(ops.ddim_fused(y, y, 0.9, 0.5, tuner=tuner),
                       ops.ddim_fused(y, y, 0.9, 0.5))


# ---- builds ---------------------------------------------------------------

def test_build_target_covers_sorted_defines():
    plain = _build._target("selective_scan")
    a = _build._target("selective_scan", ("SCAN_BWD_SUB=4",
                                          "SCAN_BWD_MIN_BLOCKS=2"))
    b = _build._target("selective_scan", ("SCAN_BWD_MIN_BLOCKS=2",
                                          "SCAN_BWD_SUB=4"))
    c = _build._target("selective_scan", ("SCAN_BWD_SUB=16",))
    assert a == b and len({plain, a, c}) == 3
    assert _build._target("selective_scan", ()) == plain
    assert _build.label("rwkv6_wkv", ("B=1", "A=2")) == "rwkv6_wkv[A=2,B=1]"


def test_table_variants_name_each_build():
    tuner = tuning.KernelTuner(tables={"sm90": _table("sm90", [
        {"kernel": "flash", "dtype": "bfloat16", "bucket": [2048, 2048, 128],
         "params": {"fwd_stages": 3}},
        {"kernel": "selective_scan", "dtype": "float32",
         "bucket": [2048, 2048, 16], "params": {"bwd_sub": 4,
                                                "channels": 32}},
        {"kernel": "elementwise", "dtype": "float32", "bucket": [4096],
         "params": {"ddim_threads": 128}}])})
    assert tuning.table_variants(tuner=tuner) == [
        ("flash_attention_fwd", ("FLASH_FWD_STAGES=3",)),
        ("selective_scan", ("SCAN_BWD_SUB=4",))]
    assert tuning.table_variants(tuner=tuning.KernelTuner(
        tables={"sm90": _table("sm90")})) == []


def test_source_macro_defaults_are_the_heuristic_tier():
    """Each build parameter is an ``#ifndef`` macro of its source whose
    default is the heuristic value, with a static_assert beside it, so the
    heuristic config builds the source unchanged."""
    for kernel, params in tuning.BUILD_PARAMS.items():
        for name, (source, macro) in params.items():
            src = (_build.CSRC / f"{source}.cu").read_text()
            got = re.search(rf"#ifndef {macro}\n#define {macro} (\d+)\n",
                            src)
            assert got, (source, macro)
            assert int(got.group(1)) == tuning.default(kernel, name)
            lo, hi, _ = tuning.LIMITS[name]
            assert tuning.default(kernel, name) in range(lo, hi + 1)
        assert tuning.defines(kernel, tuning.resolve(
            kernel, backend="cpu").params, "any") == ()
    for source in ("flash_attention_fwd", "flash_attention_bwd",
                   "rwkv6_wkv", "selective_scan"):
        assert "static_assert" in (_build.CSRC / f"{source}.cu").read_text()


# ---- the CUDA runtime preset (launch/env.py) -----------------------------

@pytest.fixture
def clean_env(monkeypatch):
    from repro_torch.launch import env
    for var in (*env.CUDA_RUNTIME_ENV.values(), *env.CUDA_PERF_ENV):
        monkeypatch.delenv(var, raising=False)
    return env


def test_alloc_conf_merges_key_by_key_ours_winning(clean_env, monkeypatch):
    env = clean_env
    monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF",
                       "max_split_size_mb:128, expandable_segments:False")
    got = env.configure_platform(alloc_conf={"expandable_segments": True},
                                 allocator="native")
    assert got["alloc_conf"] == ("max_split_size_mb:128,"
                                 "expandable_segments:True,backend:native")
    assert env.os.environ["PYTORCH_CUDA_ALLOC_CONF"] == got["alloc_conf"]
    env.configure_platform(allocator="cudaMallocAsync")
    assert env.os.environ["PYTORCH_CUDA_ALLOC_CONF"].endswith(
        "backend:cudaMallocAsync")
    assert env.os.environ["PYTORCH_CUDA_ALLOC_CONF"].count("backend") == 1


def test_configure_platform_applies_only_what_is_passed(clean_env):
    env = clean_env
    got = env.configure_platform("gpu")
    assert got["env"] == {"TORCH_NCCL_HIGH_PRIORITY": "1"}
    assert "PYTORCH_CUDA_ALLOC_CONF" not in env.os.environ
    got = env.configure_platform(allocator="uncached", log_level=4)
    assert got["env"] == {"PYTORCH_NO_CUDA_MEMORY_CACHING": "1",
                          "TORCH_CPP_LOG_LEVEL": "FATAL"}
    assert env.configure_platform("cpu")["env"] == {
        "CUDA_VISIBLE_DEVICES": ""}
    for bad in (dict(platform="tpu"), dict(allocator="bfc"),
                dict(mem_fraction=1.5)):
        with pytest.raises(ValueError):
            env.configure_platform(**bad)
    with pytest.raises(ValueError, match="no card"):
        env.configure_platform("cpu", mem_fraction=0.5)


def test_configure_platform_sets_the_fraction_on_a_card(clean_env,
                                                        monkeypatch):
    env = clean_env
    seen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_per_process_memory_fraction",
                        lambda f: seen.append(f))
    assert env.configure_platform("gpu", mem_fraction=0.5)[
        "mem_fraction"] == 0.5
    assert seen == [0.5]


def test_configure_platform_refuses_once_cuda_is_initialized(clean_env,
                                                             monkeypatch):
    env = clean_env
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="after CUDA initialized"):
        env.configure_platform("gpu")
    assert "TORCH_NCCL_HIGH_PRIORITY" not in env.os.environ


def test_emitter_parser_routes_device_through_configure_platform(
        clean_env, monkeypatch):
    from repro_torch.benchmarks import common
    seen = []
    monkeypatch.setattr(clean_env, "configure_platform",
                        lambda platform: seen.append(platform))
    assert common.parser("doc").parse_args(["--device", "cpu"]).device == \
        "cpu"
    common.parser("doc").parse_args([])
    assert seen == ["cpu", "gpu"]
