"""The port's DiT against the JAX package's, and SRDS on it.

A small DiT (2 layers, head dims 72 — SD-v2's — and 64) gets one
parameter tree, every leaf drawn nonzero from a numpy seed
(``random_jax_tree``): the adaLN-zero init would gate every layer by 0 and
make the comparison vacuous.  JAX runs it with its flash kernel in
interpret mode, the port loads the tree through ``load_jax_params``.

Tolerances (f32 on both sides): eps agrees to 1e-4 relative to its scale
(two frameworks' f32 matmul and softmax summation orders over two
layers); SRDS takes the same number of iterations, with ``tol`` checked to
sit away from every residual, and its sample agrees to 1e-3 (the eps
differences integrated over the solve).
"""
import jax

jax.config.update("jax_enable_x64", True)

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.configs.base import ArchConfig as JArch
from repro.models import dit as jdit
from repro_torch.configs.base import ArchConfig as TArch
from repro_torch.configs.base import get_arch
from repro_torch.models import dit as tdit

EPS_RTOL = 1e-4
SAMPLE_ATOL = 1e-3
SMALL = dict(name="dit-small", num_layers=2, num_kv_heads=2, num_heads=2,
             patch_size=2, in_channels=4, dtype="float32")
JAX_ONLY = dict(family="dit", vocab_size=0, causal=False, act="gelu",
                norm="layernorm")
WIDTHS = {"hd72": dict(d_model=144, d_ff=288),
          "hd64": dict(d_model=128, d_ff=256)}


def _cfgs(width):
    kw = dict(SMALL, **WIDTHS[width])
    return JArch(**kw, **JAX_ONLY), TArch(**kw)


def _jax_tree(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)


def _x(k=3, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (k, 8, 8, 4)).astype(np.float32)


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_dit_eps_matches_jax(width):
    jcfg, tcfg = _cfgs(width)
    tree = tdit.random_jax_tree(tcfg, seed=0)
    assert all(np.all(a != 0) for a in jax.tree.leaves(tree))
    x = _x()
    t = np.array([999.0, 480.0, 20.0], np.float32)
    want = np.asarray(jdit.dit_forward(jcfg, _jax_tree(tree), jnp.asarray(x),
                                       jnp.asarray(t), use_kernel=True))
    model = tdit.load_jax_params(tcfg, tree, device="cpu")
    got = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert got.shape == x.shape and np.all(np.isfinite(got))
    assert np.abs(want).mean() > 0.1           # not a vacuous comparison
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=EPS_RTOL * np.abs(want).max())


def test_srds_on_dit_matches_jax_iterations():
    jcfg, tcfg = _cfgs("hd72")
    tree = tdit.random_jax_tree(tcfg, seed=1)
    x0 = _x(k=2, seed=4)
    tol = 1e-3
    jsched = J.make_schedule("ddpm_linear", 16)
    tsched = T.make_schedule("ddpm_linear", 16)
    jfn = jdit.make_denoiser(jcfg, _jax_tree(tree), use_kernel=False)
    tfn = tdit.make_denoiser(tdit.load_jax_params(tcfg, tree, device="cpu"))
    cfg = dict(tol=tol, per_sample=True)
    jres = J.srds_sample(jfn, jsched, J.SolverConfig("ddim"),
                         jnp.asarray(x0), J.SRDSConfig(**cfg))
    tres = T.srds_sample(tfn, tsched, T.SolverConfig("ddim"),
                         torch.from_numpy(x0), T.SRDSConfig(**cfg))
    hist = np.asarray(jres.delta_history)
    assert np.all(np.abs(np.log(hist[np.isfinite(hist)] / tol)) > 0.05)
    assert 1 <= int(np.max(np.asarray(jres.iterations))) < 4
    np.testing.assert_array_equal(tres.iterations.numpy(),
                                  np.asarray(jres.iterations))
    np.testing.assert_allclose(tres.sample.numpy(), np.asarray(jres.sample),
                               atol=SAMPLE_ATOL, rtol=0)


def test_init_dit_mirrors_jax_shapes_and_adaln_zero():
    jcfg, tcfg = _cfgs("hd72")
    jtree = jdit.init_dit(jcfg, jax.random.PRNGKey(0))
    model = tdit.init_dit(tcfg, torch.Generator().manual_seed(0),
                          device="cpu")
    # the JAX tree loads into the port's init: same shapes everywhere
    loaded = tdit.load_jax_params(tcfg, jax.tree.map(np.asarray, jtree),
                                  device="cpu")
    for (name, a), (_, b) in zip(model.named_parameters(),
                                 loaded.named_parameters()):
        assert a.shape == b.shape, name
    eps = model(torch.from_numpy(_x()), torch.tensor([5.0, 50.0, 500.0]))
    assert torch.count_nonzero(eps) == 0         # adaLN-zero: eps == 0


def test_configs_and_device_rule(monkeypatch):
    sd = get_arch("srds-dit-sd2")
    assert (sd.num_layers, sd.d_model, sd.num_heads, sd.resolved_head_dim,
            sd.patch_size, sd.in_channels) == (28, 1152, 16, 72, 2, 4)
    from repro.configs.base import get_arch as jget
    for name in ("srds-dit-cifar", "srds-dit-lsun", "srds-dit-sd2"):
        j = dataclasses.asdict(jget(name))
        t = dataclasses.asdict(get_arch(name))
        assert {k: j[k] for k in t} == t, name
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdit.DiT(TArch(**dict(SMALL, **WIDTHS["hd64"])))
