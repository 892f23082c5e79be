"""The port's examples (``examples/torch_*.py``) on the CPU, each through
its ``main(argv)`` at the toy sizes JAX's examples take, with what the
JAX example states asserted on what it returns:

* ``torch_quickstart``: the tiny DiT's loss falls (60 of its default 150
  steps), and SRDS at tol 2e-3 lands within that tolerance of the
  sequential sample;
* ``torch_train_diffusion``: the loop trains (the loss falls, a
  checkpoint is written and resumed from), SRDS samples the trained DiT
  close to the sequential sample;
* ``torch_srds_sampling``: vanilla and block-parallel SRDS (8 gloo
  ranks) report identical iterations and error, as does the wavefront;
  truncation is bit-identical and cheaper; the straggler run stays
  within the tolerance; the sharded per-sample batch is bit-identical to
  the single program's; every served request completes;
* ``torch_serve_diffusion_slo``: every request of each trace completes
  or is rejected by admission, no completion without a finite latency;
* ``torch_serve_llm``: every request gets its new tokens, each the
  greedy argmax of the model's logits on the left-padded prompt and the
  tokens before it (teacher forcing through ``forward_train``).

The DiT quickstart runs on the card in ``tests/test_torch_cuda.py``.
"""
import importlib
import math
import pathlib
import sys

import pytest
import torch

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's many small ops: under
    pytest-xdist every worker's default pool (a thread a core) shares the
    host's cores, and the quickstart took 317 s under six workers (3 s
    with one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example(name):
    # the spawned gloo ranks of torch_srds_sampling import the module by
    # this name: examples/ stays on sys.path, which they inherit
    if str(EXAMPLES) not in sys.path:
        sys.path.insert(0, str(EXAMPLES))
    return importlib.import_module(name)


def test_quickstart_trains_and_srds_meets_the_sequential_sample(capsys):
    out = _example("torch_quickstart").main(["--device", "cpu", "--steps",
                                             "60"])
    assert out["last"] < out["first"]
    assert 1 <= out["iterations"] <= 10
    assert out["rel_err"] <= 2e-3
    assert out["serial_evals"] == 10 + out["iterations"] * (10 + 10)
    assert "approximation-free" in capsys.readouterr().out


def test_train_diffusion_trains_checkpoints_and_samples(tmp_path):
    mod = _example("torch_train_diffusion")
    ckpt = str(tmp_path / "ckpt")
    out = mod.main(["--device", "cpu", "--steps", "50", "--ckpt", ckpt])
    assert len(out["losses"]) == 2 and out["losses"][1] < out["losses"][0]
    assert out["err"] <= 1e-3 and out["iterations"] <= 10
    assert torch.isfinite(out["sample"]).all()
    # a rerun with more steps resumes from the checkpoint at step 50
    again = mod.main(["--device", "cpu", "--steps", "60", "--ckpt", ckpt])
    assert len(again["losses"]) == 1


@pytest.mark.distributed
def test_srds_sampling_drivers_agree():
    out = _example("torch_srds_sampling").main(["--device", "cpu"])
    assert out["block"] == out["vanilla"]
    assert out["wave"][0] == out["vanilla"][0]
    assert out["wave"][3] == out["vanilla"][1]
    k, identical, evals, untruncated = out["truncated"]
    assert k == out["vanilla"][0] and identical and evals < untruncated
    assert out["strag"][1] <= 1e-5
    iters, identical = out["batched"]
    assert iters == out["per_sample"] and identical
    served, per_sample, lockstep = out["serving"]
    assert served == 12 and per_sample < lockstep


def test_serve_diffusion_slo_accounts_for_every_request():
    out = _example("torch_serve_diffusion_slo").main(["--device", "cpu"])
    assert out["single"].iterations >= 1
    for (trace, _), rep in out["reports"].items():
        assert len(rep.responses) + len(rep.rejected) \
            + len(rep.preempted) == len(out["traces"][trace])
        assert all(math.isfinite(r.latency) for r in rep.responses.values())
        assert 0.0 <= rep.slo_attainment <= 1.0
    assert not out["reports"][("poisson", "fifo")].rejected


@pytest.mark.parametrize("arch", ["qwen3-8b", "rwkv6-1.6b"])
def test_serve_llm_decodes_greedily(arch):
    from repro_torch.models import forward_train
    out = _example("torch_serve_llm").main(["--device", "cpu", "--arch",
                                            arch])
    plen = max(len(r.prompt) for r in out["requests"])
    for req, toks in zip(out["requests"], out["outs"]):
        assert len(toks) == 12
        # the engine left-pads each prompt with token 0 to the longest
        pad = torch.zeros(plen - len(req.prompt), dtype=torch.long)
        seq = torch.cat([pad, torch.as_tensor(req.prompt),
                         torch.tensor(toks)])[None]
        with torch.no_grad():
            logits = forward_train(out["cfg"], out["model"],
                                   {"tokens": seq})
        want = logits[0, plen - 1:plen - 1 + len(toks)].argmax(-1).tolist()
        assert want == toks
