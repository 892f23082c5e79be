"""Table 3: vanilla against wavefront-pipelined SRDS (counterpart of
``benchmarks/table3_pipelined.py``).

The vanilla leg is ``run_pair`` on ``--device`` with the toy denoiser.
The wavefront leg is the port's ``make_pipelined_sampler`` on B ranks,
one block each, in a gloo group of B CPU processes
(``launch.mesh.spawn_ranks``, a ``file://`` store in a temporary
directory), whatever ``--device`` says: one card holds one NCCL rank.
Each superstep is one batched model eval, the paper's effective-serial
unit.  Its toy is JAX's: f64 ``tanh(x @ W) * (0.4 + 3e-4 t)`` on 8 dims,
``W`` and ``x0`` drawn by numpy from seeds 0 and 1 (JAX's come from
``jax.random``, which torch cannot draw).  The row adds the ranks' memory:
``wf_anon_gb``, their summed private anonymous resident memory at the end
of the run (``RssAnon``: what each rank holds beyond the shared
libraries; ``nan`` where ``/proc`` does not report it), and
``wf_peak_rss_gb``, their summed peak resident sets (shared library pages
counted once per rank).  A case whose
ranks would not fit in half the host's available memory (``RANK_GB`` a
rank) is not run and its row says so, as a JAX row of -1 does for a
failed subprocess.

    PYTHONPATH=src python -m repro_torch.benchmarks.table3_pipelined \\
        [--device cpu]
"""
import numpy as np
import torch

from repro_torch.core import SolverConfig, SRDSConfig, make_schedule

from .common import (emit, parser, resolve_device, run_pair, toy_array,
                     toy_denoiser)

CASES = [(961, 31), (196, 14), (25, 5)]     # (N, B)
WF_TOL = 1e-4
# a gloo rank's peak resident memory with a CPU-only torch imported
# (0.228 GB a rank at 5 ranks); with a CUDA build it maps ~4.9 GB, most
# of it shared libraries
RANK_GB = 0.25


def wf_model(x, t):
    w = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 8))
                         * 0.4)
    return torch.tanh(x @ w) * (0.4 + 3e-4 * t[:, None])


def _anon_gb() -> float:
    """This process's private anonymous resident memory (``RssAnon`` of
    /proc/self/status), or nan where it is not reported."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("RssAnon:"):
                    return int(line.split()[1]) / 2 ** 20
    except OSError:
        pass
    return float("nan")


def wavefront_rank(rank, world, n):
    """One rank of the wavefront leg: its result against the sequential
    sample, and this process's memory."""
    import resource

    from repro_torch.core import sample_sequential
    from repro_torch.core.pipelined import make_pipelined_sampler
    from repro_torch.launch.mesh import make_srds_mesh
    sched = make_schedule("ddpm_linear", n).astype(np.float64)
    x0 = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 8)))
    mesh = make_srds_mesh(world, device_type="cpu")
    res, steps, evals = make_pipelined_sampler(
        mesh, "time", wf_model, sched, SolverConfig("ddim"),
        SRDSConfig(tol=WF_TOL))(x0)
    ref = sample_sequential(wf_model, sched, SolverConfig("ddim"), x0)
    return dict(supersteps=steps, iters=int(res.iterations), evals=evals,
                err=float((res.sample - ref).abs().mean()),
                anon_gb=_anon_gb(), peak_rss_gb=resource.getrusage(
                    resource.RUSAGE_SELF).ru_maxrss / 2 ** 20)


def available_gb() -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2 ** 20
    return float("inf")


def wavefront(n: int, b: int) -> dict:
    """The wavefront leg at B = ``b`` ranks, or why it did not run."""
    from repro_torch.launch.mesh import spawn_ranks
    need, have = b * RANK_GB, available_gb()
    if need > 0.5 * have:
        return dict(skipped=f"{b} ranks need ~{need:.1f} GB, "
                            f"{have:.1f} GB available")
    ranks = spawn_ranks(wavefront_rank, b, n, device_type="cpu")
    out = dict(ranks[0])
    for k in ("anon_gb", "peak_rss_gb"):
        out[k] = sum(r[k] for r in ranks)
    return out


def rows(model_fn, x0, cases=tuple(CASES), repeats: int = 3):
    out = []
    for n, b in cases:
        sched = make_schedule("ddpm_linear", n)
        r = run_pair(model_fn, sched, SolverConfig("ddim"), x0,
                     SRDSConfig(tol=1e-3, num_blocks=b), repeats=repeats)
        wf = wavefront(n, b)
        name = f"table3/ddim{n}"
        if "skipped" in wf:
            tail = f"pipelined=not run ({wf['skipped']})"
        else:
            tail = (f"pipelined_supersteps={wf['supersteps']};"
                    f"pipelined_iters={wf['iters']};wf_evals={wf['evals']};"
                    f"wf_err={wf['err']:.1e};wf_anon_gb={wf['anon_gb']:.2f};"
                    f"wf_peak_rss_gb={wf['peak_rss_gb']:.2f}")
        emit(name, r["t_srds"] * 1e6,
             f"seq_evals={n};vanilla_eff={r['eff_serial']};" + tail)
        out.append(dict(name=name, n=n, blocks=b, iters=r["iters"],
                        vanilla_eff=r["eff_serial"],
                        eff_serial_pipelined=r["eff_serial_pipelined"],
                        t_srds_s=r["t_srds"], wavefront=wf))
    return out


def main(device="cuda"):
    device = resolve_device(device)
    return rows(toy_denoiser(device), toy_array("x0_table3", device))


if __name__ == "__main__":
    main(device=resolve_device(parser(__doc__).parse_args().device))
