"""Quickstart on the PyTorch port: ADC-DGD in a minute.

The port's counterpart of ``examples/quickstart.py``, on the four-node
network of the paper's Section V:

  1. DGD with *direct* compression does not converge (Fig. 1 phenomenon).
  2. ADC-DGD with the SAME compressor converges like uncompressed DGD.
  3. ADC-DGD transmits a fraction of the bytes.

then the gamma phase transition (``run_many``) and an i.i.d. Erdős-Rényi
topology schedule against the CHOCO-SGD error-feedback baseline.

Run (on ``cuda`` unless ``--device cpu``)::

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import compression, consensus, problems, topology

GAMMAS = (0.6, 0.8, 1.0, 1.2)


def compared(mix, comp, ss) -> dict:
    """The three algorithms of the first table (the reference's names)."""
    return {
        "DGD (uncompressed, 8B/elem)": consensus.DGD(mix, ss),
        "DGD + direct compression   ": consensus.CompressedDGD(mix, comp,
                                                               ss),
        "ADC-DGD (paper Alg. 2)     ": consensus.ADCDGD(mix, comp, ss,
                                                        gamma=1.0),
    }


def main(argv=None, uniforms=None) -> dict:
    """Prints the three tables; returns ``{"compare": {name: run result},
    "gamma": {gamma: (tail f, max transmitted)}, "schedule": {name: run
    result}}``.  ``uniforms(name, algorithm, problem, n_steps)`` may give a
    run's compressor draws (``consensus.run``'s ``uniforms``) instead of
    its generator's: a test feeds the reference's."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--gamma-steps", type=int, default=400)
    ap.add_argument("--trials", type=int, default=20)
    ap.add_argument("--schedule-steps", type=int, default=2000)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def draws(name, alg, prob, n):
        return None if uniforms is None else uniforms(name, alg, prob, n)

    # the paper's four-node problem: f1 non-convex, global objective convex
    prob = problems.paper_4node(device=dev)
    mix = topology.paper_fig3()           # the consensus matrix of Fig. 4
    print(f"network: 4 nodes, beta = {mix.beta:.3f} (second-largest |eig| "
          f"of W); device {dev}")
    comp = compression.RandomizedRounding(delta=1.0)   # paper Example 2
    ss = consensus.StepSize(alpha0=0.02, eta=0.0)      # constant step-size
    out = {"compare": {}, "gamma": {}, "schedule": {}}

    print(f"\n{'algorithm':<30} {'final f(x_bar)':>14} {'|grad|':>10} "
          f"{'consensus err':>14} {'kB sent':>8}")
    for name, alg in compared(mix, comp, ss).items():
        r = consensus.run(alg, prob, args.steps, key=0,
                          uniforms=draws(name, alg, prob, args.steps))
        out["compare"][name] = r
        print(f"{name:<30} {r['obj'][-1]:>14.5f} {r['grad_norm'][-1]:>10.2e} "
              f"{r['consensus'][-1]:>14.2e} {r['bytes'][-1] / 1e3:>8.1f}")
    print("\nTakeaway: direct compression stalls at a noise floor; ADC-DGD's")
    print("amplified differentials make the compression noise vanish (var ~ "
          "1/k^2),")
    print("matching uncompressed DGD at a fraction of the communication cost.")

    # gamma phase transition (paper Figs. 7/8): larger gamma converges
    # faster up to gamma = 1; past 1 only the transmitted magnitudes grow
    print(f"\n{'gamma':>6} {'tail f(x_bar)':>14} {'max transmitted':>16}")
    for gamma in GAMMAS:
        alg = consensus.ADCDGD(mix, comp, ss, gamma=gamma)
        t = consensus.run_many(alg, prob, args.gamma_steps, args.trials,
                               seed=7)
        tail = float(np.mean(t["obj"][:, -50:]))
        top = float(np.mean(t["max_tx"][:, -1]))
        out["gamma"][gamma] = (tail, top)
        print(f"{gamma:>6} {tail:>14.5f} {top:>16.3f}")

    # time-varying topology: ADC-DGD needs each step's W to be a consensus
    # matrix, so it converges on i.i.d. random graphs; CHOCO with the same
    # unbiased compressor keeps a consensus-error floor
    sched = topology.ErdosRenyiSchedule(4, p=0.6, horizon=args.schedule_steps,
                                        seed=3)
    ss_dim = consensus.StepSize(alpha0=0.02, eta=0.5)
    print(f"\n{'variant':<38} {'|grad|':>10} {'consensus err':>14}")
    for name, alg in {
        "ADC-DGD, i.i.d. Erdos-Renyi topology":
            consensus.ADCDGD(sched, comp, ss_dim, gamma=1.0),
        "CHOCO-SGD (error feedback), same W(k)":
            consensus.CHOCOGossip(sched, comp, ss_dim, consensus_lr=0.3),
    }.items():
        r = consensus.run(alg, prob, args.schedule_steps, key=1,
                          uniforms=draws(name, alg, prob,
                                         args.schedule_steps))
        out["schedule"][name] = r
        print(f"{name:<38} {r['grad_norm'][-50:].mean():>10.2e} "
              f"{r['consensus'][-50:].mean():>14.2e}")
    return out


if __name__ == "__main__":
    main()
