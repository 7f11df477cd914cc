"""Ground-truth higher-order marginal statistics of the ManyWell target
(``experiments/ground_truth_marginals.py`` of the repository).

    python3 -m fab_tpu_torch.experiments.ground_truth_marginals [--dim 32]
        [--n-samples 200000] [--config ... --checkpoint <run dir or state.pkl>]
        [--device cpu]

Exact target samples (per-well rejection sampling) give P(x_2i > 0) per well, the
pairwise and triple-wise joint positive-sign probabilities and the second moments.
The wells are independent by construction, so the joint probabilities must
factorise: the largest deviation from the product of the marginals checks the exact
sampler itself (below 0.01). With ``--checkpoint`` the flow's samples (at most
50,000) get the same statistics, and the largest per-well occupancy gap is printed.
"""
from __future__ import annotations

import argparse
import itertools

import numpy as np
import torch

from fab_tpu_torch.device import resolve_device
from fab_tpu_torch.targets import ManyWellEnergy


def sign_stats(x: np.ndarray, n_wells: int, max_tuples: int = 20):
    """Per-well P(first dim > 0), plus pair/triple joint probabilities."""
    pos = x[:, 0 : 2 * n_wells : 2] > 0  # [N, n_wells]
    marg = pos.mean(axis=0)
    pairs = {}
    for i, j in itertools.islice(itertools.combinations(range(n_wells), 2), max_tuples):
        pairs[(i, j)] = float((pos[:, i] & pos[:, j]).mean())
    triples = {}
    for t in itertools.islice(itertools.combinations(range(n_wells), 3), max_tuples):
        triples[t] = float((pos[:, t[0]] & pos[:, t[1]] & pos[:, t[2]]).mean())
    return marg, pairs, triples


def report(name, x, n_wells):
    """Print the statistics of ``x``; (marginals, pair deviation, triple deviation)."""
    marg, pairs, triples = sign_stats(x, n_wells)
    print(f"\n== {name} ==")
    print("per-well P(x_2i+1 > 0):", np.round(marg, 4))
    pair_dev = max(abs(p - marg[i] * marg[j]) for (i, j), p in pairs.items())
    triple_dev = max(
        abs(p - marg[i] * marg[j] * marg[k]) for (i, j, k), p in triples.items()
    )
    print(f"max |P(i,j) - P(i)P(j)|     = {pair_dev:.4f}")
    print(f"max |P(i,j,k) - prod|       = {triple_dev:.4f}")
    print("second moments E[x_d^2] (first 4 dims):", np.round((x**2).mean(0)[:4], 4))
    return marg, pair_dev, triple_dev


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dim", type=int, default=32)
    parser.add_argument("--n-samples", type=int, default=200_000)
    parser.add_argument("--config")
    parser.add_argument("--checkpoint")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    target = ManyWellEnergy(dim=args.dim, device=device)
    generator = torch.Generator(device=device).manual_seed(0)
    x_exact = target.sample(generator, args.n_samples).cpu().numpy()
    marg, pair_dev, triple_dev = report("exact samples", x_exact, target.n_wells)
    assert pair_dev < 0.01 and triple_dev < 0.01, (
        "exact sampler violates well independence"
    )
    out = {"marginals": marg, "pair_dev": pair_dev, "triple_dev": triple_dev}

    if args.checkpoint:
        from fab_tpu_torch.experiments.load_model_for_eval import load_model
        from fab_tpu_torch.utils.training import load_config, maybe_enable_x64

        cfg = load_config(args.config)
        model, _ = load_model(cfg, target, args.checkpoint, maybe_enable_x64(cfg), device)
        with torch.no_grad():
            x_flow = model.flow.sample(min(args.n_samples, 50_000),
                                       torch.Generator(device=device).manual_seed(1))
        flow_marg, *_ = report("flow samples", x_flow.cpu().numpy(), target.n_wells)
        out["flow_marginals"] = flow_marg
        out["max_occupancy_gap"] = float(np.abs(flow_marg - marg).max())
        print("\nmax |flow - exact| per-well occupancy:", out["max_occupancy_gap"])
    return out


if __name__ == "__main__":
    main()
