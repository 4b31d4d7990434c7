"""End-to-end federated alignment CLI (counterpart of
``repro.launch.train``), with the same flags plus ``--device``.

Runs the FIRM protocol (generation, synthetic rewards, multi-objective PPO,
in-client regularized MGDA, FedAvg) on llama-3.2-1b or, with ``--arch``,
on any other ported config (the zamba2 hybrid, the MoE mixtral-8x7b,
...).  ``--preset smoke`` runs a reduced config; ``--preset full`` the
model at its published widths (mixtral-8x7b's 32 layers exceed one
80 GB card).

Example, on the card at full width:
  PYTHONPATH=src python -m repro_torch.launch.train --preset full \\
      --rounds 1 --clients 2 --local-steps 1 --batch-size 4 --max-new 8
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \\
      --preset full --rounds 1 --clients 2 --local-steps 1 --batch-size 4
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from repro_torch.configs import FIRMConfig, get_config
from repro_torch.fed.engine import EngineConfig, FederatedTrainer
from repro_torch.train import checkpoint


def main(argv=None) -> FederatedTrainer:
    """Parse ``argv`` (default: the command line), train, write
    ``history.json`` and ``adapters.npz`` under ``--out``; returns the
    trainer."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama-3.2-1b")
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--algorithm", default="firm",
                    choices=["firm", "firm_unreg", "fedcmoo", "linear"])
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--objectives", type=int, default=2)
    ap.add_argument("--beta", type=float, default=0.01)
    ap.add_argument("--preference", type=float, nargs="*", default=None)
    ap.add_argument("--dirichlet-alpha", type=float, default=0.3)
    ap.add_argument("--heterogeneous-rms", action="store_true")
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="runs/train")
    # smoke-model size knobs
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.preset == "smoke":
        cfg = cfg.reduced(n_layers=args.layers, d_model=args.d_model,
                          vocab=args.vocab)
    fc = FIRMConfig(
        n_objectives=args.objectives, n_clients=args.clients,
        rounds=args.rounds, local_steps=args.local_steps,
        batch_size=args.batch_size, beta=args.beta,
        preference=tuple(args.preference) if args.preference else None,
    )
    ec = EngineConfig(algorithm=args.algorithm, max_new=args.max_new,
                      dirichlet_alpha=args.dirichlet_alpha, seed=args.seed,
                      heterogeneous_rms=args.heterogeneous_rms)
    print(f"[train] arch={cfg.name} alg={args.algorithm} C={fc.n_clients} "
          f"K={fc.local_steps} B={fc.batch_size} beta={fc.beta} "
          f"M={fc.n_objectives} device={args.device}")
    trainer = FederatedTrainer(cfg, fc, ec, device=args.device)
    os.makedirs(args.out, exist_ok=True)
    t0 = time.time()
    for r in range(args.rounds):
        s = trainer.run_round()
        print(f"round {r + 1}/{args.rounds} rewards="
              f"{np.round(s['rewards'], 4).tolist()} "
              f"lam={np.round(s['lam_mean'], 3).tolist()} "
              f"drift={s['lam_disagreement']:.4f} "
              f"comm={s['comm_bytes'] / 1e6:.2f}MB "
              f"({time.time() - t0:.0f}s)", flush=True)
    hist = [{k: (v.tolist() if isinstance(v, np.ndarray) else v)
             for k, v in s.items()} for s in trainer.history]
    with open(os.path.join(args.out, "history.json"), "w") as f:
        json.dump({"config": vars(args), "history": hist}, f, indent=1)
    checkpoint.save(os.path.join(args.out, "adapters.npz"),
                    trainer.global_trainable, step=args.rounds)
    print(f"[train] wrote {args.out}/history.json and adapters.npz")
    return trainer


if __name__ == "__main__":
    main()
