"""Training launcher: train a dense decoder on the card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
        --dtype bfloat16 --steps 5 [--elastic]

The flags are those of ``repro.launch.train`` plus ``--device`` (default
``cuda``; ``cpu`` runs the plain PyTorch path) and ``--dtype``.
``--elastic`` replays a Summit-calibrated idle-node trace and lets the
MILP allocator park and unpark the Trainer live (the full BFTrainer
loop); otherwise it is a plain fixed-size run.  ``--checkpoint`` writes
the final params in the JAX package's npz format.  The model is built
without remat, as the JAX launcher builds it.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_arch
from repro_torch.elastic import ElasticTrainer
from repro_torch.models import Model
from repro_torch.models.layers import resolve_device
from repro_torch.optim import AdamW

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def main(argv: Optional[Sequence[str]] = None) -> ElasticTrainer:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b-smoke")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--per-node-batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--nodes", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--elastic", action="store_true",
                    help="drive node count from a replayed idle-node trace "
                         "via the MILP allocator")
    ap.add_argument("--checkpoint", default="",
                    help="path to save the final params/opt state")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = Model(cfg, dtype=DTYPES[args.dtype], device=device,
                  generator=gen, remat=False)
    trainer = ElasticTrainer(model, optimizer=AdamW(lr=args.lr),
                             per_node_batch=args.per_node_batch,
                             seed=args.seed, total_steps=args.steps,
                             device=device)
    trainer.pipeline.cfg.seq_len = args.seq
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"arch={cfg.name} params={model.n_params():,} device={name} "
          f"dtype={args.dtype}")

    if args.elastic:
        from repro_torch.core import MILPAllocator, amdahl_curve, \
            fragments_to_events, generate_summit_like
        from repro_torch.elastic import BFTrainerRuntime, ManagedTrainer
        frags = generate_summit_like(n_nodes=max(4, args.nodes * 4),
                                     duration=48 * 3600.0, seed=args.seed)
        managed = [ManagedTrainer(
            id=0, trainer=trainer, curve=amdahl_curve(cfg.name, 100.0, 0.2),
            n_min=1, n_max=args.nodes, target_steps=args.steps)]
        rep = BFTrainerRuntime(managed, MILPAllocator("fast")).run(
            fragments_to_events(frags), max_steps_per_interval=8)
        losses = rep.losses[0]
        print(f"elastic run: {rep.steps[0]} steps over {rep.events} "
              f"allocation events, {rep.rescales[0]} rescales, "
              f"loss {losses[0]:.3f} -> {losses[-1]:.3f}"
              if losses else "no steps ran (trace had no usable fragments)")
    else:
        trainer.rescale(args.nodes)
        t0 = time.perf_counter()
        for i in range(args.steps):
            m = trainer.train_step()
            if i % max(1, args.steps // 10) == 0 or i == args.steps - 1:
                print(f"step {m.step:4d} nodes={m.n_nodes} "
                      f"loss={m.loss:.4f} ({m.step_time_s*1e3:.0f} ms)")
        dt = time.perf_counter() - t0
        print(f"{args.steps} steps in {dt:.1f}s "
              f"({args.steps * args.per_node_batch * args.nodes / dt:.1f} "
              f"samples/s)")

    if args.checkpoint:
        save_checkpoint(args.checkpoint,
                        {n: p.data for n, p in trainer.params.items()},
                        meta={"step": trainer.step_count, "arch": cfg.name})
        print("saved", args.checkpoint)
    return trainer


if __name__ == "__main__":
    main()
