"""Serving launcher: batched prefill + greedy decode on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
        --batch 4 --prompt-len 32 --new-tokens 32 --dtype bfloat16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \
        --dtype bfloat16

The flags are those of ``repro.launch.serve`` plus ``--device`` (default
``cuda``; ``cpu`` runs the plain PyTorch path) and ``--dtype``.
``--checkpoint`` reads an npz written by the JAX package
(``repro.launch.train --checkpoint``) through ``repro_torch.bridge``.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.bridge import params_from_flat
from repro_torch.configs import get_arch
from repro_torch.models import Model
from repro_torch.models.layers import resolve_device
from repro_torch.serving import GenerationResult, ServeEngine

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def main(argv: Optional[Sequence[str]] = None) -> GenerationResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b-smoke")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default="",
                    help="load params from an npz the JAX package wrote")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = Model(cfg, dtype=DTYPES[args.dtype], device=device, generator=gen,
                  trainable=False)
    if args.checkpoint:
        path = args.checkpoint
        path = path if path.endswith(".npz") else path + ".npz"
        with np.load(path) as data:
            model.load_state_dict(params_from_flat(dict(data)))
        print("loaded", path)

    eng = ServeEngine(model, max_len=args.prompt_len + args.new_tokens + 8,
                      device=device)
    rng = np.random.RandomState(args.seed)
    batch = {"tokens": rng.randint(0, cfg.vocab_size,
                                   (args.batch, args.prompt_len))}
    res = eng.generate(batch, args.new_tokens)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"arch={cfg.name} device={name} dtype={args.dtype} "
          f"batch={args.batch} prefill={res.prefill_time_s*1e3:.1f}ms "
          f"decode={res.decode_time_s*1e3:.1f}ms "
          f"throughput={res.tokens_per_s:.1f} tok/s")
    print("sample output ids:", res.tokens[0][:16].tolist())
    return res


if __name__ == "__main__":
    main()
