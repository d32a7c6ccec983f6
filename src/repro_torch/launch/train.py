"""End-to-end training launcher: the JAX package's ``repro.launch.train``
on the port.  Every arch trains: the dense GQA models (smollm-135m,
tinyllama-1.1b, granite-3-8b, qwen2.5-32b), the MoE ones (the MoE aux
loss in the loss; deepseek-v2-236b with MLA, llama4-scout-17b-a16e),
the recurrent ones (rwkv6-7b, jamba-v0.1-52b) and the audio and vision
ones (whisper-medium, paligemma-3b: each batch carries its frontend
stub, drawn as the JAX trainer draws it).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --smoke --steps 20 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-7b \\
        --smoke --steps 5 --device cpu --rns
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --steps 50 --rns      # full width on the card, through RNS

``--rns`` routes the MLP matmuls, forward and backward, through the RNS
datapath (16-bit operands, ``--rns-profile``), on the card's kernels
(``cuda``, or ``--rns-backend cuda_fused``) and on the plain PyTorch
path with ``--device cpu``.  On the card every step is one captured
program (``train/train_step.py``); ``--eager`` runs it without graphs.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging

from repro_torch.configs.base import get_config, list_archs
from repro_torch.core.rns_matmul import RnsDotConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=list_archs(),
                    help="any of the ten archs: " + ", ".join(list_archs()))
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced smoke twin")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="repro_train")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--rns", action="store_true",
                    help="route MLP matmuls through the RNS datapath")
    ap.add_argument("--rns-profile", default="rns9")
    ap.add_argument("--rns-backend", default=None,
                    choices=("reference", "cuda", "cuda_fused"),
                    help="default: the card's kernels (cuda) on a CUDA "
                         "device, the plain path on the CPU")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--eager", action="store_true",
                    help="run each step eagerly, without a captured graph")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.rns:
        cfg = dataclasses.replace(
            cfg, rns=RnsDotConfig(profile=args.rns_profile, qx=16, qw=16,
                                  backend=args.rns_backend),
            rns_targets="mlp")
    trainer = Trainer(
        cfg,
        AdamWConfig(lr=args.lr, warmup_steps=max(10, args.steps // 20),
                    total_steps=args.steps),
        TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                      ckpt_dir=args.ckpt_dir),
        DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                   global_batch=args.batch),
        device=args.device, graphs=not args.eager)
    _, history = trainer.run()
    print(f"final loss: {history[-1]:.4f} (from {history[0]:.4f})")
    return history


if __name__ == "__main__":
    main()
