"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Port of ``repro/launch/train.py``: runs the training loop
(``repro_torch.training.loop``) on one device, CUDA unless ``--device cpu``
is given (without a card the default fails loudly). ``--smoke`` takes the
reduced config, sized for the CPU; without it the config is the published
one. Whisper gets zero ``frames`` and the image-patch frontend zero
``patch_embeds``, as the reference's launcher gives them.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
        --smoke --steps 3 --device cpu
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.training.loop import TrainConfig, train
from repro_torch.training.optim import AdamWConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--compress", default="none",
                    choices=["none", "topk", "int8"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tcfg = TrainConfig(
        steps=args.steps, seq_len=args.seq_len,
        global_batch=args.global_batch, microbatches=args.microbatches,
        opt=AdamWConfig(lr_peak=args.lr, warmup_steps=max(args.steps // 20, 5),
                        total_steps=args.steps),
        grad_compress=args.compress, ckpt_dir=args.ckpt_dir)

    extra = {}
    stub = (args.global_batch // max(args.microbatches, 1),
            cfg.n_frontend_tokens, cfg.frontend_dim)
    if cfg.encdec:
        extra["frames"] = torch.zeros(stub, dtype=torch.float32, device=dev)
    if cfg.frontend == "image_patches":
        extra["patch_embeds"] = torch.zeros(stub, dtype=torch.float32,
                                            device=dev)

    params, history = train(cfg, tcfg, extra_batch=extra or None, device=dev)
    print(f"final loss: {history[-1]['loss_total']:.4f} "
          f"({len(history)} steps) device={dev}")
    return params, history


if __name__ == "__main__":
    main()
