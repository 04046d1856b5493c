"""End-to-end example: train a ~100M-parameter LM with the full loop —
deterministic data, grad accumulation, AdamW + cosine, async
checkpointing, watchdog, restart.

Port of ``examples/train_lm.py``. Runs on the card unless ``--device cpu``
is given; the checkpoints go to ``--ckpt-dir`` (by default a directory
under the system's temporary directory), and re-running resumes from the
newest one.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig
from repro_torch.training.loop import TrainConfig, train
from repro_torch.training.optim import AdamWConfig

# ~100M decoder (qwen3-flavored: GQA + qk-norm)
GPT_100M = ArchConfig(
    name="gpt-100m",
    family="dense",
    n_layers=12,
    d_model=640,
    n_heads=10,
    n_kv_heads=2,
    d_ff=2560,
    vocab_size=32000,
    d_head=64,
    qk_norm=True,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_gpt100m"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    shapes = M.model_param_shapes(GPT_100M)
    print(f"model: {GPT_100M.name}  params "
          f"{M.count_params(shapes) / 1e6:.1f}M  device={dev}")

    tcfg = TrainConfig(
        steps=args.steps,
        seq_len=args.seq_len,
        global_batch=args.global_batch,
        microbatches=args.microbatches,
        opt=AdamWConfig(lr_peak=6e-4, warmup_steps=max(args.steps // 10, 5),
                        total_steps=args.steps),
        ckpt_dir=args.ckpt_dir,
        ckpt_every=max(args.steps // 3, 10),
        log_every=5,
    )
    params, hist = train(GPT_100M, tcfg, seed=0, device=dev)
    print(f"\nloss {hist[0]['loss_total']:.4f} -> "
          f"{hist[-1]['loss_total']:.4f} over {len(hist)} steps")
    print(f"checkpoints in {args.ckpt_dir} (restart by re-running)")
    return hist


if __name__ == "__main__":
    main()
