"""End-to-end training launcher: ``python -m repro_torch.launch.train --arch
<id>`` — the twin of ``python -m repro.launch.train``, on the card unless
``--device`` names another (``--device cpu`` off the card).

Runs a reduced (default) or full config through the fault-tolerant trainer.
``--dedup`` routes the documents through the port's ``DedupFilter``, a
``DashLH`` on the trainer's device: a document whose content hash is
already in the table is skipped. See examples/train_lm_torch.py for the
~100M-param recipe.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data import DedupFilter, PackedBatcher, PipelineConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def make_batcher(cfg, batch_size: int, seq_len: int, dedup: bool, device=None) -> PackedBatcher:
    """The launcher's packed batcher: 5 % aliased documents and a
    ``DedupFilter`` on ``device`` with ``dedup``, neither without."""
    pc = PipelineConfig(vocab_size=cfg.vocab_size, seq_len=seq_len, batch_size=batch_size,
                        dup_fraction=0.05 if dedup else 0.0)
    return PackedBatcher(pc, dedup=DedupFilter(device=device) if dedup else None)


def batch_iter(cfg, batch_size: int, seq_len: int, dedup: bool, device=None, batcher=None):
    """Batches of numpy arrays for ``cfg``'s front: tokens and labels; for
    vlm also (B, num_patches, d) patch embeddings, for audio (B, S, d) frame
    embeddings and the labels modulo the vocabulary (both drawn from a
    seeded normal, as the reference's). ``batcher`` defaults to
    ``make_batcher``'s."""
    batcher = batcher or make_batcher(cfg, batch_size, seq_len, dedup, device)
    if cfg.family == "vlm":
        rng = np.random.default_rng(0)
        for b in batcher:
            P = cfg.num_patches
            yield {"tokens": b["tokens"], "labels": b["labels"],
                   "patch_embeds": rng.normal(
                       0, 1, (batch_size, P, cfg.d_model)).astype(np.float32)}
    elif cfg.family == "audio":
        rng = np.random.default_rng(0)
        for b in batcher:
            yield {"frame_embeds": rng.normal(
                0, 1, (batch_size, seq_len, cfg.d_model)).astype(np.float32),
                "labels": b["labels"] % cfg.vocab_size}
    else:
        yield from batcher


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b", choices=list(ARCH_IDS))
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--dedup", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    tcfg = TrainerConfig(total_steps=args.steps, checkpoint_every=args.ckpt_every,
                         checkpoint_dir=args.ckpt_dir)
    it = batch_iter(cfg, args.batch, args.seq, args.dedup, args.device)
    trainer = Trainer(cfg, tcfg, it, device=args.device)
    if args.resume:
        resumed = trainer.resume_if_possible()
        if resumed is not None:
            print(f"[train] resumed from step {resumed}")
    result = trainer.run()
    losses = [m["loss"] for m in result["log"] if "loss" in m]
    print(f"[train] {args.arch} done: steps={result['final_step']} "
          f"first_loss={losses[0]:.4f} last_loss={losses[-1]:.4f} "
          f"restarts={result['restarts']}")
    print(json.dumps({"first_loss": losses[0], "last_loss": losses[-1],
                      "stragglers": len(result["stragglers"])}))
    return result


if __name__ == "__main__":
    main()
