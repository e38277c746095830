"""End-to-end training on PyTorch (the port, ``repro_torch``): a ~100M-param
dense LM through the fault-tolerant trainer (atomic checkpoints, the
straggler monitor, the Dash-LH dedup stage in the data pipeline).

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 30] [--d-model 512]
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu

Twin of ``examples/train_lm.py``; runs on the card unless ``--device`` names
another. On a card run with --steps 300.
"""
import argparse
import os
import tempfile

from repro_torch.launch.train import batch_iter
from repro_torch.models.transformer import ModelConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_example_ckpt"))
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    # ~100M params at --d-model 768 --layers 12 (GPT-2-small-ish shape)
    cfg = ModelConfig(
        name="example-lm", family="dense", n_layers=args.layers,
        d_model=args.d_model, n_heads=max(4, args.d_model // 64),
        n_kv_heads=max(2, args.d_model // 128), d_ff=args.d_model * 4,
        vocab_size=8192, head_dim=64, remat="none", q_chunk=128, kv_chunk=256)
    print(f"model: {cfg.param_count() / 1e6:.1f}M params")

    tcfg = TrainerConfig(total_steps=args.steps, checkpoint_every=10,
                         checkpoint_dir=args.ckpt)
    trainer = Trainer(cfg, tcfg, batch_iter(cfg, args.batch, args.seq, dedup=True,
                                            device=args.device), device=args.device)
    result = trainer.run()
    losses = [m["loss"] for m in result["log"] if "loss" in m]
    print(f"steps={result['final_step']} loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"restarts={result['restarts']} stragglers={len(result['stragglers'])}")
    return result


if __name__ == "__main__":
    main()
