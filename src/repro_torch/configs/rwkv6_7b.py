"""rwkv6-7b — Finch: attention-free, data-dependent decay
[arXiv:2404.05892; hf].

32L d_model=4096 (64 heads of 64) d_ff=14336 vocab=65536. O(1) recurrent
state => long_500k runs. The serving prefix cache stores state snapshots
instead of KV pages (DESIGN.md SS5)."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm", n_layers=32, d_model=4096, n_heads=64,
    n_kv_heads=64, d_ff=14336, vocab_size=65536, head_dim=64,
    pattern=("rwkv",), sub_quadratic=True)

REDUCED = ModelConfig(
    name="rwkv6-7b-smoke", family="ssm", n_layers=4, d_model=256, n_heads=4,
    n_kv_heads=4, d_ff=512, vocab_size=512, head_dim=64, pattern=("rwkv",),
    sub_quadratic=True, remat="none")
