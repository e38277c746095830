"""yi-6b — llama-arch dense GQA [arXiv:2403.04652; hf].

32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000. Full attention
=> long_500k skipped (quadratic; DESIGN.md SS5)."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b", family="dense", n_layers=32, d_model=4096, n_heads=32,
    n_kv_heads=4, d_ff=11008, vocab_size=64000, head_dim=128,
    rope_theta=5_000_000.0, pattern=("dense",), sub_quadratic=False)

REDUCED = ModelConfig(
    name="yi-6b-smoke", family="dense", n_layers=4, d_model=256, n_heads=4,
    n_kv_heads=2, d_ff=512, vocab_size=512, head_dim=64,
    rope_theta=5_000_000.0, pattern=("dense",), q_chunk=64, kv_chunk=64,
    remat="none")
