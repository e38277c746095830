"""glm4-9b — RoPE + GQA, 151k vocab [hf:THUDM/glm-4-9b; hf].

40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552. Full attention
=> long_500k skipped. The 151k vocab stresses vocab-TP (lm head)."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b", family="dense", n_layers=40, d_model=4096, n_heads=32,
    n_kv_heads=2, d_ff=13696, vocab_size=151552, head_dim=128,
    rope_theta=10_000.0, pattern=("dense",), sub_quadratic=False)

REDUCED = ModelConfig(
    name="glm4-9b-smoke", family="dense", n_layers=4, d_model=256, n_heads=4,
    n_kv_heads=2, d_ff=512, vocab_size=1024, head_dim=64,
    rope_theta=10_000.0, pattern=("dense",), q_chunk=64, kv_chunk=64,
    remat="none")
