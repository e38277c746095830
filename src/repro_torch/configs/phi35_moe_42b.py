"""phi3.5-moe-42b-a6.6b — 16-expert top-2 MoE
[hf:microsoft/Phi-3.5-MoE-instruct; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=6400/expert vocab=32064, MoE 16e top-2.
Full attention => long_500k skipped. Expert axis shards over 'model' (EP)."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=6400, vocab_size=32064, head_dim=128,
    rope_theta=10_000.0, pattern=("moe",), n_experts=16, top_k=2,
    sub_quadratic=False)

REDUCED = ModelConfig(
    name="phi3.5-moe-smoke", family="moe", n_layers=2, d_model=256, n_heads=4,
    n_kv_heads=2, d_ff=512, vocab_size=512, head_dim=64, rope_theta=10_000.0,
    pattern=("moe",), n_experts=4, top_k=2, q_chunk=64, kv_chunk=64,
    remat="none")
