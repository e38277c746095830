"""mixtral-8x7b — 8-expert top-2 MoE with SWA [arXiv:2401.04088; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=14336/expert vocab=32000, MoE 8e top-2.
SWA(4096) as assigned => sub-quadratic => long_500k runs."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe", n_layers=32, d_model=4096, n_heads=32,
    n_kv_heads=8, d_ff=14336, vocab_size=32000, head_dim=128,
    rope_theta=1_000_000.0, sliding_window=4096, pattern=("moe",),
    n_experts=8, top_k=2, sub_quadratic=True)

REDUCED = ModelConfig(
    name="mixtral-8x7b-smoke", family="moe", n_layers=2, d_model=256,
    n_heads=4, n_kv_heads=2, d_ff=512, vocab_size=512, head_dim=64,
    rope_theta=1_000_000.0, sliding_window=64, pattern=("moe",), n_experts=4,
    top_k=2, q_chunk=64, kv_chunk=64, sub_quadratic=True, remat="none")
