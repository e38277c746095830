"""llava-next-mistral-7b — VLM backbone (mistral-7b) with anyres tiling
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].

Backbone only: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.
The vision frontend is a STUB: input_specs() provides precomputed patch
embeddings (B, 576, d) prepended to the text sequence; labels cover only
the text suffix. Full attention => long_500k skipped."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=32000, head_dim=128,
    rope_theta=1_000_000.0, pattern=("dense",), num_patches=576,
    sub_quadratic=False)

REDUCED = ModelConfig(
    name="llava-next-mistral-7b-smoke", family="vlm", n_layers=4, d_model=256,
    n_heads=4, n_kv_heads=2, d_ff=512, vocab_size=512, head_dim=64,
    rope_theta=1_000_000.0, pattern=("dense",), num_patches=16,
    q_chunk=64, kv_chunk=64, remat="none")
