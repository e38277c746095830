"""musicgen-large — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

48L d_model=2048 32H (kv=32: full MHA) d_ff=8192 vocab=2048. The EnCodec
frontend is a STUB: input_specs() provides precomputed frame embeddings
(B, S, d); labels are codebook tokens over vocab 2048. Full attention =>
long_500k skipped."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio", n_layers=48, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab_size=2048, head_dim=64,
    rope_theta=10_000.0, pattern=("dense",), sub_quadratic=False)

REDUCED = ModelConfig(
    name="musicgen-large-smoke", family="audio", n_layers=4, d_model=256,
    n_heads=4, n_kv_heads=4, d_ff=512, vocab_size=256, head_dim=64,
    rope_theta=10_000.0, pattern=("dense",), q_chunk=64, kv_chunk=64,
    remat="none")
