"""h2o-danube-3-4b — llama+mistral mix with sliding-window attention
[arXiv:2401.16818; unverified].

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000. SWA(4096) is
sub-quadratic => long_500k runs."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b", family="dense", n_layers=24, d_model=3840,
    n_heads=32, n_kv_heads=8, d_ff=10240, vocab_size=32000, head_dim=120,
    rope_theta=500_000.0, sliding_window=4096, pattern=("dense",),
    sub_quadratic=True)

REDUCED = ModelConfig(
    name="h2o-danube-3-4b-smoke", family="dense", n_layers=4, d_model=256,
    n_heads=4, n_kv_heads=2, d_ff=512, vocab_size=512, head_dim=64,
    rope_theta=500_000.0, sliding_window=64, pattern=("dense",),
    q_chunk=64, kv_chunk=64, sub_quadratic=True, remat="none")
