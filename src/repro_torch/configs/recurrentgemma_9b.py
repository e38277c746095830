"""recurrentgemma-9b — Griffin hybrid: RG-LRU + local attention, 1:2 ratio
[arXiv:2402.19427; unverified].

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000. Pattern
(rglru, rglru, local) x 12 + (rglru, rglru) tail = 38 layers. O(1)/windowed
state => long_500k runs."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid", n_layers=38, d_model=4096,
    n_heads=16, n_kv_heads=1, d_ff=12288, vocab_size=256000, head_dim=256,
    rope_theta=10_000.0, pattern=("rglru", "rglru", "local"),
    local_window=2048, d_rnn=4096, conv_width=4, sub_quadratic=True)

REDUCED = ModelConfig(
    name="recurrentgemma-9b-smoke", family="hybrid", n_layers=5, d_model=256,
    n_heads=4, n_kv_heads=1, d_ff=512, vocab_size=512, head_dim=64,
    rope_theta=10_000.0, pattern=("rglru", "rglru", "local"), local_window=64,
    d_rnn=256, conv_width=4, q_chunk=64, kv_chunk=64, sub_quadratic=True,
    remat="none")
