"""mistral-nemo-12b — 128k-context dense GQA
[hf:mistralai/Mistral-Nemo-Base-2407; hf].

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072; head_dim=128
(explicit — Nemo does NOT use d_model/n_heads=160). Full attention =>
long_500k skipped."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b", family="dense", n_layers=40, d_model=5120,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=131072, head_dim=128,
    rope_theta=1_000_000.0, pattern=("dense",), sub_quadratic=False)

REDUCED = ModelConfig(
    name="mistral-nemo-12b-smoke", family="dense", n_layers=4, d_model=256,
    n_heads=4, n_kv_heads=2, d_ff=512, vocab_size=1024, head_dim=64,
    rope_theta=1_000_000.0, pattern=("dense",), q_chunk=64, kv_chunk=64,
    remat="none")
