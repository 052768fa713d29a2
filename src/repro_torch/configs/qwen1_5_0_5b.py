"""qwen1.5-0.5b [dense]: 24L d=1024 16H (kv=16 -> MHA) ff=2816
vocab=151936 — QKV bias.  [hf:Qwen/Qwen1.5-0.5B; hf]
The same CONFIG and SMOKE as `repro.configs.qwen1_5_0_5b`."""
import dataclasses

from repro_torch.models.lm.config import LMConfig

CONFIG = LMConfig(
    name="qwen1.5-0.5b", family="dense", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, head_dim=64, d_ff=2816, vocab=151_936,
    qkv_bias=True, rope_theta=1e6, mlp="swiglu", norm="rmsnorm",
    tie_embeddings=True)

SMOKE = dataclasses.replace(
    CONFIG, name="qwen1.5-smoke", n_layers=3, d_model=64, n_heads=4,
    n_kv_heads=4, head_dim=16, d_ff=128, vocab=256)
