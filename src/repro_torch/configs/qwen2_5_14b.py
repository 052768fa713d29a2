"""qwen2.5-14b [dense]: 48L d=5120 40H (GQA kv=8) ff=13824 vocab=152064 —
GQA with QKV bias, SwiGLU, RMSNorm, rope 1e6.  [hf:Qwen/Qwen2.5; hf]
The same CONFIG and SMOKE as `repro.configs.qwen2_5_14b`."""
import dataclasses

from repro_torch.models.lm.config import LMConfig

CONFIG = LMConfig(
    name="qwen2.5-14b", family="dense", n_layers=48, d_model=5120,
    n_heads=40, n_kv_heads=8, head_dim=128, d_ff=13824, vocab=152_064,
    qkv_bias=True, rope_theta=1e6, mlp="swiglu", norm="rmsnorm",
    tie_embeddings=False)

SMOKE = dataclasses.replace(
    CONFIG, name="qwen2.5-smoke", n_layers=3, d_model=64, n_heads=8,
    n_kv_heads=2, head_dim=8, d_ff=160, vocab=256)
