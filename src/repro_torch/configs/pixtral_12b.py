"""pixtral-12b [vlm]: 40L d=5120 32H (GQA kv=8) ff=14336 vocab=131072 —
mistral-nemo decoder backbone; the pixtral-ViT frontend is a stub: the
caller supplies precomputed patch embeddings (B, S_img, d), prefixed to
the text tokens.  [hf:mistralai/Pixtral-12B-2409; unverified]
The same CONFIG and SMOKE as `repro.configs.pixtral_12b`."""
import dataclasses

from repro_torch.models.lm.config import LMConfig

CONFIG = LMConfig(
    name="pixtral-12b", family="vlm", n_layers=40, d_model=5120,
    n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336, vocab=131_072,
    rope_theta=1e9, mlp="swiglu", norm="rmsnorm", tie_embeddings=False,
    frontend="vit_stub", frontend_len=1024)

SMOKE = dataclasses.replace(
    CONFIG, name="pixtral-smoke", n_layers=3, d_model=64, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=128, vocab=256, frontend_len=8)
