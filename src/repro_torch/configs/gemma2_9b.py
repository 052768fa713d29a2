"""gemma2-9b [dense]: 42L d=3584 16H (GQA kv=8, head_dim 256) ff=14336
vocab=256000 — alternating local(4096)/global attention, logit softcaps,
sandwich norms, GeGLU, tied + scaled embeddings.  [arXiv:2408.00118; hf]
The same CONFIG and SMOKE as `repro.configs.gemma2_9b`."""
import dataclasses

from repro_torch.models.lm.config import LMConfig

CONFIG = LMConfig(
    name="gemma2-9b", family="dense", n_layers=42, d_model=3584,
    n_heads=16, n_kv_heads=8, head_dim=256, d_ff=14336, vocab=256_000,
    rope_theta=10_000.0, attn_softcap=50.0, final_softcap=30.0,
    window=4096, layer_pattern="local_global", mlp="geglu",
    norm="rmsnorm", sandwich_norm=True, scale_embedding=True,
    tie_embeddings=True)

SMOKE = dataclasses.replace(
    CONFIG, name="gemma2-smoke", n_layers=4, d_model=64, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=128, vocab=256, window=16)
