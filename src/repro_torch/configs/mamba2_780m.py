"""mamba2-780m [ssm]: 48L d=1536, attention-free SSD (state-space duality),
ssm_state=128, headdim=64, expand=2, vocab=50280.  [arXiv:2405.21060]
The same CONFIG and SMOKE as `repro.configs.mamba2_780m`."""
import dataclasses

from repro_torch.models.lm.config import LMConfig

CONFIG = LMConfig(
    name="mamba2-780m", family="ssm", n_layers=48, d_model=1536,
    n_heads=0, n_kv_heads=0, head_dim=0, d_ff=0, vocab=50_280,
    mlp="none", norm="rmsnorm", ssm_state=128, ssm_expand=2,
    ssm_head_dim=64, ssm_chunk=128, tie_embeddings=True)

SMOKE = dataclasses.replace(
    CONFIG, name="mamba2-smoke", n_layers=4, d_model=64, vocab=256,
    ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
