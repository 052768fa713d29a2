"""seamless-m4t-large-v2 [audio]: enc-dec transformer backbone, 24L each,
d=1024 16H (kv=16) ff=8192 vocab=256206.  The speech frontend (w2v-BERT
feature extractor) is a stub: the encoder takes precomputed frame
embeddings (B, S_enc, d).  [arXiv:2308.11596; hf]
The same CONFIG and SMOKE as `repro.configs.seamless_m4t_large_v2`."""
import dataclasses

from repro_torch.models.lm.config import LMConfig

CONFIG = LMConfig(
    name="seamless-m4t-large-v2", family="audio", n_layers=24,
    d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64, d_ff=8192,
    vocab=256_206, mlp="gelu", norm="layernorm", n_enc_layers=24,
    frontend="audio_stub", tie_embeddings=True)

SMOKE = dataclasses.replace(
    CONFIG, name="seamless-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, head_dim=16, d_ff=128, vocab=256, n_enc_layers=2)
