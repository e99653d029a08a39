from repro_torch.models.config import ModelConfig

# Gemma 7B [arXiv:2403.08295]
# dense: 28L d_model=3072 16H (kv=16) d_ff=24576 vocab=256000, GeGLU,
# head_dim=256 (qkv wider than d_model), sqrt(d) embedding scale.
CONFIG = ModelConfig(
    name="gemma-7b", arch_type="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, vocab_size=256000,
    mlp_kind="geglu", norm_kind="rmsnorm", pos="rope", rope_theta=10000.0,
    embed_scale=True, tie_embeddings=True,
    source="arXiv:2403.08295",
)
