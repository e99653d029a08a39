from repro_torch.models.config import ModelConfig

# MusicGen-medium decoder [arXiv:2306.05284]
# audio: 48L d_model=1536 24H (kv=24) d_ff=6144 vocab=2048 (EnCodec codes).
# The EnCodec codec is a stub: the prompt is precomputed frame
# embeddings (B, N, D) through ``frontend_proj``, with sinusoidal
# positions; decode feeds the generated codes through ``embed``.
CONFIG = ModelConfig(
    name="musicgen-medium", arch_type="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
    d_ff=6144, vocab_size=2048,
    mlp_kind="gelu", norm_kind="layernorm", pos="sincos",
    attn_bias=False, tie_embeddings=False, frontend="encodec_stub",
    source="arXiv:2306.05284",
)
