from repro_torch.models.config import ModelConfig

# PaliGemma 3B [arXiv:2407.07726]
# vlm: 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=257216.
# The SigLIP vision tower is a stub: 256 patch embeddings go through
# ``frontend_proj`` and overwrite the first 256 token positions, which
# attend bidirectionally (prefix-LM, ``prefix_len``).
CONFIG = ModelConfig(
    name="paligemma-3b", arch_type="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=257216,
    mlp_kind="geglu", norm_kind="rmsnorm", pos="rope",
    embed_scale=True, tie_embeddings=True,
    frontend="siglip_stub", prefix_len=256,
    source="arXiv:2407.07726",
)
