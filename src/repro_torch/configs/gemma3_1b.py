from repro_torch.models.config import ModelConfig

# Gemma 3 1B [hf:google/gemma-3-1b-pt]
# dense: 26L d_model=1152 4H (MQA kv=1) d_ff=6912 vocab=262144,
# 5:1 local(sliding-window 512):global attention, head_dim=256,
# dual rope theta (local 10k / global 1M), qk-norm, 128k-class context.
_blocks = tuple("attn" if (i + 1) % 6 == 0 else "attn_local"
                for i in range(26))
CONFIG = ModelConfig(
    name="gemma3-1b", arch_type="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
    d_ff=6912, vocab_size=262144, blocks=_blocks,
    mlp_kind="geglu", norm_kind="rmsnorm", pos="rope",
    rope_theta=1e6, rope_theta_local=10000.0, qk_norm=True,
    embed_scale=True, window=512, tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt",
)
