from repro_torch.models.config import ModelConfig

# Cohere Command-R 35B [hf:CohereForAI/c4ai-command-r-v01]
# dense: 40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000, no-bias,
# parallel attention/FFN residual block, LayerNorm.
CONFIG = ModelConfig(
    name="command-r-35b", arch_type="dense",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22528, vocab_size=256000,
    mlp_kind="swiglu", norm_kind="layernorm", pos="rope", rope_theta=8e6,
    attn_bias=False, parallel_block=True, tie_embeddings=True,
    source="hf:CohereForAI/c4ai-command-r-v01",
)
