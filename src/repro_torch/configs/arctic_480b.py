from repro_torch.models.config import ModelConfig

# Snowflake Arctic 480B [hf:Snowflake/snowflake-arctic-base]
# moe: 35L d_model=7168 56H (GQA kv=8), 128 experts top-2 (expert
# d_ff=4864) + parallel dense-residual FFN, vocab=32000.
CONFIG = ModelConfig(
    name="arctic-480b", arch_type="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=4864, vocab_size=32000, blocks=("moe",) * 35,
    mlp_kind="swiglu", norm_kind="rmsnorm", pos="rope",
    n_experts=128, top_k=2, expert_d_ff=4864, moe_dense_d_ff=4864,
    tie_embeddings=False,
    source="hf:Snowflake/snowflake-arctic-base",
)
