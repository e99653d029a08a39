from repro_torch.models.config import ModelConfig

# OLMoE 1B-7B [arXiv:2409.02060]
# moe: 16L d_model=2048 16H (kv=16), 64 experts top-8, expert d_ff=1024,
# qk-norm, vocab=50304.
CONFIG = ModelConfig(
    name="olmoe-1b-7b", arch_type="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1024, vocab_size=50304, blocks=("moe",) * 16,
    mlp_kind="swiglu", norm_kind="rmsnorm", pos="rope", qk_norm=True,
    n_experts=64, top_k=8, expert_d_ff=1024, tie_embeddings=False,
    source="arXiv:2409.02060",
)
