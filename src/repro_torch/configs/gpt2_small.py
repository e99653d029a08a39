from repro_torch.models.config import ModelConfig

# GPT-2 small [Radford et al. 2019] — the paper's AR model (Table VI).
CONFIG = ModelConfig(
    name="gpt2-small", arch_type="dense",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=3072, vocab_size=50257,
    mlp_kind="gelu", norm_kind="layernorm", pos="learned", causal=True,
    attn_bias=True, max_seq=1024, tie_embeddings=True,
    source="GPT-2 (Radford et al., 2019)",
)
