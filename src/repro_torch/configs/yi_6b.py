from repro_torch.models.config import ModelConfig

# Yi 6B [arXiv:2403.04652]
# dense llama-arch: 32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
CONFIG = ModelConfig(
    name="yi-6b", arch_type="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=11008, vocab_size=64000,
    mlp_kind="swiglu", norm_kind="rmsnorm", pos="rope", rope_theta=5e6,
    tie_embeddings=False,
    source="arXiv:2403.04652",
)
