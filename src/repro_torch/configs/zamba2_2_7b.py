from repro_torch.models.config import ModelConfig

# Zamba2 2.7B [arXiv:2411.15242]
# hybrid: 54 layers, Mamba2 blocks (d_state 64, 32 SSM heads of 160,
# conv 4) with one SHARED attention + MLP block at every 6th layer: one
# weight set over 9 layers, each with a cache of its own.  d_model 2560,
# 32 heads of 80 (MHA), shared-MLP d_ff 10240 (GELU), vocab 32000.
# Across sequence shards the Mamba2 conv takes the previous shard's last
# rows as its halo and the SSM state is handed on.
_blocks = tuple("shared_attn" if i % 6 == 5 else "mamba" for i in range(54))
CONFIG = ModelConfig(
    name="zamba2-2.7b", arch_type="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=10240, vocab_size=32000, blocks=_blocks,
    mlp_kind="gelu", norm_kind="rmsnorm", pos="rope",
    ssm_state=64, ssm_heads=32, ssm_expand=2, ssm_conv=4,
    shared_attn_every=6, tie_embeddings=False,
    source="arXiv:2411.15242",
)
