from repro_torch.models.config import ModelConfig

# ViT-B/16 [arXiv:2010.11929] — the paper's vision model (Tables II, IV).
# 12L d=768 12H d_ff=3072, 196 patches + CLS = 197 tokens, encoder.
# Patch-embedding conv is provided as flattened-patch dense (stub-style).
CONFIG = ModelConfig(
    name="vit-b16", arch_type="dense",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=3072, vocab_size=0, num_classes=1000,
    mlp_kind="gelu", norm_kind="layernorm", pos="learned", causal=False,
    attn_bias=True, max_seq=224, frontend="patch_stub",
    source="arXiv:2010.11929",
)
