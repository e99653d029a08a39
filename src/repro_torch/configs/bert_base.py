from repro_torch.models.config import ModelConfig

# BERT-base [NAACL 2019] — the paper's NLU model (Table V).
CONFIG = ModelConfig(
    name="bert-base", arch_type="dense",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=3072, vocab_size=30522, num_classes=2,
    mlp_kind="gelu", norm_kind="layernorm", pos="learned", causal=False,
    attn_bias=True, max_seq=512,
    source="NAACL 2019 (Devlin et al.)",
)
