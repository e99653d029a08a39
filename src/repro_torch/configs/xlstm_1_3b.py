from repro_torch.models.config import ModelConfig

# xLSTM 1.3B [arXiv:2405.04517]
# ssm: 48L d_model=2048, 4 heads, mLSTM:sLSTM 7:1 (every 8th layer sLSTM),
# no FFN (the cells carry their own expansion), vocab=50304.  Across
# sequence shards the mLSTM hands its constant-size state on; the sLSTM
# is sequential and runs over the gathered sequence.
_blocks = tuple("slstm" if i % 8 == 7 else "mlstm" for i in range(48))
CONFIG = ModelConfig(
    name="xlstm-1.3b", arch_type="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304, blocks=_blocks,
    norm_kind="rmsnorm", pos="none", ssm_heads=4, ssm_expand=2,
    tie_embeddings=False,
    source="arXiv:2405.04517",
)
