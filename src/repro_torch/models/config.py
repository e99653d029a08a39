"""Unified model configuration covering all assigned architecture families."""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 => d_model // n_heads
    # block pattern: one kind per layer; kinds:
    #   attn, attn_local, moe, mlstm, slstm, mamba, shared_attn
    blocks: tuple = ()             # () => ('attn',) * n_layers
    mlp_kind: str = "swiglu"
    norm_kind: str = "rmsnorm"
    pos: str = "rope"              # rope | learned | sincos | none
    rope_theta: float = 10000.0
    rope_theta_local: float = 10000.0   # gemma3 dual-theta
    causal: bool = True
    attn_bias: bool = False
    qk_norm: bool = False
    logit_softcap: Optional[float] = None
    parallel_block: bool = False   # command-r: attn & mlp from one norm
    tie_embeddings: bool = True
    embed_scale: bool = False      # gemma-style sqrt(d) input scaling
    window: Optional[int] = None   # sliding window for attn_local layers
    max_seq: int = 524288
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    moe_dense_d_ff: int = 0        # arctic: parallel dense-residual FFN
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # --- SSM ---
    ssm_state: int = 0             # mamba2 d_state
    ssm_heads: int = 0             # mlstm / mamba heads (0 => n_heads)
    ssm_expand: int = 2
    ssm_conv: int = 4
    shared_attn_every: int = 0     # zamba2: shared attn block cadence
    # --- stub frontends (assignment carve-out) ---
    frontend: Optional[str] = None  # 'siglip_stub' | 'encodec_stub' | None
    prefix_len: int = 0            # VLM image-prefix length (bidirectional)
    num_classes: int = 0           # encoder classification head (ViT/BERT)
    scan_layers: bool = True       # lax.scan over repeated units (compile
                                   # time ~O(unit)); False = fully unrolled
    attn_block: int = 0            # >0: stream attention K/V in blocks of
                                   # this size (flash-style; §Perf H3)
    source: str = ""               # citation

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def block_kinds(self) -> tuple:
        if self.blocks:
            assert len(self.blocks) == self.n_layers, (
                f"{self.name}: blocks pattern length {len(self.blocks)} != "
                f"n_layers {self.n_layers}")
            return self.blocks
        return ("attn",) * self.n_layers

    @property
    def n_ssm_heads(self) -> int:
        return self.ssm_heads or self.n_heads

    @property
    def scan_split(self) -> tuple:
        """(unit, n_units, n_tail): layers are stored as ``unit`` stacked
        trees of depth ``n_units`` (scanned — compile time independent of
        depth) plus ``n_tail`` unrolled remainder layers.  ``unit`` is the
        smallest period of the block-kind pattern (1 for uniform stacks,
        8 for xlstm's 7:1 mLSTM:sLSTM, 6 for zamba2/gemma3)."""
        kinds = self.block_kinds
        n = len(kinds)
        if not self.scan_layers:
            return n, 1, 0
        for u in range(1, n + 1):
            n_units = n // u
            if n_units == 0:
                break
            if all(kinds[i] == kinds[i % u] for i in range(n_units * u)):
                return u, n_units, n - n_units * u
        return n, 1, 0

    def reduced(self, *, n_layers: int = 2, d_model: int = 256,
                vocab: int = 512, n_experts: int = 4) -> "ModelConfig":
        """Smoke-test variant: same family, tiny dims (prompt contract:
        <=2 layers, d_model<=512, <=4 experts)."""
        assert d_model <= 512
        shrink = d_model / self.d_model
        def sc(v, lo=1):
            return max(lo, int(round(v * shrink)))
        n_heads = max(1, min(self.n_heads, 4))
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        kinds = self.block_kinds[:n_layers]
        # keep family diversity in the reduced pattern (e.g. one mamba +
        # one shared_attn for zamba2; one mlstm + one slstm for xlstm)
        uniq = []
        for k in self.block_kinds:
            if k not in uniq:
                uniq.append(k)
        kinds = tuple((uniq * n_layers)[:n_layers])
        return replace(
            self,
            name=self.name + "-smoke",
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=min(64, d_model // n_heads),
            d_ff=sc(self.d_ff) if self.d_ff else 0,
            vocab_size=vocab,
            blocks=kinds,
            n_experts=min(self.n_experts, n_experts) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            expert_d_ff=sc(self.expert_d_ff) if self.expert_d_ff else 0,
            moe_dense_d_ff=sc(self.moe_dense_d_ff) if self.moe_dense_d_ff else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_heads=min(self.n_ssm_heads, 2) if self.ssm_heads or self.arch_type in ("ssm", "hybrid") else 0,
            window=min(self.window, 16) if self.window else None,
            prefix_len=min(self.prefix_len, 8) if self.prefix_len else 0,
            max_seq=4096,
            shared_attn_every=min(self.shared_attn_every, 2) if self.shared_attn_every else 0,
        )
