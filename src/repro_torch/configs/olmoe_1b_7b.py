"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (GQA kv=16) d_ff=1024 vocab=50304,
MoE 64 experts top-8 (no dense residual).  [arXiv:2409.02060]

d_ff=1024 is the per-expert hidden dim (OLMoE's fine-grained experts); 64/16
= 4 experts per chip on the 16-way `model` axis.  Port of
``repro/configs/olmoe_1b_7b.py``; the registry entry waits for the LM
training slice (``configs/__init__.py``'s ``NOT_PORTED``).
"""
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name="olmoe-1b-7b",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1024,
        vocab=50304,
        d_head=128,
        rope_theta=10000.0,
        moe=MoEConfig(num_experts=64, top_k=8, d_ff=1024, capacity_factor=1.25),
        moe_dense_residual=False,
    )
