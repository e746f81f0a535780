"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (GQA kv=16) d_ff=1024 vocab=50304,
MoE 64 experts top-8 (no dense residual).  [arXiv:2409.02060]

d_ff=1024 is the per-expert hidden dim (OLMoE's fine-grained experts); 64/16
= 4 experts per chip on the 16-way `model` axis.  Port of
``repro/configs/olmoe_1b_7b.py``.
"""
from repro_torch.models.moe import MoEConfig
from repro_torch.configs.lm_common import register_lm
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
        seq_shard=False,
        remat_groups=4,
        microbatches=2,
    )


register_lm(
    "olmoe-1b-7b",
    make_config(),
    opt_kind="adam",
    fsdp_serve=False,
    kind="lm-moe",
    notes="d_ff=1024 is the per-expert hidden dim (OLMoE's fine-grained "
    "experts); 64/16 = 4 experts per chip.",
)
