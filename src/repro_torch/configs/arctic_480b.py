"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 **plus a dense residual FFN in parallel**
(Snowflake Arctic's dense-MoE hybrid).  [hf:Snowflake/snowflake-arctic-base]

On the 16-way `model` axis the 56 heads are padded to 64
(``TransformerConfig.padded_heads``) and the experts shard 128/16 = 8 per
chip.  The padded heads' ``wo`` rows are drawn like the others, as the
reference's ``init_params`` draws them, so they are not inert (ROADMAP,
Quirks).  Port of ``repro/configs/arctic_480b.py``.
"""
from repro_torch.models.moe import MoEConfig
from repro_torch.configs.lm_common import register_lm
from repro_torch.models.transformer import TransformerConfig


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name="arctic-480b",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=4864,
        vocab=32000,
        d_head=128,
        rope_theta=10000.0,
        moe=MoEConfig(num_experts=128, top_k=2, d_ff=4864, capacity_factor=1.25),
        moe_dense_residual=True,
        seq_shard=True,
        remat_groups=7,
        q_block=512,
        microbatches=4,
    )


register_lm(
    "arctic-480b",
    make_config(),
    opt_kind="adafactor",
    fsdp_serve=True,
    kind="lm-moe",
    notes="Expert dispatch follows the hierarchical-pooling pattern: each "
    "expert shard computes partial token outputs, one psum combines "
    "(models/moe.py).",
)
