"""stablelm-3b [dense]: 32L d_model=2560 32H (GQA kv=32) d_ff=6912 vocab=50304.

[hf:stabilityai/stablelm-2-1_6b family; unverified]  d_head = 2560/32 = 80.
RMSNorm+SwiGLU+full-RoPE stand-ins for StableLM's LN/partial-rotary; dims
are exact.  Small enough to train with Adam and serve fully TP-sharded.
Port of ``repro/configs/stablelm_3b.py``.
"""
from repro_torch.configs.lm_common import register_lm
from repro_torch.models.transformer import TransformerConfig


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name="stablelm-3b",
        n_layers=32,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_ff=6912,
        vocab=50304,
        d_head=80,
        rope_theta=10000.0,
        seq_shard=False,
        remat_groups=8,
    )


register_lm(
    "stablelm-3b",
    make_config(),
    opt_kind="adam",
    fsdp_serve=False,
    kind="lm-dense",
    notes="RMSNorm+SwiGLU+full-RoPE stand-ins for StableLM's LN/partial-rotary "
    "(DESIGN.md §6); dims are exact.",
)
