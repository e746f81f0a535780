"""qwen2-72b [dense]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064,
QKV bias.  [arXiv:2407.10671; hf]

Port of ``repro/configs/qwen2_72b.py``.
"""
from repro_torch.configs.lm_common import register_lm
from repro_torch.models.transformer import TransformerConfig


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2-72b",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=29568,
        vocab=152064,
        d_head=128,
        qkv_bias=True,
        rope_theta=1000000.0,
        seq_shard=True,
        remat_groups=10,
        q_block=512,
        microbatches=2,
    )


register_lm(
    "qwen2-72b",
    make_config(),
    opt_kind="adam",
    fsdp_serve=True,
    kind="lm-dense",
    notes="QKV bias enabled per the published config; bf16 weights (144 GB) "
    "kept FSDP-sharded for serving headroom next to the 32k KV cache.",
)
