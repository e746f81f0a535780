"""llama3-405b [dense]: 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256.  [arXiv:2407.21783]

KV heads (8) are replicated across a 16-way `model` axis
(``TransformerConfig.kv_sharded``).  Trains with Adafactor, a
sequence-parallel residual stream and 14x9 sqrt-remat; serving keeps FSDP
sharding.  Port of ``repro/configs/llama3_405b.py``.
"""
from repro_torch.configs.lm_common import register_lm
from repro_torch.models.transformer import TransformerConfig


def make_config() -> TransformerConfig:
    return TransformerConfig(
        name="llama3-405b",
        n_layers=126,
        d_model=16384,
        n_heads=128,
        n_kv_heads=8,
        d_ff=53248,
        vocab=128256,
        d_head=128,
        rope_theta=500000.0,
        seq_shard=True,
        remat_groups=14,
        q_block=512,
        microbatches=4,
    )


register_lm(
    "llama3-405b",
    make_config(),
    opt_kind="adafactor",
    fsdp_serve=True,
    kind="lm-dense",
    notes="kv heads (8) replicated across the 16-way model axis (standard GQA "
    "TP practice).",
)
