"""llama3-405b [dense]: 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256.  [arXiv:2407.21783]

KV heads (8) are replicated across a 16-way `model` axis
(``TransformerConfig.kv_sharded``).  Port of ``repro/configs/llama3_405b.py``;
the registry entry waits for the LM training slice.
"""
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
    )
