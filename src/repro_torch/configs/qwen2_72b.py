"""qwen2-72b [dense]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064,
QKV bias.  [arXiv:2407.10671; hf]

Port of ``repro/configs/qwen2_72b.py``; the registry entry waits for the LM
training slice.
"""
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
    )
