"""mind [recsys]: embed_dim=64 n_interests=4 capsule_iters=3,
interaction=multi-interest.  [arXiv:1904.08030]

One 20M-row item table; user behaviour sequences of length 50 feed B2I
capsule routing.  Retrieval scores 1M candidates against the 4 interests.

Port of ``repro/configs/mind.py``.
"""
from repro_torch.configs.recsys_common import register_recsys
from repro_torch.core.sharding import TableSpec
from repro_torch.models.recsys import RecsysConfig


def make_config() -> RecsysConfig:
    return RecsysConfig(
        name="mind",
        arch="mind",
        tables=(TableSpec("item", 20_000_000, nnz=1),),
        embed_dim=64,
        n_interests=4,
        capsule_iters=3,
        hist_len=50,
        mode="hierarchical",
    )


register_recsys(
    "mind",
    make_config,
    notes="Needs raw (unpooled) rows for capsule routing -> exercises the "
    "fig-4(a) row-level lookup path by necessity (lookup_rows).",
)
