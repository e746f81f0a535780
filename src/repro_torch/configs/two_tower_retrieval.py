"""two-tower-retrieval [recsys]: embed_dim=256 tower_mlp=1024-512-256,
interaction=dot, sampled-softmax retrieval.  [RecSys'19 (YouTube)]

User tower: user_id (50M) + user_geo (100k); item tower: item_id (10M) +
item_category (10k).  ~60M rows x 256 = 61 GB fp32.

Port of ``repro/configs/two_tower_retrieval.py``.
"""
from repro_torch.configs.recsys_common import register_recsys
from repro_torch.core.sharding import TableSpec
from repro_torch.models.recsys import RecsysConfig


def make_config() -> RecsysConfig:
    return RecsysConfig(
        name="two-tower-retrieval",
        arch="two_tower",
        tables=(
            TableSpec("user_id", 50_000_000, nnz=1),
            TableSpec("user_geo", 100_000, nnz=1),
            TableSpec("item_id", 10_000_000, nnz=1),
            TableSpec("item_category", 10_000, nnz=1),
        ),
        embed_dim=256,
        user_tables=2,
        mlp=(1024, 512, 256),
        mode="hierarchical",
    )


register_recsys(
    "two-tower-retrieval",
    make_config,
    notes="In-batch sampled softmax with logQ correction for training; "
    "retrieval_cand scores against precomputed item embeddings sharded "
    "over the full mesh with local top-k + gather.",
)
