"""two-tower-retrieval [RecSys'19 (YouTube); unverified]

embed_dim=256 tower_mlp=1024-512-256 interaction=dot, sampled-softmax retrieval.
Item corpus 10M ids; user side: id + multi-hot history bag (EmbeddingBag).
"""
from .base import EmbeddingTableSpec, RecsysConfig

CONFIG = RecsysConfig(
    name="two-tower-retrieval",
    kind="two_tower",
    embed_dim=256,
    mlp_dims=(1024, 512, 256),
    hist_len=50,
    tables=(
        EmbeddingTableSpec("user", vocab=5_000_000, dim=256),
        EmbeddingTableSpec("item", vocab=10_000_000, dim=256),
        EmbeddingTableSpec("hist_item", vocab=10_000_000, dim=256, bag_size=50),
    ),
)
FAMILY = "recsys"
