"""Configuration dataclasses of the port: the RAE, and the model families
whose serving paths the port runs (``TransformerConfig``, ``RecsysConfig``)
with their input-shape cells. Field for field the reference's
``configs/base.py``, so one config means the same model in both packages."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class RAEConfig:
    """The paper's own technique (Section 3.2) as a first-class config.

    Field for field the reference's ``RAEConfig``, so a ``meta.json`` that
    either package saved loads in the other."""

    name: str = "rae_paper"
    in_dim: int = 768
    out_dim: int = 384
    # lambda: regularization coefficient; realised as AdamW decoupled weight
    # decay (paper's experimental setup) or as an explicit Frobenius term in
    # the loss (paper's Eq. 7) when explicit_frobenius=True.
    weight_decay: float = 1e-2
    explicit_frobenius: bool = False
    use_bias: bool = False  # paper footnote 2: biases cancel in distances
    steps: int = 3000
    batch_size: int = 128
    lr_max: float = 1e-3
    lr_min: float = 1e-5
    seed: int = 0
    param_dtype: str = "float32"

    def replace(self, **kw) -> "RAEConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeCell:
    """One (input-shape) cell: what a step of an architecture is run on."""

    name: str
    kind: str  # train | prefill | decode | full_graph | minibatch | serve | retrieval
    # LM fields
    seq_len: int = 0
    global_batch: int = 0
    # GNN fields
    n_nodes: int = 0
    n_edges: int = 0
    d_feat: int = 0
    batch_nodes: int = 0
    fanout: tuple[int, ...] = ()
    graphs_per_batch: int = 0
    # RecSys fields
    n_candidates: int = 0
    extras: dict[str, Any] = field(default_factory=dict)

    def replace(self, **kw) -> "ShapeCell":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TransformerConfig:
    name: str
    family: str  # "dense" | "moe"
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3
    # flavor
    rope_theta: float = 1_000_000.0
    qkv_bias: bool = False
    qk_norm: bool = False
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    kv_chunk: int = 256  # online-softmax KV block size
    # numerics / memory
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    moment_dtype: str = "bfloat16"  # Adam m/v dtype (fp32 master retained)
    remat: bool = True
    scan_layers: bool = True
    # attention scheme: "auto" picks head-TP when n_heads % tp == 0 else
    # context-parallel (the reference's mesh knob; one card runs every head)
    attention_scheme: str = "auto"
    pad_heads_to_tp: bool = False
    xent_chunk: int = 0  # 0 = unchunked cross-entropy; >0 = token-chunked
    grad_accum: int = 1  # microbatches per step

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head

    def n_params(self) -> int:
        """Total parameter count (exact, incl. embeddings)."""
        d, L = self.d_model, self.n_layers
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.qkv_bias:
            attn += self.q_dim + 2 * self.kv_dim
        if self.family == "moe":
            mlp = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
        else:
            mlp = 3 * d * self.d_ff
        norms = 2 * d
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return L * (attn + mlp + norms) + embed + d  # + final norm

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: only routed experts)."""
        if self.family != "moe":
            return self.n_params()
        d, L = self.d_model, self.n_layers
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        mlp = self.moe_top_k * 3 * d * self.d_ff + d * self.n_experts
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return L * (attn + mlp + 2 * d) + embed + d


@dataclass(frozen=True)
class EmbeddingTableSpec:
    name: str
    vocab: int
    dim: int
    # "bag" tables take multi-hot index lists and segment-reduce them
    bag_size: int = 0  # 0 => single-id lookup


@dataclass(frozen=True)
class RecsysConfig:
    name: str
    kind: str  # "bst" | "two_tower" | "autoint" | "mind"
    embed_dim: int
    tables: tuple[EmbeddingTableSpec, ...]
    mlp_dims: tuple[int, ...] = ()
    # bst
    seq_len: int = 0
    n_blocks: int = 0
    n_heads: int = 0
    # autoint
    n_attn_layers: int = 0
    d_attn: int = 0
    n_fields: int = 0
    # mind
    n_interests: int = 0
    capsule_iters: int = 0
    hist_len: int = 0
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    def n_params(self) -> int:
        return sum(t.vocab * t.dim for t in self.tables)  # tables dominate
