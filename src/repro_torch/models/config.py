"""Model configuration for the architecture zoo.

Counterpart of ``repro.models.config``, field for field, so that a config
reads the same in both packages.  One frozen dataclass describes every
architecture; ``block_program`` derives the repeating unit of layer kinds
from it (hybrid SSM+attention, interleaved cross-attention, alternating
dense/MoE).  The port builds a plain list of ``num_layers`` layers from
that unit: layer ``r * len(unit) + i`` is unit position ``i`` of repeat
``r``.

``embed_shard`` picks the embedding table's spec (``LM.specs``),
``attn_seq_shard`` the sequence-sharded attention under the launcher
(``repro_torch.models.attention``), and ``moment_dtype`` the moments of the
sharded train state (``repro_torch.launch.steps.model_state_specs``).
``scan_unroll`` is inert: the port runs its layers in a Python loop, with
nothing to unroll.  ``remat`` and ``remat_policy`` steer the train path
(``repro_torch.models.blocks.stack_full``).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

LayerKind = Literal["attn_dense", "attn_moe", "mamba", "mamba_dense",
                    "mamba_moe", "cross_attn"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads
    qkv_bias: bool = False

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0            # expert hidden width (0 -> d_ff)
    moe_period: int = 1          # MoE FFN every k-th layer (1 = all layers)
    capacity_factor: float = 1.25
    moe_group_size: int = 512    # tokens per dispatch group: keeps the
                                 # one-hot dispatch einsum O(S*E*C*D) per
                                 # group instead of O(N^2)-ish globally
    moe_impl: str = "einsum"     # "einsum" (one-hot dispatch, baseline) |
                                 # "gather" (sparse slot-table dispatch,
                                 # §Perf variant — same math, O(E*C*D)
                                 # memory, no dispatch-einsum FLOPs)
    embed_shard: str = "vocab"   # "vocab": table (V->tp, D->fsdp); lookup
                                 #   needs a (B,S,D) psum over tp.
                                 # "hidden": table (V, D->tp); local
                                 #   lookup + small activation reshard
                                 #   (§Perf variant).
    attn_seq_shard: bool = False  # shard attention q over the TP axis by
                                  # SEQUENCE when heads %% tp != 0 (e.g.
                                  # llama4's 40 heads on 16-way TP) —
                                  # avoids replicated-head all-gathers.
    router_z_weight: float = 1e-3
    aux_loss_weight: float = 1e-2

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    attn_layer_period: int = 0   # hybrid: one attention layer every k (jamba: 8)

    # VLM
    cross_attn_period: int = 0   # one cross-attn layer every k layers
    vision_tokens: int = 0       # stub patch-embedding count (frontend is a stub)
    vision_d: int = 0            # stub patch-embedding dim

    # Encoder-decoder (audio)
    encoder_layers: int = 0
    audio_frames: int = 0        # stub post-conv frame count

    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moment_dtype: str = "float32"   # optimizer moments; "bfloat16" for >=100B
    param_dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"   # "full" (nothing saveable) | "dots"
                                 # (matmul outputs saved, elementwise
                                 # recomputed — §Perf variant)
    scan_unroll: bool = False    # True: fully unroll the layer scan.  Used
                                 # by the roofline probes (XLA cost_analysis
                                 # counts a while body once; see dryrun).

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 so the embedding/unembed
        weights shard over any tensor-parallel degree up to 256
        (Megatron-style padding; logits >= vocab_size are masked)."""
        return (self.vocab_size + 255) // 256 * 256

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: pure SSM or hybrid (tiny attention share)."""
        return self.family in ("ssm", "hybrid")

    def block_program(self) -> tuple[tuple[LayerKind, ...], int]:
        """Returns (unit, repeats): the repeating unit of layer kinds and
        how many times it is scanned.  len(unit) * repeats == num_layers."""
        kinds: list[LayerKind] = []
        for layer in range(self.num_layers):
            ffn = "moe" if self._layer_is_moe(layer) else "dense"
            if self.family == "ssm":
                kinds.append("mamba")        # pure mamba2: no FFN sub-block
            elif self.family == "hybrid":
                # jamba: 1 attention layer per attn_layer_period, rest
                # mamba; every layer carries a dense-or-MoE FFN sub-block.
                if (self.attn_layer_period
                        and layer % self.attn_layer_period
                        == self.attn_layer_period // 2):
                    kinds.append(f"attn_{ffn}")
                else:
                    kinds.append(f"mamba_{ffn}")
            elif (self.cross_attn_period
                  and layer % self.cross_attn_period
                  == self.cross_attn_period - 1):
                kinds.append("cross_attn")
            else:
                kinds.append(f"attn_{ffn}")

        # The smallest repeating unit that covers the whole stack.
        for unit_len in range(1, self.num_layers + 1):
            if self.num_layers % unit_len:
                continue
            unit = kinds[:unit_len]
            if unit * (self.num_layers // unit_len) == kinds:
                return tuple(unit), self.num_layers // unit_len
        return tuple(kinds), 1

    def _layer_is_moe(self, layer: int) -> bool:
        if not self.num_experts:
            return False
        return layer % self.moe_period == self.moe_period - 1

    # Hybrid mamba blocks keep the attention d_model; mamba inner width:
    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def validate(self) -> None:
        unit, repeats = self.block_program()
        assert len(unit) * repeats == self.num_layers
        assert self.d_model % self.num_heads == 0 or self.head_dim
        assert self.num_heads % max(self.num_kv_heads, 1) == 0
        if self.family == "ssm":
            assert self.ssm_state > 0
        if self.num_experts:
            assert self.num_experts_per_tok >= 1


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (input-shape) cell from the assignment."""
    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPE_CELLS = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)


def cell_by_name(name: str) -> ShapeCell:
    for c in SHAPE_CELLS:
        if c.name == name:
            return c
    raise KeyError(name)
