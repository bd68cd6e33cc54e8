"""Unified model configuration covering all assigned architecture families.

Families: dense | moe | ssm | hybrid | zamba2 | encdec (audio) | vlm.
One ``ModelConfig`` describes any of them; family-specific fields are zero /
unused otherwise.  ``configs/<arch>.py`` instantiates the exact assigned
configs; every config also provides a ``reduced()`` variant for CPU smoke
tests (same family and code paths, tiny dimensions).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

__all__ = ["ModelConfig"]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | zamba2 | encdec | vlm
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    head_dim: int = 0               # 0 -> d_model // n_heads

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0               # 0 -> d_ff
    dense_residual: bool = False    # arctic: dense FFN + MoE residual per layer

    # --- SSM (Mamba2 / SSD) --------------------------------------------------
    ssm_state: int = 0              # N
    ssm_head_dim: int = 64          # P
    ssm_expand: int = 2             # d_inner = expand * d_model
    ssm_groups: int = 1             # G (B/C groups)
    conv_width: int = 4
    ssd_chunk: int = 256

    # --- hybrid (zamba2) ------------------------------------------------------
    attn_every: int = 0             # apply the shared attention block every k layers

    # --- zamba2, the published form ----------------------------------------------
    hybrid_layers: Tuple[int, ...] = ()  # layers that call a shared block first
    shared_blocks: int = 0          # num_mem_blocks: shared blocks, called in turn
    adapter_rank: int = 0           # rank of each call's MLP adapter

    # --- encoder-decoder (whisper) -------------------------------------------
    enc_layers: int = 0
    source_len: int = 1500          # encoder frames (stub frontend)

    # --- VLM (internvl) -------------------------------------------------------
    vision_tokens: int = 0          # precomputed patch embeddings (stub frontend)

    # --- MoE dispatch ----------------------------------------------------------
    capacity_factor: float = 1.25
    moe_dispatch: str = "sorted"    # sorted | dense | a2a (explicit shard_map)

    # --- common ---------------------------------------------------------------
    rope_theta: float = 10_000.0
    attn_chunk: int = 1024          # blockwise-attention chunk (S > 2*chunk)
    loss_chunk: int = 256           # chunked cross-entropy rows (vocab memory)
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    window: int = 0                 # sliding-window attention (0 = full)
    subquadratic: bool = False      # eligible for long_500k
    dtype: str = "bfloat16"
    remat: str = "none"             # none | full | dots
    use_flash: bool = False         # route attention through the Pallas kernel
    opt_state_dtype: str = "float32"  # bf16 for >=100B params so Adam fits HBM

    # ------------------------------------------------------------------ props
    @property
    def padded_vocab(self) -> int:
        """Embedding-table vocab padded to a multiple of 256 so the vocab dim
        divides any mesh axis (50280 -> 50432 etc.); loss labels never index
        the pad rows.  Standard practice (MaxText pads the same way)."""
        return -(-self.vocab // 256) * 256

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def moe_ffn(self) -> int:
        return self.moe_d_ff or self.d_ff

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # --------------------------------------------------------------- counting
    def param_count(self) -> int:
        """Total parameters (N for the 6*N*D roofline term)."""
        d, v = self.d_model, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        hd = self.resolved_head_dim
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        ffn = 3 * d * self.d_ff  # SwiGLU: gate, up, down
        if self.family in ("dense", "vlm"):
            per_layer = attn + ffn + 2 * d
        elif self.family == "moe":
            moe = self.n_experts * 3 * d * self.moe_ffn + d * self.n_experts
            per_layer = attn + moe + 2 * d
            if self.dense_residual:
                per_layer += ffn
        elif self.family == "ssm":
            per_layer = self._mamba_block_params() + d
        elif self.family == "hybrid":
            per_layer = self._mamba_block_params() + d
            # one shared attention+MLP block (weights shared across uses)
            emb += attn + ffn + 2 * d
        elif self.family == "zamba2":
            per_layer = self._mamba_block_params() + d
            # shared blocks over [h, x0] (2d wide): q/k/v 2d -> H hd, o H hd
            # -> d, a GeGLU MLP; per call an adapter and a d x d linear
            block = (3 * 2 * d * self.n_heads * hd + self.n_heads * hd * d
                     + 3 * d * self.d_ff + 3 * d)
            call = self.adapter_rank * (d + 2 * self.d_ff) + d * d
            emb += (self.shared_blocks * block + len(self.hybrid_layers) * call
                    + d)
        elif self.family == "encdec":
            dec = attn + d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                + self.n_heads * hd * d + ffn + 3 * d  # self + cross + mlp
            enc = attn + ffn + 2 * d
            return emb + self.n_layers * dec + self.enc_layers * enc
        return emb + self.n_layers * per_layer

    def _mamba_block_params(self) -> int:
        d, di = self.d_model, self.d_inner
        g, n, h = self.ssm_groups, self.ssm_state, self.ssm_heads
        in_proj = d * (2 * di + 2 * g * n + h)
        conv = (di + 2 * g * n) * self.conv_width
        out_proj = di * d
        return in_proj + conv + out_proj + 3 * h + di

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.family != "moe" or not self.n_experts:
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        moe_total = self.n_layers * self.n_experts * 3 * d * self.moe_ffn
        moe_active = self.n_layers * self.top_k * 3 * d * self.moe_ffn
        return full - moe_total + moe_active
