"""First-principles roofline terms per (arch x shape x mesh): a copy of
the reference's ``roofline/analytic.py`` over the port's configs.

The terms model what the implementation executes (masked-full attention,
capacity-MoE dispatch, remat recompute): forward FLOPs of a step, HBM
bytes and collective bytes per device. The reference uses them because
XLA:CPU's ``cost_analysis()`` does not multiply while-loop bodies by their
trip count; the port has no XLA, so they are its only FLOP and byte
counts (``roofline/analysis.py``, ``chip_smoke.py``'s ``TRAIN`` phase).
Each function equals the reference's float for float.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig, ShapeConfig

BF16 = 2


def _attn_flops(cfg: ModelConfig, tokens: float, ctx: float,
                causal_skip: bool = False) -> float:
    d, hd = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    proj = 2 * tokens * d * (hq * hd) + 2 * 2 * tokens * d * (hkv * hd) \
        + 2 * tokens * (hq * hd) * d
    if causal_skip and tokens > ctx / 2:
        # q block i scans ceil((i+1)*qb/kb) kv blocks: factor (nq+1)/(2nq)
        nq = max(int(ctx) // 2048, 1)
        ctx = ctx * (nq + 1) / (2 * nq)
    attn = 2 * 2 * tokens * ctx * hq * hd
    return proj + attn


def _dense_mlp_flops(cfg: ModelConfig, tokens: float, ff: int) -> float:
    return 3 * 2 * tokens * cfg.d_model * ff


def _moe_flops(cfg: ModelConfig, tokens: float) -> float:
    d, eff = cfg.d_model, cfg.expert_d_ff
    routed_rows = tokens * cfg.top_k * cfg.capacity_factor
    f = 3 * 2 * routed_rows * d * eff
    f += 2 * tokens * d * cfg.n_experts                  # router
    if cfg.n_shared_experts:
        f += 3 * 2 * tokens * d * (cfg.n_shared_experts * eff)
    return f


def _mamba_flops(cfg: ModelConfig, tokens: float) -> float:
    d = cfg.d_model
    d_in = cfg.mamba_expand * d
    n = cfg.mamba_d_state
    r = max(1, d_in // 16)
    f = 2 * tokens * d * 2 * d_in                        # in_proj
    f += 2 * tokens * cfg.mamba_d_conv * d_in            # conv
    f += 2 * tokens * d_in * (r + 2 * n)                 # x_proj
    f += 2 * tokens * r * d_in                           # dt_proj
    f += 8 * tokens * d_in * n                           # selective scan
    f += 2 * tokens * d_in * d                           # out_proj
    return f


def _rwkv_flops(cfg: ModelConfig, tokens: float) -> float:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    f = 5 * 2 * tokens * d * d                           # r/k/v/g/o ... w_o
    f += 2 * 2 * tokens * d * 64                         # decay lora
    f += 4 * tokens * h * hd * hd                        # wkv recurrence
    return f


def step_flops(cfg: ModelConfig, shape: ShapeConfig,
               causal_skip: bool = False) -> float:
    """Forward FLOPs of one step (train multiplier applied by caller)."""
    if shape.kind == "decode":
        tokens = float(shape.global_batch)
        ctx = float(shape.seq_len)
    else:
        seq = shape.seq_len
        if cfg.family == "vlm":
            seq = shape.seq_len  # image prefix included in assigned seq
        tokens = float(shape.global_batch * seq)
        ctx = float(seq)

    total = 0.0
    for mix, mlp in cfg.layer_plan:
        if mix == "attn":
            total += _attn_flops(cfg, tokens, ctx, causal_skip)
        elif mix == "mamba":
            total += _mamba_flops(cfg, tokens)
        else:
            total += _rwkv_flops(cfg, tokens)
        if mlp == "dense":
            total += _dense_mlp_flops(cfg, tokens, cfg.d_ff)
        elif mlp == "moe":
            total += _moe_flops(cfg, tokens)

    if cfg.is_encdec:
        enc_tokens = shape.global_batch * cfg.n_audio_frames
        if shape.kind == "decode":
            # cross-attn reads the precomputed encoder KV
            total += 2 * 2 * tokens * cfg.n_audio_frames * \
                cfg.n_heads * cfg.head_dim * cfg.n_layers
            total += 2 * tokens * cfg.d_model * (cfg.n_heads * cfg.head_dim
                                                 ) * 2 * cfg.n_layers
        else:
            for _ in range(cfg.encoder_layers):
                total += _attn_flops(cfg, enc_tokens, cfg.n_audio_frames)
                total += _dense_mlp_flops(cfg, enc_tokens, cfg.d_ff)
            for _ in range(cfg.n_layers):     # cross attention in decoder
                total += _attn_flops(cfg, tokens, cfg.n_audio_frames)

    # head
    head_tokens = tokens if shape.kind == "train" else float(
        shape.global_batch)
    total += 2 * head_tokens * cfg.d_model * cfg.padded_vocab
    return total


def kv_token_bytes(cfg: ModelConfig, kv_dtype=None) -> int:
    """Exact KV bytes one token occupies across ALL attention layers —
    the per-period figure (storage dtype + quant scale/zero overhead)
    delegated to the serving layer's single source of truth
    (attention.paged_kv_token_bytes) times the attention layer count.
    ``kv_dtype=None`` means bf16-class storage (the legacy roofline
    assumption: 2 bytes/element, no overhead)."""
    n_attn = sum(1 for m, _ in cfg.layer_plan if m == "attn")
    if kv_dtype is None:
        return 2 * cfg.n_kv_heads * cfg.head_dim * BF16 * n_attn
    from repro_torch.models.attention import paged_kv_token_bytes
    return paged_kv_token_bytes(cfg, kv_dtype) * n_attn


def hbm_bytes_per_device(cfg: ModelConfig, shape: ShapeConfig,
                         chips: int, param_bytes_total: int,
                         train_mult: float, kv_dtype=None) -> float:
    """First-order HBM traffic per device per step. ``kv_dtype``
    parameterizes the KV-stream term on the pool storage dtype (int8
    pages roughly halve decode's KV traffic at production head_dim);
    ``None`` keeps the legacy bf16 formula exactly."""
    d = cfg.d_model
    if shape.kind == "decode":
        tokens = shape.global_batch
    else:
        tokens = shape.global_batch * shape.seq_len
    # weights stream: TP shards weights across 'model' (and 'data' if fsdp);
    # every device reads its shard each pass
    w_dev = param_bytes_total / (chips if cfg.fsdp else 16)
    passes = 3.0 if shape.kind == "train" else 1.0   # fwd + recompute + bwd
    traffic = w_dev * passes
    if shape.kind == "train":
        # optimizer: read mu,nu,params + write all three (fp32 states)
        opt_dev = 2 * param_bytes_total * 2 / chips    # fp32 mu+nu sharded
        traffic += 2 * opt_dev + 2 * w_dev
    # activations: residual stream r/w per layer
    act = cfg.n_layers * (tokens / chips if shape.kind != "decode"
                          else tokens / min(chips, 16)) * d * BF16 * 4
    traffic += act * (2 if shape.kind == "train" else 1)
    # KV cache
    kv_tok = kv_token_bytes(cfg, kv_dtype)
    if shape.kind == "decode":
        traffic += kv_tok * shape.seq_len * shape.global_batch / chips
        # recurrent states
        if cfg.sub_quadratic:
            d_in = cfg.mamba_expand * d
            n_m = sum(1 for m, _ in cfg.layer_plan if m == "mamba")
            n_r = sum(1 for m, _ in cfg.layer_plan if m == "rwkv")
            traffic += (n_m * d_in * cfg.mamba_d_state * 4
                        + n_r * cfg.n_heads * cfg.head_dim ** 2 * 4) \
                * 2 * shape.global_batch / min(chips, 16)
    elif shape.kind == "prefill":
        traffic += kv_tok * tokens / chips
    return traffic


@dataclass
class CollectiveModel:
    """Per-device ICI bytes per step under the baseline layout."""
    allreduce: float = 0.0
    allgather: float = 0.0
    reducescatter: float = 0.0
    alltoall: float = 0.0

    @property
    def total(self) -> float:
        return (self.allreduce + self.allgather + self.reducescatter
                + self.alltoall)


def collective_bytes_per_device(cfg: ModelConfig, shape: ShapeConfig,
                                chips: int, param_bytes_total: int,
                                data: int = 16, model: int = 16) -> \
        CollectiveModel:
    cm = CollectiveModel()
    ring = 2.0                      # ~2(n-1)/n per all-reduce
    if shape.kind == "decode":
        tok_local = shape.global_batch / (data if shape.global_batch > 1
                                          else 1)
    else:
        tok_local = shape.global_batch * shape.seq_len / data
    act = tok_local * cfg.d_model * BF16
    # TP: one all-reduce (or RS+AG) per mixer and per mlp per layer
    per_layer = 2 * act * ring
    passes = 3.0 if shape.kind == "train" else 1.0
    cm.allreduce += per_layer * cfg.n_layers * passes
    if cfg.is_encdec and shape.kind != "decode":
        enc_local = shape.global_batch * cfg.n_audio_frames / data
        cm.allreduce += 3 * enc_local * cfg.d_model * BF16 * ring \
            * cfg.encoder_layers * passes
    # MoE all-to-all: dispatch + combine of routed rows
    if cfg.is_moe and cfg.expert_sharding == "expert":
        moe_layers = sum(1 for _, m in cfg.layer_plan if m == "moe")
        rows = tok_local * cfg.top_k * cfg.capacity_factor
        cm.alltoall += 2 * rows * cfg.d_model * BF16 * moe_layers * passes
    # FSDP: all-gather weights every pass + reduce-scatter grads
    if cfg.fsdp:
        w_dev = param_bytes_total / chips
        cm.allgather += w_dev * (data - 1) / data * passes * data / data
        cm.allgather += param_bytes_total / model / data * passes
    if shape.kind == "train":
        # DP gradient reduction (bf16 compressed)
        grad_dev = param_bytes_total / (chips if cfg.fsdp else model)
        cm.reducescatter += grad_dev * ring
    return cm
