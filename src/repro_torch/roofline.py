"""Three-term roofline analysis of the dry run's records (PyTorch port of
``repro/roofline.py``), with one NVIDIA H100's constants in place of the
TPU v5e's:

    compute    = FLOPs            / (chips * PEAK_FLOPS)
    memory     = bytes            / (chips * HBM_BW)
    collective = collective_bytes / (chips * NVLINK_BW)

FLOPs and bytes are the dry run's counts of one step at the cell's global
shapes (``launch/dryrun.py``: ``torch.utils.flop_counter`` and a dispatch
mode summing each op's operand and result bytes), global already: the
port traces one entry of the sharded program and weighs each op by the
entries it stands for, as the reference multiplies XLA's per-partition
``cost_analysis`` by the chip count.

The reference reads its collective bytes off the partitioned HLO text
(``parse_collective_bytes``). Their counterpart here is the port's own
count, ``collective_bytes(mesh)``: the bytes the sharded program moves
between mesh entries, recorded by ``DeviceMesh``'s collectives in the
reference's convention (each participant's output bytes, summed over
participants), the backward's included (each collective's transpose,
the remat rerun's collectives, the gradients' all-reduce over the data
axes). They are the port's own program's, not XLA's: the two place
their collectives differently (``PERF.md`` compares them by kind).

MODEL_FLOPS = 6·N·D (train) or 2·N·D (forward) with N the *active*
parameter count — the useful-compute yardstick; ``active_param_count``,
``model_flops``, ``estimate_hbm_bytes``, ``_cache_bytes`` and
``mesh_name`` are the reference's arithmetic, copied.

Hardware: one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet):
989 TFLOP/s dense bfloat16, 3.35 TB/s HBM3, NVLink 450 GB/s each way.
This module is the port's one home of these constants
(``core/predictor.py`` imports them).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

PEAK_FLOPS = 989e12     # bfloat16 dense, tensor cores, per card
HBM_BW = 3.35e12        # bytes/s per card
NVLINK_BW = 450e9       # bytes/s per card, each direction

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def collective_bytes(mesh) -> Dict[str, int]:
    """The bytes the port's program moved between ``mesh``'s entries, by
    collective kind (every kind of the reference's present, 0 where
    none), from the mesh's ``DeviceMesh.hop`` count; all zeros for a mesh
    without one (``None``)."""
    hops = getattr(mesh, "hops", {})
    return {k: int(hops.get(k, 0)) for k in COLLECTIVES}


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    model_flops: float
    per_device_hbm_peak: Optional[float] = None
    est_hbm_bytes: float = 0.0   # fused-traffic estimate (see below)

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * HBM_BW)

    @property
    def t_memory_est(self) -> float:
        return self.est_hbm_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / (self.chips * NVLINK_BW)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def dominant_est(self) -> str:
        """Dominant term with the fused (calibrated) memory estimate."""
        terms = {"compute": self.t_compute, "memory": self.t_memory_est,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time_est(self) -> float:
        return max(self.t_compute, self.t_memory_est, self.t_collective)

    @property
    def roofline_fraction_est(self) -> float:
        ideal = self.model_flops / (self.chips * PEAK_FLOPS)
        return ideal / max(self.step_time_est, 1e-30)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / max(self.hlo_flops, 1.0)

    @property
    def step_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the step spent doing useful model FLOPs at peak —
        the score: (model_flops / chips / PEAK) / step_time."""
        ideal = self.model_flops / (self.chips * PEAK_FLOPS)
        return ideal / max(self.step_time, 1e-30)

    def row(self) -> str:
        return (f"| {self.arch} | {self.shape} | {self.mesh} | "
                f"{self.t_compute*1e3:.2f} | {self.t_memory*1e3:.2f} | "
                f"{self.t_collective*1e3:.2f} | {self.dominant} | "
                f"{self.useful_ratio:.2f} | {self.roofline_fraction*100:.1f}% |")


# ---------------------------------------------------------------------------
# MODEL_FLOPS (active-parameter yardstick)
# ---------------------------------------------------------------------------


def active_param_count(cfg) -> Tuple[int, int]:
    """Returns (total_params, active_params). Counted analytically from the
    config; embedding/lm-head included (they do participate in the matmuls)."""
    d, L, V = cfg.d_model, cfg.num_layers, cfg.vocab_size
    H, KH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    embed = 0 if cfg.embedding_inputs else V * d
    head = 0 if cfg.tie_embeddings else d * V

    def attn():
        if cfg.mla:
            r, dn, dr, dv = cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
            return (d * H * (dn + dr) + d * r + d * dr + r * H * dn
                    + r * H * dv + H * dv * d)
        return d * H * Dh + 2 * d * KH * Dh + H * Dh * d

    def mlp_dense(ff):
        return 3 * d * ff

    total = embed + head + 2 * d  # final norm & co, approx
    active = total
    if cfg.block_pattern == "attn":
        for layer in range(L):
            a = attn() + 2 * d
            if cfg.moe and layer >= cfg.first_dense:
                expert = 3 * d * cfg.d_ff_expert
                tot_moe = cfg.num_experts * expert + d * cfg.num_experts
                act_moe = cfg.top_k * expert + d * cfg.num_experts
                if cfg.d_ff_shared:
                    tot_moe += mlp_dense(cfg.d_ff_shared)
                    act_moe += mlp_dense(cfg.d_ff_shared)
                total += a + tot_moe
                active += a + act_moe
            else:
                total += a + mlp_dense(cfg.d_ff)
                active += a + mlp_dense(cfg.d_ff)
        if cfg.cross_attn_every:
            G = L // cfg.cross_attn_every
            cross = G * (attn() + mlp_dense(cfg.d_ff) + 3 * d)
            total += cross
            active += cross
    elif cfg.block_pattern == "rwkv6":
        per = (6 * d * d            # r,k,v,g,o + cm receptance
               + 2 * d * cfg.d_ff)  # channel mix
        total += L * per
        active += L * per
    elif cfg.block_pattern == "zamba2":
        d_inner = cfg.ssm_expand * d
        nheads = d_inner // cfg.ssm_head_dim
        conv_dim = d_inner + 2 * cfg.ssm_state
        per = (d * (2 * d_inner + 2 * cfg.ssm_state + nheads)
               + cfg.conv_kernel * conv_dim + d_inner * d)
        shared = attn() + mlp_dense(cfg.d_ff)
        total += L * per + shared
        active += L * per + (L // cfg.shared_attn_every) * 0 + shared * (L // cfg.shared_attn_every)
        # the shared block runs L//every times with the SAME weights: params
        # counted once (total) but its FLOPs recur -> handled in model_flops.
        active = total  # dense arch: all params active
    return int(total), int(active)


def model_flops(cfg, shape, kind: str) -> float:
    """6·N_active·D for train, 2·N_active·D forward; decode D = batch tokens.
    For zamba2 the shared block re-runs L/every times — count it as extra
    effective params."""
    total, active = active_param_count(cfg)
    if cfg.block_pattern == "zamba2":
        d = cfg.d_model
        H, Dh = cfg.num_heads, cfg.head_dim
        shared = (d * H * Dh + 2 * d * cfg.num_kv_heads * Dh + H * Dh * d
                  + 3 * d * cfg.d_ff)
        active = active + shared * (cfg.num_layers // cfg.shared_attn_every - 1)
    tokens = shape.global_batch * (shape.seq_len if kind != "decode" else 1)
    mult = 6.0 if kind == "train" else 2.0
    return mult * active * tokens


def mesh_name(mesh) -> str:
    return "x".join(str(mesh.shape[a]) for a in mesh.axis_names)


# ---------------------------------------------------------------------------
# Fused HBM-traffic estimate
# ---------------------------------------------------------------------------
#
# The dry run's byte count (``hlo_bytes``) counts every op's operands and
# results unfused, as XLA:CPU's "bytes accessed" does. This analytic
# estimate, the reference's arithmetic unchanged, counts what a fused step
# must move: (a) parameter passes, (b) optimizer state, (c) activation
# checkpoints, (d) materialized attention scores, (e) KV-cache reads. It
# gives the memory term of ``dominant_est``; the unfused bytes are
# reported beside it.


def estimate_hbm_bytes(cfg, shape, kind: str) -> float:
    total, _active = active_param_count(cfg)
    B = shape.global_batch
    S = shape.seq_len
    d, L = cfg.d_model, cfg.num_layers
    H = cfg.num_heads

    if kind == "decode":
        tokens = B
        w = 2.0 * total                      # one bf16 read of all weights
        cache = _cache_bytes(cfg, B, S)      # read once per step
        act = 40.0 * tokens * d * L          # per-layer working set
        return w + cache + act

    tokens = B * S
    act_per_layer = 8.0 * tokens * d * 2.0   # checkpoint in/out + boundaries
    scores = 0.0
    if cfg.block_pattern == "attn":
        # materialized (q-chunked) scores: QK^T + weights, fwd (+bwd for train)
        passes = 3.0 if kind == "train" else 1.0
        scores = passes * 2.0 * B * H * float(S) * S * 4.0
        if cfg.cross_attn_every:
            G = L // cfg.cross_attn_every
            scores += passes * 2.0 * B * H * float(S) * cfg.num_patches * 4.0 * G / L
    if kind == "train":
        w = 2.0 * total * 3.0                # fwd + remat + bwd bf16 reads
        opt = total * (4.0 * 2 + 8.0 * 2 + 8.0)   # grads rw, m/v rw, master rw
        act = L * act_per_layer * 2.0        # save + recompute traffic
        return w + opt + act + scores
    # prefill
    return 2.0 * total + L * act_per_layer + scores


def _cache_bytes(cfg, B: int, S: int) -> float:
    if cfg.block_pattern == "rwkv6":
        H = cfg.d_model // cfg.ssm_head_dim
        return cfg.num_layers * B * (2 * cfg.d_model * 2.0
                                     + H * cfg.ssm_head_dim ** 2 * 4.0)
    if cfg.block_pattern == "zamba2":
        d_inner = cfg.ssm_expand * cfg.d_model
        Hs = d_inner // cfg.ssm_head_dim
        G = cfg.num_layers // cfg.shared_attn_every
        ssm = cfg.num_layers * B * (Hs * cfg.ssm_state * cfg.ssm_head_dim * 4.0
                                    + (cfg.conv_kernel - 1) * (d_inner + 2 * cfg.ssm_state) * 2.0)
        attn = G * B * S * cfg.num_kv_heads * cfg.head_dim * 2 * 2.0
        return ssm + attn
    if cfg.mla:
        return cfg.num_layers * B * S * (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2.0
    return cfg.num_layers * B * S * cfg.num_kv_heads * cfg.head_dim * 2 * 2.0
