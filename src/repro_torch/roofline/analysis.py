"""Roofline terms of a step, PyTorch port of ``repro.roofline.analysis``,
with NVIDIA H100 SXM constants. Three terms per (arch x shape x mesh), in
seconds:

    compute    = FLOPs_per_device / PEAK_FLOPS
    memory     = bytes_per_device / HBM_BW
    collective = collective_bytes_per_device / LINK_BW

The JAX package reads FLOPs and collectives from the compiled per-device
HLO (``hloparse``); here ``roofline.opcount.OpCounter`` records them from
the operations a traced step runs on this device, and ``collective_stats``
costs its collectives as the JAX function costs HLO collectives (all-reduce
2x the buffer, reduce-scatter x group size to recover the operand,
all-gather / all-to-all / broadcast 1x). The memory term is the analytic
traffic model, as in the JAX package (``analytic_memory_bytes``).

The constants are the data sheet's for the H100 SXM at 700 W: 989 TFLOP/s
dense bf16 on the tensor cores and 3.35 TB/s of HBM3. A card held below
700 W runs slower than these.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.roofline import opcount

# NVIDIA H100 SXM (data sheet, 700 W).
PEAK_FLOPS = 989e12        # dense bf16 FLOP/s per card
HBM_BW = 3.35e12           # B/s per card
# One 400 Gb/s NDR InfiniBand port per card (a DGX H100 node: eight cards,
# eight ConnectX-7 ports), one direction. The production meshes' 16-wide
# 'model' axis spans two 8-card nodes, so its rings cross InfiniBand,
# whose link sets their pace; NVLink's 450 GB/s a direction holds only
# within a node's 8 cards. The JAX package's figure (one ICI link of a
# v5e) is also 50e9.
LINK_BW = 50e9             # B/s per card, inter-node


@dataclasses.dataclass
class Roofline:
    flops: float               # per-device
    bytes_accessed: float      # per-device
    collective_bytes: float    # per-device
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float         # 6*N*D (or 2*N*D inference), whole step, global
    useful_ratio: float        # model_flops / (flops * chips)
    per_device_memory: Optional[dict] = None
    collectives: Optional[dict] = None

    def row(self):
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "useful_ratio": self.useful_ratio,
        }


def model_flops(cfg, cell) -> float:
    """MODEL_FLOPS per step: 6*N_active*tokens (train) / 2*N_active*tokens
    (inference) plus the standard causal-attention term (PaLM-style MFU
    accounting: 2*2*S_kv*H*Dh per token per layer, halved for causality,
    windowed when SWA applies), which dominates 32k+ prefills."""
    n_active = active_params(cfg)
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    mult = 6.0 if cell.kind == "train" else 2.0
    flops = mult * n_active * tokens
    if cfg.attn is not None and cfg.family != "rwkv":
        a = cfg.attn
        n_attn_layers = cfg.num_layers + cfg.enc_layers
        if cfg.shared_attn_every:
            n_attn_layers = cfg.num_layers // cfg.shared_attn_every + 1
        kv_len = cell.seq_len
        causal_half = 0.5
        if a.window and not a.local_global_period:
            kv_len = min(a.window, cell.seq_len)
            causal_half = 1.0 if kv_len < cell.seq_len else 0.5
        if cell.kind == "decode":
            causal_half = 1.0  # one query reads the whole (windowed) cache
        # 2 matmuls (QK^T, PV) x 2 FLOPs/MAC x q_heads x head_dim
        per_tok = 4.0 * kv_len * a.num_heads * a.head_dim * causal_half
        attn = per_tok * tokens * n_attn_layers
        flops += (mult / 2.0) * attn
    return flops


def active_params(cfg) -> float:
    """Analytic active-parameter count from the config."""
    d, ff, v = cfg.d_model, cfg.d_ff, cfg.vocab_padded
    n = v * d  # embeddings
    if not cfg.tie_embeddings:
        n += v * d
    per_layer = 0.0
    if cfg.attn is not None and cfg.family in ("dense", "vlm", "moe", "encdec"):
        a = cfg.attn
        per_layer += d * a.q_dim + 2 * d * a.kv_dim + a.q_dim * d
    gated = cfg.activation in ("swiglu", "geglu")
    ffn = d * ff * (3 if gated else 2)
    if cfg.family == "moe":
        eff = cfg.moe.expert_d_ff or ff
        expert = d * eff * 3
        per_layer += cfg.moe.top_k * expert + d * cfg.moe.num_experts
        if cfg.moe.dense_residual:
            per_layer += ffn
    elif cfg.family == "rwkv":
        per_layer += 6 * d * d  # r,k,v,g,o + cmix gate, approx
        per_layer += d * ff + ff * d
    elif cfg.family == "mamba_hybrid":
        di = cfg.ssm.expand * d
        per_layer += d * (2 * di + 2 * cfg.ssm.state_dim) + di * d
    else:
        per_layer += ffn
    n += cfg.num_layers * per_layer
    if cfg.family == "encdec":
        enc_layer = d * cfg.attn.q_dim * 2 + 2 * d * cfg.attn.kv_dim + ffn
        cross = d * cfg.attn.q_dim * 2 + 2 * d * cfg.attn.kv_dim
        n += cfg.enc_layers * enc_layer + cfg.num_layers * cross
    if cfg.shared_attn_every:
        a = cfg.attn
        n += d * a.q_dim * 2 + 2 * d * a.kv_dim + ffn
    return float(n)


def analytic_memory_bytes(cfg, cell, n_chips, params_local_bytes,
                          opt_local_bytes=0.0):
    """The JAX package's per-device HBM traffic model, term for term:

      train:   3 reads of the local params (fwd, bwd, remat-fwd) + grad
               write+read + optimizer state read+write + param write,
               plus ~12 activation-stream touches per layer.
      prefill: 1 param read + ~6 activation touches + KV-cache write.
      decode:  1 param read (weight-streaming dominates) + cache read+write.
    """
    d = cfg.d_model
    L = cfg.num_layers + cfg.enc_layers
    dp = max(1, n_chips // 16)  # data-parallel ways of the 16-wide model axis
    tokens_local = cell.global_batch * (
        cell.seq_len if cell.kind != "decode" else 1
    ) / dp
    act = tokens_local * d * 2.0  # bf16 activation stream per layer
    if cell.kind == "train":
        p_traffic = 5.0 * params_local_bytes + 2.0 * opt_local_bytes \
            + params_local_bytes
        a_traffic = 12.0 * act * L
    elif cell.kind == "prefill":
        p_traffic = params_local_bytes
        a_traffic = 6.0 * act * L
    else:  # decode
        p_traffic = params_local_bytes
        cache_bytes = 0.0
        if cfg.attn is not None:
            slots = min(cell.seq_len, cfg.attn.window or cell.seq_len)
            cache_bytes = (
                2.0 * L * cell.global_batch * slots * cfg.attn.kv_dim * 2.0 / dp
            )
        a_traffic = 2.0 * act * L + cache_bytes
    return p_traffic + a_traffic


def collective_stats(records) -> Dict[str, float]:
    """Per-device bytes moved, by collective kind, with their sum under
    'total', from an ``OpCounter``'s records (``opcount.Collective``s) or
    the counter itself: the JAX function's sums over its HLO lines."""
    return opcount.coll_by_kind(getattr(records, "collectives", records))


def analyze(counted, cfg, cell, n_chips: int, *, counts=None,
            params_local_bytes: float = 0.0, opt_local_bytes: float = 0.0,
            memory: Optional[dict] = None):
    """The ``Roofline`` of a traced step. ``counted``: the
    ``opcount.OpCounter`` the step ran under; ``counts``: another counter
    to read FLOPs and collectives from (the JAX function's ``hlo_text``:
    a train cell's accumulation-free trace), else ``counted``. ``memory``:
    the step's ``argument_bytes``, ``output_bytes`` and ``alias_bytes`` a
    device; ``temp_bytes`` is the counter's peak of the live bytes the
    step allocated (``track_memory=True``), XLA's ``memory_analysis``
    counterpart."""
    src = counted if counts is None else counts
    flops, cbytes, colls, _info = opcount.analyze_ops(src)
    nbytes = analytic_memory_bytes(
        cfg, cell, n_chips, params_local_bytes, opt_local_bytes
    )
    compute_s = flops / PEAK_FLOPS
    memory_s = nbytes / HBM_BW
    collective_s = cbytes / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(cfg, cell)
    useful = mf / (flops * n_chips) if flops else 0.0
    mem = None
    if memory is not None:
        mem = {"argument_bytes": memory.get("argument_bytes", 0),
               "output_bytes": memory.get("output_bytes", 0),
               "temp_bytes": (counted.peak_bytes if counted.track_memory
                              else memory.get("temp_bytes", 0)),
               "alias_bytes": memory.get("alias_bytes", 0)}
    return Roofline(
        flops=flops,
        bytes_accessed=nbytes,
        collective_bytes=cbytes,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        bottleneck=bottleneck,
        model_flops=mf,
        useful_ratio=useful,
        per_device_memory=mem,
        collectives=colls,
    )
