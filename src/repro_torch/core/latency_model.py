# Copied unchanged from src/repro/core/latency_model.py.
"""Analytical latency model — Appendix A of the paper, adapted to TPU v5e.

The paper fits constants C1..C5 by profiling A100 kernels. We derive them
from first principles on the target chip (MXU peak x efficiency, HBM
bandwidth), keep the same structural form, and expose a `calibrate()` hook
that refits the efficiency knobs against measured engine step times (used
for the Table-2 simulator-accuracy experiment on CPU).

Forms (per instance, with tensor parallelism tp and pipeline pp):
  prefill:  T = GEMM_flops/(tp*peak*mm_eff) + attn_flops/(tp*peak*attn_eff)
              + comm(t) + C3
  decode:   T = (param_bytes/tp + kv_bytes)/HBM + comm_latency + C3'
SSM archs swap the per-token KV term for a constant state read.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

from . import hw
from ..configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class Parallelism:
    tp: int = 1
    pp: int = 1

    @property
    def num_chips(self) -> int:
        return self.tp * self.pp


@dataclasses.dataclass
class LatencyModel:
    cfg: ModelConfig
    chip: hw.Chip = hw.DEFAULT
    dtype_bytes: int = 2
    # calibration multipliers (refit by calibrate())
    c_mm: float = 1.0
    c_attn: float = 1.0
    c_hbm: float = 1.0
    c_over: float = 1.0

    # ---- static model quantities ------------------------------------
    def param_bytes(self) -> float:
        return self.cfg.num_params() * self.dtype_bytes

    def active_param_bytes(self, batch: int = 1) -> float:
        """Bytes of weights actually read in a decode step (MoE-aware)."""
        c = self.cfg
        if c.family != "moe":
            return self.param_bytes()
        m = c.moe
        # activated experts: each token activates k of E; a batch of B
        # tokens touches ~E*(1-(1-k/E)^B) experts
        frac = 1.0 - (1.0 - m.num_experts_per_tok / m.num_experts) ** max(batch, 1)
        expert_p = (c.num_layers - m.first_k_dense) * m.num_experts * 3 * c.d_model * c.d_ff
        rest = c.num_params() - expert_p
        return (rest + expert_p * frac) * self.dtype_bytes

    def gemm_flops_per_token(self) -> float:
        c = self.cfg
        d = c.d_model
        attn_proj = 2 * d * (c.q_dim + 2 * c.kv_dim) + 2 * c.q_dim * d
        if c.family == "moe":
            m = c.moe
            ff = 6 * d * c.d_ff * (m.num_experts_per_tok + m.num_shared_experts)
            per_moe = attn_proj + ff
            per_dense = attn_proj + 6 * d * (m.dense_d_ff or c.d_ff)
            L_moe = c.num_layers - m.first_k_dense
            total = L_moe * per_moe + m.first_k_dense * per_dense
        elif c.family == "ssm":
            s = c.ssm
            d_in = s.expand * d
            gn = s.ngroups * s.state_dim
            nh = d_in // s.head_dim
            per = 2 * d * (2 * d_in + 2 * gn + nh) + 2 * d_in * d
            # ssd state flops ~ 6 * d_in * N per token
            per += 6 * d_in * s.state_dim
            total = c.num_layers * per
        elif c.family == "hybrid":
            s = c.ssm
            d_in = s.expand * d
            gn = s.ngroups * s.state_dim
            nh = d_in // s.head_dim
            per = 2 * d * (2 * d_in + 2 * gn + nh) + 2 * d_in * d + 6 * d_in * s.state_dim
            total = c.num_layers * per
            n_attn = c.num_layers // max(c.hybrid_attn_every, 1)
            total += n_attn * (attn_proj + 6 * d * c.d_ff)
        else:
            per = attn_proj + 6 * d * c.d_ff
            L = c.num_layers + c.encoder_layers
            total = L * per
            if c.is_encdec:
                total += c.num_layers * attn_proj  # cross-attention proj
        total += 2 * d * c.vocab_size  # lm head
        return float(total)

    def attn_flops(self, lens: Sequence[int]) -> float:
        """Score+PV flops for a prefill batch with given prompt lengths."""
        c = self.cfg
        if c.family == "ssm":
            return 0.0
        n_attn = c.num_layers + c.encoder_layers
        if c.family == "hybrid":
            n_attn = c.num_layers // max(c.hybrid_attn_every, 1)
        total = 0.0
        for l in lens:
            eff_l2 = l * min(l, c.sliding_window) if c.sliding_window else l * l
            # causal -> half the square
            total += 4 * c.q_dim * (eff_l2 / 2)
        return float(total) * n_attn

    def kv_read_bytes(self, ctx_tokens: float) -> float:
        """Decode-step KV bytes for `ctx_tokens` total cached tokens."""
        c = self.cfg
        if c.family == "ssm":
            s = c.ssm
            d_in = s.expand * c.d_model
            nh = d_in // s.head_dim
            state = nh * s.head_dim * s.state_dim * 4
            return c.num_layers * state  # per batch element, ctx-independent
        per_tok = c.kv_bytes_per_token(self.dtype_bytes)
        if c.sliding_window:
            # ring caches bound the window (approximation: all-local archs)
            pass
        return per_tok * ctx_tokens

    # ---- phase latencies --------------------------------------------
    def tp_comm_time(self, tokens: float, tp: int, layers: Optional[int] = None) -> float:
        """Per-layer activation all-reduces under TP (2 per layer)."""
        if tp <= 1:
            return 0.0
        c = self.cfg
        L = layers if layers is not None else (c.num_layers + c.encoder_layers)
        bytes_per = tokens * c.d_model * self.dtype_bytes
        wire = 2.0 * bytes_per * (tp - 1) / tp          # ring all-reduce
        bw = self.chip.ici_bw * min(self.chip.ici_links, 2)
        return L * (2 * (wire / bw + self.chip.coll_latency))

    def prefill_time(self, lens: Sequence[int], par: Parallelism) -> float:
        """One prefill batch (sum over pipeline stages = full latency)."""
        t = float(sum(lens))
        gemm = self.gemm_flops_per_token() * t
        attn = self.attn_flops(lens)
        chip = self.chip
        t_mm = self.c_mm * gemm / (par.tp * chip.peak_flops_bf16 * chip.mm_eff)
        t_at = self.c_attn * attn / (par.tp * chip.peak_flops_bf16 * chip.attn_eff)
        t_comm = self.tp_comm_time(t, par.tp)
        t_weights = self.param_bytes() / par.tp / (chip.hbm_bw * chip.hbm_eff)
        compute = max(t_mm + t_at + t_comm, t_weights)
        return compute + self.c_over * chip.step_overhead

    def prefill_stage_time(self, lens: Sequence[int], par: Parallelism) -> float:
        """Occupancy of one pipeline stage (admission interval under PP)."""
        return self.prefill_time(lens, par) / par.pp

    def attn_flops_chunked(self, pairs: Sequence[Sequence[int]]) -> float:
        """Score+PV flops for a chunked-prefill batch: each entry is
        ``(new_tokens, ctx_tokens)`` — the chunk's queries attend over the
        already-resident context plus themselves (causal within the
        chunk). ``ctx = 0`` reduces to `attn_flops([new])`."""
        c = self.cfg
        if c.family == "ssm":
            return 0.0
        n_attn = c.num_layers + c.encoder_layers
        if c.family == "hybrid":
            n_attn = c.num_layers // max(c.hybrid_attn_every, 1)
        total = 0.0
        for new, ctx in pairs:
            if c.sliding_window:
                w = c.sliding_window
                eff = new * min(ctx, w) + new * min(new, w) / 2
            else:
                eff = new * ctx + new * new / 2
            total += 4 * c.q_dim * eff
        return float(total) * n_attn

    def prefill_chunk_time(self, pairs: Sequence[Sequence[int]],
                           par: Parallelism) -> float:
        """One chunked-prefill batch: entries are ``(new, ctx)`` pairs.
        Linear (GEMM) work scales with the new tokens only; attention pays
        the new-tokens-vs-context cross term, so the sum over a prompt's
        chunks charges the same attention flops as one unchunked prefill
        plus one batch overhead per chunk."""
        t = float(sum(new for new, _ in pairs))
        gemm = self.gemm_flops_per_token() * t
        attn = self.attn_flops_chunked(pairs)
        chip = self.chip
        t_mm = self.c_mm * gemm / (par.tp * chip.peak_flops_bf16 * chip.mm_eff)
        t_at = self.c_attn * attn / (par.tp * chip.peak_flops_bf16 * chip.attn_eff)
        t_comm = self.tp_comm_time(t, par.tp)
        t_weights = self.param_bytes() / par.tp / (chip.hbm_bw * chip.hbm_eff)
        compute = max(t_mm + t_at + t_comm, t_weights)
        return compute + self.c_over * chip.step_overhead

    def decode_time(self, batch: int, ctx_tokens: float, par: Parallelism) -> float:
        """One decode iteration for `batch` sequences, total cached tokens."""
        chip = self.chip
        w_bytes = self.active_param_bytes(batch) / par.tp
        kv = self.kv_read_bytes(ctx_tokens) if self.cfg.family != "ssm" \
            else self.kv_read_bytes(0) * batch
        kv /= par.tp
        t_mem = self.c_hbm * (w_bytes + kv) / (chip.hbm_bw * chip.hbm_eff)
        gemm = self.gemm_flops_per_token() * batch
        t_mm = self.c_mm * gemm / (par.tp * chip.peak_flops_bf16 * chip.mm_eff)
        L = self.cfg.num_layers + self.cfg.encoder_layers
        t_comm = self.tp_comm_time(batch, par.tp) if par.tp > 1 else 0.0
        t = max(t_mem, t_mm) + t_comm + self.c_over * chip.step_overhead
        return t / 1.0

    def decode_stage_time(self, batch: int, ctx_tokens: float, par: Parallelism) -> float:
        return self.decode_time(batch, ctx_tokens, par) / par.pp

    # ---- derived knobs ------------------------------------------------
    def saturation_tokens(self, par: Parallelism) -> int:
        """L_m: prompt tokens at which prefill turns compute-bound — the
        paper's batch-formation threshold (§3.1 / §4.3)."""
        chip = self.chip
        per_tok_time = self.gemm_flops_per_token() / (
            par.tp * chip.peak_flops_bf16 * chip.mm_eff)
        weight_time = self.param_bytes() / par.tp / (chip.hbm_bw * chip.hbm_eff)
        lm = max(int(weight_time / per_tok_time), 1)
        return min(lm, 8192)

    def auto_chunk_tokens(self, par: Parallelism, *,
                          page_tokens: int = 16,
                          overhead_frac: float = 0.1,
                          ref_tokens: int = 2048) -> int:
        """Model-derived chunked-prefill chunk size: the smallest page
        multiple whose chunking cost on a `ref_tokens` prompt stays within
        ``overhead_frac`` of the unchunked prefill time.

        Chunking re-pays the per-batch overhead (`c_over *
        chip.step_overhead`) once per chunk and loses weight-read
        amortization on short chunks, so tiny chunks are expensive; huge
        chunks stall decode longer (the interference `prefill_chunk_time`
        charges when a chunk runs on a decode/mixed instance). This walks
        chunk sizes up one page at a time and returns the first that fits
        the overhead budget — callers keep `chunk_tokens=<int>` as a
        manual override.
        """
        page_tokens = max(int(page_tokens), 1)
        ref = max(int(ref_tokens), page_tokens)
        base = self.prefill_time([ref], par)
        budget = (1.0 + overhead_frac) * base
        c = page_tokens
        while c < ref:
            total, ctx = 0.0, 0
            while ctx < ref:
                new = min(c, ref - ctx)
                total += self.prefill_chunk_time([(new, ctx)], par)
                ctx += new
            if total <= budget:
                break
            c += page_tokens
        return min(c, ref)

    def kv_transfer_time(self, prompt_len: int, bandwidth: float) -> float:
        c = self.cfg
        if c.family == "ssm":
            return self.kv_read_bytes(0) / bandwidth
        eff_len = min(prompt_len, c.sliding_window) if c.sliding_window else prompt_len
        return c.kv_bytes_per_token(self.dtype_bytes) * eff_len / bandwidth

    def kv_transfer_first_layer_time(self, prompt_len: int,
                                     bandwidth: float) -> float:
        """Exposed transfer latency under per-layer streaming: layers ship
        back-to-back, decode starts attending when layer 1 lands, so only
        1/L of the wire time sits on the critical path before the first
        decode iteration (the rest overlaps per-layer compute)."""
        L = max(self.cfg.num_layers, 1)
        return self.kv_transfer_time(prompt_len, bandwidth) / L

    def max_decode_batch(self, avg_ctx: float, par: Parallelism,
                         reserve: float = 0.35) -> int:
        """KV-capacity bound on the decode batch (paper §3.2)."""
        c = self.cfg
        hbm = self.chip.hbm_bytes * par.num_chips
        free = hbm * (1 - reserve) - self.param_bytes()
        if free <= 0:
            return 0
        if c.family == "ssm":
            per_req = self.kv_read_bytes(0)
        else:
            eff = min(avg_ctx, c.sliding_window) if c.sliding_window else avg_ctx
            per_req = c.kv_bytes_per_token(self.dtype_bytes) * eff
        return max(int(free / max(per_req, 1.0)), 0)


@dataclasses.dataclass
class EngineCharge:
    """Deterministic virtual-clock charge model for live engines.

    A live `DisaggCluster` normally charges measured `perf_counter` kernel
    times to its event loop; with `charge=EngineCharge(lm, par)` it charges
    the analytic `LatencyModel` time for each dispatch instead, so a live
    run's event timeline — and therefore its trace spans — is
    float-identical to `SimDisaggBackend` on the same request trace.  The
    three hooks mirror exactly what the simulator charges:

      prefill  `lm.prefill_time(suffix_lens, par)` — lengths net of any
               prefix-cache hit, the same lens the sim batches.
      chunk    `lm.prefill_chunk_time([(new, ctx)], par)`.
      decode   `lm.decode_time(max(b/pp, 1), ctx/pp, Parallelism(tp, 1))` —
               the sim's per-stage effective-batch form.
    """
    lm: LatencyModel
    par: Parallelism = Parallelism()

    def prefill(self, suffix_lens: Sequence[int]) -> float:
        return self.lm.prefill_time(suffix_lens, self.par)

    def chunk(self, new: int, ctx: int) -> float:
        return self.lm.prefill_chunk_time([(new, ctx)], self.par)

    def decode(self, batch: int, ctx_tokens: float) -> float:
        eff_b = max(batch / self.par.pp, 1.0)
        return self.lm.decode_time(eff_b, ctx_tokens / self.par.pp,
                                   Parallelism(self.par.tp, 1))
