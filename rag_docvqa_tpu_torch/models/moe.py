"""The dynamic-capacity expert layer: a causal-LM feed-forward of routed
experts chosen by top-p, null experts and shared experts (the language model
of Uni-MoE-2.0-Omni, `grin_qwen2_vl`). The JAX package has no counterpart:
every feed-forward there is dense.

For a token's post-attention normed state h (`models/causal_lm.py`'s ln1
output), with E routed experts, Z null experts, top-k and top-p:

  1. z = W_r float32(h), W_r (E + Z, d) in float32 (a router in float32);
     rows E .. E + Z - 1 are the null experts;
  2. p = softmax(z);
  3. the experts in order of p, largest first, ties to the lower index; a
     token takes the shortest prefix whose sum reaches top-p, cut to its
     first top-k (`route`);
  4. y = the sum of the shared experts' SwiGLUs, ungated, plus the sum over
     the taken experts i that are not null of p_i SwiGLU_i(h): the p_i are
     not renormalised, and a null expert adds nothing (`expert_layer`).

`expert_layer` makes no copy back to the host and no synchronize, so a pass
never waits on the host and a decode step could be captured as a graph. The
taken (token, expert) pairs are sorted by expert on the device, each
expert's rows found by `searchsorted` there; the gate and up products of
every expert are one grouped bf16 GEMM over those offsets
(`torch._grouped_mm`), the gated product `ops/lm_glue.py::glu_rows` over the
live rows only, the down products a second grouped GEMM; the weighted
combine is a float32 scatter-add onto the shared experts' output, rounded
once to h's dtype. The rows past the last expert's are never read: their
pairs scatter into a row of their own, which is dropped. A position the
`valid` mask leaves out (the padding of a right-padded prompt) takes no
expert: its output reaches no valid token.

Parameters (`MoEBlock`, per layer): `router` (E + Z, d); the routed experts
stacked, `gate_up` (E, 2 d_ff, d) (each expert's gate rows, then its up
rows) and `down` (E, d, d_ff); the shared experts side by side as one
SwiGLU of width S x shared_d_ff, `shared_gate_up` (2 S shared_d_ff, d) (every
shared expert's gate rows, then every one's up rows) and `shared_down` (d, S
shared_d_ff): the sum of S ungated SwiGLUs is that one.

`route` and `expert_layer` are looked up as attributes of this module where
they are called, so a caller may wrap them. With the tracer on
(`profiling.py`): the span `moe.layer`, its children `moe.route`,
`moe.experts` and `moe.shared`; the host counter `moe.layers` (one a layer
a pass) and the device counters `moe.tokens` (the valid tokens),
`moe.routed_pairs` (the taken experts that are not null), `moe.null_picks`
(the taken null experts) and `moe.one_pick` (the valid tokens whose top-p
stopped at one expert).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rag_docvqa_tpu_torch import profiling
from rag_docvqa_tpu_torch.ops import lm_glue


class MoEBlock(nn.Module):
    """A layer's router, routed experts and shared experts (module
    docstring); the shared pair is None where the layer has none."""

    def __init__(self, router, gate_up, down, shared_gate_up=None, shared_down=None):
        super().__init__()
        from rag_docvqa_tpu_torch.models.causal_lm import _hold

        self.router, self.gate_up, self.down = _hold(router), _hold(gate_up), _hold(down)
        self.shared_gate_up, self.shared_down = _hold(shared_gate_up), _hold(shared_down)

    def tensors(self):
        return (self.router, self.gate_up, self.down, self.shared_gate_up, self.shared_down)


def routers_to_float32(params) -> None:
    """Every expert layer's router of a causal LM's tree held in float32 (a
    tree loaded in bf16 keeps the same values), so `route` casts nothing a
    pass."""
    from rag_docvqa_tpu_torch.models.layers import frozen

    for layer in params.layers:
        if layer.moe is not None and layer.moe.router.dtype != torch.float32:
            layer.moe.router = frozen(layer.moe.router.detach().float())


def init_moe_block(draw, cfg, dtype: torch.dtype) -> MoEBlock:
    """The init of `causal_lm.init_causal_lm_params`: every projection
    N(0, 1/fan_in), a shared expert's down projection over its own width;
    the router drawn and held in float32."""
    d, ff, E = cfg.d_model, cfg.moe_d_ff, cfg.moe_experts
    router = draw((E + cfg.moe_null_experts, d), d**-0.5, torch.float32)
    gate_up = draw((E, 2 * ff, d), d**-0.5, dtype)
    down = draw((E, d, ff), ff**-0.5, dtype)
    shared_gate_up = shared_down = None
    if cfg.moe_shared_experts:
        width = cfg.moe_shared_experts * cfg.moe_shared_d_ff
        shared_gate_up = draw((2 * width, d), d**-0.5, dtype)
        shared_down = draw((d, width), cfg.moe_shared_d_ff**-0.5, dtype)
    return MoEBlock(router, gate_up, down, shared_gate_up, shared_down)


def route(h: torch.Tensor, router: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """h (N, d) -> (experts (N, top_k) int64, probs (N, top_k) float32): each
    token's taken experts in order of probability (null experts included,
    numbered from `moe_experts`), -1 in a slot past where its top-p stopped,
    and their softmax probabilities, 0 there."""
    p = torch.softmax(F.linear(h.float(), router.float()), dim=-1)
    probs, experts = torch.sort(p, dim=-1, descending=True, stable=True)
    probs, experts = probs[:, :cfg.moe_top_k], experts[:, :cfg.moe_top_k]
    before = torch.cumsum(probs, dim=-1) - probs  # the sum of the slots ahead of each
    taken = before < cfg.moe_top_p
    return torch.where(taken, experts, -1), torch.where(taken, probs, 0.0)


def _grouped(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """x (M, K) rows grouped by expert at `offs` (int32 ends), w (E, out, K):
    row r of expert e's group times w[e].T; the rows past the last end are
    left unset."""
    return torch._grouped_mm(x, w.transpose(1, 2), offs=offs)


def _glu(gu: torch.Tensor, act: str, fused: bool, live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """act(gate) * up of rows that hold their gate, then their up: the kernel
    over the `live` rows where `fused`, else the plain ops over every row."""
    if fused:
        return lm_glue.glu_rows(gu, act, live)
    width = gu.shape[-1] // 2
    return lm_glue.glu_reference(gu[..., :width], gu[..., width:], act)


def _shared(x: torch.Tensor, block: MoEBlock, act: str, fused: bool) -> torch.Tensor:
    from rag_docvqa_tpu_torch.models.layers import dense

    return dense(_glu(dense(x, block.shared_gate_up), act, fused), block.shared_down)


def _count(experts: torch.Tensor, kept: torch.Tensor, valid: Optional[torch.Tensor], E: int) -> None:
    profiling.count("moe.layers", 1)
    if not profiling.enabled():
        return
    live = torch.ones_like(experts[:, 0], dtype=torch.bool) if valid is None else valid
    profiling.device_count("moe.tokens", live)
    profiling.device_count("moe.routed_pairs", kept)
    profiling.device_count("moe.null_picks", (experts >= E) & live[:, None])
    if experts.shape[1] > 1:
        profiling.device_count("moe.one_pick", (experts[:, 1] < 0) & live)


def expert_layer(h: torch.Tensor, block: MoEBlock, cfg, fused: bool,
                 valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The layer's output for h (..., d), in h's dtype (module docstring);
    `valid` (h's leading shape, bool) leaves positions out, `fused` takes the
    gated product's kernel."""
    from rag_docvqa_tpu_torch.models.causal_lm import _act_name

    shape, d, E, k = h.shape, h.shape[-1], cfg.moe_experts, cfg.moe_top_k
    act = _act_name(cfg)
    x = h.reshape(-1, d)
    N = x.shape[0]
    live = None if valid is None else valid.reshape(-1)
    with profiling.span("moe.layer"):
        with profiling.span("moe.route"):
            experts, probs = route(x, block.router, cfg)
            kept = (experts >= 0) & (experts < E)
            if live is not None:
                kept = kept & live[:, None]
            _count(experts, kept, live, E)
        with profiling.span("moe.shared"):
            out = torch.empty(N + 1, d, dtype=torch.float32, device=x.device)  # row N takes the dropped pairs
            if block.shared_gate_up is not None:
                out[:N] = _shared(x, block, act, fused)
            else:
                out[:N].zero_()
            out[N].zero_()
        with profiling.span("moe.experts"):
            ids, order = torch.sort(torch.where(kept, experts, E).reshape(-1), stable=True)
            offs = torch.searchsorted(ids, torch.arange(E, device=x.device), right=True).to(torch.int32)
            token = torch.div(order, k, rounding_mode="floor")
            gu = _grouped(x[token], block.gate_up, offs)
            a = _glu(gu, act, fused, offs[E - 1:])
            del gu
            y = _grouped(a, block.down, offs)
            del a
            weight = probs.reshape(-1)[order]
            out.index_add_(0, torch.where(ids < E, token, N), y.float() * weight[:, None])
        return out[:N].to(h.dtype).reshape(shape)
