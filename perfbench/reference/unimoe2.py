"""The plain reference of Uni-MoE-2.0-Omni's language model
(https://huggingface.co/HIT-TMG/Uni-MoE-2.0-Omni, `grin_qwen2_vl`), in plain
PyTorch, float32, TF32 off.

Qwen2.5's decoder (pre-norm RMSNorm at eps 1e-6, q/k/v with biases,
rotate-half rotary at theta 1e6 split into the (t, h, w) sections of
`mrope_section`, grouped-query causal attention at hd^-1/2, the final norm,
an untied head), with every layer's feed-forward the dynamic-capacity
mixture of experts of the configuration's keys. For a token's
post-attention normed state h:

  1. z = W_r h, W_r (E + Z, d): the E routed experts, then the Z null ones;
  2. p = softmax(z);
  3. the experts in order of p, largest first, ties to the lower index; the
     token takes the shortest prefix whose sum reaches top_p, cut to its
     first top_k;
  4. y = the sum of the S shared experts' SwiGLUs (no gate) plus the sum
     over the taken routed experts i of p_i SwiGLU_i(h): the p_i are not
     renormalised, a null expert adds nothing.

A decision's margin is how far its probabilities lie from changing it: the
gap between the last taken probability and the next one, and each prefix
sum's distance from top_p where it stops or does not stop the prefix; the
smallest of these. Where a decision's margin is at most `delta` and the
caller gives the tested side's decision at that token and layer
(`follow`), the reference takes that one, with its own probabilities: a
near-tie flips on rounding, and a flipped expert moves the token by a whole
expert's output.

Weights are the program's names: `layers.{i}.moe.router` (E + Z, d),
`.moe.gate_up` (E, 2 ff, d) (an expert's gate rows, then its up rows),
`.moe.down` (E, d, ff), `.moe.shared_gate_up` (2 S fs, d) (the shared
experts' gate rows one after another, then their up rows) and
`.moe.shared_down` (d, S fs) (their down projections side by side). The
reference takes each expert's slices and computes every expert apart.

It imports nothing of the program. It runs the sequences one layer at a
time, each layer's weights made float32 once (a layer of the published
model is 3.6 GB so), or, as the control, with every linear layer's weights
and inputs, the router's included, rounded to float8 e4m3 (`model.fp8`),
the step below the bfloat16 that the configuration states.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from perfbench.reference.model import fp8


@dataclass
class Pass:
    logits: torch.Tensor  # (len(at), V) float32
    experts: np.ndarray  # (T, L, top_k) the decision taken at each token and layer, -1 past the stop
    own: np.ndarray  # (T, L, top_k) the reference's own decision there
    margin: np.ndarray  # (T, L) the own decision's margin


def decide(p: torch.Tensor, top_k: int, top_p: float):
    """p (T, n) probabilities -> (experts (T, top_k) -1 past the stop, margin
    (T,)), as the module docstring has them."""
    T, n = p.shape
    vals, idx = torch.sort(p, dim=-1, descending=True, stable=True)
    prefix = torch.cumsum(vals, dim=-1)
    # the prefix stops at the first j with prefix_j >= top_p, or at top_k
    taken = torch.full((T,), top_k, dtype=torch.long, device=p.device)
    for j in range(top_k - 1, -1, -1):
        taken = torch.where(prefix[:, j] >= top_p, torch.full_like(taken, j + 1), taken)
    margin = torch.full((T,), math.inf, device=p.device)
    for j in range(top_k):
        live = j < taken
        if j + 1 < n:  # the last taken against the first left out
            gap = vals[:, j] - vals[:, j + 1]
            margin = torch.where(live & (j + 1 == taken), torch.minimum(margin, gap), margin)
        # a taken prefix that does not reach top_p, or that stops the token short of the cap: its distance
        stop = (prefix[:, j] - top_p).abs()
        counts = (j + 1 < taken) | ((prefix[:, j] >= top_p) & (j + 1 < top_k))
        margin = torch.where(live & counts, torch.minimum(margin, stop), margin)
    slots = torch.arange(top_k, device=p.device)[None]
    experts = torch.where(slots < taken[:, None], idx[:, :top_k], -1)
    return experts, margin


class UniMoE2:
    """`w` maps the program's parameter names to tensors, `c` is the
    configuration's engine dict, `delta` the margin inside which the
    reference takes a followed decision."""

    def __init__(self, w: Dict[str, torch.Tensor], c: Dict, device, control: bool = False, delta: float = 0.0):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.w, self.device, self.control, self.delta = w, device, control, delta
        self.L, self.H, self.Hkv = c["num_layers"], c["num_heads"], c["num_kv_heads"]
        self.hd = c["d_model"] // self.H
        self.theta = c.get("rope_theta", 1e6)
        self.section = list(c.get("mrope_section") or [])
        self.E, self.Z = c["moe_experts"], c.get("moe_null_experts", 0)
        self.top_k, self.top_p = c["moe_top_k"], c["moe_top_p"]
        self.ff, self.S, self.fs = c["moe_d_ff"], c.get("moe_shared_experts", 0), c.get("moe_shared_d_ff", 0)

    def f(self, name: str) -> torch.Tensor:
        return self.w[name].to(self.device, torch.float32)

    def weight(self, name: str) -> torch.Tensor:
        """A linear layer's weight: float32, or its float8 rounding in the control."""
        w = self.f(name)
        return fp8(w) if self.control else w

    def lin(self, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = (fp8(x) if self.control else x) @ w.t()
        return y if b is None else y + b

    @staticmethod
    def rms(x, w, eps=1e-6):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w

    @staticmethod
    def rotate(x, cos, sin):
        half = x.shape[-1] // 2
        return x * cos + torch.cat([-x[..., half:], x[..., :half]], -1) * sin

    def swiglu(self, h, gate, up, down):
        return self.lin(torch.nn.functional.silu(self.lin(h, gate)) * self.lin(h, up), down)

    def tables(self, positions: np.ndarray):
        """cos, sin (T, 1, hd) of (3, T) M-RoPE positions (1-D: equal rows)."""
        inv = 1.0 / self.theta ** (torch.arange(0, self.hd, 2, device=self.device).float() / self.hd)
        ang = torch.from_numpy(np.asarray(positions)).to(self.device).float()[..., None] * inv  # (3, T, hd/2)
        if self.section:
            bounds = np.cumsum([0] + self.section)
            ang = torch.cat([ang[i, :, bounds[i]:bounds[i + 1]] for i in range(3)], -1)
        else:
            ang = ang[0]
        ang = torch.cat([ang, ang], -1)[:, None]
        return torch.cos(ang), torch.sin(ang)

    def run(self, seqs: Sequence[Sequence[int]], positions: Sequence[np.ndarray], at: Sequence[Sequence[int]],
            follow: Optional[Sequence[np.ndarray]] = None) -> List[Pass]:
        """Each sequence's logits at its places `at` and its decisions:
        `positions[i]` (3, T_i), `follow[i]` (T_i, L, top_k) the tested side's
        decisions (-1 past its stop) or None."""
        n = len(seqs)
        xs, rope, masks = [], [], []
        for ids, pos in zip(seqs, positions):
            T = len(ids)
            xs.append(self.w["embed"][torch.tensor(list(ids), device=self.w["embed"].device)]
                      .to(self.device, torch.float32))
            rope.append(self.tables(pos))
            masks.append(torch.ones(T, T, dtype=torch.bool, device=self.device).tril())
        took = [np.zeros((len(s), self.L, self.top_k), np.int64) for s in seqs]
        own = [np.zeros((len(s), self.L, self.top_k), np.int64) for s in seqs]
        margins = [np.zeros((len(s), self.L), np.float32) for s in seqs]
        for layer in range(self.L):
            W = self.layer_weights(layer)
            for i in range(n):
                x, (cos, sin), causal = xs[i], rope[i], masks[i]
                T = x.shape[0]
                h = self.rms(x, W["ln0"])
                q = self.lin(h, W["q.weight"], W["q.bias"]).view(T, self.H, self.hd)
                k = self.lin(h, W["k.weight"], W["k.bias"]).view(T, self.Hkv, self.hd)
                v = self.lin(h, W["v.weight"], W["v.bias"]).view(T, self.Hkv, self.hd)
                q, k = self.rotate(q, cos, sin), self.rotate(k, cos, sin)
                k, v = (t.repeat_interleave(self.H // self.Hkv, dim=1) for t in (k, v))
                s = torch.einsum("qhd,khd->hqk", q, k) * self.hd ** -0.5
                a = torch.softmax(s.masked_fill(~causal, -math.inf), -1)
                x = x + self.lin(torch.einsum("hqk,khd->qhd", a, v).reshape(T, -1), W["o.weight"])
                h = self.rms(x, W["ln1"])
                theirs = None
                if follow is not None and follow[i] is not None:
                    theirs = torch.from_numpy(np.asarray(follow[i][:, layer])).to(self.device)
                y, chosen, mine, margin = self.experts(h, W, theirs)
                took[i][:, layer], own[i][:, layer] = chosen.cpu().numpy(), mine.cpu().numpy()
                margins[i][:, layer] = margin.cpu().numpy()
                xs[i] = x + y
            del W
        final, head = self.f("final_ln"), self.weight("lm_head")
        out = []
        for i in range(n):
            x = self.rms(xs[i], final)[torch.tensor(list(at[i]), device=self.device, dtype=torch.long)]
            out.append(Pass(self.lin(x, head), took[i], own[i], margins[i]))
        return out

    def layer_weights(self, layer: int) -> Dict[str, torch.Tensor]:
        """Layer `layer`'s tensors in float32, its linear weights rounded to
        float8 in the control."""
        p = f"layers.{layer}."
        W = {k: self.weight(p + k) for k in ("q.weight", "k.weight", "v.weight", "o.weight", "moe.router",
                                             "moe.gate_up", "moe.down")}
        W.update({k: self.f(p + k) for k in ("ln0", "ln1", "q.bias", "k.bias", "v.bias")})
        if self.S:
            W["moe.shared_gate_up"] = self.weight(p + "moe.shared_gate_up")
            W["moe.shared_down"] = self.weight(p + "moe.shared_down")
        return W

    def experts(self, h: torch.Tensor, W: Dict[str, torch.Tensor], theirs: Optional[torch.Tensor] = None):
        """The expert layer on h (T, d): (y (T, d), the decision taken (T,
        top_k), the own decision, its margin (T,)); `theirs` (T, top_k) the
        followed decision or None."""
        T, d = h.shape
        p = torch.softmax(self.lin(h, W["moe.router"]), -1)
        mine, margin = decide(p, self.top_k, self.top_p)
        chosen = mine if theirs is None else torch.where((margin <= self.delta)[:, None], theirs.long(), mine)
        y = torch.zeros(T, d, device=h.device)
        fs = self.fs
        for s in range(self.S):
            gate = W["moe.shared_gate_up"][s * fs:(s + 1) * fs]
            up = W["moe.shared_gate_up"][(self.S + s) * fs:(self.S + s + 1) * fs]
            y = y + self.swiglu(h, gate, up, W["moe.shared_down"][:, s * fs:(s + 1) * fs])
        for e in range(self.E):
            rows = (chosen == e).any(-1).nonzero()[:, 0]
            if rows.numel() == 0:
                continue
            out = self.swiglu(h[rows], W["moe.gate_up"][e, :self.ff], W["moe.gate_up"][e, self.ff:], W["moe.down"][e])
            y[rows] += p[rows, e][:, None] * out
        return y, chosen, mine, margin
