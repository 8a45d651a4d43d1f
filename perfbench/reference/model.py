"""The plain reference of the device side: VT5 (T5 with 2-D box embeddings)
and Hi-VT5's page encode and page head, in plain PyTorch.

It follows the published T5 (t5-base: pre-norm RMSNorm without a mean or a
bias, eps 1e-6; no 1/sqrt(d_kv) scale in attention; a relative-position bias
of 32 log buckets up to distance 128, bidirectional in the encoder, causal
in the decoder, added in the first layer's attention and shared by the
others; a ReLU feed-forward; the LM head tied to the shared table after a
d_model^-1/2 scale), VT5's spatial embedding (x and y tables indexed by the
box corners times 1000, summed, LayerNorm eps 1e-12, a linear layer) added
to the token embedding, and Hi-VT5 (each page row led by `page_tokens`
copies of its page's embedding; the first `page_tokens` hidden states of
each page kept; a linear page head over the flattened kept states). The
buckets are worked out in float64, exactly.

It imports nothing of the program. It computes in float32 with TF32 off, or,
as the control, with every linear layer's weights and inputs rounded to
float8 e4m3 (one scale a tensor), the step below the bfloat16 that the
configurations state.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

MASKED = -1e9
E4M3_MAX = 448.0


def buckets(q_len: int, k_len: int, bidirectional: bool, n_buckets: int = 32, max_distance: int = 128) -> np.ndarray:
    """(q_len, k_len) relative-position buckets of key j seen from query i."""
    rel = np.arange(k_len)[None, :] - np.arange(q_len)[:, None]
    out = np.zeros_like(rel)
    if bidirectional:
        n_buckets //= 2
        out += (rel > 0) * n_buckets
        n = np.abs(rel)
    else:
        n = np.maximum(-rel, 0)
    exact = n_buckets // 2
    with np.errstate(divide="ignore"):
        large = exact + np.floor(np.log(np.maximum(n, 1) / exact) / math.log(max_distance / exact)
                                 * (n_buckets - exact)).astype(np.int64)
    return out + np.where(n < exact, n, np.minimum(large, n_buckets - 1))


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor (its amax over
    448, as Hopper's float8 products take it), returned in float32."""
    scale = x.abs().amax().clamp(min=1e-12) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class VT5:
    """`w` maps the parameter names (t5.shared, t5.encoder.layers.0.attn.q,
    ..., spatial.x_emb, page_emb, page_head.weight) to tensors; `c` is the
    configuration's engine dict."""

    def __init__(self, w: Dict[str, torch.Tensor], c: Dict, device, control: bool = False):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.w = {k: v.to(device=device, dtype=torch.float32) for k, v in w.items()}
        self.control = control
        self._q: Dict[str, torch.Tensor] = {}
        self.d, self.H, self.dkv = c["d_model"], c["num_heads"], c["d_kv"]
        self.n_enc = c["num_layers"]
        self.n_dec = c.get("num_decoder_layers", c["num_layers"])
        self.device = device

    # ---------------------------------------------------------------- parts
    def lin(self, x: torch.Tensor, name: str, bias: Optional[str] = None) -> torch.Tensor:
        w = self.w[name]
        if self.control:
            if name not in self._q:
                self._q[name] = fp8(w)
            w, x = self._q[name], fp8(x)
        y = x @ w.t()
        return y if bias is None else y + self.w[bias]

    def rms(self, x, name, eps=1e-6):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * self.w[name]

    def bias(self, stack: str, q_len: int, k_len: int, bidirectional: bool) -> torch.Tensor:
        b = torch.from_numpy(buckets(q_len, k_len, bidirectional)).to(self.device)
        return self.w[f"t5.{stack}.rel_bias"][b].permute(2, 0, 1)  # (H, q, k)

    def attend(self, x, kv, prefix, bias, mask):
        """Multi-head attention of x over kv: mask (N, 1|q, k) bool."""
        N, Tq, _ = x.shape
        Tk = kv.shape[1]
        q = self.lin(x, prefix + "q").view(N, Tq, self.H, self.dkv).transpose(1, 2)
        k = self.lin(kv, prefix + "k").view(N, Tk, self.H, self.dkv).transpose(1, 2)
        v = self.lin(kv, prefix + "v").view(N, Tk, self.H, self.dkv).transpose(1, 2)
        s = q @ k.transpose(-1, -2)
        if bias is not None:
            s = s + bias
        s = s.masked_fill(~mask[:, None], MASKED)
        o = (torch.softmax(s, -1) @ v).transpose(1, 2).reshape(N, Tq, -1)
        return self.lin(o, prefix + "o")

    def ffn(self, x, prefix):
        return self.lin(torch.relu(self.lin(x, prefix + "wi")), prefix + "wo")

    # ---------------------------------------------------------------- model
    def embed(self, ids: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """Token plus spatial embedding of (N, T) ids and (N, T, 4) int boxes."""
        b = boxes.clamp(0, self.w["spatial.x_emb"].shape[0] - 1)
        xe, ye = self.w["spatial.x_emb"], self.w["spatial.y_emb"]
        s = xe[b[..., 0]] + ye[b[..., 1]] + xe[b[..., 2]] + ye[b[..., 3]]
        mu = s.mean(-1, keepdim=True)
        var = (s - mu).square().mean(-1, keepdim=True)
        s = (s - mu) * torch.rsqrt(var + 1e-12) * self.w["spatial.ln_w"] + self.w["spatial.ln_b"]
        return self.w["t5.shared"][ids] + self.lin(s, "spatial.matcher_w", "spatial.matcher_b")

    def encode(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        T = x.shape[1]
        bias = self.bias("encoder", T, T, True)
        m = mask[:, None, :]
        for i in range(self.n_enc):
            p = f"t5.encoder.layers.{i}."
            h = self.rms(x, p + "ln0")
            x = x + self.attend(h, h, p + "attn.", bias, m)
            x = x + self.ffn(self.rms(x, p + "ln1"), p + "ffn.")
        return self.rms(x, "t5.encoder.final_ln")

    def decode_logits(self, enc: torch.Tensor, enc_mask: torch.Tensor, dec_in: torch.Tensor) -> torch.Tensor:
        """(N, Td, V) teacher-forced logits of the decoder inputs `dec_in`."""
        Td = dec_in.shape[1]
        x = self.w["t5.shared"][dec_in]
        bias = self.bias("decoder", Td, Td, False)
        causal = torch.ones(Td, Td, dtype=torch.bool, device=x.device).tril()[None]
        cross = enc_mask[:, None, :]
        for i in range(self.n_dec):
            p = f"t5.decoder.layers.{i}."
            h = self.rms(x, p + "ln0")
            x = x + self.attend(h, h, p + "self_attn.", bias, causal)
            x = x + self.attend(self.rms(x, p + "ln1"), enc, p + "cross_attn.", None, cross)
            x = x + self.ffn(self.rms(x, p + "ln2"), p + "ffn.")
        x = self.rms(x, "t5.decoder.final_ln") * self.d ** -0.5
        return self.lin(x, "t5.shared")

    def page_states(self, page: torch.Tensor, ids: torch.Tensor, boxes: torch.Tensor, mask: torch.Tensor,
                    k: int) -> torch.Tensor:
        """Hi-VT5: the first k hidden states of each page row, the row led by
        k copies of its page's embedding: (N, k, d)."""
        lead = self.w["page_emb"][page][:, None, :].expand(-1, k, -1)
        x = torch.cat([lead, self.embed(ids, boxes)], 1)
        m = torch.cat([torch.ones(ids.shape[0], k, dtype=torch.bool, device=ids.device), mask], 1)
        return self.encode(x, m)[:, :k]

    def page_logits(self, doc: torch.Tensor) -> torch.Tensor:
        """(N, P) page logits of (N, P * k, d) document states."""
        return self.lin(doc.reshape(doc.shape[0], -1), "page_head.weight", "page_head.bias")
