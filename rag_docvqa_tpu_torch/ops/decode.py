"""Fixed-length greedy decoding with the confidence product.

Counterpart of `rag_docvqa_tpu/ops/decode.py` (`greedy_decode`). The
semantics are those of `_decode_loop`: greedy argmax, pad emitted after a
sequence's EOS, and the confidence is the product over steps of the max of
an f32 softmax, with finished sequences and the last step contributing 1.

A Python loop over steps replaces `lax.scan`. It never syncs with the host:
the step is a Python int, the done flags and the confidence stay on the
device, and the decoder's rel-pos bias for every step is built once before
the loop. The JAX package's split dispatch (`greedy_decode_split`) works
around XLA relayouting an in-program cache; eager PyTorch has no such
program boundary, so the port has one function for it.

`greedy_decode_sharded` is the decode of the JAX dry run's split-dispatch
case under the `(data, model)` layout (`parallel/mesh.py`): the encoder rows
are this rank's share of the data axis, the parameters this rank's slices
as `training/train_step.py::vt5_param_spec` splits them; the split leaves
are gathered whole over the model axis, the rank decodes its rows (K3 where
the config asks for it), and the tokens and confidences are all-gathered in
rank order, so every rank returns the replicated decode's ids.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from rag_docvqa_tpu_torch.models import t5 as t5_mod
from rag_docvqa_tpu_torch.parallel.mesh import Mesh, gathered_params
from rag_docvqa_tpu_torch.profiling import span


def greedy_decode(
    params: "t5_mod.T5Params",
    cfg: "t5_mod.T5Config",
    encoder_hidden: torch.Tensor,  # (B, Te, D)
    encoder_mask: torch.Tensor,  # (B, Te) bool
    max_new_tokens: int = 100,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (tokens (B, T) int64 padded after EOS, confidence (B,) f32)."""
    B = encoder_hidden.shape[0]
    dev = encoder_hidden.device
    cache = t5_mod.init_decode_cache(params, cfg, encoder_hidden, max_new_tokens)
    bias = t5_mod.decoder_self_bias(params, cfg, max_new_tokens)  # (1, H, T, T)
    token = torch.full((B,), cfg.decoder_start_token_id, dtype=torch.int64, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    conf = torch.ones((B,), dtype=torch.float32, device=dev)
    tokens = []
    for t in range(max_new_tokens):
        with span("decode.step"):
            logits, cache = t5_mod.decode_step(params, cfg, cache, token, t, encoder_mask,
                                               self_bias=bias[:, :, t, :])
            with span("decode.head"):
                next_tok = logits.argmax(dim=-1)  # first max, as jnp.argmax
                emitted = torch.where(done, cfg.pad_id, next_tok)
                if t < max_new_tokens - 1:  # the last step is left out of the confidence
                    max_prob = torch.softmax(logits.float(), dim=-1).amax(dim=-1)
                    conf = conf * torch.where(done, 1.0, max_prob)
                done = done | (emitted == cfg.eos_id)
                token = emitted
                tokens.append(emitted)
    return torch.stack(tokens, dim=1), conf


@torch.no_grad()
def greedy_decode_sharded(
    params: "t5_mod.T5Params",  # this rank's slices, split as `spec` says
    cfg: "t5_mod.T5Config",
    encoder_hidden: torch.Tensor,  # (B / data, Te, D): this rank's rows
    encoder_mask: torch.Tensor,  # (B / data, Te) bool
    max_new_tokens: int,
    *,
    mesh: Mesh,
    spec: Dict[str, Optional[int]],  # parameter name -> model-axis dimension or None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`greedy_decode` of the whole batch: (tokens (B, T), confidence (B,)),
    the same on every rank."""
    whole = gathered_params(params, spec, mesh)
    tokens, conf = greedy_decode(whole, cfg, encoder_hidden, encoder_mask, max_new_tokens)
    return torch.cat(mesh.all_gather(tokens, "data")), torch.cat(mesh.all_gather(conf, "data"))
