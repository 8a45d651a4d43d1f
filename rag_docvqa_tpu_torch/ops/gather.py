"""Assembly of generator inputs from retrieval output, on the device.

Counterpart of `rag_docvqa_tpu/ops/gather.py` for the concat strategy:
`compute_ownership`, `group_boxes`, `_ordered_slots`, `_flatten_tokens_src`
and `assemble_concat`. The per-chunk and per-page assemblies wait for the
slice of the other strategies.

Semantics ("slot" = word occurrence, see data/contract.py):

  1. Top-k chunk r covers slot window [start_r - s, end_r + s) clamped to its
     page's slot range.
  2. A slot is owned by the first (best-ranked) chunk whose window covers it.
  3. Output word order = ranks in retrieval order, slots in page order within
     each rank.
  4. Generator input = prompt tokens ++ flattened slot tokens (optional sep
     token between rank groups) ++ EOS, truncated to max_source_length with
     the EOS always kept.

Two places where torch differs from `jnp`: `.at[].add(mode="drop")` drops
out-of-range offsets while `scatter_add_` raises on them, so offsets of S or
more are masked out first; and the slot argsort is asked to be stable.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from rag_docvqa_tpu_torch.data.contract import ChunkedBatch, GeneratorInputs

# layout label values for non-content tokens
PROMPT_LABEL = 4
EOS_LABEL = 4
PAD_LABEL = 4
PROMPT_BOX = (0, 0, 1000, 1000)


@dataclass(frozen=True)
class AssembleConfig:
    max_source_length: int = 512
    include_surroundings: int = 0
    sep_token_id: int = 0  # 0 disables sep insertion
    eos_token_id: int = 1
    pad_token_id: int = 0


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """take_along_axis on dim 1."""
    return torch.gather(x, 1, idx)


def compute_ownership(
    batch: ChunkedBatch,
    top_k_idx: torch.Tensor,  # (B, K)
    top_k_valid: torch.Tensor,  # (B, K)
    include_surroundings: int,
) -> torch.Tensor:
    """Returns owner (B, W): rank of the first covering chunk, else K."""
    B, K = top_k_idx.shape
    W = batch.slot_mask.shape[1]
    start = _take(batch.chunk_slot_start, top_k_idx)
    length = _take(batch.chunk_slot_len, top_k_idx)
    page = _take(batch.chunk_page, top_k_idx)
    lo = torch.maximum(_take(batch.page_slot_start, page), start - include_surroundings)
    hi = torch.minimum(_take(batch.page_slot_end, page), start + length + include_surroundings)
    g = torch.arange(W, device=top_k_idx.device)[None, None, :]
    covered = (g >= lo[:, :, None]) & (g < hi[:, :, None]) & top_k_valid[:, :, None]
    rank = torch.arange(K, device=top_k_idx.device)[None, :, None]
    owner = torch.where(covered, rank, K).amin(dim=1)
    return torch.where(batch.slot_mask, owner, K)


def group_boxes(batch: ChunkedBatch, owner: torch.Tensor, K: int) -> torch.Tensor:
    """Per-rank bbox union of owned slots; empty group -> [0, 0, 1, 1]."""
    onehot = owner[:, None, :] == torch.arange(K, device=owner.device)[None, :, None]
    box = batch.slot_box[:, None, :, :]  # (B, 1, W, 4)
    big = 1e9
    mins = torch.where(onehot[..., None], box, big).amin(dim=2)
    maxs = torch.where(onehot[..., None], box, -big).amax(dim=2)
    out = torch.stack([mins[..., 0], mins[..., 1], maxs[..., 2], maxs[..., 3]], dim=-1)
    empty = ~onehot.any(dim=2)
    fallback = torch.tensor([0.0, 0.0, 1.0, 1.0], device=owner.device)
    return torch.where(empty[..., None], fallback, out)


def _flatten_tokens_src(
    order: torch.Tensor,  # (B, M) output slot position -> source index
    order_ntok: torch.Tensor,  # (B, M) in ordered positions, 0 for dropped
    src_tokens: torch.Tensor,  # (B0, M, TW) payload in source order
    src_box: torch.Tensor,  # (B0, M, 4) int scaled boxes, source order
    src_label: torch.Tensor,  # (B0, M) source order
    prompt_tokens: torch.Tensor,  # (B, LP)
    prompt_len: torch.Tensor,  # (B,)
    cfg: AssembleConfig,
) -> GeneratorInputs:
    """Flatten ordered slots into (B, S) generator rows, composing the slot
    permutation into the final gathers. With B = B0 * R output rows, source
    batch b = row // R."""
    B, M = order.shape
    B0, _, TW = src_tokens.shape
    R = B // B0
    S = cfg.max_source_length
    lp = prompt_tokens.shape[1]
    dev = order.device

    offsets = prompt_len[:, None] + torch.cumsum(order_ntok, dim=1) - order_ntok  # (B, M)
    total = prompt_len + order_ntok.sum(dim=1)
    eos_pos = torch.clamp(total, max=S - 1)

    # .at[].add(mode="drop"): offsets >= S add nothing
    in_range = offsets < S
    bounds = torch.zeros((B, S), dtype=torch.int64, device=dev)
    bounds.scatter_add_(1, torch.where(in_range, offsets, 0), in_range.to(torch.int64))
    m_i = (torch.cumsum(bounds, dim=1) - 1).clamp(0, M - 1)  # (B, S)

    src_off = _take(offsets, m_i)
    i_pos = torch.arange(S, device=dev)[None, :]
    t_i = (i_pos - src_off).clamp(0, TW - 1)

    src_m = _take(order, m_i)  # (B, S) source slot
    b_idx = (torch.arange(B, device=dev) // R)[:, None]
    flat_tok = src_tokens.reshape(B0, M * TW)
    content_ids = flat_tok[b_idx, src_m * TW + t_i]
    content_box = src_box[b_idx, src_m]  # (B, S, 4)
    content_lab = src_label[b_idx, src_m]

    prompt_ids = _take(prompt_tokens, i_pos.clamp(max=lp - 1).expand(B, S))

    is_eos = i_pos == eos_pos[:, None]
    is_prompt = i_pos < prompt_len[:, None]
    is_content = (i_pos >= prompt_len[:, None]) & (i_pos < eos_pos[:, None])
    out_ids = torch.where(
        is_eos, cfg.eos_token_id,
        torch.where(is_prompt, prompt_ids, torch.where(is_content, content_ids, cfg.pad_token_id)),
    )
    pbox = torch.tensor(PROMPT_BOX, dtype=torch.int64, device=dev)[None, None, :]
    out_box = torch.where(
        is_eos[..., None], 0,
        torch.where(is_prompt[..., None], pbox, torch.where(is_content[..., None], content_box, 0)),
    )
    out_lab = torch.where(
        is_eos, EOS_LABEL,
        torch.where(is_prompt, PROMPT_LABEL, torch.where(is_content, content_lab, PAD_LABEL)),
    )
    return GeneratorInputs(
        input_ids=out_ids, input_boxes=out_box, input_labels=out_lab,
        attention_mask=i_pos <= eos_pos[:, None],
    )


def _ordered_slots(batch: ChunkedBatch, owner: torch.Tensor, K: int, sep_token_id: int):
    """Sort slots by (owner rank, slot index); prepend a sep pseudo-slot to
    each non-empty group r > 0 when sep_token_id != 0. Returns the order and
    the ordered ntok, with the payloads left in source order."""
    B, W = owner.shape
    TW = batch.slot_tokens.shape[2]
    dev = owner.device
    g = torch.arange(W, device=dev)[None, :]
    box_int = (batch.slot_box * 1000).to(torch.int64)

    if sep_token_id != 0:
        ranks = torch.arange(K, device=dev)[None, :]
        group_nonempty = (owner[:, None, :] == ranks[:, :, None]).any(dim=2)  # (B, K)
        sep_active = group_nonempty & (ranks > 0)
        sep_owner = torch.where(sep_active, ranks, K)
        sep_tokens = torch.zeros((B, K, TW), dtype=batch.slot_tokens.dtype, device=dev)
        sep_tokens[:, :, 0] = sep_token_id
        all_owner = torch.cat([owner, sep_owner], dim=1)
        # real slot at owner*(W+2) + g + 1; sep at owner*(W+2) (group head)
        key = torch.cat([owner * (W + 2) + g + 1, sep_owner * (W + 2)], dim=1)
        all_tokens = torch.cat([batch.slot_tokens, sep_tokens], dim=1)
        all_ntok = torch.cat([batch.slot_ntok, sep_active.to(batch.slot_ntok.dtype)], dim=1)
        all_box = torch.cat([box_int, torch.zeros((B, K, 4), dtype=box_int.dtype, device=dev)], dim=1)
        all_label = torch.cat(
            [batch.slot_label, torch.zeros((B, K), dtype=batch.slot_label.dtype, device=dev)], dim=1)
    else:
        all_owner = owner
        key = owner * (W + 2) + g + 1
        all_tokens, all_ntok, all_box, all_label = (
            batch.slot_tokens, batch.slot_ntok, box_int, batch.slot_label)

    order = torch.argsort(key, dim=1, stable=True)
    o_owner = _take(all_owner, order)
    o_ntok = torch.where(o_owner < K, _take(all_ntok, order), 0)
    return order, o_ntok, all_tokens, all_box, all_label


def assemble_concat(
    batch: ChunkedBatch,
    top_k_idx: torch.Tensor,  # (B, K)
    top_k_valid: torch.Tensor,  # (B, K)
    cfg: AssembleConfig,
) -> Tuple[GeneratorInputs, torch.Tensor]:
    """Concat strategy: all top-k groups flattened into one generator input
    per sample. Returns (inputs, owner)."""
    K = top_k_idx.shape[1]
    owner = compute_ownership(batch, top_k_idx, top_k_valid, cfg.include_surroundings)
    order, o_ntok, src_tokens, src_box, src_label = _ordered_slots(batch, owner, K, cfg.sep_token_id)
    gen = _flatten_tokens_src(
        order, o_ntok, src_tokens, src_box, src_label,
        batch.prompt_tokens, batch.prompt_len, cfg,
    )
    return gen, owner
