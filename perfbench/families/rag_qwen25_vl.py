"""RAG with Qwen2.5-VL (`build_engine`'s Qwen branch with `use_visual`): how
the benchmark builds it, what it records from the timed path, the work of a
call and its check.

The tree is the program's `CausalLMParams` with the Qwen2.5-VL tower under
`vision`, built on the `meta` device (no memory) and filled by the seeded
weights. `leaf_init` is the initialisation of the program's own
`init_causal_lm_params` and `init_qwen25_vision_params`: projections
fan_in^-1/2, the embedding 0.02, an untied head d_model^-1/2, biases zeros,
norms ones.

Recorded per call: the chosen chunks (`rag_qwen.retrieve`'s top-k), the
page images the call was handed and the crop tokens the tower gave with
their validity (`RAGQwenEngine._encode_crops`), and the prompt ids, mask,
M-RoPE positions and served tokens (`causal_lm.generate`). The crop tokens
are kept on the device until the check (a call's are B x max_crops x 256 x
d_model, 235 MB in bfloat16 at B 32).

The check holds a sample of the served documents to the plain reference
(`perfbench/reference/qwen25_vl.py`), which builds each prompt from its
own chunk table, the program's choice of chunks and the page images the
stream makes again: "prompt_mismatch", positions of ids or mask unlike the
reference's; "position_mismatch", valid positions whose (t, h, w) index
fed to the prefill differs from the reference's (0 .. T-1 on every axis
where the program fed none); "image_mismatch", pages unlike; "crop_err",
the widest distance of a crop's merged token from the reference tower's on
the reference's own crop, over the largest norm of that crop's reference
tokens (infinite where the crops differ in number); "logit_gap", every
served token against the reference's teacher-forced logits, its own crop
tokens in the image spans (`perfbench/check.py`). With `control`, the
float8 control's readings of the last two in the program's place.
"""

from __future__ import annotations

import math
from contextlib import ExitStack, contextmanager
from typing import Dict, List

import numpy as np
import torch

from perfbench import check as chk
from perfbench import work
from perfbench.reference import text
from perfbench.reference.qwen25_vl import QwenVL, chunk_box, crop, crop_pixels, rope_index

# the ChatML prompt of the Qwen2.5 chat template, with a vision span a crop
SYSTEM = "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
USER_OPEN = "<|im_start|>user\n"
USER_CLOSE = "<|im_end|>\n<|im_start|>assistant\n"
USER_TEXT = ("question: {question}\nDirectly provide only a short direct answer to the question. "
             "The answer appears in the following context. Context: {context}")
VISION_OPEN, VISION_CLOSE, IMAGE_PAD = "<|vision_start|>", "<|vision_end|>", "<|image_pad|>"


def leaf_init(name: str, shape, c: Dict):
    last = name.rsplit(".", 1)[-1]
    if last in ("ln0", "ln1", "ln2", "final_ln", "ln_q"):
        return ("ones",)
    if last == "bias" or last.endswith("_b"):
        return ("zeros",)
    if name == "embed":
        return ("normal", 0.02)
    if name == "lm_head":
        return ("normal", c["d_model"] ** -0.5)
    if len(shape) == 2 and (last == "weight" or last.endswith("_w")):
        return ("normal", shape[1] ** -0.5)
    raise ValueError(f"no initialisation rule for the leaf {name!r} {tuple(shape)}")


def structure(c: Dict, vocab: int, device):
    """The program's tree on the `meta` device: the causal LM with an untied
    head, the tower under `vision`."""
    from rag_docvqa_tpu_torch.config import build_qwen25_vision_config, build_qwen_config
    from rag_docvqa_tpu_torch.models.causal_lm import CausalLMLayer, CausalLMParams, Proj
    from rag_docvqa_tpu_torch.models.qwen25_vision import Qwen25VisionLayer, Qwen25VisionParams

    cfg = build_qwen_config(c, vocab)
    d, hd, ff = cfg.d_model, cfg.head_dim, cfg.d_ff
    q, kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    e = lambda *shape: torch.empty(*shape, device="meta")
    lin = lambda din, dout, bias: Proj(e(dout, din), e(dout) if bias else None)
    layers = [CausalLMLayer(e(d), lin(d, q, True), lin(d, kv, True), lin(d, kv, True), lin(q, d, False), e(d),
                            lin(d, ff, False), lin(d, ff, False), lin(ff, d, False)) for _ in range(cfg.num_layers)]
    v = build_qwen25_vision_config(c, d)
    D, I, merged = v.hidden_size, v.intermediate_size, v.hidden_size * v.spatial_merge_size**2
    shapes = {"ln1": (D,), "ln2": (D,), "qkv_w": (3 * D, D), "qkv_b": (3 * D,), "proj_w": (D, D), "proj_b": (D,),
              "gate_w": (I, D), "gate_b": (I,), "up_w": (I, D), "up_b": (I,), "down_w": (D, I), "down_b": (D,)}
    tower = Qwen25VisionParams(e(D, v.patch_dim), [Qwen25VisionLayer(**{k: e(*s) for k, s in shapes.items()})
                                                   for _ in range(v.depth)],
                               e(D), e(merged, merged), e(merged), e(d, merged), e(d))
    return CausalLMParams(e(vocab, d), layers, e(d), e(vocab, d), vision=tower)


@contextmanager
def install(engine, recorder):
    from rag_docvqa_tpu_torch.engine import rag_qwen
    from rag_docvqa_tpu_torch.models import causal_lm

    from perfbench.record import wrapped

    def chosen(ret, *args, **kwargs):
        recorder.put(topk_idx=ret.top_k_idx, topk_valid=ret.top_k_valid)

    def crops(out, batch, aux, ret):
        recorder.put(images=aux["images"], crops=out[0], crop_valid=out[1])

    def generated(out, params, cfg, ids, mask, *args, **kwargs):
        recorder.put(ids=ids, mask=mask, positions=kwargs.get("positions"), tokens=out[0])

    with ExitStack() as stack:
        stack.enter_context(wrapped(rag_qwen, "retrieve", chosen))
        stack.enter_context(wrapped(engine, "_encode_crops", crops))
        stack.enter_context(wrapped(causal_lm, "generate", generated))
        yield


def tower_work(c: Dict, crops: int) -> work.Work:
    """The tower over `crops` valid crops: the patch embedding, each layer's
    projections and feed-forward, its attention over a window's or the
    whole crop's patches, the merger; the tower's weights read once, the
    patches read and the merged tokens written."""
    v, d = c["vision"], c["d_model"]
    D, I, p = v["hidden_size"], v["intermediate_size"], v["patch_size"]
    g = v["image_size"] // p
    seq, window = g * g, (v["window_size"] // p) ** 2
    patch_dim = 3 * v["temporal_patch_size"] * p * p
    merged = 4 * D
    full = len(v["fullatt_block_indexes"])
    layer = 2.0 * seq * (4 * D * D + 3 * D * I)
    attn = 4.0 * seq * D * (full * seq + (v["depth"] - full) * window)
    flops = 2.0 * seq * patch_dim * D + v["depth"] * layer + attn + 2.0 * (seq // 4) * (merged * merged + merged * d)
    weights = (patch_dim * D + v["depth"] * (4 * D * D + 3 * D * I) + merged * merged + merged * d) * work.BF16
    return work.Work(crops * flops, weights + work.BF16 * crops * (seq * patch_dim + (seq // 4) * d))


def call_work(c: Dict, vocab: int, record) -> Dict[str, work.Work]:
    """The tower over the valid crops; the prefill over each row's valid
    prompt tokens and the decode's steps up to each row's EOS: every
    projection, the causal attention, the head at the positions that give a
    token; the weights read once a pass, the KV cache once a step."""
    d, L, H, Hkv, ff = c["d_model"], c["num_layers"], c["num_heads"], c["num_kv_heads"], c["d_ff"]
    hd = d // H
    layer = d * (H + 2 * Hkv) * hd + H * hd * d + 3 * d * ff
    weights = (L * layer + vocab * d) * work.BF16
    valid = record.get("crop_valid")
    crops = tower_work(c, int(np.asarray(valid).sum()) if valid is not None else 0)
    prompt = record["mask"].sum(1).tolist()
    steps = chk.served_steps(record["tokens"].cpu().numpy()).tolist()
    prefill = work.Work(sum(2.0 * L * layer * n + 2.0 * L * n * n * H * hd + 2.0 * d * vocab for n in prompt),
                        weights + work.BF16 * sum(prompt) * (d + 2 * L * Hkv * hd))
    decode = work.Work()
    for t in range(1, max(steps, default=0)):
        rows = [n for n, s in zip(prompt, steps) if s > t]
        cache = sum(n + t for n in rows)
        decode = decode + work.Work(len(rows) * 2.0 * (L * layer + d * vocab) + 4.0 * L * H * hd * cache,
                                    weights + work.BF16 * 2 * L * Hkv * hd * cache)
    return {"crops": crops, "prefill": prefill, "decode": decode, "model": crops + prefill + decode}


def ranked_words(d: text.Doc, chosen: List[int]) -> List[List[str]]:
    """The chosen chunks' words, rank by rank: each word slot once, taken by
    the best-ranked chunk that holds it, in slot order within a rank."""
    owner: Dict[tuple, int] = {}
    for r, i in enumerate(chosen):
        for k in range(len(d.chunks[i])):
            owner.setdefault((i, k), r)
    ranks: List[List[str]] = [[] for _ in chosen]
    for i, ch in enumerate(d.chunks):
        for k, (p, w) in enumerate(ch):
            if (i, k) in owner:
                ranks[owner[i, k]].append(d.words[p][w])
    return ranks


def prompt(question: str, ranks: List[List[str]], n_crops: int, tokens: int, tok: text.HashTokenizer, limit: int):
    """(ids, image spans (start, tokens)) of the ChatML prompt with one vision
    span of `tokens` image tokens a crop after the text, cut to `limit`."""
    context = " ".join(" ".join(r) for r in ranks)
    ids = tok.text(SYSTEM + USER_OPEN) + tok.text(USER_TEXT.format(question=question, context=context))
    spans = []
    for _ in range(n_crops):
        ids += tok.text(VISION_OPEN)
        spans.append(len(ids))
        ids += tok.text(IMAGE_PAD)[:1] * tokens
        ids += tok.text(VISION_CLOSE)
    ids = (ids + tok.text(USER_CLOSE))[:limit]
    return ids, [(s, min(tokens, len(ids) - s)) for s in spans if s < len(ids)]


def check(ctx, control: bool = False) -> Dict[str, float]:
    c = ctx.cfg["engine"]
    v = c["vision"]
    tok = text.HashTokenizer(ctx.vocab)
    ref = QwenVL(ctx.weights, c, ctx.device)
    low = QwenVL(ctx.weights, c, ctx.device, control=True) if control else None
    grid = v["image_size"] // v["patch_size"] // v["spatial_merge_size"]
    Tv, M = grid * grid, c.get("max_crops", 4)
    if not ctx.sample:
        missing = {"crop_err": math.inf, "logit_gap": math.inf}
        return missing if control else dict(missing, prompt_mismatch=math.inf, position_mismatch=math.inf,
                                              image_mismatch=math.inf)
    mismatch = positions = pages = 0
    crop_err, gaps = 0.0, []
    with torch.no_grad():
        for s in ctx.sample:
            rec = s.call.record
            d = text.read_doc(s.doc, tok, c)
            valid = rec["topk_valid"][s.row].cpu().numpy()
            chosen = rec["topk_idx"][s.row].cpu().numpy()[valid].tolist()
            images = [ctx.stream.page_image(s.doc, p) for p in range(len(s.doc.words))]
            cut = [crop(images[d.chunk_page[i]], chunk_box(d.boxes, d.chunks[i])) for i in chosen[:M]]
            ids, spans = prompt(s.doc.question, ranked_words(d, chosen), len(cut), Tv, tok, c["max_prompt_tokens"])
            want_pos = rope_index(len(ids), spans, grid)
            image_at = [q for a, n in spans for q in range(a, a + n)]
            mine = ref.tower(crop_pixels(cut, v["image_size"], ref.device)) if cut else None
            if not control:
                got, mask = rec["ids"][s.row].cpu().numpy(), rec["mask"][s.row].cpu().numpy()
                want = np.zeros_like(got)
                want[:len(ids)] = ids
                mismatch += int((got != want).sum() + (mask != (np.arange(len(mask)) < len(ids))).sum())
                fed = rec["positions"]
                n = min(len(ids), got.shape[0])
                fed = (fed[:, s.row].cpu().numpy() if fed is not None
                       else np.broadcast_to(np.arange(len(got)), (3, len(got))))
                positions += int((fed[:, :n] != want_pos[:, :n]).any(0).sum())
                seen = rec["images"][s.row]
                pages += sum(seen is None or p >= len(seen) or not np.array_equal(seen[p], images[p])
                             for p in range(len(images)))
                prog = rec["crops"][s.row] if rec.get("crops") is not None else None
                kept = np.asarray(rec["crop_valid"][s.row]) if rec.get("crop_valid") is not None else np.zeros(M, bool)
                if prog is None or int(kept.sum()) != len(cut) or not kept[:len(cut)].all():
                    crop_err = math.inf
                elif cut:
                    diff = (prog[:len(cut)].float().to(mine.device) - mine).norm(dim=-1).amax(-1)
                    crop_err = max(crop_err, float((diff / mine.norm(dim=-1).amax(-1)).max()))
            else:
                lowt = low.tower(crop_pixels(cut, v["image_size"], ref.device)) if cut else None
                if cut:
                    crop_err = max(crop_err, float(((lowt - mine).norm(dim=-1).amax(-1)
                                                    / mine.norm(dim=-1).amax(-1)).max()))
            tokens = rec["tokens"][s.row].cpu().numpy()
            steps = int(chk.served_steps(tokens[None])[0])
            seq = ids + tokens[:steps - 1].tolist()
            nxt = int(want_pos.max()) + 1 if len(ids) else 0
            pos = np.concatenate([want_pos, np.broadcast_to(nxt + np.arange(steps - 1), (3, steps - 1))], 1)
            at = list(range(len(ids) - 1, len(ids) - 1 + steps))
            flat = mine.reshape(-1, mine.shape[-1])[:len(image_at)] if mine is not None else None
            logits = ref.logits(seq, pos, flat, image_at, at)
            if control:
                lflat = lowt.reshape(-1, lowt.shape[-1])[:len(image_at)] if lowt is not None else None
                pick = low.logits(seq, pos, lflat, image_at, at).argmax(-1)
            else:
                pick = torch.from_numpy(tokens[:steps]).to(logits.device)
            gaps.append(chk.token_gaps(logits[None], pick[None], np.array([steps])))
    out = {"crop_err": crop_err, "logit_gap": max(gaps)}
    if not control:
        out.update(prompt_mismatch=float(mismatch), position_mismatch=float(positions), image_mismatch=float(pages))
    return out
