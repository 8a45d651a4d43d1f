"""RAG with Uni-MoE-2.0-Omni's language model (`build_engine`'s Qwen branch
with the expert layer of `models/moe.py`, text only): how the benchmark
builds it, what it records from the timed path, the work of a call and its
check.

The tree is the program's `CausalLMParams` whose every layer holds a
`MoEBlock` (a router, four routed experts stacked, two shared experts side by
side), built on the `meta` device and filled by the seeded weights.
`leaf_init` is the program's own initialisation (`init_causal_lm_params`):
projections fan_in^-1/2 (a shared expert's down projection over its own
width), the router d_model^-1/2, the embedding 0.02, an untied head
d_model^-1/2, biases zeros, norms ones.

Recorded per call, from the timed path: the chosen chunks
(`rag_qwen.retrieve`'s top-k); the prompt ids, mask, M-RoPE positions and
served tokens (`causal_lm.generate`); every routing decision, the experts
`moe.route` gave each token of each layer in the prefill and in each decode
step, in int8 on the device (B x T x 28 x 2 bytes in the prefill, 2.3 MB a
call at B 32 x T 1,280); and the stream time of the expert layers, CUDA
events recorded around each `moe.expert_layer` call and read once
`generate` has returned (its decode stage ended on a synchronize), so no
synchronize is added (the host's clock on the CPU, where a call's work is
done when it returns): all of them ("moe_s") and the prefill's
("moe_prefill_s", the first `num_layers`). The prefill's layers keep the
card busy between the events; a decode step's are bound by the host's
launches, so there the events also time the card waiting for them.

The check holds a sample of the served documents to the plain reference
(`perfbench/reference/unimoe2.py`), teacher-forced over each prompt (built
from the reference's own chunk table and the program's choice of chunks)
and the served tokens: "prompt_mismatch", positions of ids or mask unlike
the reference's; "route_mismatch", (token, layer) decisions of the program
unlike the reference's where the reference's margin exceeds `route_delta`
(inside it the reference takes the program's decision); "logit_gap", every
served token against the reference's logits (`perfbench/check.py`). The
share of decisions within `route_delta` ("tie_share"), the routing shares
and the margins of the decisions unlike the reference's go to stderr: they
read the seeded router's spread, not the program. With `control`, the
float8 control's readings of the last two in the program's place: its own
decisions and its greedy tokens, the reference following its decisions
inside `route_delta`.
"""

from __future__ import annotations

import math
import sys
from contextlib import ExitStack, contextmanager
from typing import Dict, List

import numpy as np
import torch

from perfbench import check as chk
from perfbench import work
from perfbench.families.rag_qwen25_vl import prompt, ranked_words
from perfbench.reference import text
from perfbench.reference.unimoe2 import UniMoE2


def leaf_init(name: str, shape, c: Dict):
    last = name.rsplit(".", 1)[-1]
    if last in ("ln0", "ln1", "final_ln"):
        return ("ones",)
    if last == "bias":
        return ("zeros",)
    if name == "embed":
        return ("normal", 0.02)
    if name == "lm_head":
        return ("normal", c["d_model"] ** -0.5)
    if last == "shared_down":
        return ("normal", c["moe_shared_d_ff"] ** -0.5)
    if last in ("weight", "router", "shared_gate_up") and len(shape) == 2:
        return ("normal", shape[1] ** -0.5)
    if last in ("gate_up", "down") and len(shape) == 3:
        return ("normal", shape[2] ** -0.5)
    raise ValueError(f"no initialisation rule for the leaf {name!r} {tuple(shape)}")


def structure(c: Dict, vocab: int, device):
    """The program's tree on the `meta` device: an untied head, an expert
    block in every layer."""
    from rag_docvqa_tpu_torch.config import build_qwen_config
    from rag_docvqa_tpu_torch.models.causal_lm import CausalLMLayer, CausalLMParams, Proj
    from rag_docvqa_tpu_torch.models.moe import MoEBlock

    cfg = build_qwen_config(c, vocab)
    d, hd, ff, E = cfg.d_model, cfg.head_dim, cfg.moe_d_ff, cfg.moe_experts
    q, kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    shared = cfg.moe_shared_experts * cfg.moe_shared_d_ff
    e = lambda *shape: torch.empty(*shape, device="meta")
    lin = lambda din, dout, bias: Proj(e(dout, din), e(dout) if bias else None)
    block = lambda: MoEBlock(e(E + cfg.moe_null_experts, d), e(E, 2 * ff, d), e(E, d, ff), e(2 * shared, d),
                             e(d, shared))
    layers = [CausalLMLayer(e(d), lin(d, q, True), lin(d, kv, True), lin(d, kv, True), lin(q, d, False), e(d),
                            moe=block()) for _ in range(cfg.num_layers)]
    return CausalLMParams(e(vocab, d), layers, e(d), e(vocab, d))


@contextmanager
def install(engine, recorder):
    from rag_docvqa_tpu_torch.engine import rag_qwen
    from rag_docvqa_tpu_torch.models import causal_lm, moe

    from perfbench.record import clock, wrapped

    spare: List = []  # CUDA events kept from call to call

    def chosen(ret, *args, **kwargs):
        recorder.put(topk_idx=ret.top_k_idx, topk_valid=ret.top_k_valid)

    def routed(out, *args, **kwargs):
        recorder.current.setdefault("route", []).append(out[0].to(torch.int8))

    layer = moe.expert_layer

    def timed(h, *args, **kwargs):
        marks = recorder.current.setdefault("moe_marks", [])
        if not h.is_cuda:
            t0 = clock()
            out = layer(h, *args, **kwargs)
            marks.append(clock() - t0)
            return out
        start, end = (spare.pop() if spare else torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = layer(h, *args, **kwargs)
        end.record()
        marks.append((start, end))
        return out

    def generated(out, params, cfg, ids, mask, *args, **kwargs):
        seconds = []
        for m in recorder.current.pop("moe_marks", []):
            if isinstance(m, float):
                seconds.append(m)
            else:
                seconds.append(m[0].elapsed_time(m[1]) * 1e-3)
                spare.extend(m)
        recorder.put(ids=ids, mask=mask, positions=kwargs.get("positions"), tokens=out[0], moe_s=sum(seconds),
                     moe_prefill_s=sum(seconds[:cfg.num_layers]))

    with ExitStack() as stack:
        stack.enter_context(wrapped(rag_qwen, "retrieve", chosen))
        stack.enter_context(wrapped(moe, "route", routed))
        moe.expert_layer = timed
        stack.callback(setattr, moe, "expert_layer", layer)
        stack.enter_context(wrapped(causal_lm, "generate", generated))
        yield


def passes(c: Dict, record) -> List[np.ndarray]:
    """The recorded routing by pass: the prefill's (B, T, L, top_k), then each
    decode step's (B, 1, L, top_k); -1 past a token's stop."""
    L = c["num_layers"]
    route = [r.cpu().numpy().astype(np.int64) for r in record["route"]]
    B, T = record["mask"].shape
    out = []
    for at in range(0, len(route), L):
        rows = B * T if at == 0 else B
        out.append(np.stack([r.reshape(rows, -1) for r in route[at:at + L]], 1).reshape(B, rows // B, L, -1))
    return out


def call_work(c: Dict, vocab: int, record) -> Dict[str, work.Work]:
    """The prefill over each row's valid prompt tokens and the decode's steps
    up to each row's EOS, counting only what the router chose: every
    attention projection, the causal attention, the router, the two shared
    experts, each valid token's routed experts that are not null (2 x 3 x d
    x moe_d_ff operations each), the head at the positions that give a token;
    bytes: the attention's and shared experts' weights once a pass, a routed
    expert's once a pass where it received a row, the KV cache once a step.
    "experts" holds the expert layers alone (router, shared and routed
    experts, their weights read and each token's state in and out), a Work a
    pass (the prefill's, then each decode step's): a pass's least time is
    its own, bound by operations in the prefill and by bytes in a decode
    step, so their sum is the layers' least time."""
    d, L, H, Hkv = c["d_model"], c["num_layers"], c["num_heads"], c["num_kv_heads"]
    E, ff = c["moe_experts"], c["moe_d_ff"]
    hd = d // H
    attn = d * (H + 2 * Hkv) * hd + H * hd * d
    router = d * (E + c.get("moe_null_experts", 0))
    shared = 3 * d * c.get("moe_shared_experts", 0) * c.get("moe_shared_d_ff", 0)
    expert = 3 * d * ff
    prompt = record["mask"].sum(1).tolist()
    steps = chk.served_steps(record["tokens"].cpu().numpy()).tolist()
    mask = record["mask"].cpu().numpy().astype(bool)
    route = passes(c, record)

    def experts_work(r: np.ndarray, live: np.ndarray) -> work.Work:
        """The expert layers of one pass over the tokens `live` (B, T)."""
        tokens = int(live.sum())
        picks = ((r >= 0) & (r < E)) & live[:, :, None, None]  # (B, T, L, k)
        pairs = int(picks.sum())
        received = sum(int(((r[..., l, :] == e) & picks[..., l, :]).any()) for l in range(L) for e in range(E))
        return work.Work(2.0 * tokens * L * (router + shared) + 2.0 * expert * pairs,
                         work.BF16 * (L * (router + shared) + received * expert + 2 * L * d * tokens))

    head = vocab * d * work.BF16
    prefill_experts = experts_work(route[0], mask)
    prefill = prefill_experts + work.Work(
        sum(2.0 * L * attn * n + 2.0 * L * n * n * H * hd + 2.0 * d * vocab for n in prompt),
        L * attn * work.BF16 + head + work.BF16 * sum(prompt) * (d + 2 * L * Hkv * hd))
    decode, passes_experts = work.Work(), [prefill_experts]
    for t in range(1, max(steps, default=0)):
        live = np.array([s > t for s in steps])
        rows = [n for n, s in zip(prompt, steps) if s > t]
        cache = sum(n + t for n in rows)
        ex = experts_work(route[t], live[:, None]) if t < len(route) else work.Work()
        passes_experts.append(ex)
        decode = decode + ex + work.Work(len(rows) * 2.0 * (L * attn + d * vocab) + 4.0 * L * H * hd * cache,
                                         L * attn * work.BF16 + head + work.BF16 * 2 * L * Hkv * hd * cache)
    return {"prefill": prefill, "decode": decode, "experts": passes_experts, "model": prefill + decode}


def check(ctx, control: bool = False) -> Dict[str, float]:
    c = ctx.cfg["engine"]
    delta = float(ctx.cfg["route_delta"])
    tok = text.HashTokenizer(ctx.vocab)
    names = ("route_mismatch", "logit_gap")
    if not ctx.sample:
        return {k: math.inf for k in names + (() if control else ("prompt_mismatch",))}
    mismatch = 0
    seqs, pos, at, follow, served = [], [], [], [], []
    with torch.no_grad():
        for s in ctx.sample:
            rec = s.call.record
            d = text.read_doc(s.doc, tok, c)
            valid = rec["topk_valid"][s.row].cpu().numpy()
            chosen = rec["topk_idx"][s.row].cpu().numpy()[valid].tolist()
            ids, _ = prompt(s.doc.question, ranked_words(d, chosen), 0, 0, tok, c["max_prompt_tokens"])  # no crops
            got, mask = rec["ids"][s.row].cpu().numpy(), rec["mask"][s.row].cpu().numpy()
            want = np.zeros_like(got)
            want[:len(ids)] = ids
            mismatch += int((got != want).sum() + (mask != (np.arange(len(mask)) < len(ids))).sum())
            tokens = rec["tokens"][s.row].cpu().numpy()
            steps = int(chk.served_steps(tokens[None])[0])
            seq = ids + tokens[:steps - 1].tolist()
            seqs.append(seq)
            pos.append(np.broadcast_to(np.arange(len(seq)), (3, len(seq))).copy())
            at.append(list(range(len(ids) - 1, len(ids) - 1 + steps)))
            served.append(tokens[:steps])
            route = passes(c, rec)
            n = min(len(ids), route[0].shape[1])
            mine = np.full((len(seq), c["num_layers"], c["moe_top_k"]), -1, np.int64)
            mine[:n] = route[0][s.row, :n]
            for j in range(steps - 1):
                if 1 + j < len(route):
                    mine[len(ids) + j] = route[1 + j][s.row, 0]
            follow.append(mine)
        if control:  # the control's own decisions and greedy tokens, the reference following them
            low = UniMoE2(ctx.weights, c, ctx.device, control=True).run(seqs, pos, at)
            follow = [p.own for p in low]
            served = [p.logits.argmax(-1).cpu().numpy() for p in low]
        ref = UniMoE2(ctx.weights, c, ctx.device, delta=delta).run(seqs, pos, at, follow)
    decisions = sum(p.margin.size for p in ref)
    inside = sum(int((p.margin <= delta).sum()) for p in ref)
    wrong = [(np.sort(p.own, -1) != np.sort(f, -1)).any(-1) for p, f in zip(ref, follow)]  # as sets
    outside = sum(int((w & (p.margin > delta)).sum()) for w, p in zip(wrong, ref))
    worst = max((float(p.margin[w].max()) for w, p in zip(wrong, ref) if w.any()), default=0.0)
    gaps = [chk.token_gaps(p.logits[None], torch.from_numpy(np.asarray(t)[None]).to(p.logits.device),
                           np.array([len(t)])) for p, t in zip(ref, served)]
    taken = np.concatenate([f.reshape(-1, f.shape[-1]) for f in follow])
    E = c["moe_experts"]
    margins = np.concatenate([p.margin.reshape(-1) for p in ref])
    unlike = np.concatenate([p.margin[w] for w, p in zip(wrong, ref)])
    steps = (0.01, 0.02, 0.03, 0.05, 0.08)
    print(f"{'control' if control else 'program'} routing over {decisions} (token, layer) decisions, "
          f"tie_share {inside / max(decisions, 1):.4f} (within {delta}): "
          f"one expert {np.mean(taken[:, 1] < 0):.4f}, a null pick {np.mean((taken >= E).any(-1)):.4f}; "
          f"unlike the reference {len(unlike)}, the widest margin of those {worst:.5f}, {outside} outside {delta}; "
          "margins within " + ", ".join(f"{m}: {np.mean(margins <= m):.4f}" for m in steps)
          + "; unlike the reference beyond " + ", ".join(f"{m}: {int((unlike > m).sum())}" for m in steps),
          file=sys.stderr, flush=True)
    out = {"route_mismatch": float(outside), "logit_gap": max(gaps)}
    if not control:
        out["prompt_mismatch"] = float(mismatch)
    return out
