"""RAG-VT5 (`build_engine`'s VT5 branch): how the benchmark builds it, what
it records from the timed path, the work of a call and its check.

Recorded per call: the chosen chunks (`rag_vt5.retrieve`'s top-k), the
generator rows and the served tokens (`RAGVT5Engine._generate`'s input and
output). The check holds a sample of the served documents to the plain
reference: the chosen chunks against the reference's float32 cosine scores
over its own chunk table ("retrieval_err": the widest distance between a
chosen chunk's score as the program gives it and as the reference does,
over the largest magnitude of the document's scores; "retrieval_misses":
the chosen chunks that score below the reference's k-th best by more than
that number's limit); the generator row against the one the reference
assembles from its own chunks and tokens and the program's choice, token for
token, box for box ("assembly_mismatch"); and every served token against
the reference's encoder and teacher-forced decoder ("logit_gap").
"""

from __future__ import annotations

from contextlib import ExitStack, contextmanager
from typing import Dict, List

import numpy as np
import torch

from perfbench import check as chk
from perfbench import work
from perfbench.reference import text
from perfbench.reference.model import VT5
from perfbench.weights import t5_leaf_init as leaf_init  # noqa: F401  (the family's weight rule)


def structure(c: Dict, vocab: int, device):
    """The program's parameter tree (every leaf is replaced by the
    benchmark's weights before use)."""
    from rag_docvqa_tpu_torch.config import build_vt5_config
    from rag_docvqa_tpu_torch.models.vt5 import init_vt5_params

    return init_vt5_params(torch.Generator(device=device).manual_seed(0), build_vt5_config(c, vocab))


@contextmanager
def install(engine, recorder):
    from rag_docvqa_tpu_torch.engine import rag_vt5

    def chosen(ret, *args, **kwargs):
        recorder.put(topk_idx=ret.top_k_idx, topk_valid=ret.top_k_valid, topk_score=ret.top_k_score)

    def generated(out, gen, visual=None):
        recorder.put(gen=gen, tokens=out[0])

    from perfbench.record import wrapped

    with ExitStack() as stack:
        stack.enter_context(wrapped(rag_vt5, "retrieve", chosen))
        stack.enter_context(wrapped(engine, "_generate", generated))
        yield


def call_work(c: Dict, vocab: int, record) -> Dict[str, work.Work]:
    valid = record["gen"].attention_mask.sum(1).tolist()
    steps = chk.served_steps(np.asarray(record["tokens"])).tolist()
    encode = work.embed_work(c, sum(valid)) + work.encoder_work(c, valid)
    decode = work.decode_work(c, vocab, valid, steps)
    return {"encode": encode, "decode": decode, "model": encode + decode}


def _scores(shared: torch.Tensor, d: text.Doc, tok, c: Dict, fp8: bool = False) -> torch.Tensor:
    """Cosine scores of the document's chunks against its question: each the
    mean of the shared table's rows of its first `embed_tokens` tokens. With
    `fp8`, the control's: the table, the means and the scores each rounded to
    float8 e4m3, as the program rounds them to bfloat16."""
    from perfbench.reference.model import fp8 as round8

    rnd = round8 if fp8 else (lambda x: x)
    shared = rnd(shared)
    dev = shared.device
    rows = [text.chunk_tokens(d, tok, i, c["embed_tokens"]) for i in range(len(d.chunks))]
    ce = rnd(torch.stack([shared[torch.tensor(r, device=dev)].mean(0) for r in rows]))
    qe = rnd(shared[torch.tensor(d.question, device=dev)].mean(0))
    return rnd((ce @ qe) / (ce.norm(dim=1) * qe.norm() + 1e-8))


def _retrieval(scores: torch.Tensor, chosen: List[int], got: torch.Tensor, k: int, tol: float):
    """(score error, misses) of a choice of chunks. The score error is the
    widest distance between the scores `got` that came with the chosen
    chunks and the reference's scores of those chunks, over the largest
    magnitude of the document's reference scores (infinite where the choice
    is not k distinct chunks of the document); misses count the chosen
    chunks that score below the reference's k-th best by more than `tol`
    times that magnitude, `tol` being the score error the check allows.
    Rounding errs in proportion to the scores' magnitudes, so this scale
    holds it steady; the best score would not, since a question that shares
    no word with its document scores near 0 against every chunk."""
    n = scores.shape[0]
    k = min(k, n)
    if len(chosen) != k or len(set(chosen)) != k or max(chosen, default=0) >= n:
        return float("inf"), k
    mine = scores[torch.tensor(chosen, device=scores.device)]
    kth = scores.sort(descending=True).values[k - 1]
    scale = scores.abs().max().clamp(min=1e-12)
    return float((got.to(mine) - mine).abs().max() / scale), int((kth - mine > tol * scale).sum())


def check(ctx, control: bool = False) -> Dict[str, float]:
    """The numbers of the sampled documents, or with `control` those of the
    float8 control put in the program's place."""
    c = ctx.cfg["engine"]
    tok = text.HashTokenizer(ctx.vocab)
    ref = VT5(ctx.weights, c, ctx.device)
    low = VT5(ctx.weights, c, ctx.device, control=True) if control else None
    k, S = c["chunk_num"], c["max_source_length"]
    ret_err, misses, mismatch = 0.0, 0, 0
    ids, boxes, masks, served = [], [], [], []
    for s in ctx.sample:
        rec = s.call.record
        d = text.read_doc(s.doc, tok, c)
        scores = _scores(ref.w["t5.shared"], d, tok, c)
        valid = rec["topk_valid"][s.row].cpu().numpy()
        prog_chosen = rec["topk_idx"][s.row].cpu().numpy()[valid].tolist()
        if control:
            low_scores = _scores(ref.w["t5.shared"], d, tok, c, fp8=True)
            chosen = low_scores.sort(descending=True, stable=True).indices[:min(k, len(d.chunks))]
            err, _ = _retrieval(scores, chosen.tolist(), low_scores[chosen], k, ctx.cfg["limits"]["retrieval_err"])
        else:
            got = rec["topk_score"][s.row][torch.from_numpy(valid).to(rec["topk_score"].device)].float()
            err, miss = _retrieval(scores, prog_chosen, got, k, ctx.cfg["limits"]["retrieval_err"])
            misses += miss
        ret_err = max(ret_err, err)
        r_ids, r_boxes, r_labels, r_mask = text.concat_row(d, prog_chosen, tok, S, c.get("include_surroundings", 0))
        gen = rec["gen"]
        if not control:
            mismatch += int((gen.input_ids[s.row].cpu().numpy() != r_ids).sum()
                            + (gen.input_boxes[s.row].cpu().numpy() != r_boxes).any(-1).sum()
                            + (gen.input_labels[s.row].cpu().numpy() != r_labels).sum()
                            + (gen.attention_mask[s.row].cpu().numpy() != r_mask).sum())
        ids.append(r_ids)
        boxes.append(r_boxes)
        masks.append(r_mask)
        served.append(np.asarray(rec["tokens"][s.row]))
    if not served:
        missing = {"retrieval_err": float("inf"), "logit_gap": float("inf")}
        return missing if control else dict(missing, retrieval_misses=float("inf"), assembly_mismatch=float("inf"))
    dev = ctx.device
    ids_t, boxes_t = torch.from_numpy(np.stack(ids)).to(dev), torch.from_numpy(np.stack(boxes)).to(dev)
    mask_t = torch.from_numpy(np.stack(masks)).to(dev)
    tokens = np.stack(served)
    steps = chk.served_steps(tokens)
    dec_in = chk.teacher_inputs(tokens).to(dev)
    gaps = []
    with torch.no_grad():
        for lo in range(0, len(served), ctx.block):
            sl = slice(lo, lo + ctx.block)
            enc = ref.encode(ref.embed(ids_t[sl], boxes_t[sl]), mask_t[sl])
            logits = ref.decode_logits(enc, mask_t[sl], dec_in[sl])
            if control:
                lenc = low.encode(low.embed(ids_t[sl], boxes_t[sl]), mask_t[sl])
                pick = low.decode_logits(lenc, mask_t[sl], dec_in[sl]).argmax(-1)
            else:
                pick = torch.from_numpy(tokens[sl]).to(dev)
            gaps.append(chk.token_gaps(logits, pick, steps[sl]))
    out = {"retrieval_err": ret_err, "logit_gap": max(gaps)}
    if not control:
        out.update(retrieval_misses=float(misses), assembly_mismatch=float(mismatch))
    return out
