"""Hi-VT5 (`build_engine`'s Hi-VT5 branch): how the benchmark builds it,
what it records from the timed path, the work of a call and its check.

Recorded per call: the page rows (`hivt5.assemble_page_rows`), the kept
page states and their mask (`hivt5.encode_document`), the page head's logits
(`hivt5.page_retrieval_logits`) and the served tokens (`hivt5.generate`). The check holds a sample of the served
documents to the plain reference: each real page's row against the one the
reference builds from its own tokens ("page_rows_mismatch"); the kept page
states against the reference's float32 page encode, as the widest relative
distance of a state ("page_state_err", infinite where a padded slot's
states are not zero); the page head's logits against the reference's over the real pages
("page_logit_err": the widest distance, each over the most its logit could
be, the product of the norms of its weight row and of the document's
states); and every
served token against the reference's teacher-forced decoder over its own
page states ("logit_gap").
"""

from __future__ import annotations

from contextlib import ExitStack, contextmanager
from typing import Dict

import numpy as np
import torch

from perfbench import check as chk
from perfbench import work
from perfbench.reference import text
from perfbench.reference.model import VT5
from perfbench.weights import t5_leaf_init as leaf_init  # noqa: F401  (the family's weight rule)


def structure(c: Dict, vocab: int, device):
    from rag_docvqa_tpu_torch.config import build_hivt5_config
    from rag_docvqa_tpu_torch.models.hivt5 import init_hivt5_params

    return init_hivt5_params(torch.Generator(device=device).manual_seed(0), build_hivt5_config(c, vocab))


def dims(c: Dict):
    return c.get("max_pages", 20), c.get("page_tokens", 10), c.get("max_text_tokens", c["max_source_length"])


@contextmanager
def install(engine, recorder):
    from rag_docvqa_tpu_torch.models import hivt5

    from perfbench.record import wrapped

    with ExitStack() as stack:
        stack.enter_context(wrapped(hivt5, "assemble_page_rows", lambda out, *a, **k: recorder.put(rows=out)))
        stack.enter_context(wrapped(hivt5, "encode_document",
                                    lambda out, *a, **k: recorder.put(doc_emb=out[0], doc_mask=out[1])))
        stack.enter_context(wrapped(hivt5, "page_retrieval_logits",
                                    lambda out, *a, **k: recorder.put(page_logits=out)))
        stack.enter_context(wrapped(hivt5, "generate", lambda out, *a, **k: recorder.put(tokens=out[0])))
        yield


def call_work(c: Dict, vocab: int, record) -> Dict[str, work.Work]:
    P, K, _ = dims(c)
    pages = (record["doc_mask"].sum(1) // K).tolist()
    text_valid = record["rows"].attention_mask.sum(1).view(len(pages), P).tolist()
    rows = [K + n for b, p in enumerate(pages) for n in text_valid[b][:p]]
    steps = chk.served_steps(record["tokens"].cpu().numpy()).tolist()
    encode = (work.embed_work(c, sum(r - K for r in rows)) + work.encoder_work(c, rows)
              + work.page_head_work(c, pages, K, P))
    decode = work.decode_work(c, vocab, [p * K for p in pages], steps)
    return {"encode": encode, "decode": decode, "model": encode + decode}


def check(ctx, control: bool = False) -> Dict[str, float]:
    c = ctx.cfg["engine"]
    P, K, S = dims(c)
    tok = text.HashTokenizer(ctx.vocab)
    ref = VT5(ctx.weights, c, ctx.device)
    low = VT5(ctx.weights, c, ctx.device, control=True) if control else None
    dev = ctx.device
    mismatch, state_err, page_err, gaps = 0, 0.0, 0.0, []
    if not ctx.sample:
        missing = {"page_state_err": float("inf"), "page_logit_err": float("inf"), "logit_gap": float("inf")}
        return missing if control else dict(missing, page_rows_mismatch=float("inf"))
    with torch.no_grad():
        docs, served = [], []
        for s in ctx.sample:
            rec = s.call.record
            d = text.read_doc(s.doc, tok, c)
            n = min(len(s.doc.words), P)
            rows = [text.page_row(d, p, tok, S) for p in range(n)]
            if not control:
                g = rec["rows"]
                for p, (ids, boxes, labels, mask) in enumerate(rows):
                    r = s.row * P + p
                    mismatch += int((g.input_ids[r].cpu().numpy() != ids).sum()
                                    + (g.input_boxes[r].cpu().numpy() != boxes).any(-1).sum()
                                    + (g.input_labels[r].cpu().numpy() != labels).sum()
                                    + (g.attention_mask[r].cpu().numpy() != mask).sum())
            args = [torch.from_numpy(np.stack([r[i] for r in rows])).to(dev) for i in (0, 1, 3)]
            page = torch.arange(n, device=dev)
            states = torch.cat([ref.page_states(page[lo:lo + ctx.block], *(a[lo:lo + ctx.block] for a in args), K)
                                for lo in range(0, n, ctx.block)])
            doc = torch.zeros(P * K, ref.d, device=dev)
            doc[:n * K] = states.reshape(n * K, -1)
            logits = ref.page_logits(doc[None])[0][:n]
            if control:
                low_states = torch.cat([low.page_states(page[lo:lo + ctx.block],
                                                        *(a[lo:lo + ctx.block] for a in args), K)
                                        for lo in range(0, n, ctx.block)])
                low_doc = torch.zeros_like(doc)
                low_doc[:n * K] = low_states.reshape(n * K, -1)
                got, got_logits = low_doc, low.page_logits(low_doc[None])[0][:n]
                docs.append((doc, low_doc, n))
            else:
                got, got_logits = rec["doc_emb"][s.row].float(), rec["page_logits"][s.row][:n].float()
                docs.append((doc, None, n))
                if n < P and got[n * K:].abs().max() > 0:
                    state_err = float("inf")
            err = ((got[:n * K] - doc[:n * K]).norm(dim=-1) / doc[:n * K].norm(dim=-1)).max()
            state_err = max(state_err, float(err))
            # a logit's distance over the most it could be, |w_p| |doc| (Cauchy-Schwarz)
            bound = ref.w["page_head.weight"][:n].norm(dim=1) * doc.norm()
            page_err = max(page_err, float(((got_logits - logits).abs() / bound).max()))
            tokens = rec["tokens"][s.row].cpu().numpy()
            served.append(tokens)
        tokens = np.stack(served)
        steps = chk.served_steps(tokens)
        dec_in = chk.teacher_inputs(tokens).to(dev)
        for lo in range(0, len(docs), ctx.block):
            part = docs[lo:lo + ctx.block]
            enc = torch.stack([d for d, _, _ in part])
            mask = torch.stack([torch.arange(P * K, device=dev) < n * K for _, _, n in part])
            logits = ref.decode_logits(enc, mask, dec_in[lo:lo + ctx.block])
            if control:
                pick = low.decode_logits(torch.stack([l for _, l, _ in part]), mask, dec_in[lo:lo + ctx.block])
                pick = pick.argmax(-1)
            else:
                pick = torch.from_numpy(tokens[lo:lo + ctx.block]).to(dev)
            gaps.append(chk.token_gaps(logits, pick, steps[lo:lo + ctx.block]))
    out = {"page_state_err": state_err, "page_logit_err": page_err, "logit_gap": max(gaps, default=float("inf"))}
    if not control:
        out["page_rows_mismatch"] = float(mismatch)
    return out
