"""End-to-end answer quality of the port: the whole train -> retrieve ->
assemble -> generate -> decode -> ANLS loop gives the planted answers.

The port's counterpart of `tests/test_e2e_answer_quality.py`'s two VT5-family
cases, without real weights: a tiny VT5 (t5 d 64, d_kv 16, 2 + 2 layers)
trained through `make_train_step` on 8 planted-fact documents of 2 pages x 30
words (seed 42, lr 3e-3, 500 steps) answers every question through the
`evaluate` loop (ANLS 1.0, the decoded answers the planted ones), and a tiny
Hi-VT5 trained through `make_hivt5_train_step` (800 steps) does too, its page
head finding the planted page (retrieval precision 1.0). The weights start
from the port's own seeded init, not JAX's. The Qwen SFT and LoRA cases wait
for the causal-LM slice.

Both decode through K3 (`fused_decode_attn`; its plain version on the CPU).
`vt5_case` and `hivt5_case` take the device: `chip_smoke.py` phase 11f runs
them on the card, through K1-K3 and K6-K8. Slow on the CPU, as the JAX original is,
so outside Tier-1.
"""

from __future__ import annotations

import time

import pytest
import torch

from rag_docvqa_tpu_torch.data.contract import Caps, to_device
from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
from rag_docvqa_tpu_torch.data.synthetic import make_corpus
from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
from rag_docvqa_tpu_torch.engine.evaluate import evaluate
from rag_docvqa_tpu_torch.engine.hivt5_engine import HiVT5Engine
from rag_docvqa_tpu_torch.engine.rag_vt5 import RAGConfig, RAGVT5Engine
from rag_docvqa_tpu_torch.metrics import Evaluator
from rag_docvqa_tpu_torch.models import hivt5 as hm
from rag_docvqa_tpu_torch.models import t5 as t5m
from rag_docvqa_tpu_torch.models import vt5 as vt5m
from rag_docvqa_tpu_torch.models.embeddings import SpatialConfig
from rag_docvqa_tpu_torch.ops.chunking import ChunkSpec
from rag_docvqa_tpu_torch.training.optimizer import build_optimizer, trainable_mask
from rag_docvqa_tpu_torch.training.train_step import TrainState, make_hivt5_train_step, make_train_step

pytestmark = pytest.mark.slow

T5_KW = dict(vocab_size=2048, d_model=64, d_kv=16, num_heads=4, d_ff=128, num_encoder_layers=2,
             num_decoder_layers=2, dropout_rate=0.0, fused_decode_attn=True)
CAPS = Caps(max_pages=2, max_chunks=12, max_slots=192, tokens_per_word=8, embed_tokens=48)
RAG = RAGConfig(page_retrieval="concat", chunk_num=3, max_source_length=128, max_new_tokens=8)


def _data(device):
    """The 8 planted-fact documents, ingested, on `device`, with their
    8-token answer labels."""
    tok = HashTokenizer(vocab_size=2048)
    docs = make_corpus(8, n_pages=2, words_per_page=30, seed=42)
    ing = DocVQAIngestor(tok, ChunkSpec(chunk_size=10, overlap=2), CAPS)
    batch, aux = ing.ingest(docs)
    labels = torch.from_numpy(ing.answer_labels(aux["answers"], max_len=8, seed=0)).to(device)
    return tok, docs, ing, to_device(batch, device), labels


def _train(step, state, batch, labels, steps: int):
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, batch, labels)
    loss = m["loss"].item()  # waits for the card
    return state, loss, (time.perf_counter() - t0) * 1e3 / steps


def vt5_case(device="cpu", steps: int = 500) -> dict:
    """Trains the tiny VT5 and evaluates it on its training documents."""
    tok, docs, ing, batch, labels = _data(device)
    cfg = vt5m.VT5Config(t5=t5m.T5Config(**T5_KW), spatial=SpatialConfig(hidden_size=64, dropout_rate=0.0))
    params = vt5m.init_vt5_params(torch.Generator(device=device).manual_seed(0), cfg)
    opt = build_optimizer(lr=3e-3, warmup_steps=10, total_steps=600, mask=trainable_mask(params, ("t5", "spatial")))
    state, loss, step_ms = _train(make_train_step(cfg, RAG, opt), TrainState.create(params, opt), batch, labels,
                                  steps)
    t0 = time.perf_counter()
    out = evaluate(RAGVT5Engine(RAG, cfg, state.params, tok), docs, ing, Evaluator(), batch_size=8)
    return {"loss": loss, "step_ms": step_ms, "eval_ms": (time.perf_counter() - t0) * 1e3, "anls": out["anls"],
            "accuracy": out["accuracy"], "answers": out["pred_answers"], "planted": [d.answers[0] for d in docs]}


def hivt5_case(device="cpu", steps: int = 800) -> dict:
    """Trains the tiny Hi-VT5 (LM and page cross-entropy) and evaluates it."""
    tok, docs, ing, batch, labels = _data(device)
    cfg = hm.HiVT5Config(t5=t5m.T5Config(**T5_KW), spatial=SpatialConfig(hidden_size=64, dropout_rate=0.0),
                         page_tokens=6, max_doc_pages=2, page_seq_len=64)
    params = hm.init_hivt5_params(torch.Generator(device=device).manual_seed(0), cfg)
    opt = build_optimizer(lr=3e-3, warmup_steps=10, total_steps=900)
    state, loss, step_ms = _train(make_hivt5_train_step(cfg, opt), TrainState.create(params, opt), batch, labels,
                                  steps)
    t0 = time.perf_counter()
    out = evaluate(HiVT5Engine(cfg, state.params, tok, max_new_tokens=8), docs, ing, Evaluator(), batch_size=8)
    return {"loss": loss, "step_ms": step_ms, "eval_ms": (time.perf_counter() - t0) * 1e3, "anls": out["anls"],
            "accuracy": out["accuracy"], "retrieval_precision": out["retrieval_precision"],
            "answers": out["pred_answers"], "planted": [d.answers[0] for d in docs]}


def test_trained_model_answers_correctly():
    res = vt5_case()
    assert res["loss"] < 0.1
    assert res["anls"] == 1.0, f"anls {res['anls']}: {res['answers']}"
    assert res["accuracy"] == 1.0
    assert res["answers"] == res["planted"]  # the answers really decode to the planted facts


def test_trained_hivt5_answers_and_retrieves_pages():
    res = hivt5_case()
    assert res["loss"] < 0.1
    assert res["anls"] == 1.0, f"anls {res['anls']}: {res['answers']}"
    assert res["retrieval_precision"] == 1.0
