"""The engines' stage clock (`rag_docvqa_tpu_torch/engine/stages.py`) on tiny
CPU engines: how many synchronizes a call makes, the names of the stages it
ends (those of the benchmark's configuration but its last, which ends at a
copy to the host), and each "timings" key's definition, read off a fake
clock whose every noted time is a distinct power of two, so that each
difference names its two ends."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from rag_docvqa_tpu_torch.data.contract import Caps
from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
from rag_docvqa_tpu_torch.data.synthetic import make_corpus
from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
from rag_docvqa_tpu_torch.engine import hivt5_engine, rag_qwen, rag_vt5, stages
from rag_docvqa_tpu_torch.models import causal_lm as clm
from rag_docvqa_tpu_torch.models import hivt5, qwen25_vision, t5, vit, vt5
from rag_docvqa_tpu_torch.models.embeddings import SpatialConfig
from rag_docvqa_tpu_torch.ops.chunking import ChunkSpec

torch.set_num_threads(2)

CONFIGS = Path(__file__).resolve().parents[1] / "perfbench" / "configs"
VOCAB = 1024
T5_KW = dict(vocab_size=VOCAB, d_model=32, d_kv=8, num_heads=4, d_ff=64, num_encoder_layers=2,
             num_decoder_layers=2, dropout_rate=0.0)
SPATIAL = SpatialConfig(hidden_size=32, dropout_rate=0.0)
SPEC = ChunkSpec(chunk_size=10, overlap=2)


def _stages(config: str):
    """The configuration's stages but its last, which ends at a copy to the host."""
    return json.loads((CONFIGS / f"{config}.json").read_text())["stages"][:-1]


def _docs(seed=5, pages=2):
    docs = make_corpus(2, n_pages=pages, words_per_page=30, seed=seed)
    rng = np.random.RandomState(seed)
    for d in docs:
        d.images = [rng.randint(0, 255, (150, 120, 3)).astype(np.uint8) for _ in d.words]
    return docs


def _vt5(strategy="concat", reranker=None, visual=False):
    cfg = vt5.VT5Config(t5=t5.T5Config(**T5_KW), spatial=SPATIAL, use_visual=visual,
                        vit=vit.ViTConfig(hidden_size=16, num_layers=2, num_heads=2, mlp_dim=32, patch_size=8,
                                          image_size=32))
    params = vt5.init_vt5_params(torch.Generator().manual_seed(0), cfg)
    engine = rag_vt5.RAGVT5Engine(rag_vt5.RAGConfig(page_retrieval=strategy, chunk_num=3, max_source_length=96,
                                                    max_new_tokens=3, use_visual=visual),
                                  cfg, params, HashTokenizer(VOCAB), reranker=reranker)
    ingestor = DocVQAIngestor(HashTokenizer(VOCAB), SPEC, Caps(max_pages=2, max_chunks=16, max_slots=160,
                                                              embed_tokens=16))
    return engine, ingestor


def _hivt5():
    cfg = hivt5.HiVT5Config(t5=t5.T5Config(**T5_KW), spatial=SPATIAL, page_tokens=4, max_doc_pages=2,
                            page_seq_len=40)
    params = hivt5.init_hivt5_params(torch.Generator().manual_seed(0), cfg)
    engine = hivt5_engine.HiVT5Engine(cfg, params, HashTokenizer(VOCAB), max_new_tokens=3)
    return engine, DocVQAIngestor(HashTokenizer(VOCAB), SPEC, Caps(max_pages=2, max_chunks=16, max_slots=160))


def _qwen(visual=True):
    vcfg = qwen25_vision.Qwen25VisionConfig(hidden_size=32, intermediate_size=64, num_heads=4, depth=2,
                                            patch_size=14, temporal_patch_size=2, spatial_merge_size=2,
                                            window_size=56, out_hidden_size=64, fullatt_block_indexes=(1,),
                                            image_size=56)
    vparams = qwen25_vision.init_qwen25_vision_params(torch.Generator().manual_seed(0), vcfg)
    lm_cfg = clm.CausalLMConfig(vocab_size=512, d_model=64, num_layers=2, num_heads=4, num_kv_heads=2, d_ff=128,
                                tie_word_embeddings=False, mrope_section=(2, 3, 3))
    params = clm.init_causal_lm_params(torch.Generator().manual_seed(3), lm_cfg)
    engine = rag_qwen.RAGQwenEngine(rag_qwen.QwenRAGConfig(chunk_num=3, max_prompt_tokens=96, max_new_tokens=3,
                                                           use_visual=visual, max_crops=2),
                                    lm_cfg, params, HashTokenizer(512), vision_cfg=vcfg, vision_params=vparams)
    return engine, DocVQAIngestor(HashTokenizer(512), SPEC, Caps(max_pages=2, max_chunks=12, max_slots=128))


def _vt5_timings(t):
    return {"retrieve_assemble_s": t["assemble"] - t["start"], "encode_s": t["encode"] - t["assemble"],
            "decode_s": t["decode"] - t["encode"]}


def _vt5_retrieval(t):
    return {"retrieval_time": t["retrieve"] - t["start"], "generation_time": t["decode"] - t["retrieve"]}


def _qwen_timings(t):
    return {"retrieve_s": t["retrieve"] - t["start"], "crops_s": t["crops"] - t["retrieve"],
            "assemble_s": t["assemble"] - t["crops"], "prefill_s": t["prefill"] - t["assemble"],
            "decode_s": t["decode"] - t["prefill"]}


# name: (make the engine and its ingestor, the engine's module, its ended stages,
#        its "timings" and the timed keys of its "retrieval", from the clock's times;
#        whether the clock starts before the copy to the device)
CASES = {
    "vt5-concat": (_vt5, rag_vt5, _stages("rag-vt5-base"), _vt5_timings, _vt5_retrieval, False),
    "hivt5": (_hivt5, hivt5_engine, _stages("hivt5-base"),
              lambda t: {"visual_host_s": t["visual_host"] - t["start"], "visual_s": t["visual"] - t["start"],
                         "encode_s": t["encode"] - t["start"], "decode_s": t["decode"] - t["encode"]},
              lambda t: {"retrieval_time": 0.0, "generation_time": t["answers"] - t["start"]}, True),
    "qwen-crops": (_qwen, rag_qwen, _stages("rag-qwen25-vl-7b"), _qwen_timings, lambda t: {}, False),
    # the text path notes the retrieve's end without a synchronize
    "qwen-text": (lambda: _qwen(visual=False), rag_qwen, _stages("rag-qwen25-vl-7b")[1:], _qwen_timings,
                  lambda t: {}, False),
    # sub-stage ends inside a configured stage
    "vt5-none": (lambda: _vt5("none"), rag_vt5, ["assemble", "encode"], _vt5_timings, lambda t: {}, False),
    "vt5-rerank": (lambda: _vt5(reranker=lambda batch, ret: ret), rag_vt5,
                   ["topk", "rerank"] + _stages("rag-vt5-base"), _vt5_timings,
                   lambda t: dict(_vt5_retrieval(t), rerank_time=t["rerank"] - t["topk"]), False),
    "vt5-visual": (lambda: _vt5(visual=True), rag_vt5, ["retrieve", "assemble", "visual", "encode"],
                   lambda t: dict(_vt5_timings(t), visual_s=t["visual"] - t["assemble"]), _vt5_retrieval, False),
}


def test_configured_stages_are_what_the_engines_end():
    assert _stages("rag-vt5-base") == ["retrieve", "assemble", "encode"]
    assert _stages("hivt5-base") == ["visual_host", "visual", "encode"]
    assert _stages("rag-qwen25-vl-7b") == ["retrieve", "crops", "assemble", "prefill", "decode"]


@pytest.mark.parametrize("case", list(CASES))
def test_a_call_ends_its_stages_and_times_them_by_definition(case, monkeypatch):
    make, module, ended, timings, retrieval, starts_before_copy = CASES[case]
    events, clocks, syncs = [], [], []

    class TickClock(stages.StageClock):
        def __init__(self, device):
            self.ended = []
            super().__init__(device)
            clocks.append(self)

        def end(self, stage):
            self.ended.append(stage)
            super().end(stage)

        def note(self, name):
            events.append(name)
            self.times[name] = float(2 ** len(self.times))

    original = module.on_device

    def copied(batch, device):
        events.append("copy")
        return original(batch, device)

    monkeypatch.setattr(stages, "StageClock", TickClock)
    monkeypatch.setattr(stages, "synchronize", lambda device: syncs.append(device))
    monkeypatch.setattr(module, "on_device", copied)
    engine, ingestor = make()
    batch, aux = ingestor.ingest(_docs())
    out = engine.inference(batch, aux)

    (clock,) = clocks
    assert len(syncs) == len(ended) and clock.ended == ended
    assert events[:2] == (["start", "copy"] if starts_before_copy else ["copy", "start"])
    t = clock.times
    assert len(set(t.values())) == len(t)
    assert out["timings"] == timings(t)
    got = {k: v for k, v in out["retrieval"].items() if k.endswith("_time")}
    assert got == retrieval(t)


def test_the_clock_synchronizes_only_cuda_and_notes_in_order(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: calls.append(device))
    clock = stages.StageClock("cpu")
    clock.end("a")
    clock.note("b")
    assert calls == [] and list(clock.times) == ["start", "a", "b"]
    assert clock.times["start"] <= clock.times["a"] <= clock.times["b"]
    stages.synchronize(torch.device("cuda", 0))
    assert calls == [torch.device("cuda", 0)]
