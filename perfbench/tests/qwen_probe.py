"""A decoder-only family that comes in as a file of its own: RAG-Qwen
(`build_engine`'s Qwen branch, `engine/rag_qwen.py`), text only, with its
plain float32 reference. The tests register it as
`perfbench.families.qwen_probe` to show that the harness takes such a family
without an edit to any of its files; it is no cell of the benchmark.

What it gives the harness: `leaf_init` (the causal LM's initialisation as
`init_causal_lm_params` draws it: projections fan_in^-1/2, the embedding
0.02, an untied head d_model^-1/2, biases zeros, norms ones), `structure` (the
program's `CausalLMParams` on the `meta` device, no memory), `install`
(records the chosen chunks from `rag_qwen.retrieve`, the prompt and the
served tokens from `causal_lm.generate`, and the `aux["images"]` each call
hands to `RAGQwenEngine._encode_crops`), `call_work` and `check`.

The check, over the sampled documents: the prompt the program fed
`generate` against the ChatML prompt the reference builds from its own
chunk table and the program's choice of chunks ("prompt_mismatch":
positions of ids or mask unlike the reference's); each page image the call
was handed against the one the stream makes again ("image_mismatch": pages
unlike); and every served token against the reference's teacher-forced
logits ("logit_gap", as `perfbench/check.py` defines it).

    python3 perfbench/tests/qwen_probe.py --seed <n> --seconds <s> [--check-docs 16]

runs it once on the card at Qwen2.5-VL-7B-Instruct's published language-model
widths (bfloat16, `mpdocvqa` at B 32, the profiler over the window's next 2
calls) through `harness.run`, and prints one JSON line: set-up seconds,
memory peak, documents and calls in the window, each traced call's device
time and operations by stage (null where its synchronizes do not match the
stages), the per-layer metrics that apply and the check's readings (no
limit is set at these widths: readings only).
"""

import time

T0 = time.perf_counter()  # set-up counts from here, as in run.py

import copy  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from contextlib import ExitStack, contextmanager  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from perfbench import check as chk  # noqa: E402
from perfbench import work  # noqa: E402
from perfbench.reference import text  # noqa: E402

NAME = "qwen_probe"

# Qwen2.5-VL-7B-Instruct's language model (https://huggingface.co/Qwen/Qwen2.5-VL-7B-Instruct): d 3584, 28 layers,
# 28 query and 4 KV heads of 128, d_ff 18944, vocabulary 152064, an untied head, rope theta 1e6 (the
# CausalLMConfig default); the RAG settings of RAG-VT5's cell and QwenRAGConfig's defaults
PUBLISHED = {
    "family": NAME,
    "dtype": "bfloat16",
    "tokenizer": "hash:152064",
    "stages": ["retrieve", "assemble", "prefill", "decode", "answers"],
    "engine": {"model_name": "Qwen", "d_model": 3584, "num_layers": 28, "num_heads": 28, "num_kv_heads": 4,
               "d_ff": 18944, "page_retrieval": "concat", "chunk_num": 10, "chunk_size": 60, "chunk_size_tol": 0.2,
               "overlap": 10, "include_surroundings": 0, "max_prompt_tokens": 512, "max_new_tokens": 16,
               "use_visual": False, "tokens_per_word": 8, "embed_tokens": 96, "question_tokens": 48,
               "prompt_tokens": 64},
    "check_docs": 16,
    "limits": {"prompt_mismatch": 0, "image_mismatch": 0, "logit_gap": math.inf},
}

# the ChatML prompt of the Qwen2.5 chat template, as the reference builds it
SYSTEM = "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
USER_OPEN = "<|im_start|>user\n"
USER_CLOSE = "<|im_end|>\n<|im_start|>assistant\n"
USER_TEXT = ("question: {question}\nDirectly provide only a short direct answer to the question. "
             "The answer appears in the following context. Context: {context}")


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
    if last == "weight" and len(shape) == 2:
        return ("normal", shape[1] ** -0.5)
    raise ValueError(f"no initialisation rule for the leaf {name!r} {tuple(shape)}")


def structure(c: Dict, vocab: int, device):
    """The program's tree on the `meta` device, with an untied head."""
    from rag_docvqa_tpu_torch.config import build_qwen_config
    from rag_docvqa_tpu_torch.models.causal_lm import CausalLMLayer, CausalLMParams, Proj

    cfg = build_qwen_config(c, vocab)
    d, hd, ff = cfg.d_model, cfg.head_dim, cfg.d_ff
    q, kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    e = lambda *shape: torch.empty(*shape, device="meta")
    lin = lambda din, dout, bias: Proj(e(dout, din), e(dout) if bias else None)
    layers = [CausalLMLayer(e(d), lin(d, q, True), lin(d, kv, True), lin(d, kv, True), lin(q, d, False), e(d),
                            lin(d, ff, False), lin(d, ff, False), lin(ff, d, False)) for _ in range(cfg.num_layers)]
    return CausalLMParams(e(vocab, d), layers, e(d), e(vocab, d))


@contextmanager
def install(engine, recorder):
    from rag_docvqa_tpu_torch.engine import rag_qwen
    from rag_docvqa_tpu_torch.models import causal_lm

    from perfbench.record import wrapped

    def chosen(ret, *args, **kwargs):
        recorder.put(topk_idx=ret.top_k_idx, topk_valid=ret.top_k_valid)

    def crops(out, batch, aux, ret):
        recorder.put(images=aux["images"])

    def generated(out, params, cfg, ids, mask, *args, **kwargs):
        recorder.put(ids=ids, mask=mask, tokens=out[0])

    with ExitStack() as stack:
        stack.enter_context(wrapped(rag_qwen, "retrieve", chosen))
        stack.enter_context(wrapped(engine, "_encode_crops", crops))
        stack.enter_context(wrapped(causal_lm, "generate", generated))
        yield


def call_work(c: Dict, vocab: int, record) -> Dict[str, work.Work]:
    """The prefill over each row's valid prompt tokens and the decode's steps
    up to each row's EOS: every projection, the causal attention, the head
    at the positions that give a token; the weights read once a pass, the
    KV cache read once a step."""
    d, L, H, Hkv, ff = c["d_model"], c["num_layers"], c["num_heads"], c["num_kv_heads"], c["d_ff"]
    hd = d // H
    layer = d * (H + 2 * Hkv) * hd + H * hd * d + 3 * d * ff
    weights = (L * layer + vocab * d) * work.BF16
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
    return {"prefill": prefill, "decode": decode, "model": prefill + decode}


class Qwen2:
    """The plain reference: Qwen2's decoder (pre-norm RMSNorm at eps 1e-6,
    q/k/v with biases, rotary positions in the rotate-half form at theta 1e6,
    grouped-query causal attention at hd^-1/2, a SwiGLU feed-forward, the
    final norm, an untied head) in float32 with TF32 off, one layer's weights
    at a time; it imports nothing of the program."""

    def __init__(self, w: Dict[str, torch.Tensor], c: Dict, device):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.w, self.device = w, device
        self.L, self.H, self.Hkv = c["num_layers"], c["num_heads"], c["num_kv_heads"]
        self.hd = c["d_model"] // self.H
        self.theta = c.get("rope_theta", 1e6)

    def f(self, name: str) -> torch.Tensor:
        return self.w[name].to(self.device, torch.float32)

    @staticmethod
    def rms(x, w):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6) * w

    def rope(self, x, cos, sin):
        half = self.hd // 2
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def logits(self, ids: List[int], at: List[int]) -> torch.Tensor:
        """(len(at), V) logits at the positions `at` of the sequence `ids`."""
        T = len(ids)
        x = self.w["embed"][torch.tensor(ids, device=self.w["embed"].device)].to(self.device, torch.float32)
        inv = 1.0 / self.theta ** (torch.arange(0, self.hd, 2, device=self.device).float() / self.hd)
        ang = torch.arange(T, device=self.device).float()[:, None] * inv
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        causal = torch.ones(T, T, dtype=torch.bool, device=self.device).tril()
        for i in range(self.L):
            p = f"layers.{i}."
            h = self.rms(x, self.f(p + "ln0"))
            q = (h @ self.f(p + "q.weight").t() + self.f(p + "q.bias")).view(T, self.H, self.hd)
            k = (h @ self.f(p + "k.weight").t() + self.f(p + "k.bias")).view(T, self.Hkv, self.hd)
            v = (h @ self.f(p + "v.weight").t() + self.f(p + "v.bias")).view(T, self.Hkv, self.hd)
            q, k = self.rope(q, cos, sin), self.rope(k, cos, sin)
            k, v = (t.repeat_interleave(self.H // self.Hkv, dim=1) for t in (k, v))
            s = torch.einsum("qhd,khd->hqk", q, k) * self.hd ** -0.5
            a = torch.softmax(s.masked_fill(~causal, -math.inf), -1)
            x = x + torch.einsum("hqk,khd->qhd", a, v).reshape(T, -1) @ self.f(p + "o.weight").t()
            h = self.rms(x, self.f(p + "ln1"))
            g = torch.nn.functional.silu(h @ self.f(p + "gate.weight").t()) * (h @ self.f(p + "up.weight").t())
            x = x + g @ self.f(p + "down.weight").t()
        x = self.rms(x, self.f("final_ln"))[torch.tensor(at, device=self.device)]
        return x @ self.f("lm_head").t()


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


def prompt_ids(question: str, ranks: List[List[str]], tok: text.HashTokenizer, limit: int) -> List[int]:
    context = " ".join(" ".join(r) for r in ranks)
    ids = tok.text(SYSTEM + USER_OPEN) + tok.text(USER_TEXT.format(question=question, context=context)) \
        + tok.text(USER_CLOSE)
    return ids[:limit]


def check(ctx, control: bool = False) -> Dict[str, float]:
    c = ctx.cfg["engine"]
    tok = text.HashTokenizer(ctx.vocab)
    ref = Qwen2(ctx.weights, c, ctx.device)
    painted = "page_images" in ctx.stream.t
    mismatch, pages, gaps = 0, 0, []
    if not ctx.sample:
        return {"prompt_mismatch": math.inf, "image_mismatch": math.inf, "logit_gap": math.inf}
    with torch.no_grad():
        for s in ctx.sample:
            rec = s.call.record
            d = text.read_doc(s.doc, tok, c)
            valid = rec["topk_valid"][s.row].cpu().numpy()
            chosen = rec["topk_idx"][s.row].cpu().numpy()[valid].tolist()
            ids = prompt_ids(s.doc.question, ranked_words(d, chosen), tok, c["max_prompt_tokens"])
            got, mask = rec["ids"][s.row].cpu().numpy(), rec["mask"][s.row].cpu().numpy()
            want = np.zeros_like(got)
            want[:len(ids)] = ids
            mismatch += int((got != want).sum() + (mask != (np.arange(len(mask)) < len(ids))).sum())
            seen = rec["images"][s.row]
            if painted:
                pages += sum(seen is None or p >= len(seen)
                             or not np.array_equal(seen[p], ctx.stream.page_image(s.doc, p))
                             for p in range(len(s.doc.words)))
            else:
                pages += seen is not None
            tokens = rec["tokens"][s.row].cpu().numpy()
            steps = int(chk.served_steps(tokens[None])[0])
            logits = ref.logits(ids + tokens[:steps - 1].tolist(), list(range(len(ids) - 1, len(ids) - 1 + steps)))
            gaps.append(chk.token_gaps(logits[None], torch.from_numpy(tokens[None, :steps]).to(ref.device),
                                       np.array([steps])))
    return {"prompt_mismatch": float(mismatch), "image_mismatch": float(pages), "logit_gap": max(gaps)}


def register() -> None:
    """This module as the harness finds a family: `perfbench.families.<NAME>`."""
    sys.modules[f"perfbench.families.{NAME}"] = sys.modules[__name__]


def main(argv) -> int:
    import argparse

    from perfbench import harness

    ap = argparse.ArgumentParser(description="RAG-Qwen at Qwen2.5-VL-7B's widths through harness.run, once")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--check-docs", type=int, default=16)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    register()
    manifest = harness.load_json(harness.ROOT / "BENCHMARK.json")
    # one traced run reports them all: the end-to-end pair beside the per-layer metrics that apply
    e2e = [m for m in manifest["end_to_end"] if m["name"] in ("docs_per_s", "setup_s")]
    metrics = {"end_to_end": e2e, "per_layer": e2e + [m for m in manifest["per_layer"] if m["name"] in (
        "ingest_ms", "loop_wait_ms", "decode_step_ms", "decode_launches_per_step", "device_idle_share", "mfu")]}
    cfg = dict(copy.deepcopy(PUBLISHED), check_docs=args.check_docs)
    sp = harness.Spec("qwen25-vl-7b-text.mpdocvqa", cfg, harness.load_json(harness.BENCH / "traffic" / "mpdocvqa.json"),
                      1, metrics)
    kept = {}
    summary = harness._summary
    harness._summary = lambda prof, stages: kept.setdefault("trace", summary(prof, stages))
    r = harness.run(sp, args.seed, args.seconds, True, t0=T0)
    t = kept.get("trace")
    calls = [None if cs is None else {"device_s": cs.device_s, "ops": cs.ops} for cs in (t.calls if t else [])]
    print(json.dumps(harness.finite({"result": r, "traced_calls": calls,
                                     "stages_matched": sum(cs is not None for cs in calls)})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
