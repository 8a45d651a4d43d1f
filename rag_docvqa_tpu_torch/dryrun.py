"""The multi-rank dry run: every multi-device path of the port on tiny
shapes, each held against its unsharded form.

    python -m rag_docvqa_tpu_torch.dryrun N [--device cuda|cpu]
    torchrun --nproc_per_node N -m rag_docvqa_tpu_torch.dryrun N [--device cuda|cpu]

Counterpart of `__graft_entry__.py::dryrun_multichip`. Without `torchrun`
it spawns N ranks joined by a `FileStore` under a temporary directory (no
network). On the CPU the ranks use gloo. With `--device cuda` (the
default; it raises without a card) N cards take NCCL, a rank a card; fewer
cards than ranks are shared, rank r on card r % cards, and the ranks then
use gloo (NCCL refuses two ranks on one card), which takes CUDA tensors
through the host (`parallel/mesh.py`). Under `torchrun` the launcher's
group is joined, NCCL on cuda:LOCAL_RANK.

The checks, on a (N/2, 2) mesh of axes (data, model) where N is even, else
(N, 1), and a (N,) data mesh for the index, MaxSim and evaluate:
  * three VT5 train steps with remat="layer" (the split leaves stored as
    slices, labels of unequal lengths on the data ranks) against the
    unsharded step: loss and grad norms within 1e-5 relative, every leaf
    after three AdamW steps of lr 1e-3 within 1e-5 (the encoder's rel-pos
    table, whose gradient comes through the bf16 bias, within 2e-4);
  * three Hi-VT5 steps, the same way;
  * the sharded index (f32, K4 on the card) against `single_device_query`:
    ids exact, values within 1e-5;
  * greedy decode of encoder rows split over the data axis with the trained
    slices (`ops/decode.py::greedy_decode_sharded`) against a replicated
    decode: ids exact, confidences within 1e-4;
  * sharded MaxSim (K15) against `late_interaction` and a top-k over the
    whole index;
  * data-parallel `evaluate` against the unsharded run: answers equal,
    metrics within 1e-6.
Every rank checks; a failing rank exits non-zero and stops the others, and
every collective times out instead of waiting. Each rank prints one JSON
line with the kernel launches of its sharded paths (the unsharded runs they
are held to not counted); the first then prints the JAX dry run's line,
`dryrun_multichip(N) OK: loss=... grad_norm=... hivt5_loss=...
sharded_index_parity=ok sharded_decode_parity=ok sharded_maxsim_parity=ok
sharded_eval_parity=ok`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

TIMEOUT_S = 120  # a collective that waits longer fails
DEADLINE_S = 600  # ranks still running this long after the spawn are stopped
TRAIN_RTOL = 1e-5  # loss and grad norms, f32 sums over another split of the batch
LR = 1e-3
# the leaves after three AdamW steps: a hundredth of one step's size. AdamW divides each gradient by its
# own magnitude, so where a gradient is near 0 the sum over another split of the batch moves the step
LEAF_ATOL = 1e-2 * LR
# the encoder's rel-pos table takes its gradient through the layer's bf16 bias: each rank's batch sum is
# rounded to bf16 before the ranks' sum, the unsharded one once, and AdamW carries the rounding into the table
REL_BIAS_ATOL = 0.2 * LR


def build_tiny(device, n_docs: int = 4):
    """The JAX dry run's tiny VT5 world (`__graft_entry__._build(tiny=True)`):
    (vt5_cfg, rag_cfg, tokenizer, ingestor, docs, batch, labels); decode
    through K3 (its plain version on the CPU)."""
    from rag_docvqa_tpu_torch.data.contract import Caps
    from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
    from rag_docvqa_tpu_torch.data.synthetic import make_corpus
    from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
    from rag_docvqa_tpu_torch.engine.rag_vt5 import RAGConfig
    from rag_docvqa_tpu_torch.models import t5 as t5m
    from rag_docvqa_tpu_torch.models import vt5 as vt5m
    from rag_docvqa_tpu_torch.models.embeddings import SpatialConfig
    from rag_docvqa_tpu_torch.ops.chunking import ChunkSpec

    tok = HashTokenizer(vocab_size=2048)
    t5_cfg = t5m.T5Config(vocab_size=tok.vocab_size, d_model=64, d_kv=16, num_heads=4, d_ff=128,
                          num_encoder_layers=2, num_decoder_layers=2, dropout_rate=0.0, fused_decode_attn=True)
    caps = Caps(max_pages=4, max_chunks=16, max_slots=512, tokens_per_word=8, embed_tokens=32)
    rag_cfg = RAGConfig(page_retrieval="concat", chunk_num=4, max_source_length=128, max_new_tokens=8)
    vt5_cfg = vt5m.VT5Config(t5=t5_cfg, spatial=SpatialConfig(hidden_size=t5_cfg.d_model, dropout_rate=0.0))
    ing = DocVQAIngestor(tok, ChunkSpec(chunk_size=30, overlap=5), caps)
    docs = make_corpus(n_docs, n_pages=3, words_per_page=80, seed=0)
    batch, aux = ing.ingest(docs)
    labels = ing.answer_labels(aux["answers"], max_len=8)
    labels[n_docs // 2:, 2:] = -100  # the second half's answers shorter: unequal counts on the data ranks
    return vt5_cfg, rag_cfg, tok, ing, docs, batch, labels


def _close(what: str, got: float, want: float, rtol: float) -> None:
    if not abs(got - want) <= rtol * abs(want):
        raise AssertionError(f"{what}: sharded {got} against unsharded {want} (rtol {rtol})")


def train_parity(init, make_step, trainable_roots, mesh, batch, labels, launches: dict, steps: int = 3):
    """`steps` sharded steps against the unsharded ones from the same
    weights: every metric within TRAIN_RTOL, then every leaf within
    LEAF_ATOL. Returns the sharded state and the last metrics."""
    import torch

    from rag_docvqa_tpu_torch import kernels
    from rag_docvqa_tpu_torch.parallel.mesh import gathered_params, shard_params
    from rag_docvqa_tpu_torch.training.optimizer import build_optimizer, trainable_mask
    from rag_docvqa_tpu_torch.training.train_step import TrainState, vt5_param_spec

    states = []
    for sharded in (False, True):
        params = init()
        spec = vt5_param_spec(params)
        if sharded:
            shard_params(params, spec, mesh)
        opt = build_optimizer(lr=LR, warmup_steps=1, total_steps=10, mask=trainable_mask(params, trainable_roots))
        states.append([TrainState.create(params, opt), make_step(opt, mesh if sharded else None), spec])
    for i in range(steps):
        metrics = []
        for sharded, s in enumerate(states):
            if sharded:
                s[0], m = kernels.counted(launches, s[1], s[0], batch, labels)
            else:
                s[0], m = s[1](s[0], batch, labels)
            metrics.append(m)
        for k in metrics[0]:
            _close(f"{k} step {i}", metrics[1][k].item(), metrics[0][k].item(), TRAIN_RTOL)
    with torch.no_grad():
        ref, got = states[0][0].params, gathered_params(states[1][0].params, states[1][2], mesh)
    for (name, w), (_, g) in zip(ref.named_parameters(), got.named_parameters()):
        err = (g.detach() - w.detach()).abs().max().item()
        if not err <= (REL_BIAS_ATOL if name == "t5.encoder.rel_bias" else LEAF_ATOL):
            raise AssertionError(f"{name} after {steps} steps: sharded and unsharded differ by {err}")
    return states[1][0], states[1][2], metrics[1]


def rank_checks(rank: int, device) -> dict:
    """The six checks on this rank (the process group is up); returns its
    numbers and kernel launches."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from rag_docvqa_tpu_torch import kernels
    from rag_docvqa_tpu_torch.engine.evaluate import evaluate
    from rag_docvqa_tpu_torch.engine.rag_vt5 import RAGVT5Engine
    from rag_docvqa_tpu_torch.metrics import Evaluator
    from rag_docvqa_tpu_torch.models import hivt5 as hm
    from rag_docvqa_tpu_torch.models import vt5 as vt5m
    from rag_docvqa_tpu_torch.ops.decode import greedy_decode, greedy_decode_sharded
    from rag_docvqa_tpu_torch.ops.late_interaction import late_interaction
    from rag_docvqa_tpu_torch.parallel import ShardedIndex, create_mesh, sharded_maxsim_topk, single_device_query
    from rag_docvqa_tpu_torch.parallel.mesh import gathered_params, local_rows
    from rag_docvqa_tpu_torch.training.train_step import make_hivt5_train_step, make_train_step, vt5_param_spec

    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    n = dist.get_world_size()
    model = 2 if n % 2 == 0 else 1
    mesh = create_mesh((n // model, model), ("data", "model"), device=device, timeout_s=TIMEOUT_S)
    idx_mesh = create_mesh((n,), ("data",), device=device, timeout_s=TIMEOUT_S)
    data = mesh.size("data")
    vt5_cfg, rag_cfg, tok, ing, docs, batch, labels = build_tiny(device, n_docs=data * -(-4 // data))
    gen = lambda seed: torch.Generator(device=device).manual_seed(seed)
    launches = dict.fromkeys(kernels.LAUNCHES, 0)  # the sharded paths' own

    # the VT5 step with remat="layer", the Hi-VT5 step
    state, spec, metrics = train_parity(
        lambda: vt5m.init_vt5_params(gen(0), vt5_cfg),
        lambda opt, m: make_train_step(vt5_cfg, rag_cfg, opt, remat="layer", mesh=m), ("t5", "spatial"), mesh,
        batch, labels, launches)
    hcfg = hm.HiVT5Config(t5=vt5_cfg.t5, spatial=vt5_cfg.spatial, page_tokens=2, max_doc_pages=4, page_seq_len=64)
    _, _, hmetrics = train_parity(lambda: hm.init_hivt5_params(gen(1), hcfg),
                                  lambda opt, m: make_hivt5_train_step(hcfg, opt, mesh=m),
                                  ("t5", "spatial", "page_emb", "page_head"), mesh, batch, labels, launches)

    # the sharded index against the unsharded query
    rng = np.random.RandomState(0)
    emb, queries = rng.randn(1000, 64).astype(np.float32), rng.randn(8, 64).astype(np.float32)
    index = ShardedIndex.build(emb, tile_n=128, use_kernel=device.type == "cuda", mesh=idx_mesh)
    sv, si, _ = kernels.counted(launches, index.query, queries, k=5)
    rv, ri, _ = single_device_query(torch.from_numpy(emb).to(device), torch.from_numpy(queries).to(device), k=5)
    if not (torch.equal(si.long(), ri.long()) and (sv - rv).abs().max().item() <= 1e-5):
        raise AssertionError(f"sharded index: ids {si.tolist()} against {ri.tolist()}")

    # decode of data-split encoder rows with the trained slices against a replicated decode
    enc = torch.from_numpy(rng.randn(n, 32, vt5_cfg.t5.d_model).astype(np.float32)).to(device)
    emask = torch.ones((n, 32), dtype=torch.bool, device=device)
    rows = local_rows(n, mesh)
    toks, conf = kernels.counted(launches, greedy_decode_sharded, state.params.t5, vt5_cfg.t5, enc[rows],
                                 emask[rows], 4, mesh=mesh, spec=vt5_param_spec(state.params.t5))
    with torch.no_grad():
        whole = gathered_params(state.params, spec, mesh)
        rtoks, rconf = greedy_decode(whole.t5, vt5_cfg.t5, enc, emask, 4)
    if not (torch.equal(toks, rtoks) and (conf - rconf).abs().max().item() <= 1e-4):
        raise AssertionError(f"sharded decode: {toks.tolist()} against {rtoks.tolist()}")

    # sharded MaxSim against the whole index's scores
    n_rows = n * -(-64 // n)
    patches = torch.from_numpy(rng.randn(n_rows, 6, 32).astype(np.float32)).to(device)
    pmask = torch.from_numpy(rng.rand(n_rows, 6) < 0.8).to(device)
    qtok = torch.from_numpy(rng.randn(5, 32).astype(np.float32)).to(device)
    n_valid = n_rows - 3
    mine = local_rows(n_rows, idx_mesh)
    mv, mi, mok = kernels.counted(launches, sharded_maxsim_topk, patches[mine], pmask[mine], qtok, mesh=idx_mesh,
                                  n_valid=n_valid, k=5)
    scores = late_interaction(qtok, patches, patch_mask=pmask)
    scores = torch.where(torch.arange(n_rows, device=device) < n_valid, scores, float("-inf"))
    rv2, ri2 = torch.sort(scores, descending=True, stable=True)
    if not (torch.equal(mi, ri2[:5]) and (mv - rv2[:5]).abs().max().item() <= 1e-5 and bool(mok.all())):
        raise AssertionError(f"sharded MaxSim: {mi.tolist()} against {ri2[:5].tolist()}")

    # data-parallel evaluate against the unsharded run, on the trained weights
    engine = RAGVT5Engine(rag_cfg, vt5_cfg, whole, tok)
    plain = evaluate(engine, docs, ing, Evaluator(), batch_size=4)
    shard = kernels.counted(launches, evaluate, engine, docs, ing, Evaluator(), batch_size=4, mesh=idx_mesh)
    for key in ("accuracy", "anls", "retrieval_precision", "chunk_score", "n_samples"):
        if not abs(shard[key] - plain[key]) <= 1e-6:
            raise AssertionError(f"sharded evaluate: {key} {shard[key]} against {plain[key]}")
    if shard["pred_answers"] != plain["pred_answers"]:
        raise AssertionError(f"sharded evaluate: answers {shard['pred_answers']} against {plain['pred_answers']}")
    return {"rank": rank, "device": str(device), "backend": dist.get_backend(), "loss": metrics["loss"].item(),
            "grad_norm": metrics["grad_norm"].item(), "hivt5_loss": hmetrics["loss"].item(),
            "launches": launches}


def _spawned_rank(rank: int, device: str, n_cards: int) -> dict:
    import torch

    if device == "cpu":
        torch.set_num_threads(2)
        return rank_checks(rank, "cpu")
    return rank_checks(rank, f"cuda:{rank % n_cards}")


def report(results) -> None:
    for r in results:
        print(json.dumps(r), flush=True)
    first = results[0]
    print(f"dryrun_multichip({len(results)}) OK: loss={first['loss']:.4f} grad_norm={first['grad_norm']:.4f} "
          f"hivt5_loss={first['hivt5_loss']:.4f} sharded_index_parity=ok sharded_decode_parity=ok "
          f"sharded_maxsim_parity=ok sharded_eval_parity=ok", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="multi-rank dry run of the port's multi-device paths")
    parser.add_argument("n", type=int, help="ranks")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)

    from rag_docvqa_tpu_torch.parallel import mesh as pm
    from rag_docvqa_tpu_torch.train import resolve_device

    resolve_device(args.device)
    if pm.under_torchrun():
        import torch.distributed as dist

        device = pm.init_from_env(args.device, timeout_s=TIMEOUT_S)
        if dist.get_world_size() != args.n:
            raise SystemExit(f"torchrun started {dist.get_world_size()} ranks, the dry run was asked for {args.n}")
        try:
            results = [None] * args.n
            dist.all_gather_object(results, rank_checks(dist.get_rank(), device))
        finally:
            dist.destroy_process_group()
        if int(os.environ["RANK"]) == 0:
            report(results)
        return 0
    import torch

    n_cards = torch.cuda.device_count() if args.device == "cuda" else 0
    backend = "nccl" if args.device == "cuda" and n_cards >= args.n else "gloo"
    if args.device == "cuda":
        from rag_docvqa_tpu_torch import kernels

        kernels.library()  # built once here, not in every rank
    print(f"dryrun: {args.n} ranks on {args.device}"
          + (f" ({n_cards} card(s), {backend})" if args.device == "cuda" else " (gloo)"), flush=True)
    report(pm.spawn(_spawned_rank, args.n, args=(args.device, n_cards), backend=backend,
                    timeout_s=TIMEOUT_S, deadline_s=DEADLINE_S))
    return 0


if __name__ == "__main__":
    sys.exit(main())
