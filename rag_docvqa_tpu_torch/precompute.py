"""Offline precompute of the PyTorch port: corpus chunk-embedding index
build + query.

    # build an index over a dataset (the synthetic corpus needs no data files)
    python -m rag_docvqa_tpu_torch.precompute index -m configs/VT5_tiny.yml \\
        -d configs/Synthetic.yml --out corpus_index.npz [--device cuda|cpu]

    # query it
    python -m rag_docvqa_tpu_torch.precompute query --index corpus_index.npz \\
        -m configs/VT5_tiny.yml -q "what is the total?" --k 5 \\
        [--index-dtype f32|bf16|int8|int4] [--refine] [--device cuda|cpu]

The `index` and `query` commands of the root `precompute.py` with its
arguments; `--device` takes the place of `--platform`, the default is cuda,
and without a CUDA device the CLI raises unless `--device cpu` is given.
`index` embeds every chunk with the VT5 table embedder and writes an `.npz`
with that CLI's keys (`embeddings`, `meta`), so either CLI reads the
other's file. `query` keeps the index resident on the device in the chosen
precision (`parallel/index.py`) and prints one JSON line per rank. The
`layouts` command waits for the layout detectors.
"""

from __future__ import annotations

import argparse
import json
import time


def _setup(args, dataset=None):
    """config, tokenizer, VT5 config and random-weight parameters from the
    config's seed, on the CLI's device."""
    import torch

    from rag_docvqa_tpu_torch.config import build_vt5_config, load_config, load_tokenizer
    from rag_docvqa_tpu_torch.models import vt5 as vt5m
    from rag_docvqa_tpu_torch.train import parse_overrides, resolve_device

    device = resolve_device(args.device)
    config = load_config(model=args.model, dataset=dataset, overrides=parse_overrides(args.overrides))
    tokenizer = load_tokenizer(config.get("tokenizer"))
    vt5_cfg = build_vt5_config(config, tokenizer.vocab_size)
    params = vt5m.init_vt5_params(torch.Generator(device=device).manual_seed(config["seed"]), vt5_cfg)
    return device, config, tokenizer, vt5_cfg, params


def embed_question(shared, tokenizer, question: str, device):
    """The (1, D) table embedding of a question's first 64 tokens."""
    import numpy as np
    import torch

    from rag_docvqa_tpu_torch.models.embedder import vt5_table_embed

    ids = tokenizer.encode(question)[:64]
    q = np.zeros((1, 64), np.int64)
    m = np.zeros((1, 64), bool)
    q[0, : len(ids)] = ids
    m[0, : len(ids)] = True
    return vt5_table_embed(shared, torch.from_numpy(q).to(device), torch.from_numpy(m).to(device)).float()


def cmd_index(args):
    import numpy as np
    import torch

    from rag_docvqa_tpu_torch.config import build_caps, build_chunk_spec
    from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
    from rag_docvqa_tpu_torch.models.embedder import vt5_table_embed
    from rag_docvqa_tpu_torch.train import build_docs

    device, config, tokenizer, vt5_cfg, params = _setup(args, dataset=args.dataset)
    ingestor = DocVQAIngestor(tokenizer, build_chunk_spec(config), build_caps(config))
    shared = params.t5.shared
    docs = build_docs(config, args.split)

    all_emb, meta = [], []
    t0 = time.time()
    bs = config.get("batch_size", 8)
    for start in range(0, len(docs), bs):
        chunk_docs = docs[start: start + bs]
        batch, aux = ingestor.ingest(chunk_docs)
        with torch.inference_mode():
            emb = vt5_table_embed(shared, torch.from_numpy(np.asarray(batch.chunk_emb_tokens)).to(device).long(),
                                  torch.from_numpy(np.asarray(batch.chunk_emb_mask)).to(device))
        emb = emb.float().cpu().numpy()
        mask = np.asarray(batch.chunk_mask)
        pages = np.asarray(batch.chunk_page)
        for b, doc in enumerate(chunk_docs):
            for c in np.where(mask[b])[0]:
                all_emb.append(emb[b, c])
                meta.append({
                    "question_id": doc.question_id,
                    "doc_idx": start + b,
                    "page": int(pages[b, c]),
                    "text": aux["chunk_texts"][b][c] if c < len(aux["chunk_texts"][b]) else "",
                })
    embeddings = np.stack(all_emb) if all_emb else np.zeros((0, vt5_cfg.t5.d_model), np.float32)
    build_time = time.time() - t0
    np.savez_compressed(args.out, embeddings=embeddings, meta=json.dumps(meta))
    print(json.dumps({
        "n_chunks": len(embeddings),
        "n_docs": len(docs),
        "dim": int(embeddings.shape[1]),
        "build_time_s": round(build_time, 2),
        "chunks_per_sec": round(len(embeddings) / max(build_time, 1e-9), 1),
        "out": args.out,
    }))


def cmd_query(args):
    import numpy as np
    import torch

    from rag_docvqa_tpu_torch.parallel import ShardedIndex

    data = np.load(args.index, allow_pickle=True)
    embeddings = data["embeddings"]
    meta = json.loads(str(data["meta"]))

    device, config, tokenizer, vt5_cfg, params = _setup(args)
    index = ShardedIndex.build(embeddings, tile_n=args.tile_n, use_kernel=device.type == "cuda",
                               dtype=args.index_dtype, device=device,
                               refine=args.refine and args.index_dtype in ("int8", "int4"))

    with torch.inference_mode():
        q_emb = embed_question(params.t5.shared, tokenizer, args.question, device)
        vals, idx, valid = index.query(q_emb, args.k)
    to_np = lambda x: x.cpu().numpy() if isinstance(x, torch.Tensor) else x
    for rank, (v, i, ok) in enumerate(zip(to_np(vals)[0], to_np(idx)[0], to_np(valid)[0])):
        if not ok:
            break
        info = meta[int(i)]
        print(json.dumps({"rank": rank, "score": round(float(v), 4), **info}))


def main(argv=None):
    parser = argparse.ArgumentParser(description="offline index precompute / query (PyTorch port)")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_index = sub.add_parser("index")
    p_index.add_argument("-m", "--model", required=True)
    p_index.add_argument("-d", "--dataset", required=True)
    p_index.add_argument("--split", default="val")
    p_index.add_argument("--out", required=True)
    p_index.add_argument("overrides", nargs="*")

    p_query = sub.add_parser("query")
    p_query.add_argument("--index", required=True)
    p_query.add_argument("-m", "--model", required=True)
    p_query.add_argument("-q", "--question", required=True)
    p_query.add_argument("--k", type=int, default=5)
    p_query.add_argument("--tile-n", type=int, default=512)
    p_query.add_argument("--index-dtype", choices=("f32", "bf16", "int8", "int4"), default="f32",
                         help="resident index precision: bf16 halves the device memory, int8 quarters it, "
                              "int4 is the 8x capacity extreme (agreement depends on the corpus)")
    p_query.add_argument("--refine", action="store_true",
                         help="int8/int4: keep the npz's full-precision rows in host memory and rescore the "
                              "device's exact quantized top-k' shortlist per query, so top-k agreement "
                              "becomes shortlist recall instead of quantized ordering")
    p_query.add_argument("overrides", nargs="*")

    for p in (p_index, p_query):
        p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")

    args = parser.parse_args(argv)
    if args.cmd == "index":
        cmd_index(args)
    else:
        cmd_query(args)


if __name__ == "__main__":
    main()
