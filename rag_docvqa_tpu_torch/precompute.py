"""Offline precompute of the PyTorch port: corpus chunk-embedding index
build + query, and page layouts.

    # build an index over a dataset (the synthetic corpus needs no data files)
    python -m rag_docvqa_tpu_torch.precompute index -m configs/VT5_tiny.yml \\
        -d configs/Synthetic.yml --out corpus_index.npz [--device cuda|cpu]

    # query it
    python -m rag_docvqa_tpu_torch.precompute query --index corpus_index.npz \\
        -m configs/VT5_tiny.yml -q "what is the total?" --k 5 \\
        [--index-dtype f32|bf16|int8|int4] [--refine] [--device cuda|cpu]

    # detect every page's layout regions into an .npz the datasets read
    python -m rag_docvqa_tpu_torch.precompute layouts -m configs/VT5_tiny.yml \
        -d <dataset.yml with page images> --detector DIT|YOLO \
        [--weights detector.safetensors] --out layouts.npz [--device cuda|cpu]

The commands of the root `precompute.py` with its arguments; `--device` takes
the place of `--platform`, the default is cuda, and without a CUDA device the
CLI raises unless `--device cpu` is given. `index` embeds every chunk with
the VT5 table embedder and writes an `.npz` with that CLI's keys
(`embeddings`, `meta`), so either CLI reads the other's file. `query` keeps
the index resident on the device in the chosen precision
(`parallel/index.py`) and prints one JSON line per rank. Under `torchrun`
(`torchrun --nproc_per_node N -m rag_docvqa_tpu_torch.precompute index|query
...`) both run on a mesh of every process on the data axis (NCCL on
cuda:LOCAL_RANK, gloo with `--device cpu`): `index` embeds every N-th batch
on each rank and the first rank writes the file the single process writes;
`query` keeps each rank's shard of the index on its device
(`ShardedIndex.build(..., mesh=)`) and the first rank prints the ranking.
`layouts` runs the
DiT segmentation detector (`models/layout_seg.py`, its backbone through K14)
or the YOLO detector (`models/yolo.py`) over every page image of the split,
sized by the config keys of the root CLI (`layout_d_model`,
`layout_num_layers`, `layout_num_heads`, `layout_mlp_dim`,
`layout_image_size`, `layout_out_indices`; `layout_width`, `layout_depth`),
from seeded weights or a local checkpoint (`--weights`, read by
`models/loader.py`), and writes {boxes, labels} per page. Unlike the root
CLI, which keys a page "<question_id>_p<page>" where MP-DocVQA reads it by
image name (ROADMAP Queue 3, F8), pages of a dataset with image names
(`document_pages`) are keyed by image name, so `use_precomputed_layouts`
reads the file back; pages of the synthetic corpus, which has none, keep the
root CLI's keys. Pages are read as the detector needs them and go through
it in batches of `LAYOUT_BATCH`; a page that several questions share is
detected once, so `n_pages` counts distinct pages where the dataset has
image names (the root CLI counts a page for every question). The line
printed is the root CLI's, and `pages_per_sec` covers reading and decoding
the pages, detecting them and writing the file.
"""

from __future__ import annotations

import argparse
import itertools
import json
import time

LAYOUT_BATCH = 16  # pages a detector forward


def _setup(args, dataset=None, device=None):
    """config, tokenizer, VT5 config and random-weight parameters from the
    config's seed, on `device` (default: the CLI's)."""
    import torch

    from rag_docvqa_tpu_torch.config import build_vt5_config, load_config, load_tokenizer
    from rag_docvqa_tpu_torch.models import vt5 as vt5m
    from rag_docvqa_tpu_torch.train import parse_overrides, resolve_device

    device = device or resolve_device(args.device)
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
    from rag_docvqa_tpu_torch.parallel.mesh import mesh_from_env
    from rag_docvqa_tpu_torch.train import build_docs, resolve_device

    mesh = mesh_from_env(resolve_device(args.device))
    device, config, tokenizer, vt5_cfg, params = _setup(args, dataset=args.dataset,
                                                        device=None if mesh is None else mesh.device)
    ingestor = DocVQAIngestor(tokenizer, build_chunk_spec(config), build_caps(config))
    shared = params.t5.shared
    docs = build_docs(config, args.split)

    all_emb, meta = [], []
    t0 = time.time()
    bs = config.get("batch_size", 8)
    starts = list(range(0, len(docs), bs))
    if mesh is not None:  # every data-size-th batch on this rank
        starts = starts[mesh.index("data")::mesh.size("data")]
    for start in starts:
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
    if mesh is not None:  # the ranks' chunks in document order
        parts = mesh.all_gather_object(list(zip(all_emb, meta)), "data")
        rows = sorted((r for part in parts for r in part), key=lambda r: r[1]["doc_idx"])
        all_emb, meta = [e for e, _ in rows], [m for _, m in rows]
        import torch.distributed as dist

        dist.destroy_process_group()
    embeddings = np.stack(all_emb) if all_emb else np.zeros((0, vt5_cfg.t5.d_model), np.float32)
    build_time = time.time() - t0
    if mesh is not None and not mesh.first:
        return
    np.savez_compressed(args.out, embeddings=embeddings, meta=json.dumps(meta))
    print(json.dumps({
        "n_chunks": len(embeddings),
        "n_docs": len(docs),
        "dim": int(embeddings.shape[1]),
        "build_time_s": round(build_time, 2),
        "chunks_per_sec": round(len(embeddings) / max(build_time, 1e-9), 1),
        "out": args.out,
    }))


def layout_detector(config, name: str, weights, device):
    """The DiT or YOLO detector callable of the root CLI's configuration
    (`make_dit_detector` / `make_yolo_detector`), on `device`."""
    import torch

    from rag_docvqa_tpu_torch import params as P

    gen = torch.Generator(device=device).manual_seed(config["seed"])
    if weights:
        from rag_docvqa_tpu_torch.models.loader import read_state_dict
    if name == "DIT":
        from rag_docvqa_tpu_torch.models.layout_seg import (
            BeitSegConfig, convert_beit_seg_state_dict, init_beit_seg_params, make_dit_detector,
        )
        from rag_docvqa_tpu_torch.models.vit import ViTConfig

        cfg = BeitSegConfig(
            vit=ViTConfig(hidden_size=config.get("layout_d_model", 32),
                          num_layers=config.get("layout_num_layers", 5),
                          num_heads=config.get("layout_num_heads", 4),
                          mlp_dim=config.get("layout_mlp_dim", 64),
                          patch_size=16, image_size=config.get("layout_image_size", 224),
                          arch="beit", use_abs_pos=False, use_rel_pos_bias=True,
                          layer_scale_init=0.1, use_final_layernorm=False),
            out_indices=tuple(config.get("layout_out_indices", (2, 3, 4, 5))),
        )
        params = (P.layout_seg_from_jax(convert_beit_seg_state_dict(read_state_dict(weights), cfg), device)
                  if weights else init_beit_seg_params(gen, cfg))
        return make_dit_detector(params, cfg)
    from rag_docvqa_tpu_torch.models.yolo import YOLOConfig, convert_yolo_state_dict, init_yolo_params, make_yolo_detector

    cfg = YOLOConfig(width=config.get("layout_width", 16), depth=config.get("layout_depth", 1),
                     image_size=config.get("layout_image_size", 256))
    params = (P.yolo_from_jax(convert_yolo_state_dict(read_state_dict(weights), cfg), device)
              if weights else init_yolo_params(gen, cfg))
    return make_yolo_detector(params, cfg)


def layout_pages(config, split):
    """(key, page image) for every distinct page with an image of the split,
    in document and page order, each document read when the one before is
    used up: keyed by image name where the dataset has them
    (`document_pages`; a page that several questions share comes once), else
    "<question_id>_p<page>"."""
    import numpy as np

    from rag_docvqa_tpu_torch.data.datasets import build_dataset
    from rag_docvqa_tpu_torch.train import build_docs

    ds = None if config.get("dataset_name") == "Synthetic" else build_dataset(config, split)
    if hasattr(ds, "document_pages"):
        named = (ds.document_pages(i) for i in range(len(ds)))
    else:
        named = ((d, [f"{d.question_id}_p{p}" for p in range(len(d.words))])
                 for d in (build_docs(config, split) if ds is None else ds))
    seen = set()
    for doc, names in named:
        for name, img in zip(names, doc.images or ()):
            if img is not None and name not in seen:
                seen.add(name)
                yield name, np.asarray(img)


def cmd_layouts(args):
    """Detect every page's layout regions into one .npz of {boxes, labels}
    per page key (see the module docstring)."""
    import numpy as np

    from rag_docvqa_tpu_torch.config import load_config
    from rag_docvqa_tpu_torch.train import parse_overrides, resolve_device

    device = resolve_device(args.device)
    config = load_config(model=args.model, dataset=args.dataset, overrides=parse_overrides(args.overrides))
    detector = layout_detector(config, args.detector, args.weights, device)
    pages = layout_pages(config, args.split)
    out: dict = {}
    t0 = time.time()
    while chunk := list(itertools.islice(pages, LAYOUT_BATCH)):
        for (key, _), (boxes, labels) in zip(chunk, detector.batch([img for _, img in chunk])):
            out[key] = np.asarray({"boxes": boxes, "labels": labels}, dtype=object)
    np.savez_compressed(args.out, **out)
    print(json.dumps({
        "n_pages": len(out), "detector": args.detector,
        "pages_per_sec": round(len(out) / max(time.time() - t0, 1e-9), 2), "out": args.out,
    }))


def cmd_query(args):
    import numpy as np
    import torch

    from rag_docvqa_tpu_torch.parallel import ShardedIndex
    from rag_docvqa_tpu_torch.parallel.mesh import mesh_from_env
    from rag_docvqa_tpu_torch.train import resolve_device

    data = np.load(args.index, allow_pickle=True)
    embeddings = data["embeddings"]
    meta = json.loads(str(data["meta"]))

    mesh = mesh_from_env(resolve_device(args.device))
    device, config, tokenizer, vt5_cfg, params = _setup(args, device=None if mesh is None else mesh.device)
    index = ShardedIndex.build(embeddings, tile_n=args.tile_n, use_kernel=device.type == "cuda",
                               dtype=args.index_dtype, device=device, mesh=mesh,
                               refine=args.refine and args.index_dtype in ("int8", "int4"))

    with torch.inference_mode():
        q_emb = embed_question(params.t5.shared, tokenizer, args.question, device)
        vals, idx, valid = index.query(q_emb, args.k)
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
        if not mesh.first:
            return
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

    p_lay = sub.add_parser("layouts")
    p_lay.add_argument("-m", "--model", required=True)
    p_lay.add_argument("-d", "--dataset", required=True)
    p_lay.add_argument("--split", default="val")
    p_lay.add_argument("--detector", choices=("DIT", "YOLO"), default="DIT")
    p_lay.add_argument("--weights", default=None, help="local checkpoint (safetensors, .bin or a directory) to convert")
    p_lay.add_argument("--out", required=True)
    p_lay.add_argument("overrides", nargs="*")

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

    for p in (p_index, p_query, p_lay):
        p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")

    args = parser.parse_args(argv)
    {"index": cmd_index, "layouts": cmd_layouts, "query": cmd_query}[args.cmd](args)


if __name__ == "__main__":
    main()
