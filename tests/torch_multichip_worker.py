"""The ranks of tests/test_torch_multichip.py: each runs the port's
multi-device paths in a gloo group on the CPU and returns numpy results.

Kept apart from the test file so that a spawned rank imports torch and the
port only, never jax."""

import contextlib
import io
import os

import numpy as np
import torch

from rag_docvqa_tpu_torch import params as p_params
from rag_docvqa_tpu_torch.data.contract import Caps
from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
from rag_docvqa_tpu_torch.data.synthetic import make_corpus
from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
from rag_docvqa_tpu_torch.engine.evaluate import evaluate
from rag_docvqa_tpu_torch.engine.rag_vt5 import RAGConfig, RAGVT5Engine
from rag_docvqa_tpu_torch.metrics import Evaluator
from rag_docvqa_tpu_torch.models import hivt5 as p_hivt5
from rag_docvqa_tpu_torch.models import t5 as p_t5
from rag_docvqa_tpu_torch.models import vt5 as p_vt5
from rag_docvqa_tpu_torch.models.embeddings import SpatialConfig
from rag_docvqa_tpu_torch.ops.chunking import ChunkSpec
from rag_docvqa_tpu_torch.ops.decode import greedy_decode_sharded
from rag_docvqa_tpu_torch.parallel import ShardedIndex, create_mesh, sharded_maxsim_topk
from rag_docvqa_tpu_torch.parallel.mesh import gathered_params, init_with_store, local_rows, shard_params
from rag_docvqa_tpu_torch.training.optimizer import build_optimizer, trainable_mask
from rag_docvqa_tpu_torch.training.train_step import (TrainState, make_hivt5_train_step, make_train_step,
                                                     vt5_param_spec)

INDEX_MODES = {"f32": dict(dtype="f32"), "bf16": dict(dtype="bf16"), "int8": dict(dtype="int8"),
               "int4": dict(dtype="int4"), "int4_refine": dict(dtype="int4", refine=True)}
TIMEOUT_S = 60


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _index(case, mesh):
    """Per precision: the port's own build from the raw rows as one shard a
    rank and as row ranges of one tensor, and the JAX-built rows carried
    over (`params.index_from_numpy`) as one shard a rank."""
    out = {}
    for mode, kw in INDEX_MODES.items():
        common = dict(tile_n=case["tile_n"], refine_kprime=case["kprime"], **kw)
        index = ShardedIndex.build(case["emb"], mesh=mesh, **common)
        ranges = ShardedIndex.build(case["emb"], n_shards=mesh.size("data"), **common)
        jax_rows = case["jax_rows"][mode]
        carried = p_params.index_from_numpy(jax_rows["embeddings"], jax_rows["scales"], n_valid=len(case["emb"]),
                                            dtype=kw["dtype"], tile_n=case["tile_n"], host_rows=jax_rows["host_rows"],
                                            refine_kprime=case["kprime"], mesh=mesh)
        query = lambda idx: tuple(map(_np, idx.query(case["queries"], case["k"])))
        out[mode] = {"group": query(index), "ranges": query(ranges), "carried": query(carried),
                     "resident_bytes": index.resident_bytes, "padded_bytes": ranges.resident_bytes,
                     "held_rows": index.embeddings.shape[0], "carried_rows": carried.embeddings.shape[0]}
    return out


def _maxsim(case, mesh):
    rows = local_rows(case["patches"].shape[0], mesh)
    got = sharded_maxsim_topk(torch.from_numpy(case["patches"][rows]), torch.from_numpy(case["mask"][rows]),
                              torch.from_numpy(case["query"]), mesh=mesh, n_valid=case["n_valid"], k=case["k"])
    return tuple(map(_np, got))


def _steps(case, mesh, params, make_step, roots):
    spec = vt5_param_spec(params)
    full = {n: p.numel() for n, p in params.named_parameters()}
    shard_params(params, spec, mesh)
    held = {n: p.numel() for n, p in params.named_parameters()}
    opt = build_optimizer(**case["opt"], mask=trainable_mask(params, roots))
    state = TrainState.create(params, opt)
    step = make_step(opt)
    metrics = []
    for _ in range(case["steps"]):
        state, m = step(state, case["batch"], case["labels"])
        metrics.append({k: v.item() for k, v in m.items()})
    moments = {n: t.numel() for n, t in state.opt_state["mu"].items()}
    with torch.no_grad():
        whole = gathered_params(state.params, spec, mesh)
    return {"metrics": metrics, "params": whole, "spec": spec, "full": full,
            "held": held, "moments": moments}


def _vt5_train(case, mesh):
    cfg = p_vt5.VT5Config(t5=p_t5.T5Config(**case["t5"]), spatial=SpatialConfig(hidden_size=case["t5"]["d_model"],
                                                                                dropout_rate=0.0))
    out = _steps(case, mesh, p_params.from_jax(case["tree"]),
                 lambda opt: make_train_step(cfg, RAGConfig(**case["rag"]), opt, mesh=mesh), ("t5", "spatial"))
    out["params"] = p_params.to_jax(out["params"])
    return out


def _hivt5_train(case, mesh):
    cfg = p_hivt5.HiVT5Config(t5=p_t5.T5Config(**case["t5"]),
                              spatial=SpatialConfig(hidden_size=case["t5"]["d_model"], dropout_rate=0.0), **case["hi"])
    out = _steps(case, mesh, p_params.hivt5_from_jax(case["tree"]),
                 lambda opt: make_hivt5_train_step(cfg, opt, mesh=mesh), ("t5", "spatial", "page_emb", "page_head"))
    out["params"] = p_params.hivt5_to_jax(out["params"])
    return out


def _decode(case, mesh):
    cfg = p_t5.T5Config(**case["t5"])
    params = p_params.t5_from_jax(case["tree"])
    spec = vt5_param_spec(params)
    shard_params(params, spec, mesh)
    rows = local_rows(case["enc"].shape[0], mesh)
    toks, conf = greedy_decode_sharded(params, cfg, torch.from_numpy(case["enc"][rows]),
                                       torch.from_numpy(case["mask"][rows]), case["steps"], mesh=mesh, spec=spec)
    return _np(toks), _np(conf)


def _evaluate(case, mesh):
    cfg = p_vt5.VT5Config(t5=p_t5.T5Config(**case["t5"]), spatial=SpatialConfig(hidden_size=case["t5"]["d_model"],
                                                                                dropout_rate=0.0))
    tok = HashTokenizer(case["t5"]["vocab_size"])
    engine = RAGVT5Engine(RAGConfig(**case["rag"]), cfg, p_params.from_jax(case["tree"]), tok)
    ing = DocVQAIngestor(tok, ChunkSpec(**case["spec"]), Caps(**case["caps"]))
    docs = make_corpus(case["n_docs"], n_pages=3, words_per_page=30, seed=case["seed"])
    out = evaluate(engine, docs, ing, Evaluator(), batch_size=case["batch_size"], compute_stats=True, mesh=mesh,
                   save_path=case["save_path"] + f".rank{mesh.index('data')}.json")
    keep = ("accuracy", "anls", "retrieval_precision", "chunk_score", "n_samples", "pred_answers", "retrieval_stats",
            "retrieval_stats_examples", "scores_by_samples")
    return {k: out[k] for k in keep}


def run(rank: int, cases: dict) -> dict:
    """Every case on this rank: the 2-D cases on a (world/2, 2) mesh of
    axes (data, model), the index, MaxSim and evaluate on a (world,) data
    mesh."""
    import torch.distributed as dist

    torch.set_num_threads(2)
    world = dist.get_world_size()
    mesh2 = create_mesh((world // 2, 2), ("data", "model"), device="cpu", timeout_s=TIMEOUT_S)
    mesh1 = create_mesh((world,), ("data",), device="cpu", timeout_s=TIMEOUT_S)
    return {"rank": rank, "coords": mesh2.coords,
            "index": _index(cases["index"], mesh1), "maxsim": _maxsim(cases["maxsim"], mesh1),
            "vt5_train": _vt5_train(cases["vt5_train"], mesh2), "hivt5_train": _hivt5_train(cases["hivt5_train"], mesh2),
            "decode": _decode(cases["decode"], mesh2), "evaluate": _evaluate(cases["evaluate"], mesh1)}


def run_clis(rank: int, runs: list, workdir: str) -> list:
    """Each (module, argv) of `runs` in turn, as `torchrun` would start it on
    this rank (RANK, WORLD_SIZE and LOCAL_RANK set): the CLI joins the group
    that is up (`init_from_env` keeps an initialized one) and ends it, so
    every run after the first gets a new group here. Returns each run's
    (return value, standard output)."""
    import torch.distributed as dist

    from rag_docvqa_tpu_torch import eval as p_eval
    from rag_docvqa_tpu_torch import precompute as p_precompute

    torch.set_num_threads(2)
    world = dist.get_world_size()
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    mains = {"eval": p_eval.main, "precompute": p_precompute.main}
    out = []
    for i, (module, argv) in enumerate(runs):
        if not dist.is_initialized():
            init_with_store(os.path.join(workdir, f"store_{i}"), rank, world, "gloo", TIMEOUT_S)
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            ret = mains[module](argv)
        if dist.is_initialized():
            raise AssertionError(f"{module} {argv[0]} left its process group up")
        out.append((ret, printed.getvalue()))
    return out
