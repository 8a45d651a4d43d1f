"""Port parity, the RAG-Pix2Struct engine end to end on the CPU against the
JAX engine, on the same seeded page images and the same weights (the JAX
tree carried over with `params.p2s_from_jax`): `inference` in the grid and
layout chunk modes, `prepare_docs`, `inference_stream`, `build_visual_index`
+ `inference_indexed`, the packed generator input of
`_indexed_retrieve_pack` with its chained row offsets, `no_rag_max_conf`,
the wire-dtype gate, and `configs/Pix2Struct_tiny.yml` through
`config.build_engine` in a process that imports neither jax nor the JAX
package.

Integer and string outputs (retrieved chunk indices, pages, packed row and
column ids, masks, decoded answers) are exact; MaxSim scores agree to 1e-4
(sums of 24 cosines over a 2-layer f32 tower), confidences to 1e-4."""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_docvqa_tpu.data import HashTokenizer as JHashTokenizer
from rag_docvqa_tpu.data.contract import RawDocument as JRawDocument
from rag_docvqa_tpu.engine import rag_pix2struct as j_eng
from rag_docvqa_tpu.models import pix2struct as j_p2s
from rag_docvqa_tpu.models import t5 as j_t5
from rag_docvqa_tpu_torch import params as P
from rag_docvqa_tpu_torch.data.contract import RawDocument
from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
from rag_docvqa_tpu_torch.engine import rag_pix2struct as eng
from rag_docvqa_tpu_torch.models import pix2struct as p2s
from rag_docvqa_tpu_torch.models import t5 as t5m

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIS = dict(hidden_size=32, num_layers=2, num_heads=4, d_ff=64, patch_dim=768, max_rows=128, max_cols=128)
TEXT = dict(vocab_size=300, d_model=32, d_kv=8, num_heads=4, d_ff=64, num_encoder_layers=0, num_decoder_layers=2,
            gated_ffn=True, tie_word_embeddings=False, dropout_rate=0.0)
J_CFG = j_p2s.Pix2StructConfig(vision=j_p2s.P2SVisionConfig(**VIS), text=j_t5.T5Config(**TEXT))
P_CFG = p2s.Pix2StructConfig(vision=p2s.P2SVisionConfig(**VIS), text=t5m.T5Config(**TEXT))
RAG = dict(chunk_num=3, image_patch_size=96, patches_per_chunk=24, max_chunks=16, max_total_patches=96,
           max_new_tokens=3)


@pytest.fixture(scope="module")
def weights():
    tree = j_p2s.init_p2s_params(jax.random.PRNGKey(0), J_CFG)
    return tree, P.p2s_from_jax(jax.tree.map(np.array, tree))


def _engines(weights, **kw):
    tree, params = weights
    cfg = {**RAG, **kw}
    return (j_eng.RAGPix2StructEngine(j_eng.P2SRAGConfig(**cfg), J_CFG, tree, JHashTokenizer(vocab_size=300)),
            eng.RAGPix2StructEngine(eng.P2SRAGConfig(**cfg), P_CFG, params, HashTokenizer(vocab_size=300)))


def _docs(seed, n_docs=2, n_pages=2, layout=None):
    rng = np.random.RandomState(seed)
    images = [[rng.randint(0, 255, (200, 160, 3), np.uint8) for _ in range(n_pages)] for _ in range(n_docs)]
    mk = lambda cls: [cls(question=f"what is item {i}?", words=[[]], boxes=[[]], answers=["x"], images=images[i],
                          layout=layout) for i in range(n_docs)]
    return mk(JRawDocument), mk(RawDocument)


def _same_result(got, want, conf_tol=1e-4):
    assert got["pred_answers"] == want["pred_answers"]
    assert got["pred_answer_pages"] == want["pred_answer_pages"]
    np.testing.assert_allclose(got["confidences"], want["confidences"], rtol=conf_tol, atol=1e-6)


@pytest.mark.parametrize("surround", [0, 1, (1, 0)])
def test_inference_matches_jax_engine(weights, surround):
    je, pe = _engines(weights, include_surroundings=surround)
    jdocs, pdocs = _docs(0)
    want, got = je.inference(jdocs), pe.inference(pdocs)
    _same_result(got, want)
    assert all(0.0 <= c <= 1.0 + 1e-6 for c in got["confidences"])
    # the evaluate loop's (batch, aux) form
    aux = {"questions": [d.question for d in pdocs], "images": [d.images for d in pdocs]}
    _same_result(pe.inference(None, aux), want)


def test_retrieve_steps_and_scores_match_jax(weights):
    je, pe = _engines(weights, include_surroundings=1)
    jdocs, pdocs = _docs(1, n_docs=1)
    jc, jp, jv, js = je.retrieve(jdocs[0].question, jdocs[0].images)
    pc, pp, pv, ps = pe.retrieve(pdocs[0].question, pdocs[0].images)
    assert pp == jp and ps["coords"] == js["coords"] and ps["xyxy"] == js["xyxy"] and ps["n_chunks"] == js["n_chunks"]
    np.testing.assert_allclose(pv, np.asarray(jv), rtol=0, atol=1e-4)
    assert len(pc) == len(jc)
    for a, b in zip(pc, jc):
        np.testing.assert_array_equal(a, b)


def test_layout_mode_matches_jax_engine(weights):
    layout = [{"boxes": [[0.0, 0.0, 1.0, 0.5], [0.2, 0.6, 0.8, 0.95]], "labels": [1, 3]},
              {"boxes": [], "labels": []}]  # second page: grid fallback
    kw = dict(include_surroundings=1, chunk_mode="layout", layout_fallback_mode="horizontal", image_patch_size=64,
              max_total_patches=64)
    je, pe = _engines(weights, **kw)
    jdocs, pdocs = _docs(2, n_docs=1, layout=layout)
    _, jp, jv, js = je.retrieve(jdocs[0].question, jdocs[0].images, layouts=layout)
    _, pp, pv, ps = pe.retrieve(pdocs[0].question, pdocs[0].images, layouts=layout)
    assert ps["coords"] == js["coords"] and ps["xyxy"] == js["xyxy"] and pp == jp
    assert len({g for (p, g, r, c) in ps["coords"] if p == 0}) == 2  # a text grid and a whole-table grid
    np.testing.assert_allclose(pv, np.asarray(jv), rtol=0, atol=1e-4)
    _same_result(pe.inference(pdocs), je.inference(jdocs))


def test_prepare_docs_and_prepared_inference(weights):
    je, pe = _engines(weights)
    jdocs, pdocs = _docs(3)
    images_list = [[np.asarray(im) for im in d.images] for d in pdocs]
    jprep, pprep = je.prepare_docs(images_list), pe.prepare_docs(images_list)
    for a, b in zip(pprep, jprep):
        assert a.coords == b.coords and a.xyxy == b.xyxy and a.shapes == b.shapes and a.n_chunks == b.n_chunks
        for name in ("patches", "tok_mask", "chunk_rows", "chunk_page"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    direct, via_prep = pe.inference(pdocs), pe.inference(pdocs, prepared=pprep)
    assert direct["pred_answers"] == via_prep["pred_answers"]
    assert direct["pred_answer_pages"] == via_prep["pred_answer_pages"]
    assert direct["confidences"] == via_prep["confidences"]
    _same_result(via_prep, je.inference(jdocs, prepared=jprep))


def test_inference_stream_matches_per_batch(weights):
    je, pe = _engines(weights)
    batches = [_docs(s) for s in (4, 5, 6)]
    piped = list(pe.inference_stream(iter([p for _, p in batches]), depth=2))
    assert len(piped) == 3
    for (jdocs, pdocs), out in zip(batches, piped):
        ref = pe.inference(pdocs)
        assert out["pred_answers"] == ref["pred_answers"] and out["pred_answer_pages"] == ref["pred_answer_pages"]
        assert out["confidences"] == ref["confidences"]  # the same code on the same inputs, in order
    _same_result(piped[1], je.inference(batches[1][0]))


def test_inference_indexed_matches_jax_engine(weights):
    je, pe = _engines(weights)
    jdocs, pdocs = _docs(7, n_docs=3)
    images_list = [[np.asarray(im) for im in d.images] for d in pdocs]
    jindex, pindex = je.build_visual_index(je.prepare_docs(images_list)), pe.build_visual_index(pe.prepare_docs(images_list))
    assert pindex.mc == jindex.mc
    np.testing.assert_array_equal(pindex.chunk_valid.numpy(), np.asarray(jindex.chunk_valid))
    np.testing.assert_array_equal(pindex.chunk_rows.numpy(), np.asarray(jindex.chunk_rows))
    np.testing.assert_array_equal(pindex.chunk_page.numpy(), np.asarray(jindex.chunk_page))
    np.testing.assert_allclose(pindex.emb.numpy()[pindex.chunk_valid.numpy()],
                               np.asarray(jindex.emb)[np.asarray(jindex.chunk_valid)], rtol=0, atol=1e-4)
    qs, ids = [d.question for d in pdocs], [2, 0, 1]
    want, got = je.inference_indexed(qs, ids, jindex), pe.inference_indexed(qs, ids, pindex)
    _same_result(got, want)
    np.testing.assert_array_equal(got["retrieval"]["chunk_indices"], want["retrieval"]["chunk_indices"])
    np.testing.assert_array_equal(got["retrieval"]["valid"], want["retrieval"]["valid"])
    np.testing.assert_allclose(got["retrieval"]["similarities"], want["retrieval"]["similarities"], rtol=0, atol=1e-4)
    # the host path ranks the same chunks from the same embeddings
    _, _, host_vals, _ = pe._retrieve_batch(qs, [images_list[i] for i in ids],
                                            prepared=[pe.prepare_docs(images_list)[i] for i in ids])
    np.testing.assert_allclose(got["retrieval"]["similarities"], host_vals, rtol=0, atol=1e-4)
    with pytest.raises(ValueError):
        pe.inference_indexed(qs, [0], pindex)


def test_indexed_pack_row_offsets_match_jax(weights):
    """The packed generator input, bit for bit: header rows 1..h, chunk j's
    rows shifted by h + the row counts of the chunks before it, padding rows
    zero."""
    je, pe = _engines(weights)
    _, pdocs = _docs(8, n_docs=2)
    images_list = [[np.asarray(im) for im in d.images] for d in pdocs]
    jindex, pindex = je.build_visual_index(je.prepare_docs(images_list)), pe.build_visual_index(pe.prepare_docs(images_list))
    T, F = RAG["patches_per_chunk"], 2 + VIS["patch_dim"]
    B = 2
    q_patches, q_mask, hrows = np.zeros((B, T, F), pe._xfer), np.zeros((B, T), np.float32), np.zeros((B,), np.int64)
    for b, d in enumerate(pdocs):
        q_patches[b], q_mask[b], hrows[b] = pe._render_question(d.question)
    g = min(max(RAG["max_total_patches"] // T - 1, 1), pindex.mc, RAG["chunk_num"])
    doc_ids = np.asarray([1, 0])
    want = j_eng._indexed_retrieve_pack(
        je.params, je.p2s_cfg, jindex.emb, jindex.tok_mask, jindex.patches, jindex.chunk_valid, jindex.chunk_rows,
        jindex.chunk_page, jnp.asarray(q_patches), jnp.asarray(q_mask), jnp.asarray(doc_ids.astype(np.int32)),
        jnp.asarray(hrows.astype(np.int32)), RAG["chunk_num"], g, T)
    got = eng._indexed_retrieve_pack(pe.params, pe.p2s_cfg, pindex, torch.from_numpy(q_patches),
                                     torch.from_numpy(q_mask), torch.from_numpy(doc_ids), torch.from_numpy(hrows),
                                     RAG["chunk_num"], g, T)
    names = ("gen_patches", "gen_mask", "vals", "idx", "valid", "pages")
    for name, a, b in zip(names, got, want):
        a, b = a.numpy(), np.asarray(b)
        if name == "vals":
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    gen = got[0].numpy()
    assert gen.shape == (B, (g + 1) * T, F)
    # the chain itself, from the index's own row counts
    rows = pindex.chunk_rows.numpy()
    for b in range(B):
        off = int(hrows[b])
        for j in range(g):
            blk, c = gen[b, (j + 1) * T:(j + 2) * T], int(got[3][b, j])
            real = blk[:, 0] > 0
            if not bool(got[4][b, j]):
                assert not real.any()
                continue
            assert blk[real, 0].min() == off + 1 and blk[real, 0].max() == off + rows[doc_ids[b], c]
            assert (blk[~real] == 0).all()
            off += int(rows[doc_ids[b], c])


def test_no_rag_and_wire_dtype_gate(weights):
    je, pe = _engines(weights)
    jdocs, pdocs = _docs(9, n_docs=1, n_pages=3)
    (ja, jc), (pa, pc) = je.no_rag_max_conf(jdocs[0]), pe.no_rag_max_conf(pdocs[0])
    assert pa == ja and abs(pc - jc) <= 1e-4 * max(jc, 1e-6) + 1e-7
    je2, pe2 = _engines(weights, use_rag=False)
    _same_result(pe2.inference(pdocs), je2.inference(jdocs))
    # f32 weights keep exact f32 transfers; bf16 weights ship f16 while ids up to 2048 stay exact
    assert pe._xfer == np.float32
    tok = HashTokenizer(vocab_size=300)
    bf16 = P.p2s_from_jax(jax.tree.map(np.array, weights[0])).to(torch.bfloat16)
    e16 = eng.RAGPix2StructEngine(eng.P2SRAGConfig(**RAG), P_CFG, bf16, tok)
    assert e16._xfer == np.float16
    assert eng.RAGPix2StructEngine(eng.P2SRAGConfig(chunk_num=3, max_total_patches=4096), P_CFG, bf16, tok)._xfer \
        == np.float32
    out16 = e16.inference(pdocs)
    e16._xfer = np.float32  # the same bf16 weights, f32 transfers
    out32 = e16.inference(pdocs)
    assert out16["pred_answers"] == out32["pred_answers"] and out16["pred_answer_pages"] == out32["pred_answer_pages"]
    np.testing.assert_allclose(out16["confidences"], out32["confidences"], rtol=2e-2, atol=1e-3)
    with pytest.raises(ValueError):
        pe.inference([RawDocument(question="q", words=[[]], boxes=[[]])])


def test_chunk_num_above_the_bucket_floor(weights):
    """k <= mc: the chunk axis floors at chunk_num, as in JAX."""
    je, pe = _engines(weights, chunk_num=20, max_chunks=32)
    jdocs, pdocs = _docs(10, n_docs=1)
    _same_result(pe.inference(pdocs), je.inference(jdocs))
    assert pe._chunk_cap([3]) == 32 and pe._chunk_cap([40]) == 32
    assert _engines(weights)[1]._chunk_cap([3]) == 16


def test_geometry_helpers_match_jax():
    for inc in (0, 1, 2, 3, 4, (1, 2), (0, 1)):
        for center, shape in (((0, 0), (3, 4)), ((2, 1), (3, 4)), ((1, 0), (1, 1))):
            assert sorted(eng._surrounding_coords(center, shape, inc)) == sorted(j_eng._surrounding_coords(center, shape, inc))
    rng = np.random.RandomState(0)
    images = [rng.randint(0, 255, (100, 80, 3), np.uint8) for _ in range(2)]
    coords = [(0, 0, 0, 0), (0, 0, 1, 0), (1, 1, 0, 0), (1, 1, 1, 0)]
    xyxy = [[0, 0, 80, 40], [0, 30, 80, 70], [0, 0, 80, 50], [0, 60, 80, 100]]
    got = eng._merge_overlapping(sorted(coords), xyxy, coords, images)
    want = j_eng._merge_overlapping(sorted(coords), xyxy, coords, images)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


CONFIG_JAX_FREE = textwrap.dedent("""
    import json, sys
    for name in ("jax", "flax", "optax", "orbax"):
        sys.modules[name] = None   # any import of them now fails
    import numpy as np, torch
    torch.set_num_threads(2)
    from rag_docvqa_tpu_torch.config import build_engine, build_p2s_config, load_config, load_tokenizer
    from rag_docvqa_tpu_torch.data.contract import RawDocument
    from rag_docvqa_tpu_torch.models import pix2struct as p2s
    c = load_config("configs/Pix2Struct_tiny.yml", overrides={"n_pages": 2})
    tok = load_tokenizer("hash:300")
    params = p2s.init_p2s_params(torch.Generator().manual_seed(c["seed"]), build_p2s_config(c, tok.vocab_size))
    engine = build_engine(c, params, tok)
    rng = np.random.RandomState(0)
    size = c["synthetic_image_size"]
    docs = [RawDocument(question=f"what is the total {i}?", words=[[]], boxes=[[]],
                        images=[rng.randint(0, 255, (size, size, 3), np.uint8) for _ in range(2)]) for i in range(2)]
    out = engine.inference(docs)
    assert not any(m.split(".")[0] in ("jax", "flax", "jaxlib", "optax", "orbax")
                   for m in sys.modules if sys.modules[m] is not None)
    assert not [m for m in sys.modules if m == "rag_docvqa_tpu" or m.startswith("rag_docvqa_tpu.")]
    print(json.dumps({"engine": type(engine).__name__, "n": len(out["pred_answers"]), "conf": out["confidences"],
                      "pages": out["pred_answer_pages"], "layers": engine.p2s_cfg.vision.num_layers,
                      "k": engine.cfg.chunk_num, "new": engine.cfg.max_new_tokens}))
""")


def test_tiny_config_serves_through_the_port_without_jax():
    proc = subprocess.run([sys.executable, "-c", CONFIG_JAX_FREE], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["engine"] == "RAGPix2StructEngine" and res["n"] == 2 and all(np.isfinite(res["conf"]))
    assert (res["layers"], res["k"], res["new"]) == (2, 3, 4)  # configs/Pix2Struct_tiny.yml
    assert all(set(p) <= {0, 1} for p in res["pages"])


def test_build_p2s_config_matches_jax():
    import dataclasses

    from rag_docvqa_tpu import config as j_config
    from rag_docvqa_tpu_torch import config as p_config

    for c in ({}, {"d_model": 32, "d_kv": 8, "num_heads": 4, "d_ff": 64, "num_layers": 2, "decode_kv_int8": True}):
        want, got = j_config.build_p2s_config(c, 300), p_config.build_p2s_config(c, 300)
        wv = dataclasses.asdict(want.vision)
        assert wv.pop("flash_encoder") is False  # the JAX tower's route switch; the port's tower has one route
        assert dataclasses.asdict(got.vision) == wv
        gt, wt = dataclasses.asdict(got.text), dataclasses.asdict(want.text)
        assert {k: v for k, v in gt.items() if k in wt} == {k: v for k, v in wt.items() if k in gt}
    assert dataclasses.asdict(eng.P2SRAGConfig()) == dataclasses.asdict(j_eng.P2SRAGConfig())
