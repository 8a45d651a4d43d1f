"""Port parity, RAG-VT5 `concat` serving with the visual branch on the CPU:
`RAGVT5Engine.inference` with `use_visual=True` against the JAX engine on
the same ingested batch, the same seeded page images and the same weights
(the JAX tree, ViT tower and matcher included, carried over with
`params.from_jax`), for a ViT and a BEiT (DiT-like) tower; the visual
tokens themselves; and the `use_visual` / `visual_*` config keys.

Decoded answers, pages, layout labels and boxes are exact; the visual
tokens agree to 1e-3 of their largest value (the JAX engine runs its tower
through the XLA blocks on the CPU: exact erf, f32 rel-pos table; the port
runs the K14 cast points), the confidences to 1e-3."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from rag_docvqa_tpu import config as j_config
from rag_docvqa_tpu.data import DocVQAIngestor as JIngestor
from rag_docvqa_tpu.data import HashTokenizer as JHashTokenizer
from rag_docvqa_tpu.data.contract import Caps as JCaps
from rag_docvqa_tpu.data.synthetic import make_corpus as j_make_corpus
from rag_docvqa_tpu.engine import RAGConfig as JRAGConfig
from rag_docvqa_tpu.engine import RAGVT5Engine as JEngine
from rag_docvqa_tpu.models import t5 as j_t5
from rag_docvqa_tpu.models import vit as j_vit
from rag_docvqa_tpu.models import vt5 as j_vt5
from rag_docvqa_tpu.models.embeddings import SpatialConfig as JSpatialConfig
from rag_docvqa_tpu.ops.chunking import ChunkSpec
from rag_docvqa_tpu_torch import config as p_config
from rag_docvqa_tpu_torch import params as p_params
from rag_docvqa_tpu_torch.data.contract import Caps
from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
from rag_docvqa_tpu_torch.data.synthetic import make_corpus
from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
from rag_docvqa_tpu_torch.engine.rag_vt5 import RAGConfig, RAGVT5Engine
from rag_docvqa_tpu_torch.models import t5 as p_t5
from rag_docvqa_tpu_torch.models import vit as p_vit
from rag_docvqa_tpu_torch.models import vt5 as p_vt5
from rag_docvqa_tpu_torch.models.embeddings import SpatialConfig

torch.set_num_threads(2)

T5_KW = dict(vocab_size=1024, d_model=32, d_kv=8, num_heads=4, d_ff=64, num_encoder_layers=2,
             num_decoder_layers=2, dropout_rate=0.0)
RAG_KW = dict(page_retrieval="concat", chunk_num=3, include_surroundings=1, max_source_length=96, max_new_tokens=4)
CAPS = dict(max_pages=3, max_chunks=16, max_slots=128, tokens_per_word=8, embed_tokens=48)
SPEC = ChunkSpec(chunk_size=8, overlap=1)


def _vit_kw(arch):
    return dict(hidden_size=16, num_layers=2, num_heads=2, mlp_dim=32, patch_size=8, image_size=32, arch=arch,
                use_rel_pos_bias=arch == "beit", use_abs_pos=arch == "vit",
                layer_scale_init=0.1 if arch == "beit" else 0.0, use_final_layernorm=arch == "vit")


def _setup(arch):
    jcfg = j_vt5.VT5Config(t5=j_t5.T5Config(**T5_KW), spatial=JSpatialConfig(hidden_size=32, dropout_rate=0.0),
                           vit=j_vit.ViTConfig(**_vit_kw(arch)), use_visual=True)
    pcfg = p_vt5.VT5Config(t5=p_t5.T5Config(**T5_KW), spatial=SpatialConfig(hidden_size=32, dropout_rate=0.0),
                           vit=p_vit.ViTConfig(**_vit_kw(arch)), use_visual=True)
    tree = jax.tree.map(np.array, j_vt5.init_vt5_params(jax.random.PRNGKey(1), jcfg))
    bf16_exact = lambda a: np.asarray(torch.from_numpy(np.array(a)).bfloat16().float())
    # tables that bf16 holds exactly: the port's layers take their rel-pos bias in bf16, the JAX engine's
    # plain blocks on the CPU in f32
    tree["t5"]["encoder"]["rel_bias"] = bf16_exact(tree["t5"]["encoder"]["rel_bias"])
    rng = np.random.RandomState(2)
    blocks = tree["visual"]["vit"]["blocks"]
    for name in ("q", "v", "o", "fc1", "fc2"):
        blocks[name]["bias"] = (rng.randn(*blocks[name]["bias"].shape) * 0.1).astype(np.float32)
    if arch == "beit":
        blocks["rel_bias_table"] = bf16_exact(rng.randn(*blocks["rel_bias_table"].shape).astype(np.float32))
    tree["visual"]["matcher"]["bias"] = np.linspace(-0.3, 0.3, 32).astype(np.float32)
    return jcfg, pcfg, tree, p_params.from_jax(tree)


def _batches(seed=3, n_docs=3, n_pages=2):
    jdocs = j_make_corpus(n_docs, n_pages=n_pages, words_per_page=30, seed=seed)
    pdocs = make_corpus(n_docs, n_pages=n_pages, words_per_page=30, seed=seed)
    rng = np.random.RandomState(seed)
    for jd, pd in zip(jdocs, pdocs):
        jd.images = pd.images = [rng.randint(0, 255, (64, 48, 3), np.uint8) for _ in range(n_pages)]
    jtok, ptok = JHashTokenizer(1024), HashTokenizer(1024)
    jb, jaux = JIngestor(jtok, SPEC, JCaps(**CAPS)).ingest(jdocs)
    pb, paux = DocVQAIngestor(ptok, SPEC, Caps(**CAPS)).ingest(pdocs)
    return jtok, ptok, jb, jaux, pb, paux


@pytest.mark.parametrize("arch", ["vit", "beit"])
def test_visual_concat_engine_matches_jax(arch):
    jcfg, pcfg, tree, port = _setup(arch)
    jtok, ptok, jb, jaux, pb, paux = _batches()
    jeng = JEngine(JRAGConfig(use_visual=True, **RAG_KW), jcfg, jax.tree.map(jax.numpy.asarray, tree), jtok)
    peng = RAGVT5Engine(RAGConfig(use_visual=True, **RAG_KW), pcfg, port, ptok)
    want, got = jeng.inference(jb, jaux), peng.inference(pb, paux)
    assert got["pred_answers"] == want["pred_answers"]
    assert got["pred_answer_pages"] == want["pred_answer_pages"]
    np.testing.assert_allclose(got["confidences"], want["confidences"], rtol=1e-3)
    r, w = got["retrieval"], want["retrieval"]
    assert r["top_k_layout_labels"] == w["top_k_layout_labels"]
    np.testing.assert_array_equal(r["boxes"], np.asarray(w["boxes"]))

    # the visual tokens themselves, from the engines' own crops and grids
    from rag_docvqa_tpu.ops.gather import assemble_concat as j_assemble
    from rag_docvqa_tpu_torch.data.contract import to_device
    from rag_docvqa_tpu_torch.engine.rag_vt5 import retrieve
    from rag_docvqa_tpu_torch.ops.gather import assemble_concat

    jbd = jb
    jret = jeng.retrieve(jbd)
    _, jowner = j_assemble(jbd, jret.top_k_idx, jret.top_k_valid, jeng.cfg.assemble())
    jvis = np.asarray(jeng._visual(jbd, jaux, jowner, jret))
    pbd = to_device(pb, peng.device)
    pret = retrieve(port.t5.shared, pbd, k=3)
    _, powner = assemble_concat(pbd, pret.top_k_idx, pret.top_k_valid, peng.cfg.assemble())
    pvis = peng._visual(pbd, paux, powner, pret).numpy()
    assert pvis.shape == jvis.shape == (3, 17, 32)
    assert np.abs(pvis - jvis).max() <= 1e-3 * max(1.0, np.abs(jvis).max())

    # the branch changes the conditioning: Te grows by the 17 visual tokens
    embeds, mask = p_vt5.input_embeds(port, pcfg, assemble_concat(pbd, pret.top_k_idx, pret.top_k_valid,
                                                                 peng.cfg.assemble())[0], torch.from_numpy(pvis))
    assert embeds.shape[1] == mask.shape[1] == 96 + 17 and bool(mask[:, 96:].all())


def test_visual_branch_off_or_without_images():
    jcfg, pcfg, tree, port = _setup("vit")
    jtok, ptok, jb, jaux, pb, paux = _batches(seed=4, n_docs=2)
    jtree = jax.tree.map(jax.numpy.asarray, tree)
    # use_visual off in the RAG config: the tower is not run, as in JAX
    want = JEngine(JRAGConfig(use_visual=False, **RAG_KW), jcfg, jtree, jtok).inference(jb, jaux)
    off = RAGVT5Engine(RAGConfig(use_visual=False, **RAG_KW), pcfg, port, ptok)
    got = off.inference(pb, paux)
    assert got["pred_answers"] == want["pred_answers"]
    np.testing.assert_allclose(got["confidences"], want["confidences"], rtol=1e-4)
    # no page images in the batch: the text path alone
    on = RAGVT5Engine(RAGConfig(use_visual=True, **RAG_KW), pcfg, port, ptok)
    no_img = dict(paux, images=[None] * len(paux["images"]))
    assert on.inference(pb, no_img)["pred_answers"] == got["pred_answers"]
    # parameters without a tower
    bare = p_params.from_jax({k: v for k, v in tree.items() if k != "visual"})
    assert bare.visual is None
    assert RAGVT5Engine(RAGConfig(use_visual=True, **RAG_KW), pcfg, bare, ptok).inference(pb, paux)["pred_answers"] \
        == got["pred_answers"]


def test_generate_with_visual_tokens_matches_jax():
    jcfg, pcfg, tree, port = _setup("beit")
    _, _, jb, jaux, pb, paux = _batches(seed=5, n_docs=2)
    from rag_docvqa_tpu.engine.rag_vt5 import retrieve_device
    from rag_docvqa_tpu.ops.gather import assemble_concat as j_assemble
    from rag_docvqa_tpu.engine.rag_vt5 import RAGConfig as JRC
    from rag_docvqa_tpu_torch.data.contract import to_device
    from rag_docvqa_tpu_torch.engine.rag_vt5 import retrieve
    from rag_docvqa_tpu_torch.ops.gather import assemble_concat

    rng = np.random.RandomState(0)
    visual = rng.randn(2, 17, 32).astype(np.float32)
    vmask = np.ones((2, 17), bool)
    vmask[1, 9:] = False
    jbd, pbd = jb, to_device(pb, "cpu")
    jtree = jax.tree.map(jax.numpy.asarray, tree)
    jret = retrieve_device(jtree["t5"]["shared"], jbd, k=3)
    pret = retrieve(port.t5.shared, pbd, k=3)
    acfg = JRC(**RAG_KW).assemble()
    jgen, _ = j_assemble(jbd, jret.top_k_idx, jret.top_k_valid, acfg)
    pgen, _ = assemble_concat(pbd, pret.top_k_idx, pret.top_k_valid, RAGConfig(**RAG_KW).assemble())
    jt, jc = j_vt5.generate(jtree, jcfg, jgen, jax.numpy.asarray(visual), jax.numpy.asarray(vmask), max_new_tokens=4)
    pt, pc = p_vt5.generate(port, pcfg, pgen, torch.from_numpy(visual), torch.from_numpy(vmask), max_new_tokens=4)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=1e-4)


def test_config_keys_build_the_visual_branch():
    """`build_vt5_config` reads `visual_hidden_size` only, as the JAX
    `build_vt5_config`: the same dict through both gives the same tower, and
    the other `visual_*` keys leave it at `ViTConfig`'s defaults."""
    c = {"use_visual": True, "visual_hidden_size": 16, "visual_num_layers": 2, "visual_num_heads": 2,
         "visual_mlp_dim": 32, "visual_patch_size": 8, "visual_image_size": 32, "d_model": 32, "d_kv": 8,
         "num_heads": 4, "d_ff": 64, "num_layers": 2}
    got = p_config.build_vt5_config(c, 1024)
    assert got.use_visual and p_config.build_rag_config(c).use_visual
    want = j_config.build_vt5_config(c, 1024).vit
    assert dataclasses.asdict(got.vit) == dataclasses.asdict(want)
    assert got.vit.hidden_size == 16 and got.vit.num_layers == j_vit.ViTConfig().num_layers
    assert not p_config.build_vt5_config({}, 1024).use_visual and not p_config.build_rag_config({}).use_visual
    assert dataclasses.asdict(p_config.build_vt5_config({}, 1024).vit) == dataclasses.asdict(j_vit.ViTConfig())
    # a small tower stays reachable by building the config directly
    tok = HashTokenizer(1024)
    small = dataclasses.replace(got, vit=p_vit.ViTConfig(**_vit_kw("vit")))
    params = p_vt5.init_vt5_params(torch.Generator().manual_seed(0), small)
    engine = RAGVT5Engine(p_config.build_rag_config(c), small, params, tok)
    assert engine.cfg.use_visual and engine.params.visual is not None and engine.vt5_cfg.vit.num_layers == 2
