"""Port parity, the RAG-Qwen engine: `engine/rag_qwen.py` against the JAX
`RAGQwenEngine` on the same ingested batch and weights (the JAX inits
carried over with `params.causal_lm_from_jax`, `qwen_vision_from_jax` and
`qwen25_vision_from_jax`), for every case of tests/test_rag_qwen.py.

Exact: the ChatML prompt, retrieved texts and pages, prompt ids, masks,
<|image_pad|> spans and the visual mask, SFT labels, decoded answers.
Within 1e-5 relative: confidences (f32 products of softmax maxima; XLA and
torch sum in other orders); the spliced crop embeddings within 2e-5 of their
largest value (the towers' f32 sums). Also: `build_engine`'s Qwen branch
against JAX's config, F10 (JAX's `use_visual` branch calls a function it
never defines: NameError there; the port builds the Qwen2.5-VL engine from
a tree that carries the tower under `vision` and runs it), and
the eval CLI on configs/Qwen_tiny.yml against root `eval.py --platform cpu`
from the same weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_docvqa_tpu import config as j_config
from rag_docvqa_tpu.data import DocVQAIngestor as JIngestor
from rag_docvqa_tpu.data import HashTokenizer as JHashTokenizer
from rag_docvqa_tpu.data.contract import Caps as JCaps
from rag_docvqa_tpu.data.synthetic import make_corpus as j_make_corpus
from rag_docvqa_tpu.engine import rag_qwen as J
from rag_docvqa_tpu.models import causal_lm as j_clm
from rag_docvqa_tpu.models import qwen25_vision as j_q25
from rag_docvqa_tpu.models import qwen_vision as j_qv
from rag_docvqa_tpu.models.vit import ViTConfig as JViTConfig
from rag_docvqa_tpu.ops.chunking import ChunkSpec
from rag_docvqa_tpu_torch import config as p_config
from rag_docvqa_tpu_torch import params as p_params
from rag_docvqa_tpu_torch.data.contract import Caps
from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
from rag_docvqa_tpu_torch.data.synthetic import make_corpus
from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
from rag_docvqa_tpu_torch.engine import rag_qwen as Q
from rag_docvqa_tpu_torch.models import causal_lm as clm
from rag_docvqa_tpu_torch.models import qwen25_vision as q25
from rag_docvqa_tpu_torch.models import qwen_vision as qv
from rag_docvqa_tpu_torch.models.vit import ViTConfig

torch.set_num_threads(2)

LM_KW = dict(vocab_size=2048, d_model=32, num_layers=2, num_heads=4, num_kv_heads=2, d_ff=64)
CAPS = dict(max_pages=2, max_chunks=12, max_slots=128)
SPEC = ChunkSpec(chunk_size=10, overlap=2)
VIT_KW = dict(hidden_size=16, num_layers=1, num_heads=2, mlp_dim=32, patch_size=8, image_size=32)
Q25_KW = dict(hidden_size=32, intermediate_size=64, num_heads=4, depth=2, patch_size=4, temporal_patch_size=2,
              spatial_merge_size=2, window_size=16, out_hidden_size=32, fullatt_block_indexes=(1,), image_size=32)


def _batches(images: bool, bs: int = 2):
    """Both packages' ingest of the same documents (seed 21, 2 pages x 30
    words), with seeded 64 x 64 page images when asked for."""
    out = []
    for make, ingestor in ((j_make_corpus, JIngestor(JHashTokenizer(2048), SPEC, JCaps(**CAPS))),
                           (make_corpus, DocVQAIngestor(HashTokenizer(2048), SPEC, Caps(**CAPS)))):
        docs = make(bs, n_pages=2, words_per_page=30, seed=21)
        if images:
            rng = np.random.RandomState(0)
            for d in docs:
                d.images = [rng.randint(0, 255, (64, 64, 3)).astype(np.uint8) for _ in d.words]
        out.append((docs, *ingestor.ingest(docs)))
    return out


def _engines(cfg_kw, tower=None):
    """The JAX and port engines on the same weights; `tower` None, "stand_in"
    or "qwen25"."""
    jl, pl = j_clm.CausalLMConfig(**LM_KW), clm.CausalLMConfig(**LM_KW)
    tree = j_clm.init_causal_lm_params(jax.random.PRNGKey(0), jl)
    params = p_params.causal_lm_from_jax(jax.tree.map(np.asarray, tree))
    jv = pv = vparams = None
    if tower == "stand_in":
        jv = j_qv.QwenVisionConfig(vit=JViTConfig(**VIT_KW), out_dim=jl.d_model)
        pv = qv.QwenVisionConfig(vit=ViTConfig(**VIT_KW), out_dim=jl.d_model)
        tree["vision"] = j_qv.init_qwen_vision_params(jax.random.PRNGKey(1), jv)
        vparams = p_params.qwen_vision_from_jax(jax.tree.map(np.asarray, tree["vision"]))
    elif tower == "qwen25":
        jv, pv = j_q25.Qwen25VisionConfig(**Q25_KW), q25.Qwen25VisionConfig(**Q25_KW)
        tree["vision"] = j_q25.init_qwen25_vision_params(jax.random.PRNGKey(1), jv)
        vparams = p_params.qwen25_vision_from_jax(jax.tree.map(np.asarray, tree["vision"]))
    jeng = J.RAGQwenEngine(J.QwenRAGConfig(**cfg_kw), jl, tree, JHashTokenizer(2048), vision_cfg=jv)
    peng = Q.RAGQwenEngine(Q.QwenRAGConfig(**cfg_kw), pl, params, HashTokenizer(2048), vision_cfg=pv,
                           vision_params=vparams)
    return jeng, peng


def _same_inference(jeng, peng, jb, jaux, pb, paux):
    want, got = jeng.inference(jb, jaux), peng.inference(pb, paux)
    assert got["pred_answers"] == want["pred_answers"]
    assert got["pred_answer_pages"] == want["pred_answer_pages"]
    assert got["retrieval"] == want["retrieval"]
    np.testing.assert_allclose(got["confidences"], want["confidences"], rtol=1e-5)
    assert set(got["timings"]) == {"retrieve_s", "crops_s", "assemble_s", "prefill_s", "decode_s"}
    return got


def _same_sft(jeng, peng, jb, jaux, pb, paux, seed=0):
    want, got = jeng.build_sft_batch(jb, jaux, seed=seed), peng.build_sft_batch(pb, paux, seed=seed)
    assert len(got) == len(want)
    for a, b in zip(got[:3], want[:3]):  # ids, mask, labels
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if len(want) == 5:
        np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
        np.testing.assert_allclose(got[3].float().numpy(), np.asarray(want[3]), rtol=0,
                                   atol=2e-5 * max(1.0, float(np.abs(np.asarray(want[3])).max())))
    return got


def test_build_prompt_is_jax_s():
    assert Q.build_prompt("what?", ["chunk one", "chunk two"]) == J.build_prompt("what?", ["chunk one", "chunk two"])
    assert (Q.CHATML_SYSTEM, Q.CHATML_USER_OPEN, Q.CHATML_USER_CLOSE, Q.USER_TEXT_TEMPLATE, Q.CHATML_IMAGE_PAD) == (
        J.CHATML_SYSTEM, J.CHATML_USER_OPEN, J.CHATML_USER_CLOSE, J.USER_TEXT_TEMPLATE, J.CHATML_IMAGE_PAD)


def test_retrieve_texts_and_inference_match_jax():
    (jdocs, jb, jaux), (docs, pb, paux) = _batches(images=False)
    jeng, peng = _engines(dict(chunk_num=3, max_prompt_tokens=128, max_new_tokens=3))
    texts, pages = peng.retrieve_texts(pb, paux)
    assert (texts, pages) == jeng.retrieve_texts(jb, jaux)
    for b, d in enumerate(docs):  # the planted chunk comes first
        assert d.answers[0] in " ".join(texts[b]) and pages[b][0] == d.answer_page_idx
    _same_inference(jeng, peng, jb, jaux, pb, paux)


def test_sft_batch_and_loss_match_jax():
    (_, jb, jaux), (_, pb, paux) = _batches(images=False)
    jeng, peng = _engines(dict(chunk_num=2, max_prompt_tokens=96, answer_max_tokens=8))
    for seed in (0, 3):
        ids, mask, labels = _same_sft(jeng, peng, jb, jaux, pb, paux, seed)
        lab = labels.numpy()
        assert (lab[:, 0] == -100).all()
        for b in range(2):
            sup = lab[b][lab[b] != -100]
            assert len(sup) > 0 and sup[-1] == clm.CausalLMConfig().eos_id
    jids, jmask, jlabels = jeng.build_sft_batch(jb, jaux)
    got = float(Q.sft_step_loss(peng.params, peng.lm_cfg, ids, mask, labels))
    want = float(J.sft_step_loss(jeng.params, jeng.lm_cfg, jids, jmask, jlabels))
    assert abs(got - want) <= 1e-5 * abs(want)


@pytest.mark.parametrize("tower", ["stand_in", "qwen25"])
def test_visual_path_matches_jax(tower):
    """Crops of the top-k boxes through either tower, spliced at the
    <|image_pad|> spans: the same prompts, spans, answers and confidences as
    JAX; without images the placeholders are absent and the output changes."""
    (jdocs, jb, jaux), (docs, pb, paux) = _batches(images=True)
    kw = dict(chunk_num=3, max_prompt_tokens=196 if tower == "stand_in" else 256, max_new_tokens=3, use_visual=True,
              max_crops=2)
    jeng, peng = _engines(kw, tower)
    vis = _same_inference(jeng, peng, jb, jaux, pb, paux)
    txt = _same_inference(jeng, peng, jb, dict(jaux, images=[None] * 2), pb, dict(paux, images=[None] * 2))
    assert vis["pred_answers"] != txt["pred_answers"] or not np.allclose(vis["confidences"], txt["confidences"])
    ids, mask, labels, vemb, vmask = _same_sft(jeng, peng, jb, jaux, pb, paux)
    ids, vmask = ids.numpy(), vmask.numpy()
    assert vmask.sum() > 0 and (ids[vmask] == peng.image_pad_id).all()
    assert vmask[0].sum() % peng.vision_cfg.tokens_per_image == 0
    crops, _ = peng._encode_crops(peng._on_device(pb), paux, peng._retrieve(peng._on_device(pb), paux)[0])
    assert crops.shape[1:3] == (2, peng.vision_cfg.tokens_per_image)


def test_visual_sft_spans_clipped_at_prompt_truncation():
    """A prompt over max_prompt_tokens cuts a placeholder span: the span is
    clipped to the prompt, so no crop embedding lands on an answer token."""
    (_, jb, jaux), (_, pb, paux) = _batches(images=True)
    jeng, peng = _engines(dict(chunk_num=3, max_prompt_tokens=64, answer_max_tokens=8, use_visual=True, max_crops=2),
                          "stand_in")
    ids, mask, labels, vemb, vmask = _same_sft(jeng, peng, jb, jaux, pb, paux)
    ids, vmask, labels = ids.numpy(), vmask.numpy(), labels.numpy()
    assert (ids[vmask] == peng.image_pad_id).all() and (labels[vmask] == -100).all()


def test_build_engine_qwen_branch_and_f10():
    """`build_engine` with model_name Qwen: JAX's QwenRAGConfig and causal-LM
    config (on the fields JAX has; the port's `mrope_section` at its
    default). F10: with use_visual, JAX's branch calls
    build_qwen_vision_config, which its package never defines (NameError);
    the port builds the Qwen2.5-VL engine from the tree's `vision` tower and
    the engine dict's `vision` fields, with M-RoPE where `mrope_section` is
    set, and it answers a batch with page images; a tree without a tower
    raises."""
    c = dict(model_name="Qwen", d_model=32, num_layers=2, num_heads=4, num_kv_heads=2, d_ff=64, chunk_num=3,
             max_source_length=96, max_new_tokens=4, include_surroundings=[1], max_crops=3)
    pl = clm.CausalLMConfig(**LM_KW)
    params = clm.init_causal_lm_params(torch.Generator().manual_seed(0), pl)
    eng = p_config.build_engine(c, params, HashTokenizer(2048))
    jtree = j_clm.init_causal_lm_params(jax.random.PRNGKey(0), j_clm.CausalLMConfig(**LM_KW))
    jeng = j_config.build_engine(c, jtree, JHashTokenizer(2048))
    assert isinstance(eng, Q.RAGQwenEngine) and vars(eng.cfg) == vars(jeng.cfg)
    want = vars(jeng.lm_cfg)
    for got in (eng.lm_cfg, p_config.build_qwen_config(c, 2048)):
        assert {k: v for k, v in vars(got).items() if k in want} == want and got.mrope_section == ()
    # an untied tree (Qwen2.5-7B's head) gives an untied engine, with no config key for it
    untied = clm.init_causal_lm_params(torch.Generator().manual_seed(0),
                                       clm.CausalLMConfig(**dict(LM_KW, tie_word_embeddings=False)))
    assert p_config.build_engine(c, untied, HashTokenizer(2048)).lm_cfg.tie_word_embeddings is False
    with pytest.raises(NameError, match="build_qwen_vision_config"):
        j_config.build_engine(dict(c, use_visual=True), jtree, JHashTokenizer(2048))
    tower = {k: list(v) if isinstance(v, tuple) else v for k, v in Q25_KW.items() if k != "out_hidden_size"}
    visual = dict(c, use_visual=True, vision=tower, max_source_length=256, max_crops=2, mrope_section=[2, 1, 1])
    with pytest.raises(ValueError, match="no `vision` tower"):
        p_config.build_engine(visual, params, HashTokenizer(2048))
    params.vision = q25.init_qwen25_vision_params(torch.Generator().manual_seed(1), q25.Qwen25VisionConfig(**Q25_KW))
    eng = p_config.build_engine(visual, params, HashTokenizer(2048))
    assert eng.vision_cfg == q25.Qwen25VisionConfig(**Q25_KW) and eng.vision_params is params.vision
    assert eng.lm_cfg.mrope_section == (2, 1, 1) and eng.cfg.use_visual
    _, (_, pb, paux) = _batches(images=True)
    out = eng.inference(pb, paux)
    assert len(out["pred_answers"]) == 2 and out["timings"]["crops_s"] > 0
    assert p_config.build_engine(dict(visual, use_visual=False), params, HashTokenizer(2048)).vision_cfg is None


def test_eval_cli_qwen_matches_root_eval(tmp_path, monkeypatch, capsys):
    """The port's eval CLI on configs/Qwen_tiny.yml against root `eval.py
    --platform cpu`: the root CLI's seeded weights, carried to the port as a
    checkpoint of its trainer and read back with --ckpt; the same summary."""
    import eval as root_eval

    from rag_docvqa_tpu_torch import eval as p_eval
    from rag_docvqa_tpu_torch.training.checkpoint import CheckpointManager
    from rag_docvqa_tpu_torch.training.train_step import TrainState

    trees = []
    init = j_clm.init_causal_lm_params

    def keep(key, cfg):
        trees.append(jax.tree.map(np.asarray, init(key, cfg)))
        return jax.tree.map(jnp.asarray, trees[-1])

    monkeypatch.setattr(j_clm, "init_causal_lm_params", keep)
    args = ["-m", "configs/Qwen_tiny.yml", "-d", "configs/Synthetic.yml"]
    want = root_eval.main(args + ["--platform", "cpu"])[0]
    ckpt = tmp_path / "ckpt"
    CheckpointManager(str(ckpt)).save(0, TrainState(params=p_params.causal_lm_from_jax(trees[0]), opt_state={}, step=0))
    got = p_eval.main(args + ["--device", "cpu", "--ckpt", str(ckpt)])[0]
    capsys.readouterr()
    assert got.keys() == want.keys()
    for k in want:
        if k != "wall_time":
            assert got[k] == pytest.approx(want[k], rel=1e-6), k
