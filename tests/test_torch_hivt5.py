"""Port parity, Hi-VT5: `models/hivt5.py`, `HiVT5Engine`, the Hi-VT5 train
step, the `Trainer` and both CLIs on the CPU against the JAX package, on the
same ingested batch and the same weights (the JAX tree carried over with
`params.hivt5_from_jax`).

The documents have fewer pages than `max_doc_pages` (4, 2 and 3 of 4 page
slots), so every batch holds page rows with no valid key. The encoder's
rel-pos table is bf16-exact: the port's layers take the bias in bf16, the
JAX blocks on the CPU in f32.

Tolerances: the document embedding, the page logits, the cross-attention
probabilities and the page relevance within 2e-5 (f32 sums in another
order), and finite; `doc_mask`, decoded ids and `pred_page` exact; losses
within 1e-5 relative; each gradient leaf within 1e-4 of its largest value,
except the encoder rel-pos table against the JAX blocks path (f32 bias
there, bf16 here, as on the JAX fused path): within 1e-2 of its largest
value. The visual tokens within 1e-3 of their largest value (exact erf in
the JAX tower on the CPU, as `tests/test_torch_visual_engine.py` says),
confidences within 1e-5 (1e-3 with the visual branch)."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_docvqa_tpu.data import DocVQAIngestor as JIngestor
from rag_docvqa_tpu.data import HashTokenizer as JHashTokenizer
from rag_docvqa_tpu.data.contract import Caps as JCaps
from rag_docvqa_tpu.data.synthetic import make_document as j_make_document
from rag_docvqa_tpu.engine.hivt5_engine import HiVT5Engine as JEngine
from rag_docvqa_tpu.models import hivt5 as j_hivt5
from rag_docvqa_tpu.models import t5 as j_t5
from rag_docvqa_tpu.models import vit as j_vit
from rag_docvqa_tpu.models.embeddings import SpatialConfig as JSpatialConfig
from rag_docvqa_tpu.models.embeddings import get_visual_boxes as j_get_visual_boxes
from rag_docvqa_tpu.ops import fused_encoder_bwd as j_feb
from rag_docvqa_tpu.ops.chunking import ChunkSpec
from rag_docvqa_tpu.training import TrainState as JTrainState
from rag_docvqa_tpu.training import build_optimizer as j_build_optimizer
from rag_docvqa_tpu.training.train_step import make_hivt5_train_step as j_make_hivt5_train_step
from rag_docvqa_tpu_torch import config as p_config
from rag_docvqa_tpu_torch import params as p_params
from rag_docvqa_tpu_torch.data.contract import Caps, to_device
from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
from rag_docvqa_tpu_torch.data.synthetic import make_document
from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
from rag_docvqa_tpu_torch.engine.hivt5_engine import HiVT5Engine
from rag_docvqa_tpu_torch.models import hivt5 as p_hivt5
from rag_docvqa_tpu_torch.models import t5 as p_t5
from rag_docvqa_tpu_torch.models import vit as p_vit
from rag_docvqa_tpu_torch.models.embeddings import SpatialConfig, get_visual_boxes
from rag_docvqa_tpu_torch.training.optimizer import build_optimizer, trainable_mask
from rag_docvqa_tpu_torch.training.train_step import TrainState, make_hivt5_train_step

torch.set_num_threads(2)

VOCAB = 1024
T5_KW = dict(vocab_size=VOCAB, d_model=32, d_kv=8, num_heads=4, d_ff=64, num_encoder_layers=2,
             num_decoder_layers=2, dropout_rate=0.0)
HI_KW = dict(page_tokens=4, max_doc_pages=4, page_seq_len=48)
VIT_KW = dict(hidden_size=16, num_layers=1, num_heads=2, mlp_dim=32, patch_size=8, image_size=16)
CAPS = dict(max_pages=4, max_chunks=16, max_slots=128)
SPEC = ChunkSpec(chunk_size=8, overlap=2)
PAGES = (4, 2, 3)  # pages of each document; 4 page slots
EMB_TOL = 2e-5


def _configs(use_visual=False, fused_decode=False):
    jcfg = j_hivt5.HiVT5Config(t5=j_t5.T5Config(**T5_KW), spatial=JSpatialConfig(hidden_size=32, dropout_rate=0.0),
                               use_visual=use_visual, vit=j_vit.ViTConfig(**VIT_KW), **HI_KW)
    pcfg = p_hivt5.HiVT5Config(t5=p_t5.T5Config(**T5_KW, fused_decode_attn=fused_decode),
                               spatial=SpatialConfig(hidden_size=32, dropout_rate=0.0), use_visual=use_visual,
                               vit=p_vit.ViTConfig(**VIT_KW), **HI_KW)
    return jcfg, pcfg


def _tree(jcfg, seed=0):
    tree = jax.tree.map(np.array, j_hivt5.init_hivt5_params(jax.random.PRNGKey(seed), jcfg))
    rb = tree["t5"]["encoder"]["rel_bias"]
    tree["t5"]["encoder"]["rel_bias"] = np.asarray(torch.from_numpy(rb).bfloat16().float())
    return tree


def _docs(make, seed=9, pages=PAGES):
    rng = random.Random(seed)
    return [make(rng, n_pages=n, words_per_page=20, question_id=i) for i, n in enumerate(pages)]


def _batches(seed=9, pages=PAGES):
    jing = JIngestor(JHashTokenizer(VOCAB), SPEC, JCaps(**CAPS))
    ping = DocVQAIngestor(HashTokenizer(VOCAB), SPEC, Caps(**CAPS))
    jdocs, pdocs = _docs(j_make_document, seed, pages), _docs(make_document, seed, pages)
    (jb, jaux), (pb, paux) = jing.ingest(jdocs), ping.ingest(pdocs)
    labels = ping.answer_labels(paux["answers"], max_len=4, seed=3)
    np.testing.assert_array_equal(labels, jing.answer_labels(jaux["answers"], max_len=4, seed=3))
    return jb, pb, labels, pdocs


@pytest.fixture(scope="module")
def world():
    jcfg, pcfg = _configs()
    tree = _tree(jcfg)
    jb, pb, labels, docs = _batches()
    return dict(jcfg=jcfg, pcfg=pcfg, tree=tree, jparams=jax.tree.map(jnp.asarray, tree),
                port=p_params.hivt5_from_jax(tree), jb=jb, pb=to_device(pb, "cpu"), pb_np=pb, labels=labels,
                docs=docs)


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), f"{what}: non-finite values"
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= tol, f"{what}: max abs error {err} above {tol}"


def test_visual_boxes_match_jax():
    for n, scale, grid in ((1, 1.0, 14), (3, 1000.0, 14), (2, 1000.0, 2)):
        np.testing.assert_array_equal(get_visual_boxes(n, scale, grid).numpy(),
                                      np.asarray(j_get_visual_boxes(n, scale, grid)))


def test_params_round_trip(world):
    back = p_params.hivt5_to_jax(world["port"])
    for (path, want), (_, got) in zip(jax.tree_util.tree_leaves_with_path(world["tree"]),
                                      jax.tree_util.tree_leaves_with_path(back)):
        np.testing.assert_array_equal(got, want, err_msg=jax.tree_util.keystr(path))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(world["tree"])


def test_encode_document_matches_jax(world):
    """Three documents of 4, 2 and 3 pages in 4 slots: the padded slots' rows
    have no valid key; their kept positions are zero in both packages."""
    jemb, jmask = j_hivt5.encode_document(world["jparams"], world["jcfg"], world["jb"])
    emb, mask = p_hivt5.encode_document(world["port"], world["pcfg"], world["pb"])
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert mask.sum(dim=1).tolist() == [4 * n for n in PAGES]
    _close(emb, jemb, EMB_TOL, "doc_emb")
    assert not emb[~mask].any()  # the padded pages' rows are exactly zero
    _close(p_hivt5.page_retrieval_logits(world["port"], world["pcfg"], emb),
           j_hivt5.page_retrieval_logits(world["jparams"], world["jcfg"], jemb), EMB_TOL, "page logits")


def _grad_tree(port, grads):
    """The gradients, in the layout of `hivt5_to_jax`."""
    g = p_params.hivt5_from_jax(p_params.hivt5_to_jax(port))
    for (name, p), grad in zip(g.named_parameters(), grads):
        p.data = grad.detach().clone()
    return p_params.hivt5_to_jax(g)


@pytest.mark.parametrize("fused_gate", ["on", "off"])
def test_forward_train_and_every_gradient_match_jax(world, fused_gate, monkeypatch):
    """The losses, the page logits and the gradient of every parameter (the
    encoder's rel-pos table, `page_emb` and `page_head` among them) against
    jax.grad, with the JAX fused-train gate on (its whole-layer kernels in
    interpret mode, a bf16 bias as here) and off (its plain blocks, an f32
    bias)."""
    if fused_gate == "on":
        monkeypatch.setattr(j_feb, "fused_t5_train_wanted", lambda *a, **k: True)
    jcfg, pcfg, labels = world["jcfg"], world["pcfg"], world["labels"]

    def jloss(p):
        return j_hivt5.forward_train(p, jcfg, world["jb"], jnp.asarray(labels))

    (jl, jaux), jgrads = jax.value_and_grad(jloss, has_aux=True)(world["jparams"])
    port = p_params.hivt5_from_jax(world["tree"])
    params = list(port.parameters())
    for p in params:
        p.requires_grad_(True)
    loss, aux = p_hivt5.forward_train(port, pcfg, world["pb"], torch.from_numpy(labels).long())
    grads = torch.autograd.grad(loss, params)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for k in ("lm_loss", "ret_loss"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=1e-5, err_msg=k)
    assert aux["ret_loss"].item() > 0
    _close(aux["ret_logits"].detach(), jaux["ret_logits"], EMB_TOL, "ret_logits")
    got = _grad_tree(port, grads)
    jg = jax.tree.map(np.asarray, jgrads)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(jg)
    for (path, want), (_, g) in zip(jax.tree_util.tree_leaves_with_path(jg), jax.tree_util.tree_leaves_with_path(got)):
        name = jax.tree_util.keystr(path)
        scale = max(float(np.abs(want).max()), 1e-6)
        limit = (1e-2 if fused_gate == "off" and "rel_bias" in name and "encoder" in name else 1e-4) * scale
        _close(g, want, limit, f"gradient {name}")
    for root in ("page_emb", "page_head"):
        assert np.abs(jax.tree_util.tree_leaves(got[root])[0]).sum() > 0, root


def test_train_step_trains_page_prediction_as_jax(world):
    """`make_hivt5_train_step` against the JAX one, 30 steps of lr 3e-3 on
    one batch: the first three steps' losses and grad norms within 1e-4
    relative (after a step the rel-pos table is no longer bf16-exact, so the
    two drift apart by bf16 roundings of the bias), and both page heads
    overfit to the answer pages."""
    jcfg, pcfg, labels = world["jcfg"], world["pcfg"], world["labels"]
    kw = dict(lr=3e-3, warmup_steps=0, total_steps=100, weight_decay=0.0)
    tx = j_build_optimizer(**kw)
    jstate = JTrainState.create(jax.tree.map(jnp.asarray, world["tree"]), tx)  # the step donates its state
    jstep = j_make_hivt5_train_step(jcfg, tx)
    port = p_params.hivt5_from_jax(world["tree"])
    opt = build_optimizer(**kw, mask=trainable_mask(port, ("t5", "spatial", "page_emb", "page_head")))
    pstate = TrainState.create(port, opt)
    pstep = make_hivt5_train_step(pcfg, opt)
    jlab = jnp.asarray(labels)
    for i in range(30):
        jstate, jm = jstep(jstate, world["jb"], jlab)
        pstate, pm = pstep(pstate, world["pb_np"], labels)
        if i < 3:
            for k in ("loss", "lm_loss", "ret_loss", "grad_norm"):
                np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-4, err_msg=f"{k} step {i}")
    assert {"grad_norm/page_emb", "grad_norm/page_head", "grad_norm/t5", "grad_norm/spatial"} <= set(pm)
    want = np.asarray([d.answer_page_idx for d in world["docs"]])
    pb = world["pb"]
    with torch.no_grad():
        emb, _ = p_hivt5.encode_document(pstate.params, pcfg, pb)
        pred = p_hivt5.predict_page(pcfg, pb, p_hivt5.page_retrieval_logits(pstate.params, pcfg, emb)).numpy()
    jemb, _ = j_hivt5.encode_document(jstate.params, jcfg, world["jb"])
    jlog = np.asarray(j_hivt5.page_retrieval_logits(jstate.params, jcfg, jemb))
    jpred = np.argmax(np.where(np.arange(4)[None] < np.asarray(PAGES)[:, None], jlog, -1e9), axis=1)
    np.testing.assert_array_equal(jpred, want)
    np.testing.assert_array_equal(pred, want)


def test_train_step_refuses_remat(world):
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        make_hivt5_train_step(world["pcfg"], None, remat="layer")


@pytest.mark.parametrize("fused_decode", [False, True])
def test_generate_matches_jax(world, fused_decode):
    """Decoded ids and the predicted page exactly, with K3's plain path
    (`fused_decode_attn`) on and off."""
    _, pcfg = _configs(fused_decode=fused_decode)
    jt, jc, jp = j_hivt5.generate(world["jparams"], world["jcfg"], world["jb"], max_new_tokens=4)
    with torch.no_grad():
        t, c, p = p_hivt5.generate(world["port"], pcfg, world["pb"], max_new_tokens=4)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    assert (p.numpy() < np.asarray(PAGES)).all()
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-7)


def test_pred_page_takes_the_first_of_ties():
    cfg = p_hivt5.HiVT5Config(max_doc_pages=4)
    batch = type("B", (), {"num_pages": torch.tensor([3, 4, 1])})()
    logits = torch.tensor([[0.5, 2.0, 2.0, 9.0], [1.0, 1.0, 1.0, 1.0], [-3.0, 5.0, 5.0, 5.0]])
    assert p_hivt5.predict_page(cfg, batch, logits).tolist() == [1, 0, 0]
    want = np.argmax(np.where(np.arange(4)[None] < np.array([3, 4, 1])[:, None], logits.numpy(), -1e9), axis=-1)
    assert p_hivt5.predict_page(cfg, batch, logits).tolist() == want.tolist()


def test_attention_viz_matches_jax(world):
    jout = j_hivt5.attention_viz(world["jparams"], world["jcfg"], world["jb"], jnp.asarray(world["labels"]))
    with torch.no_grad():
        out = p_hivt5.attention_viz(world["port"], world["pcfg"], world["pb"], torch.from_numpy(world["labels"]).long())
    L, H, Td = 2, 4, world["labels"].shape[1]
    assert out["cross_attn"].shape == (L, 3, H, Td, 16)
    _close(out["cross_attn"], jout["cross_attn"], EMB_TOL, "cross_attn")
    _close(out["page_relevance"], jout["page_relevance"], EMB_TOL, "page_relevance")
    rel = out["page_relevance"].numpy()
    np.testing.assert_allclose(rel.sum(axis=1), 1.0, rtol=1e-5)
    for b, n in enumerate(PAGES):
        assert (rel[b, n:] == 0).all()


def _visual_world():
    jcfg, pcfg = _configs(use_visual=True)
    tree = _tree(jcfg, seed=1)
    jb, pb, labels, docs = _batches()
    rng = np.random.RandomState(0)
    images = [[rng.randint(0, 255, (32, 24, 3)).astype(np.uint8) for _ in d.words] for d in docs]
    return jcfg, pcfg, tree, jb, pb, labels, images


def test_per_page_visual_branch_matches_jax():
    """The engine's per-page visual tokens and validity, the document
    embedding with them, and the served answers, against the JAX engine; the
    visual tokens change the answers' confidences."""
    jcfg, pcfg, tree, jb, pb, labels, images = _visual_world()
    jeng = JEngine(jcfg, jax.tree.map(jnp.asarray, tree), JHashTokenizer(VOCAB), max_new_tokens=3)
    eng = HiVT5Engine(pcfg, p_params.hivt5_from_jax(tree), HashTokenizer(VOCAB), max_new_tokens=3)
    aux = {"images": images}
    jpv, jvalid = jeng._page_visual(jb, aux)
    pbt = to_device(pb, "cpu")
    with torch.no_grad():
        pv, valid = eng._page_visual(pbt, aux)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert valid.sum().item() == sum(PAGES)
    scale = float(np.abs(np.asarray(jpv)).max())
    _close(pv, jpv, 1e-3 * scale, "page visual tokens")
    with torch.no_grad():
        emb, _ = p_hivt5.encode_document(eng.params, pcfg, pbt, pv, valid)
    jemb, _ = j_hivt5.encode_document(jeng.params, jcfg, jb, jpv, jvalid)
    _close(emb, jemb, 1e-3 * max(float(np.abs(np.asarray(jemb)).max()), 1.0), "doc_emb with visual tokens")
    out, want = eng.inference(pb, aux), jeng.inference(jb, aux)
    assert out["pred_answers"] == want["pred_answers"] and out["pred_answer_pages"] == want["pred_answer_pages"]
    np.testing.assert_allclose(out["confidences"], want["confidences"], rtol=1e-3)
    plain = eng.inference(pb, {"images": [None] * len(PAGES)})
    assert not np.allclose(out["confidences"], plain["confidences"], rtol=1e-6)


def test_visual_branch_masks_imageless_pages():
    """A document without renders gets no visual token: its encoding equals
    the text-only one; the document with renders differs."""
    jcfg, pcfg, tree, jb, pb, labels, images = _visual_world()
    eng = HiVT5Engine(pcfg, p_params.hivt5_from_jax(tree), HashTokenizer(VOCAB), max_new_tokens=3)
    jeng = JEngine(jcfg, jax.tree.map(jnp.asarray, tree), JHashTokenizer(VOCAB), max_new_tokens=3)
    aux = {"images": [images[0], None, None]}
    pbt = to_device(pb, "cpu")
    with torch.no_grad():
        pv, valid = eng._page_visual(pbt, aux)
        mixed, _ = p_hivt5.encode_document(eng.params, pcfg, pbt, pv, valid)
        plain, _ = p_hivt5.encode_document(eng.params, pcfg, pbt)
    _, jvalid = jeng._page_visual(jb, aux)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert valid[0].sum().item() == PAGES[0] and valid[1:].sum().item() == 0
    np.testing.assert_allclose(mixed[1:].numpy(), plain[1:].numpy(), rtol=1e-5, atol=1e-6)
    assert not np.allclose(mixed[0].numpy(), plain[0].numpy(), atol=1e-4)


def test_engine_from_build_engine_matches_jax(world):
    """`config.build_engine` -> `HiVT5Engine.inference` against the JAX
    engine from the JAX `build_engine` on the same config and weights."""
    from rag_docvqa_tpu import config as j_config

    c = dict(model_name="Hi-VT5", d_model=32, d_kv=8, num_heads=4, d_ff=64, num_layers=2, dropout_rate=0.0,
             page_tokens=4, max_pages=4, max_text_tokens=48, max_new_tokens=4, page_retrieval="oracle")
    jeng = j_config.build_engine(c, world["jparams"], JHashTokenizer(VOCAB))
    eng = p_config.build_engine(c, world["port"], HashTokenizer(VOCAB))
    assert isinstance(eng, HiVT5Engine)
    hc = p_config.build_hivt5_config(c, VOCAB)
    jhc = j_config.build_hivt5_config(c, VOCAB)
    for k in ("page_tokens", "max_doc_pages", "page_seq_len", "retrieval_loss_weight", "use_visual"):
        assert getattr(hc, k) == getattr(jhc, k), k
    assert hc.vit.__dict__ == {k: getattr(jhc.vit, k) for k in hc.vit.__dict__}
    assert hc.t5.__dict__ == {k: getattr(jhc.t5, k) for k in hc.t5.__dict__ if k != "fused_decode_attn"} | \
        {"fused_decode_attn": False}
    want, out = jeng.inference(world["jb"]), eng.inference(world["pb_np"])
    assert set(out) == set(want) | {"timings"} and set(out["retrieval"]) == set(want["retrieval"])
    assert out["pred_answers"] == want["pred_answers"]
    assert out["pred_answer_pages"] == want["pred_answer_pages"] == out["retrieval"]["page_indices"]
    np.testing.assert_allclose(out["confidences"], want["confidences"], rtol=1e-5)
    assert out["retrieval"]["retrieval_time"] == 0.0 and out["timings"]["decode_s"] > 0


def test_trainer_matches_jax():
    """Two epochs of the `Trainer` with `hivt5_cfg` (4 steps of B 2, then the
    evaluation through `HiVT5Engine`) against the JAX trainer: the same
    batches in the same order, losses within 1e-3 relative (the rel-pos
    table drifts from bf16-exact as it trains), and both evaluations."""
    from rag_docvqa_tpu.training.trainer import Trainer as JTrainer
    from rag_docvqa_tpu.training.trainer import TrainLoopConfig as JLoopConfig
    from rag_docvqa_tpu.engine import RAGConfig as JRAGConfig
    from rag_docvqa_tpu_torch.engine.rag_vt5 import RAGConfig
    from rag_docvqa_tpu_torch.training.trainer import TrainLoopConfig, Trainer

    jcfg, pcfg = _configs()
    tree = _tree(jcfg, seed=2)
    loop = dict(epochs=2, batch_size=2, lr=1e-3, warmup_steps=1, eval_start=False, log_every=1, seed=5,
                answer_max_len=4, eval_batch_size=2)
    train = [_docs(make_document, 20 + i, (2 + i % 3,))[0] for i in range(4)]
    jtrain = [_docs(j_make_document, 20 + i, (2 + i % 3,))[0] for i in range(4)]
    val, jval = _docs(make_document, 40, (3, 4)), _docs(j_make_document, 40, (3, 4))

    class Log:
        def __init__(self):
            self.rows = []

        def log(self, m):
            self.rows.append(m)

    jlog, plog = Log(), Log()
    jt = JTrainer(None, JRAGConfig(), jax.tree.map(jnp.asarray, tree), JHashTokenizer(VOCAB),
                  JIngestor(JHashTokenizer(VOCAB), SPEC, JCaps(**CAPS)), JLoopConfig(**loop), logger=jlog,
                  hivt5_cfg=jcfg)
    pt = Trainer(None, RAGConfig(), p_params.hivt5_from_jax(tree), HashTokenizer(VOCAB),
                 DocVQAIngestor(HashTokenizer(VOCAB), SPEC, Caps(**CAPS)), TrainLoopConfig(**loop), logger=plog,
                 hivt5_cfg=pcfg)
    want, got = jt.fit(jtrain, jval), pt.fit(train, val)
    steps = lambda rows: [r for r in rows if "step" in r]
    assert len(steps(plog.rows)) == len(steps(jlog.rows)) == 4
    for g, w in zip(steps(plog.rows), steps(jlog.rows)):
        assert g["step"] == w["step"]
        for k in ("loss", "lm_loss", "ret_loss", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-3, err_msg=f"{k} step {w['step']}")
    for g, w in zip(got["history"], want["history"]):
        for k in ("accuracy", "anls", "retrieval_precision"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-6, err_msg=k)
    assert isinstance(pt.engine(), HiVT5Engine)
    assert set(pt.opt.mask) and all(pt.opt.mask[n] for n in ("page_emb", "page_head.weight", "page_head.bias"))


def test_eval_cli_matches_root_eval(tmp_path, monkeypatch, capsys):
    """`python -m rag_docvqa_tpu_torch.eval -m configs/HiVT5_tiny.yml` against
    the root `eval.py` on the weights the root CLI's seeded init made (with
    a bf16-exact rel-pos table), carried as a checkpoint of the port's
    trainer (`--ckpt`)."""
    import eval as root_eval
    from rag_docvqa_tpu_torch import eval as p_eval
    from rag_docvqa_tpu_torch.training.checkpoint import CheckpointManager

    trees, j_init = [], j_hivt5.init_hivt5_params

    def rounded(key, cfg):
        trees.append(_bf16_rel_bias(jax.tree.map(np.array, j_init(key, cfg))))
        return jax.tree.map(jnp.asarray, trees[-1])

    monkeypatch.setattr(j_hivt5, "init_hivt5_params", rounded)
    args = ["-m", "configs/HiVT5_tiny.yml", "-d", "configs/Synthetic.yml", "n_val_docs=4"]
    want = root_eval.main(args + ["--platform", "cpu"])
    capsys.readouterr()
    ckpt = str(tmp_path / "ckpt")
    CheckpointManager(ckpt).save(0, TrainState(params=p_params.hivt5_from_jax(trees[0]), opt_state={}, step=0))
    got = p_eval.main(args + ["--device", "cpu", "--ckpt", ckpt])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert len(got) == len(want) == 1 and set(got[0]) == set(want[0])
    for k in ("accuracy", "anls", "retrieval_precision", "chunk_score", "n_samples", "page_retrieval"):
        assert got[0][k] == pytest.approx(want[0][k], rel=1e-6) if isinstance(want[0][k], float) else \
            got[0][k] == want[0][k], k
    assert got[0]["n_samples"] == 4 and got[0]["page_retrieval"] == "oracle" and '"n_samples": 4' in line


def _bf16_rel_bias(tree):
    rb = tree["t5"]["encoder"]["rel_bias"]
    tree["t5"]["encoder"]["rel_bias"] = np.asarray(torch.from_numpy(rb).bfloat16().float())
    return tree


def test_train_cli_then_eval_from_its_checkpoint(tmp_path, capsys):
    """`python -m rag_docvqa_tpu_torch.train -m configs/HiVT5_tiny.yml
    --device cpu` trains and checkpoints; the eval CLI reads the checkpoint
    back (the best step, else the latest)."""
    from rag_docvqa_tpu_torch import eval as p_eval
    from rag_docvqa_tpu_torch import train as p_train

    save = tmp_path / "run"
    result = p_train.main(["-m", "configs/HiVT5_tiny.yml", "-d", "configs/Synthetic.yml", "--device", "cpu",
                           "--no-eval-start", "n_train_docs=8", "n_val_docs=4", f"save_dir={save}"])
    out = capsys.readouterr().out
    assert "epoch=0 train_loss=" in out and (save / "checkpoints.json").exists()
    assert np.isfinite(result["history"][0]["train_loss"]) and result["history"][0]["train_loss"] > 0
    got = p_eval.main(["-m", "configs/HiVT5_tiny.yml", "-d", "configs/Synthetic.yml", "--device", "cpu",
                       "--ckpt", str(save), "n_val_docs=4"])
    assert got[0]["n_samples"] == 4 and 0.0 <= got[0]["retrieval_precision"] <= 1.0
