"""The port's own copies of the plain-Python host modules, held against the
originals in the JAX package so they cannot drift unnoticed: the chunker
(`ops/chunking.py`) on seeded pages, the metrics (`metrics/`) on a few
strings, `convert_bert_state_dict` (numpy only, but in a module of the
JAX package that imports jax) on seeded state dicts, the image patch
math (`ops/patches.py`) on seeded page images, the ingest statistics
(`utils_stats.py`) on a seeded batch, and the S2 chunker (`ops/s2chunker.py`)
on the cases of `tests/test_s2chunker.py`. Everything here is integer,
string, copying or identical numpy work on the host: equal exactly."""

import dataclasses
import os

import numpy as np
import pytest

from rag_docvqa_tpu import metrics as j_metrics
from rag_docvqa_tpu.metrics import mmlongbench as j_mmlb
from rag_docvqa_tpu.models import bert as j_bert
from rag_docvqa_tpu.ops import chunking as j_chunking
from rag_docvqa_tpu.ops import patches as j_patches
from rag_docvqa_tpu_torch import metrics as p_metrics
from rag_docvqa_tpu_torch.metrics import mmlongbench as p_mmlb
from rag_docvqa_tpu_torch.models import bert as p_bert
from rag_docvqa_tpu_torch.ops import chunking as p_chunking
from rag_docvqa_tpu_torch.ops import patches as p_patches


def _page(n_words, seed):
    rng = np.random.RandomState(seed)
    words = [f"w{rng.randint(1000)}" for _ in range(n_words)]
    xy = rng.rand(n_words, 2) * 0.8
    boxes = np.concatenate([xy, xy + rng.rand(n_words, 2) * 0.1 + 0.01], axis=1).tolist()
    return words, boxes


CHUNK_CASES = {
    # name: (n_words, spec kwargs, layout regions)
    "fixed": (137, dict(chunk_size=12, overlap=2), 0),
    "fixed_tail_merge": (61, dict(chunk_size=60, overlap=10), 0),
    "empty_page": (0, dict(chunk_size=12, overlap=2), 0),
    "oracle": (40, dict(chunk_size=12, overlap=2, mode="oracle"), 0),
    "layout": (90, dict(chunk_size=10, overlap=2), 4),
    "layout_clustered": (90, dict(chunk_size=10, overlap=2, cluster_layouts=True), 4),
}


@pytest.mark.parametrize("case", CHUNK_CASES)
def test_chunk_page_copy_matches_original(case):
    n_words, kw, n_regions = CHUNK_CASES[case]
    words, boxes = _page(n_words, seed=len(case))
    layout = {}
    if n_regions:
        layout = dict(layout_boxes=[[0.0, 0.0, 0.5, 0.5], [0.5, 0.0, 1.0, 0.5], [0.0, 0.5, 0.5, 1.0],
                                    [0.5, 0.5, 1.0, 1.0]][:n_regions],
                      layout_labels=[1, 2, 3, 1][:n_regions], layout_clusters=[0, 0, 1, 2][:n_regions])
    want = j_chunking.chunk_page(words, boxes, j_chunking.ChunkSpec(**kw), **layout)
    got = p_chunking.chunk_page(words, boxes, p_chunking.ChunkSpec(**kw), **layout)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(p_chunking.ChunkSpec(**kw)) == dataclasses.asdict(j_chunking.ChunkSpec(**kw))


def test_chunking_helpers_copy_matches_original():
    for n, size, overlap, tol in ((0, 5, 1, 0.2), (23, 5, 1, 0.2), (61, 60, 10, 0.2), (100, 7, 3, 0.0)):
        assert (p_chunking.make_chunk_indices(range(n), size, overlap, tol)
                == j_chunking.make_chunk_indices(range(n), size, overlap, tol))
    small, large = [0.1, 0.1, 0.4, 0.3], [0.2, 0.0, 1.0, 1.0]
    assert p_chunking.containment_ratio(small, large) == j_chunking.containment_ratio(small, large)
    _, boxes = _page(9, seed=3)
    assert p_chunking.compact_chunk_box(boxes, [1, 4, 7]) == j_chunking.compact_chunk_box(boxes, [1, 4, 7])
    assert set(n for n in dir(j_chunking) if not n.startswith("_")) == \
        set(n for n in dir(p_chunking) if not n.startswith("_"))


STRING_PAIRS = [("total amount", "total amount"), ("Total Amount", "total amout"), ("42", "forty two"),
                ("", "x"), ("invoice 2021-03", "invoice 2021-08"), ("naïve café", "naive cafe")]


@pytest.mark.parametrize("gt,pred", STRING_PAIRS)
def test_anls_copy_matches_original(gt, pred):
    assert p_metrics.levenshtein(gt, pred) == j_metrics.levenshtein(gt, pred)
    assert p_metrics.anls(gt, pred) == j_metrics.anls(gt, pred)
    assert p_metrics.similarity_score(f"the {gt} of the page", pred) == \
        j_metrics.similarity_score(f"the {gt} of the page", pred)
    assert p_metrics.anls_compute(gt, pred) == j_metrics.anls_compute(gt, pred)


def test_evaluator_copy_matches_original():
    answers = [["total amount", "the total"], ["42"], ["paris"], ["1,200.50"]]
    preds = ["total amout", "42", ["london", "Paris "], "1200.5"]
    types = ["string", "number", "string", "number"]
    chunks = [["the total amount is due", "other text"], ["page 42 of 50"], [], ["sum 1,200.50 eur"]]
    for kw in ({}, {"case_sensitive": True}):
        want_ev, got_ev = j_metrics.Evaluator(**kw), p_metrics.Evaluator(**kw)
        assert got_ev.get_metrics(answers, preds, types) == want_ev.get_metrics(answers, preds, types)
        assert got_ev.get_metrics(answers, None) == want_ev.get_metrics(answers, None)
        assert got_ev.get_retrieval_metric([1, 0, 2, 3], [1, 1, 2, 0]) == \
            want_ev.get_retrieval_metric([1, 0, 2, 3], [1, 1, 2, 0])
        assert got_ev.get_retrieval_metric([1, 0], [[1, 2], [3]]) == want_ev.get_retrieval_metric([1, 0], [[1, 2], [3]])
        assert got_ev.eval_retrieval(answers, chunks) == want_ev.eval_retrieval(answers, chunks)
        assert got_ev.update_global_metrics(0.5, 0.6, 1) == want_ev.update_global_metrics(0.5, 0.6, 1)
        assert (got_ev.best_accuracy, got_ev.best_epoch) == (want_ev.best_accuracy, want_ev.best_epoch)


MMLB_CASES = [("12", "12.0", "Int"), ("3.14", "3.1", "Float"), ("Paris", "paris", "Str"),
              ("['a', 'b']", "['b', 'a']", "List"), ("Not answerable", "Not answerable", "None"),
              ("https://x.org/a", "x.org/a", "Str")]


@pytest.mark.parametrize("gt,pred,fmt", MMLB_CASES)
def test_mmlongbench_copy_matches_original(gt, pred, fmt):
    assert p_mmlb.eval_score(gt, pred, fmt) == j_mmlb.eval_score(gt, pred, fmt)
    assert p_mmlb.get_clean_string(pred) == j_mmlb.get_clean_string(pred)
    assert p_mmlb.is_exact_match(gt) == j_mmlb.is_exact_match(gt)


def test_mmlongbench_summary_copy_matches_original():
    samples = [{"answer": g, "pred": p, "score": j_mmlb.eval_score(g, p, f)} for g, p, f in MMLB_CASES]
    assert p_mmlb.eval_acc_and_f1(samples) == j_mmlb.eval_acc_and_f1(samples)
    assert p_mmlb.eval_acc_and_f1([]) == j_mmlb.eval_acc_and_f1([])
    assert p_metrics.__all__ == j_metrics.__all__


def _hf_state_dict(cfg, prefix, rng):
    """A state dict with the HF names and shapes of a BERT / RoBERTa
    classifier, random values."""
    d, f = cfg.hidden_size, cfg.intermediate_size
    e, sd = prefix + "embeddings.", {}
    r = lambda *s: rng.randn(*s).astype(np.float32)
    sd[e + "word_embeddings.weight"], sd[e + "position_embeddings.weight"] = r(cfg.vocab_size, d), r(cfg.max_position_embeddings, d)
    if cfg.type_vocab_size:
        sd[e + "token_type_embeddings.weight"] = r(cfg.type_vocab_size, d)
    sd[e + "LayerNorm.weight"], sd[e + "LayerNorm.bias"] = r(d), r(d)
    for i in range(cfg.num_layers):
        l = f"{prefix}encoder.layer.{i}."
        for name, (dout, din) in (("attention.self.query", (d, d)), ("attention.self.key", (d, d)),
                                  ("attention.self.value", (d, d)), ("attention.output.dense", (d, d)),
                                  ("intermediate.dense", (f, d)), ("output.dense", (d, f))):
            sd[l + name + ".weight"], sd[l + name + ".bias"] = r(dout, din), r(dout)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[l + name + ".weight"], sd[l + name + ".bias"] = r(d), r(d)
    if cfg.num_labels:
        sd["classifier.dense.weight"], sd["classifier.dense.bias"] = r(d, d), r(d)
        sd["classifier.out_proj.weight"], sd["classifier.out_proj.bias"] = r(cfg.num_labels, d), r(cfg.num_labels)
    return sd


BERT_COPY_CASES = {"bert_model": (dict(type_vocab_size=2), ""), "roberta_classifier": (dict(type_vocab_size=0, num_labels=1,
                                                                                          position_offset=2, pad_id=1), "roberta.")}


@pytest.mark.parametrize("case", BERT_COPY_CASES)
def test_convert_bert_state_dict_copy_matches_original(case):
    import jax

    over, prefix = BERT_COPY_CASES[case]
    kw = dict(vocab_size=50, hidden_size=16, num_layers=3, num_heads=2, intermediate_size=24, max_position_embeddings=20, **over)
    sd = _hf_state_dict(p_bert.BertConfig(**kw), prefix, np.random.RandomState(0))
    want = j_bert.convert_bert_state_dict(sd, j_bert.BertConfig(**kw), prefix)
    got = p_bert.convert_bert_state_dict(sd, p_bert.BertConfig(**kw), prefix)
    flat_w, flat_g = jax.tree_util.tree_flatten_with_path(want)[0], jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))
    assert dataclasses.asdict(p_bert.BertConfig(**kw)) == dataclasses.asdict(j_bert.BertConfig(**kw))
    assert dataclasses.asdict(p_bert.BertConfig()) == dataclasses.asdict(j_bert.BertConfig())


def _same(a, b):
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


PATCH_IMAGES = {"portrait": (600, 400), "landscape": (200, 520), "strip": (96, 160), "tiny": (20, 17)}


@pytest.mark.parametrize("mode", ["square", "horizontal", "page"])
@pytest.mark.parametrize("image", sorted(PATCH_IMAGES))
def test_divide_image_copy_matches_original(image, mode):
    img = np.random.RandomState(len(image)).randint(0, 255, (*PATCH_IMAGES[image], 3), np.uint8)
    for size, overlap in ((256, True), (96, False), (64, True)):
        _same(p_patches.divide_image_into_patches(img, size, overlap, mode),
              j_patches.divide_image_into_patches(img, size, overlap, mode))


@pytest.mark.parametrize("image", sorted(PATCH_IMAGES))
def test_extract_and_pack_patches_copy_matches_original(image):
    rng = np.random.RandomState(len(image) + 1)
    img = rng.randint(0, 255, (*PATCH_IMAGES[image], 3), np.uint8)
    for kw in (dict(max_patches=24, normalize=True), dict(max_patches=128, normalize=True, row_offset=5),
               dict(max_patches=16, pad=False, normalize=True)):
        _same(p_patches.extract_flattened_patches(img, **kw), j_patches.extract_flattened_patches(img, **kw))
    f = img.astype(np.float32)
    _same(p_patches.extract_flattened_patches(p_patches.adaptive_normalize(f), 24),
          j_patches.extract_flattened_patches(j_patches.adaptive_normalize(f), 24))
    _same(p_patches.patch_grid_shape(*PATCH_IMAGES[image], 128), j_patches.patch_grid_shape(*PATCH_IMAGES[image], 128))
    header = p_patches.render_text("what is the total amount due on this invoice?")
    _same(header, j_patches.render_text("what is the total amount due on this invoice?"))
    other = rng.randint(0, 255, (120, 90, 3), np.uint8)
    for images, hd in (([img, other], header), ([img], None), ([], header)):
        _same(p_patches.pack_multi_image_patches(images, 96, header=hd),
              j_patches.pack_multi_image_patches(images, 96, header=hd))
    _same(p_patches.resize_image(img, 32, 32), j_patches.resize_image(img, 32, 32))
    _same(p_patches.stack_header(header, img), j_patches.stack_header(header, img))


def test_layout_and_grid_patches_copy_matches_original():
    rng = np.random.RandomState(3)
    img = rng.randint(0, 255, (400, 300, 3), np.uint8)
    boxes = [[0.5, 0.1, 0.9, 0.3], [0.1, 0.1, 0.4, 0.5], [0.2, 0.6, 0.6, 0.9], [0.0, 0.0, 1.0, 0.6]]
    labels, clusters = [1, 2, 3, 1], [0, 0, -1, 1]
    _same(p_patches.layout_region_crops(img, boxes, labels, clusters), j_patches.layout_region_crops(img, boxes, labels, clusters))
    _same(p_patches.layout_region_crops(img, boxes, labels), j_patches.layout_region_crops(img, boxes, labels))
    for kw in (dict(patch_size=96, overlap=False, mode="horizontal"), dict(patch_size=64, overlap=True, mode="square")):
        _same(p_patches.divide_image_into_layout_patches(img, boxes, labels, clusters, **kw),
              j_patches.divide_image_into_layout_patches(img, boxes, labels, clusters, **kw))
    crops = [p_patches.crop_box(img, b) for b in boxes]
    for a, b in zip(crops, (j_patches.crop_box(img, b) for b in boxes)):
        _same(a, b)
    for n in (0, 1, 3, 4):
        _same(p_patches.concatenate_patches_grid(crops[:n]), j_patches.concatenate_patches_grid(crops[:n]))
    assert set(n for n in dir(j_patches) if not n.startswith("_")) == set(n for n in dir(p_patches) if not n.startswith("_"))


def test_render_text_fallback_without_pil(monkeypatch):
    """A machine without PIL renders the deterministic byte strip, in both."""
    import builtins

    real = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError(name)
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    got, want = p_patches.render_text("what is item 3?"), j_patches.render_text("what is item 3?")
    _same(got, want)
    assert got.shape == (16, 16, 3) and got[4, 0, 0] == ord("w")


def test_utils_stats_copy_matches_original():
    """`utils_stats.py`: the same source below its docstring, and the same
    distributions and examples of a seeded ingested batch and top-k."""
    import inspect

    from rag_docvqa_tpu import utils_stats as j_stats
    from rag_docvqa_tpu.data import DocVQAIngestor as JIngestor
    from rag_docvqa_tpu.data import HashTokenizer as JHashTokenizer
    from rag_docvqa_tpu.data.contract import RetrievalResult as JRetrievalResult
    from rag_docvqa_tpu.data.synthetic import make_corpus
    from rag_docvqa_tpu_torch import utils_stats as p_stats

    body = lambda m: inspect.getsource(m).split("from __future__ import annotations", 1)[1]
    assert body(p_stats) == body(j_stats)
    batch, aux = JIngestor(JHashTokenizer(4096), j_chunking.ChunkSpec(chunk_size=12, overlap=2)).ingest(
        make_corpus(4, n_pages=3, words_per_page=40, seed=2))
    got, want = p_stats.collect_ingest_stats(batch, aux), j_stats.collect_ingest_stats(batch, aux)
    assert got.summary() == want.summary() and got.stats_examples == want.stats_examples
    rng = np.random.RandomState(0)
    labels, valid = rng.randint(0, 6, (4, 5)), rng.rand(4, 5) > 0.3
    ret = JRetrievalResult(top_k_idx=None, top_k_valid=valid, top_k_score=None, top_k_page=None, top_k_label=labels,
                           top_k_box=None, similarities=None)
    names = {0: "text", 1: "title", 2: "list"}
    assert (p_stats.collect_topk_label_stats(ret, names).summary()
            == j_stats.collect_topk_label_stats(ret, names).summary())


def _s2_boxes():
    rng = np.random.RandomState(0)
    left, right = rng.rand(6, 2) * 0.1, rng.rand(6, 2) * 0.1 + 0.9
    return np.concatenate([np.concatenate([c, c + 0.05], axis=1) for c in (left, right)])


# the six cases of tests/test_s2chunker.py, each a function of the module under test
S2_CASES = {
    "affinity": lambda m: (m.region_affinity(np.asarray([[0, 0, 0.1, 0.1], [0.0, 0.05, 0.1, 0.15], [0.9, 0.9, 1.0, 1.0]])),
                           m.region_affinity(np.asarray([[0, 0, 0.1, 0.1], [0.0, 0.05, 0.1, 0.15],
                                                         [0.9, 0.9, 1.0, 1.0]]),
                                             np.asarray([[1.0, 0.0], [1.0, 0.0], [0.0, 1.0]]))),
    "cluster_groups": lambda m: m.cluster_regions(_s2_boxes(), cfg=m.S2Config(max_clusters=4, use_semantics=False)),
    "cluster_tiny": lambda m: (m.cluster_regions([]), m.cluster_regions([[0, 0, 1, 1]]),
                               m.cluster_regions([[0, 0, 1, 1], [0, 0, 1, 1]])),
    "kmeans_silhouette": lambda m: (m.kmeans(np.concatenate([np.zeros((5, 2)), np.ones((5, 2))]), 2, seed=0),
                                    m.silhouette_score(np.concatenate([np.zeros((5, 2)), np.ones((5, 2))]),
                                                       np.asarray([0] * 5 + [1] * 5)),
                                    m.silhouette_score(np.concatenate([np.zeros((5, 2)), np.ones((5, 2))]),
                                                       np.zeros(10, np.int32))),
    "spectral_embedding": lambda m: m.spectral_embedding(np.eye(6) * 0 + 0.5, 2),
    "split_oversized": lambda m: (m.split_oversized_clusters(np.zeros(5, np.int32), [40] * 5, max_tokens=100),
                                  m.split_oversized_clusters(np.zeros(5, np.int32), [40] * 5, 0)),
}


@pytest.mark.parametrize("case", S2_CASES)
def test_s2chunker_copy_matches_original(case):
    from rag_docvqa_tpu.ops import s2chunker as j_s2
    from rag_docvqa_tpu_torch.ops import s2chunker as p_s2

    _same(S2_CASES[case](p_s2), S2_CASES[case](j_s2))
    assert dataclasses.asdict(p_s2.S2Config()) == dataclasses.asdict(j_s2.S2Config())


def _layout_mask():
    m = np.zeros((10, 12), bool)
    m[1:4, 1:5] = True
    m[6:9, 7:11] = True
    d = np.zeros((4, 4), bool)
    d[0, 0] = d[1, 1] = True  # 8-connected: one component
    return m, d


def _layout_seg():
    seg = np.zeros((20, 20), np.int32)
    seg[2:8, 2:18] = 10  # Text
    seg[12:18, 2:9] = 9  # Table
    seg[0, 19] = 4  # a component under min_component
    return seg


# the seven numpy cases of tests/test_layout.py, each through both copies
LAYOUT_CASES = {
    "nms_keeps_biggest": lambda m: (m.non_maximum_suppression([[0, 0, 10, 10], [1, 1, 9, 9], [20, 20, 25, 25]], 0.5),
                                    m.non_maximum_suppression([]),
                                    m.compute_iou([0, 0, 2, 2], np.asarray([[1, 1, 3, 3], [5, 5, 6, 6]], float))),
    "mask_to_boxes_components": lambda m: sorted(m.mask_to_boxes(_layout_mask()[0])) + m.mask_to_boxes(np.zeros((3, 3))),
    "mask_to_boxes_diagonal_connectivity": lambda m: m.mask_to_boxes(_layout_mask()[1]),
    "segmentation_to_layout": lambda m: (m.segmentation_to_layout(_layout_seg()),
                                         m.segmentation_to_layout(_layout_seg(), min_component=1)),
    "filter_dit_remap_and_containment": lambda m: [
        m.filter_detections_dit([[0, 0, 100, 100], [10, 10, 90, 90], [0, 0, 5, 5]], [10, 9, 0], (100, 100),
                                condition=cond) for cond in ("or", "and", "small", "overlap")],
    "filter_yolo": lambda m: m.filter_detections_yolo(
        [[0, 0, 0.5, 0.5], [0.01, 0.01, 0.49, 0.49], [0.6, 0.6, 0.9, 0.9]], [1, 2, 8], iou_threshold=0.5),
    "layout_provider_precomputed": lambda m: (
        m.LayoutProvider(precomputed={"img0": {"boxes": [[0, 0, 1, 1]], "labels": [1]}}).batch_forward(
            [[None, None]], keys=[["img0", "missing"]]),
        m.LayoutProvider(detector=lambda img: ([[0.0, 0.0, 1.0, 1.0]], [int(img.sum()) % 4])).page_layout(
            image=np.ones((2, 2))),
        m.get_layout_model_map(), m.DIT_LABEL_MAP, m.YOLO_LABEL_MAP),
}


@pytest.mark.parametrize("case", LAYOUT_CASES)
def test_layout_copy_matches_original(case):
    from rag_docvqa_tpu.models import layout as j_layout
    from rag_docvqa_tpu_torch.models import layout as p_layout

    _same(LAYOUT_CASES[case](p_layout), LAYOUT_CASES[case](j_layout))


def test_load_precomputed_layouts_copy_matches_original(tmp_path):
    from rag_docvqa_tpu.models import layout as j_layout
    from rag_docvqa_tpu_torch.models import layout as p_layout

    np.savez_compressed(tmp_path / "l.npz", doc0_p0=np.asarray({"boxes": [[0.0, 0.1, 0.5, 0.6]], "labels": [1]},
                                                              dtype=object),
                        doc0_p1=np.asarray({"boxes": [], "labels": [], "clusters": []}, dtype=object))
    _same(p_layout.load_precomputed_layouts(str(tmp_path / "l.npz")),
          j_layout.load_precomputed_layouts(str(tmp_path / "l.npz")))


def test_utils_viz_copy_matches_original(tmp_path):
    """The overlay case of tests/test_engine_visual.py:55 through both copies:
    every pixel equal, the PNG bytes equal, the page and patch overlays of a
    seeded two-page document equal."""
    from types import SimpleNamespace

    from rag_docvqa_tpu import utils_viz as j_viz
    from rag_docvqa_tpu_torch import utils_viz as p_viz

    img = np.full((100, 80, 3), 255, np.uint8)
    kw = dict(chunk_boxes=[[0.1, 0.1, 0.5, 0.3]], retrieved_boxes=[[0.2, 0.5, 0.9, 0.9]],
              layout={"boxes": [[0.0, 0.0, 1.0, 0.45]]})
    np.testing.assert_array_equal(p_viz.render_page_overlay(img, **kw), j_viz.render_page_overlay(img, **kw))
    np.testing.assert_array_equal(p_viz.render_page_overlay(None, **kw), j_viz.render_page_overlay(None, **kw))
    assert (img == 255).all()
    for color in ("LAYOUT_COLOR", "CHUNK_COLOR", "RETRIEVED_COLOR"):
        assert getattr(p_viz, color) == getattr(j_viz, color)
    a, b = img.copy(), img.copy()
    p_viz.draw_box(a, [-5, 3, 200, 40], (1, 2, 3), 4)
    j_viz.draw_box(b, [-5, 3, 200, 40], (1, 2, 3), 4)
    np.testing.assert_array_equal(a, b)

    rng = np.random.RandomState(0)
    images = [rng.randint(0, 255, (120, 100, 3), np.uint8) for _ in range(2)]
    doc = SimpleNamespace(words=[["a"] * 3, ["b"] * 2], images=images,
                          layout=[{"boxes": [[0.1, 0.1, 0.6, 0.5]], "labels": [1]}, None])
    batch = SimpleNamespace(chunk_box=np.asarray([[[0.1, 0.2, 0.4, 0.3], [0.5, 0.5, 0.9, 0.8], [0, 0, 1, 1]]],
                                                 np.float32),
                            chunk_page=np.asarray([[0, 1, 0]]), chunk_mask=np.asarray([[True, True, False]]))
    result = {"retrieval": {"boxes": np.asarray([[[0.5, 0.5, 0.9, 0.8], [0.1, 0.2, 0.4, 0.3]]])},
              "pred_answer_pages": [[1, 0]]}
    steps = {"coords": [(0, 0), (1, 0), (0, 1)], "xyxy": [[0, 0, 50, 40], [10, 10, 60, 90], [50, 40, 100, 120]]}
    for name, fn in (("page", lambda m, d: m.save_step_overlays(doc, batch, result, str(d))),
                     ("patch", lambda m, d: m.save_patch_overlays(images, steps, str(d), retrieved=(2,)))):
        got, want = fn(p_viz, tmp_path / f"p_{name}"), fn(j_viz, tmp_path / f"j_{name}")
        assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
        for p, q in zip(got, want):
            assert open(p, "rb").read() == open(q, "rb").read(), name
