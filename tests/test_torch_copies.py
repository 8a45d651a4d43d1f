"""The port's own copies of the plain-Python host modules, held against the
originals in the JAX package so they cannot drift unnoticed: the chunker
(`ops/chunking.py`) on seeded pages, the metrics (`metrics/`) on a few
strings, `convert_bert_state_dict` (numpy only, but in a module of the
JAX package that imports jax) on seeded state dicts, and the image patch
math (`ops/patches.py`) on seeded page images. Everything here is integer,
string, copying or identical numpy work on the host: equal exactly."""

import dataclasses

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
