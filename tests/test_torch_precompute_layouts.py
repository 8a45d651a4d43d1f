"""Port parity, `python -m rag_docvqa_tpu_torch.precompute layouts` and the
layout-guided path it feeds: the port's CLI against the root `precompute.py
layouts --platform cpu` on an MP-DocVQA directory with seeded page images
(`chip_smoke.write_mp_docvqa`, banded pages), for the DiT detector (a seeded
Hugging Face BeitForSemanticSegmentation at the CLI's default widths, 224 px,
saved as safetensors) and for YOLO (a synthetic ultralytics state dict at
width 8, 128 px), both read through `--weights`. Boxes and labels must be
equal page for page, exactly.

F8: the root CLI keys a page "<question_id>_p<page>", which its own
MP-DocVQA dataset cannot read (it reads image names); the port's CLI writes
image names, which both packages' datasets read back. Then the eval CLI with
`use_precomputed_layouts` on the port's file, RAG-VT5 `concat` and
RAG-Pix2Struct `chunk_mode: layout`, against the root `eval.py` on the same
file and weights: the same summary, and the same chunk counts from both
ingestors, which differ from the counts without layouts."""

from __future__ import annotations

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from chip_smoke import write_mp_docvqa
from test_torch_eval import _root_then_port, _same_saved, _same_summary
from test_torch_yolo import ultralytics_state_dict

torch.set_num_threads(2)

N_DOCS = 4
DIT_ARGS = []  # the CLI's default widths: d 32, 5 layers, 4 heads, mlp 64, 224 px, out_indices (2, 3, 4, 5)
YOLO_ARGS = ["layout_width=8", "layout_image_size=128"]


def _dit_weights(path: str) -> None:
    """A seeded HF BEiT segmentation model at the CLI's DiT widths, with
    random BatchNorm statistics, a classifier of unit scale and the patch
    projection scaled by 20 (so the class map follows the page's bands, not
    one class everywhere), saved as safetensors."""
    from safetensors.torch import save_file
    from transformers import BeitConfig, BeitForSemanticSegmentation

    hf_cfg = BeitConfig(image_size=224, patch_size=16, hidden_size=32, num_hidden_layers=5, num_attention_heads=4,
                        intermediate_size=64, num_labels=12, out_indices=[2, 3, 4, 5],
                        use_relative_position_bias=True, use_absolute_position_embeddings=False,
                        use_mean_pooling=True, layer_scale_init_value=0.1, use_auxiliary_head=False,
                        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0, drop_path_rate=0.0)
    torch.manual_seed(0)
    hf = BeitForSemanticSegmentation(hf_cfg).eval()
    with torch.no_grad():
        for m in hf.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.5)
                m.running_var.uniform_(0.5, 2.0)
        hf.decode_head.classifier.weight.normal_(0, 1.0)
        hf.decode_head.classifier.bias.zero_()
        hf.beit.embeddings.patch_embeddings.projection.weight.mul_(20.0)
    save_file({k: v.detach().contiguous().clone() for k, v in hf.state_dict().items()}, path)


def _yolo_weights(path: str) -> None:
    from safetensors.numpy import save_file

    from rag_docvqa_tpu.models import yolo as j_yolo

    save_file(ultralytics_state_dict(j_yolo.YOLOConfig(width=8, depth=1, image_size=128)), path)


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    """Both CLIs' .npz files and printed lines, per detector, on one
    fixture; the directory's overrides."""
    import precompute as root_pre
    from rag_docvqa_tpu_torch import precompute as p_pre

    root = str(tmp_path_factory.mktemp("layouts"))
    imdb, images = write_mp_docvqa(os.path.join(root, "mp"), n_docs=N_DOCS, bands=True)
    data = [f"imdb_dir={imdb}", f"images_dir={images}", "use_images=true"]
    weights = {"DIT": os.path.join(root, "dit.safetensors"), "YOLO": os.path.join(root, "yolo.safetensors")}
    _dit_weights(weights["DIT"])
    _yolo_weights(weights["YOLO"])
    out = {"data": data, "imdb": imdb}
    for det, extra in (("DIT", DIT_ARGS), ("YOLO", YOLO_ARGS)):
        common = ["layouts", "-m", "configs/VT5_tiny.yml", "-d", "configs/MP-DocVQA.yml", "--detector", det,
                  "--weights", weights[det]]
        jpath, ppath = os.path.join(root, f"jax_{det}.npz"), os.path.join(root, f"port_{det}.npz")
        jline = _run(root_pre.main, common + ["--out", jpath, "--platform", "cpu"] + data + extra)
        pline = _run(p_pre.main, common + ["--out", ppath, "--device", "cpu"] + data + extra)
        out[det] = (jpath, ppath, jline, pline)
    return out


def _records(imdb: str):
    return list(np.load(os.path.join(imdb, "imdb_val.npy"), allow_pickle=True)[1:])


@pytest.mark.parametrize("detector", ["DIT", "YOLO"])
def test_layouts_cli_matches_root(layouts, detector):
    jpath, ppath, jline, pline = layouts[detector]
    assert jline.keys() == pline.keys() == {"n_pages", "detector", "pages_per_sec", "out"}
    assert pline["n_pages"] == jline["n_pages"] and pline["detector"] == detector and pline["out"] == ppath
    jz, pz = np.load(jpath, allow_pickle=True), np.load(ppath, allow_pickle=True)
    pairs = [(f"{r['question_id']}_p{p}", name) for r in _records(layouts["imdb"])
             for p, name in enumerate(r["image_name"])]
    assert sorted(jz.files) == sorted(q for q, _ in pairs) and sorted(pz.files) == sorted(n for _, n in pairs)
    assert len(pairs) == jline["n_pages"]
    boxes = 0
    for qkey, name in pairs:
        want, got = jz[qkey].item(), pz[name].item()
        assert got == want, (qkey, name)
        assert all(type(v) is float for b in got["boxes"] for v in b) and all(type(v) is int for v in got["labels"])
        boxes += len(got["boxes"])
    assert boxes > 0


def test_f8_root_keys_are_unreadable_by_its_dataset(layouts):
    """The root CLI's file raises KeyError in the JAX MP-DocVQA dataset,
    whose pages are named `doc<i>_p<p>`; the port's file loads in both
    datasets, each page's layout its entry."""
    from rag_docvqa_tpu.data import datasets as j_ds
    from rag_docvqa_tpu_torch.data import datasets as p_ds

    jpath, ppath, _, _ = layouts["DIT"]
    imdb = layouts["imdb"]
    images = os.path.join(os.path.dirname(imdb), "images")
    with pytest.raises(KeyError):
        j_ds.MPDocVQADataset(imdb, images, precomputed_layouts_path=jpath)[0]
    pz = np.load(ppath, allow_pickle=True)
    for ds in (j_ds.MPDocVQADataset(imdb, images, precomputed_layouts_path=ppath),
               p_ds.MPDocVQADataset(imdb, images, precomputed_layouts_path=ppath)):
        for i, r in enumerate(_records(imdb)):
            assert ds[i].layout == [pz[name].item() for name in r["image_name"]]
    # the port's dataset names the pages of every view
    ds = p_ds.MPDocVQADataset(imdb, images, use_images=True)
    for i, r in enumerate(_records(imdb)):
        doc, names = ds.document_pages(i)
        assert names == list(r["image_name"]) and len(doc.images) == len(names)
    oracle = p_ds.MPDocVQADataset(imdb, images, page_retrieval="oracle")
    assert oracle.document_pages(1)[1] == [_records(imdb)[1]["image_name"][_records(imdb)[1]["answer_page_idx"]]]


def _chunk_counts(config_overrides, layouts_path):
    """Valid chunks per document from both ingestors over the MP-DocVQA
    documents, with the layouts of `layouts_path` or without any."""
    from rag_docvqa_tpu import config as j_config
    from rag_docvqa_tpu.data import DocVQAIngestor as JIngestor, load_tokenizer as j_tok
    from rag_docvqa_tpu.data.datasets import build_dataset as j_build
    from rag_docvqa_tpu_torch import config as p_config
    from rag_docvqa_tpu_torch.data.datasets import build_dataset as p_build
    from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor

    cfg = p_config.load_config(model="configs/VT5_tiny.yml", dataset="configs/MP-DocVQA.yml",
                               overrides=dict(kv.split("=", 1) for kv in config_overrides))
    cfg["use_images"] = True
    if layouts_path:
        cfg.update(use_precomputed_layouts=True, precomputed_layouts_path=layouts_path)
    counts = []
    for build, ing in ((p_build, DocVQAIngestor(p_config.load_tokenizer(cfg.get("tokenizer")),
                                                p_config.build_chunk_spec(cfg), p_config.build_caps(cfg))),
                       (j_build, JIngestor(j_tok(cfg.get("tokenizer")), j_config.build_chunk_spec(cfg),
                                           j_config.build_caps(cfg)))):
        docs = list(build(dict(cfg), "val"))
        counts.append(np.asarray(ing.ingest(docs)[0].chunk_mask).sum(1).tolist())
    return counts


@pytest.mark.parametrize("model", ["vt5_concat", "pix2struct_layout"])
def test_eval_cli_with_layouts_matches_root(layouts, model, tmp_path, monkeypatch, capsys):
    _, ppath, _, _ = layouts["DIT"]
    overrides = layouts["data"] + ["use_precomputed_layouts=true", f"precomputed_layouts_path={ppath}"]
    if model == "vt5_concat":
        want, got, jlines, plines = _root_then_port(tmp_path, monkeypatch, capsys, [], overrides,
                                                    data="configs/MP-DocVQA.yml")
        with_layouts, without = _chunk_counts(layouts["data"], ppath), _chunk_counts(layouts["data"], None)
        assert with_layouts[0] == with_layouts[1] and without[0] == without[1]
        assert with_layouts[0] != without[0]
    else:
        want, got, jlines, plines = _root_then_port(tmp_path, monkeypatch, capsys, [],
                                                    overrides + ["chunk_mode=layout", "batch_size=2"],
                                                    model="configs/Pix2Struct_tiny.yml", data="configs/MP-DocVQA.yml",
                                                    kind="pix2struct")
    assert len(want) == len(got) == 1 and got[0]["n_samples"] == N_DOCS
    _same_summary(got[0], want[0])
    _same_saved(tmp_path)


def test_layouts_cli_streams_and_detects_each_page_once(tmp_path, monkeypatch):
    """Questions that share a document share its image names: the port's
    CLI detects each distinct page once, counts distinct pages in
    `n_pages`, and reads the documents as the detector asks for pages (the
    first batch is detected before the last document is read), in batches
    of at most LAYOUT_BATCH."""
    from rag_docvqa_tpu_torch import precompute as p_pre
    from rag_docvqa_tpu_torch.data import datasets as p_ds

    imdb, images = write_mp_docvqa(str(tmp_path / "mp"), n_docs=6, bands=True)
    records = np.load(os.path.join(imdb, "imdb_val.npy"), allow_pickle=True)
    again = [dict(r, question_id=2000 + i) for i, r in enumerate(records[1:4])]  # three more questions
    np.save(os.path.join(imdb, "imdb_val.npy"), np.asarray(list(records) + again, dtype=object), allow_pickle=True)
    names = [n for r in records[1:] for n in r["image_name"]]

    events = []
    read = p_ds.MPDocVQADataset.document_pages
    monkeypatch.setattr(p_ds.MPDocVQADataset, "document_pages",
                        lambda self, i: events.append(("read", i)) or read(self, i))
    make = p_pre.layout_detector

    def counted_detector(*a):
        det = make(*a)
        batch = det.batch
        det.batch = lambda imgs: events.append(("batch", len(imgs))) or batch(imgs)
        return det

    monkeypatch.setattr(p_pre, "layout_detector", counted_detector)
    monkeypatch.setattr(p_pre, "LAYOUT_BATCH", 4)
    path = str(tmp_path / "layouts.npz")
    line = _run(p_pre.main, ["layouts", "-m", "configs/VT5_tiny.yml", "-d", "configs/MP-DocVQA.yml", "--detector",
                             "YOLO", "--out", path, "--device", "cpu", f"imdb_dir={imdb}", f"images_dir={images}",
                             "use_images=true"] + YOLO_ARGS)
    batches = [n for kind, n in events if kind == "batch"]
    reads = [i for kind, i in events if kind == "read"]
    assert line["n_pages"] == len(names) == sum(batches) == len(set(names)) < sum(len(r["image_name"]) for r in
                                                                               list(records[1:]) + again)
    assert sorted(np.load(path, allow_pickle=True).files) == sorted(names)
    assert max(batches) == 4 and reads == list(range(len(records) - 1 + len(again)))
    assert events.index(("batch", 4)) < events.index(("read", len(reads) - 1))
