"""Port parity, the demo (`python -m rag_docvqa_tpu_torch.demo`): the round
trip of `tests/test_demo_serve.py` against the port's stdlib server over a
real socket on the CPU (the UI page, /sample browsing with its overlay
toggles and wrap-around, /ask with its chunk introspection and overlay PNGs,
the 400, 500 and 404 paths), with the root demo's session on the same
seeded config and weights (the root's own seeded init, its encoder rel-pos
table rounded to bf16, which the port's encoder takes, carried over with
`params.from_jax`) as the reference: /sample's payload equal, /ask's answer,
pages, chunk texts and overlay PNGs equal, scores and the confidence within
1e-5 (f32 over a different order of sums)."""

from __future__ import annotations

import base64
import json
import threading
import types
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_docvqa_tpu.models import vt5 as j_vt5
from rag_docvqa_tpu_torch import params as p_params
from rag_docvqa_tpu_torch.models import vt5 as p_vt5

torch.set_num_threads(2)

TOL = 1e-5


def _sessions(monkeypatch):
    import demo as root_demo
    from rag_docvqa_tpu_torch import demo as p_demo

    trees = []
    j_init = j_vt5.init_vt5_params

    def rounded(key, cfg):
        tree = jax.tree.map(np.array, j_init(key, cfg))
        rb = tree["t5"]["encoder"]["rel_bias"]
        tree["t5"]["encoder"]["rel_bias"] = np.asarray(torch.from_numpy(rb).bfloat16().float())
        trees.append(tree)
        return jax.tree.map(jnp.asarray, tree)

    monkeypatch.setattr(j_vt5, "init_vt5_params", rounded)
    monkeypatch.setattr(p_vt5, "init_vt5_params", lambda g, cfg: p_params.from_jax(trees[0]))
    common = dict(model="configs/VT5_tiny.yml", dataset="configs/Synthetic.yml", pdf=None, doc=0,
                  overrides=["n_val_docs=2"])
    want = root_demo.build_session(types.SimpleNamespace(platform="cpu", **common))
    got = p_demo.build_session(types.SimpleNamespace(device="cpu", **common))
    return p_demo, want, got


def _same_ask(got: dict, want: dict):
    assert got.keys() == want.keys()
    assert got["question"] == want["question"] and got["answer"] == want["answer"]
    np.testing.assert_allclose(got["confidence"], want["confidence"], rtol=0, atol=TOL)
    assert len(got["chunks"]) == len(want["chunks"])
    for g, w in zip(got["chunks"], want["chunks"]):
        assert (g["rank"], g["page"], g["text"]) == (w["rank"], w["page"], w["text"])
        assert isinstance(g["score"], float)
        np.testing.assert_allclose(g["score"], w["score"], rtol=0, atol=TOL)


def test_demo_serve_roundtrip_matches_root(monkeypatch):
    p_demo, want, session = _sessions(monkeypatch)
    assert session.describe == want.describe and "Loaded doc 0" in session.describe
    assert session.num_docs == want.num_docs == 2

    httpd = p_demo.make_server(session, 0)  # ephemeral port
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{port}"
    get = lambda path: json.loads(urllib.request.urlopen(f"{base}{path}", timeout=120).read())
    try:
        html = urllib.request.urlopen(f"{base}/", timeout=30).read().decode()
        assert "rag_docvqa_tpu" in html and "/ask" in html and "/sample" in html

        s1 = get("/sample?idx=1&layout=1&chunks=1")
        assert s1 == want.sample(1, layout=True, chunks=True)
        assert s1["idx"] == 1 and s1["question"] and s1["answers"]
        assert len(s1["pages_png_b64"]) == s1["num_pages"] >= 1
        for b in s1["pages_png_b64"]:
            assert base64.b64decode(b)[:8] == b"\x89PNG\r\n\x1a\n"
        s1_off = get("/sample?idx=1&layout=0&chunks=0")
        assert s1_off == want.sample(1, layout=False, chunks=False)
        assert s1_off["pages_png_b64"] != s1["pages_png_b64"]
        assert get("/sample?idx=-1&layout=0&chunks=0")["idx"] == 1

        req = urllib.request.Request(f"{base}/ask",
                                     data=json.dumps({"question": "what is the total?", "doc": 1}).encode(),
                                     headers={"Content-Type": "application/json"})
        out = json.loads(urllib.request.urlopen(req, timeout=300).read())
        assert set(out) >= {"question", "answer", "confidence", "chunks", "viz_png_b64"}
        import tempfile

        with tempfile.TemporaryDirectory() as td:
            ref = want.ask("what is the total?", doc_idx=1, viz_dir=td)
            ref_pngs = [base64.b64encode(open(p, "rb").read()).decode() for p in ref.pop("viz_paths")]
        viz = out.pop("viz_png_b64")
        _same_ask(out, ref)
        assert viz == ref_pngs and viz
        for b in viz:
            assert base64.b64decode(b)[:8] == b"\x89PNG\r\n\x1a\n"

        bad = urllib.request.Request(f"{base}/ask", data=b"{}", headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(bad, timeout=30)
        assert ei.value.code == 400 and json.loads(ei.value.read())["error"]
        broken = urllib.request.Request(f"{base}/ask", data=json.dumps({"question": "q", "doc": "not-an-int"}).encode(),
                                        headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(broken, timeout=30)
        assert ei.value.code == 500 and "invalid literal" not in json.loads(ei.value.read())["error"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/nope", timeout=30)
        assert ei.value.code == 404
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_demo_one_shot_and_pdf(monkeypatch, tmp_path, capsys):
    """`-q` with `--save-viz` prints the root demo's lines (the answer, each
    chunk's page) and writes one overlay a page; `--pdf` raises the
    ImportError that names pdfminer when it is missing, as the port's loader
    does; without a card the default device raises."""
    import sys

    from rag_docvqa_tpu_torch import demo as p_demo

    p_demo.main(["-m", "configs/VT5_tiny.yml", "-d", "configs/Synthetic.yml", "--device", "cpu", "-q",
                 "what is the total?", "--save-viz", str(tmp_path / "viz"), "n_val_docs=2"])
    out = capsys.readouterr().out
    assert "Q: what is the total?" in out and "A: " in out and "[chunk 0] page" in out
    assert sorted(p.name for p in (tmp_path / "viz").iterdir()) == ["page_0.png", "page_1.png", "page_2.png"]
    monkeypatch.setitem(sys.modules, "pdfminer", None)
    for mod in [m for m in sys.modules if m.startswith("pdfminer.")]:
        monkeypatch.setitem(sys.modules, mod, None)
    (tmp_path / "a.pdf").write_bytes(b"%PDF-1.4\n")
    with pytest.raises(ImportError, match="pdfminer"):
        p_demo.main(["-m", "configs/VT5_tiny.yml", "--pdf", str(tmp_path / "a.pdf"), "--device", "cpu", "-q", "x"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            p_demo.main(["-m", "configs/VT5_tiny.yml", "-d", "configs/Synthetic.yml", "-q", "x"])
