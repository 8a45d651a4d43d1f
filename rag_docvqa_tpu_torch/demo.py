"""Interactive demo of the PyTorch port (the root `demo.py`'s, reference
demo.py / demo2.py).

    python -m rag_docvqa_tpu_torch.demo -m configs/VT5_tiny.yml -d configs/Synthetic.yml [--device cuda|cpu]
    python -m rag_docvqa_tpu_torch.demo -m configs/VT5_tiny.yml --pdf some.pdf
    python -m rag_docvqa_tpu_torch.demo -m configs/VT5_tiny.yml -d configs/Synthetic.yml --serve 7860

Loads a corpus (the synthetic one, any configured dataset, or a PDF through
`--pdf`, which needs pdfminer and names it in an ImportError when it is
missing) and answers questions about one of its documents with RAG-VT5 from
the config's seeded weights, showing the retrieval steps: the top-k chunks
with their scores and pages, and the generated answer. Front ends over one
`DemoSession`: a one-shot question (`-q`), the terminal REPL (default),
`--save-viz DIR` (per-page step-overlay PNGs through `utils_viz.py`: layout
regions green, chunk boxes blue, retrieved regions red), and `--serve PORT`,
a browser UI on the stdlib http.server: GET / the page, GET
/sample?idx=N&layout=1&chunks=1 a document with its dataset question,
ground-truth answers and toggled overlays, POST /ask {"question", "doc"} the
answer, chunks and overlays as JSON. The payloads are the root demo's; the
engine runs on the card unless `--device cpu` is given (`--device` takes the
place of `--platform`).
"""

from __future__ import annotations

import argparse
import base64
import http.server
import json
import os
import sys
import tempfile
import threading
import traceback
import urllib.parse

_INDEX_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>rag_docvqa_tpu demo</title>
<style>
  body { font-family: system-ui, sans-serif; margin: 2rem auto; max-width: 60rem;
         color: #1a1a1a; }
  h1 { font-size: 1.3rem; }
  #browse { display: flex; gap: .5rem; align-items: center; flex-wrap: wrap;
            margin-bottom: .75rem; }
  #qrow { display: flex; gap: .5rem; }
  #q { flex: 1; font-size: 1rem; padding: .5rem; }
  button { font-size: 1rem; padding: .5rem 1.2rem; cursor: pointer; }
  #browse button { padding: .25rem .8rem; }
  #gt { color: #444; font-size: .9rem; margin: .25rem 0 .75rem; }
  #answer { font-size: 1.15rem; margin: 1rem 0 .25rem; }
  #conf { color: #666; font-size: .9rem; }
  table { border-collapse: collapse; margin-top: 1rem; width: 100%; }
  td, th { border: 1px solid #ddd; padding: .35rem .6rem; font-size: .9rem;
           text-align: left; vertical-align: top; }
  th { background: #f5f5f5; }
  #pages, #samplepages { display: flex; flex-wrap: wrap; gap: .75rem;
                         margin-top: 1rem; }
  #pages img, #samplepages img { max-width: 18rem; border: 1px solid #ccc; }
  #status { color: #999; margin-top: .5rem; }
  label { font-size: .9rem; user-select: none; }
</style></head><body>
<h1>rag_docvqa_tpu &mdash; retrieve &rarr; answer demo</h1>
<div id="browse">
  <button onclick="nav(-1)">&#8592; prev</button>
  <span id="which"></span>
  <button onclick="nav(1)">next &#8594;</button>
  <label><input type="checkbox" id="tg_layout" checked onchange="loadSample(cur)">
    layout regions</label>
  <label><input type="checkbox" id="tg_chunks" checked onchange="loadSample(cur)">
    chunk boxes</label>
  <button onclick="useGtQuestion()">use dataset question</button>
</div>
<div id="gt"></div>
<div id="samplepages"></div>
<div id="qrow">
  <input id="q" placeholder="Ask a question about the loaded document&hellip;"
         onkeydown="if(event.key==='Enter')ask()">
  <button onclick="ask()">Ask</button>
</div>
<div id="status"></div>
<div id="answer"></div><div id="conf"></div>
<div id="chunks"></div>
<div id="pages"></div>
<script>
let cur = 0, numDocs = 1, gtQuestion = '';
function el(tag, text) {
  const e = document.createElement(tag);
  if (text != null) e.textContent = text;   // textContent: no HTML injection
  return e;
}
function setImages(containerId, b64s) {
  const box = document.getElementById(containerId);
  box.replaceChildren();
  for (const b of (b64s || [])) {
    const img = document.createElement('img');
    img.src = 'data:image/png;base64,' + b;
    box.appendChild(img);
  }
}
async function loadSample(idx) {
  const layout = document.getElementById('tg_layout').checked ? 1 : 0;
  const chunks = document.getElementById('tg_chunks').checked ? 1 : 0;
  document.getElementById('status').textContent = 'loading sample…';
  try {
    const r = await fetch(`/sample?idx=${idx}&layout=${layout}&chunks=${chunks}`);
    const d = await r.json();
    if (!r.ok) throw new Error(d.error || r.statusText);
    cur = d.idx; numDocs = d.num_docs; gtQuestion = d.question || '';
    document.getElementById('which').textContent =
      `sample ${d.idx + 1} / ${d.num_docs} (${d.num_pages} pages)`;
    const gt = document.getElementById('gt');
    gt.replaceChildren();
    if (d.question) gt.appendChild(el('div', 'dataset question: ' + d.question));
    if (d.answers && d.answers.length)
      gt.appendChild(el('div', 'ground truth: ' + d.answers.join(' | ')));
    setImages('samplepages', d.pages_png_b64);
    document.getElementById('status').textContent = '';
  } catch (e) {
    document.getElementById('status').textContent = 'error: ' + e.message;
  }
}
function nav(d) { loadSample((cur + d + numDocs) % numDocs); }
function useGtQuestion() { if (gtQuestion) document.getElementById('q').value = gtQuestion; }
async function ask() {
  const q = document.getElementById('q').value.trim();
  if (!q) return;
  document.getElementById('status').textContent = 'retrieving + generating…';
  try {
    const r = await fetch('/ask', {method: 'POST',
      headers: {'Content-Type': 'application/json'},
      body: JSON.stringify({question: q, doc: cur})});
    const d = await r.json();
    if (!r.ok) throw new Error(d.error || r.statusText);
    document.getElementById('status').textContent = '';
    document.getElementById('answer').textContent = 'A: ' + JSON.stringify(d.answer);
    document.getElementById('conf').textContent =
      d.confidence == null ? '' : 'confidence ' + Number(d.confidence).toFixed(4);
    const box = document.getElementById('chunks');
    box.replaceChildren();
    if (d.chunks && d.chunks.length) {
      const table = el('table'), head = el('tr');
      for (const h of ['#', 'page', 'score', 'chunk text']) head.appendChild(el('th', h));
      table.appendChild(head);
      for (const c of d.chunks) {
        const tr = el('tr');
        tr.appendChild(el('td', c.rank));
        tr.appendChild(el('td', c.page ?? ''));
        tr.appendChild(el('td', c.score == null ? '' : c.score.toFixed(4)));
        tr.appendChild(el('td', c.text || ''));
        table.appendChild(tr);
      }
      box.appendChild(table);
    }
    setImages('pages', d.viz_png_b64);
  } catch (e) {
    document.getElementById('status').textContent = 'error: ' + e.message;
  }
}
loadSample(0);
</script></body></html>
"""


class DemoSession:
    """One loaded engine + corpus. `ask` answers a question against a document
    (the reference demo's query path); `sample` exposes the dataset-browser
    payload (GT question/answers + toggled per-page overlays, reference
    demo.py:68-178)."""

    def __init__(self, engine, ingestor, docs, describe: str):
        self._engine = engine
        self._ingestor = ingestor
        self._docs = docs
        self.describe = describe
        self.num_docs = len(docs)

    def sample(self, idx: int, layout: bool = True, chunks: bool = True) -> dict:
        import numpy as np

        from rag_docvqa_tpu_torch.utils_viz import render_page_overlay, save_png

        idx = int(idx) % self.num_docs
        doc = self._docs[idx]
        chunk_layers = ([], [], [])
        if chunks:
            batch, _ = self._ingestor.ingest([doc])
            chunk_layers = (np.asarray(batch.chunk_box[0]),
                            np.asarray(batch.chunk_page[0]),
                            np.asarray(batch.chunk_mask[0]))
        pngs = []
        with tempfile.TemporaryDirectory() as td:
            for p in range(len(doc.words)):
                img = None
                if doc.images is not None and p < len(doc.images) and doc.images[p] is not None:
                    img = np.asarray(doc.images[p])
                cboxes = ()
                if chunks:
                    cbox, cpage, cmask = chunk_layers
                    cboxes = [cbox[c] for c in range(len(cbox))
                              if cmask[c] and cpage[c] == p]
                overlay = render_page_overlay(
                    img, chunk_boxes=cboxes,
                    layout=(doc.layout[p] if layout and doc.layout
                            and p < len(doc.layout) else None),
                )
                path = os.path.join(td, f"page_{p}.png")
                save_png(overlay, path)
                with open(path, "rb") as f:
                    pngs.append(base64.b64encode(f.read()).decode())
        return {
            "idx": idx,
            "num_docs": self.num_docs,
            "num_pages": len(doc.words),
            "question": doc.question or "",
            "answers": list(doc.answers or []),
            "answer_page": (None if doc.answer_page_idx is None
                            else int(doc.answer_page_idx)),
            "pages_png_b64": pngs,
        }

    def ask(self, question: str, doc_idx: int = 0, viz_dir=None) -> dict:
        import numpy as np

        from rag_docvqa_tpu_torch.data.contract import RawDocument

        base_doc = self._docs[int(doc_idx) % self.num_docs]
        doc = RawDocument(
            question=question, words=base_doc.words, boxes=base_doc.boxes,
            answers=base_doc.answers, answer_page_idx=base_doc.answer_page_idx,
            images=base_doc.images, layout=base_doc.layout,
        )
        batch, aux = self._ingestor.ingest([doc])
        out = self._engine.inference(batch, aux)
        ret = out.get("retrieval", {}) or {}
        pages = out["pred_answer_pages"][0]
        if not isinstance(pages, list):
            pages = [pages]
        sims = ret.get("similarities")
        chunks = []
        for r, text in enumerate(ret.get("text", [[]])[0]):
            chunks.append({
                "rank": r,
                "page": int(pages[r]) if r < len(pages) else None,
                "score": float(np.asarray(sims)[0][r]) if sims is not None else None,
                "text": text,
            })
        conf = out["confidences"][0]
        result = {
            "question": question,
            "answer": out["pred_answers"][0],
            "confidence": conf if conf is None or isinstance(conf, list) else float(conf),
            "chunks": chunks,
        }
        if viz_dir:
            from rag_docvqa_tpu_torch.utils_viz import save_step_overlays

            result["viz_paths"] = save_step_overlays(doc, batch, out, viz_dir)
        return result


def build_session(args) -> DemoSession:
    """Build the engine, ingestor and corpus once, on `args.device`."""
    import torch

    from rag_docvqa_tpu_torch.config import (
        build_caps, build_chunk_spec, build_rag_config, build_vt5_config, load_config, load_tokenizer,
    )
    from rag_docvqa_tpu_torch.data.contract import RawDocument
    from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
    from rag_docvqa_tpu_torch.engine.rag_vt5 import RAGVT5Engine
    from rag_docvqa_tpu_torch.models import vt5 as vt5m
    from rag_docvqa_tpu_torch.train import build_docs, parse_overrides, resolve_device

    device = resolve_device(args.device)
    config = load_config(model=args.model, dataset=args.dataset, overrides=parse_overrides(args.overrides))
    tokenizer = load_tokenizer(config.get("tokenizer"))
    vt5_cfg = build_vt5_config(config, tokenizer.vocab_size)
    rag_cfg = build_rag_config(config)
    ingestor = DocVQAIngestor(tokenizer, build_chunk_spec(config), build_caps(config))
    params = vt5m.init_vt5_params(torch.Generator(device=device).manual_seed(config["seed"]), vt5_cfg)
    engine = RAGVT5Engine(rag_cfg, vt5_cfg, params, tokenizer)

    if args.pdf:
        from rag_docvqa_tpu_torch.data.pdf import load_pdf

        words, boxes, _ = load_pdf(args.pdf, render_images=False)
        docs = [RawDocument(question="", words=words, boxes=boxes)]
        describe = (f"Loaded PDF: {len(words)} pages, "
                    f"{sum(len(w) for w in words)} words")
    else:
        docs = build_docs(config, "val")
        base_doc = docs[args.doc]
        describe = (f"Loaded doc {args.doc}: {len(base_doc.words)} pages; "
                    f"dataset question: {base_doc.question!r} (gt: {base_doc.answers})")

    return DemoSession(engine, ingestor, docs, describe)


def make_server(session: DemoSession, port: int, host: str = "127.0.0.1"):
    """stdlib HTTP server over the session: GET / serves the UI, GET /sample
    browses the dataset (prev/next + overlay toggles), POST /ask runs a query
    (engine access serialized by a lock) and inlines the step-overlay PNGs as
    base64. Returns the (not yet running) ThreadingHTTPServer.

    Engine exceptions are logged server-side with a traceback; the client
    sees a generic error body (exception strings can leak paths/config)."""
    lock = threading.Lock()

    class Handler(http.server.BaseHTTPRequestHandler):
        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_500(self):
            traceback.print_exc(file=sys.stderr)
            self._send(500, b'{"error": "internal error (see server log)"}',
                       "application/json")

        def do_GET(self):
            parsed = urllib.parse.urlparse(self.path)
            if parsed.path in ("/", "/index.html"):
                return self._send(200, _INDEX_HTML.encode(), "text/html; charset=utf-8")
            if parsed.path == "/sample":
                try:
                    q = urllib.parse.parse_qs(parsed.query)
                    idx = int(q.get("idx", ["0"])[0])
                    layout = q.get("layout", ["1"])[0] not in ("0", "false")
                    chunks = q.get("chunks", ["1"])[0] not in ("0", "false")
                    with lock:
                        payload = session.sample(idx, layout=layout, chunks=chunks)
                    return self._send(200, json.dumps(payload).encode(),
                                      "application/json")
                except Exception:
                    return self._send_500()
            self._send(404, b'{"error": "not found"}', "application/json")

        def do_POST(self):
            if self.path != "/ask":
                return self._send(404, b'{"error": "not found"}', "application/json")
            try:
                n = int(self.headers.get("Content-Length") or 0)
                req = json.loads(self.rfile.read(n) or b"{}")
                question = str(req.get("question", "")).strip()
                doc_idx = int(req.get("doc", 0))
                if not question:
                    return self._send(
                        400, b'{"error": "empty question"}', "application/json")
                with lock, tempfile.TemporaryDirectory() as td:
                    result = session.ask(question, doc_idx=doc_idx, viz_dir=td)
                    pngs = []
                    for p in result.pop("viz_paths", []):
                        with open(p, "rb") as f:
                            pngs.append(base64.b64encode(f.read()).decode())
                result["viz_png_b64"] = pngs
                self._send(200, json.dumps(result).encode(), "application/json")
            except Exception:
                self._send_500()

        def log_message(self, *a):  # quiet access log
            pass

    return http.server.ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-m", "--model", required=True)
    parser.add_argument("-d", "--dataset", default=None)
    parser.add_argument("--pdf", default=None, help="ad-hoc PDF ingestion (demo2.py path)")
    parser.add_argument("--doc", type=int, default=0, help="document index to query")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("-q", "--question", default=None, help="one-shot question (else REPL)")
    parser.add_argument("--save-viz", default=None, metavar="DIR",
                        help="write per-page step-overlay PNGs (layout boxes green, "
                             "chunk boxes blue, retrieved regions red — the reference "
                             "demo's visualization, demo.py:68-178)")
    parser.add_argument("--serve", type=int, default=None, metavar="PORT",
                        help="browser UI on http://127.0.0.1:PORT (the reference's "
                             "Gradio demo on the stdlib http.server)")
    parser.add_argument("--host", default="127.0.0.1", help="--serve bind address")
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    session = build_session(args)
    print(session.describe)

    if args.serve is not None:
        if args.host not in ("127.0.0.1", "localhost", "::1"):
            print(f"WARNING: binding to {args.host!r} exposes an unauthenticated "
                  "compute endpoint beyond loopback", file=sys.stderr)
        httpd = make_server(session, args.serve, args.host)
        host, port = httpd.server_address[:2]
        print(f"Serving demo UI on http://{host}:{port} (Ctrl-C to stop)")
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            httpd.shutdown()
        return

    def show(question: str):
        if args.save_viz:
            os.makedirs(args.save_viz, exist_ok=True)
        result = session.ask(question, doc_idx=args.doc, viz_dir=args.save_viz)
        print(f"\nQ: {question}")
        for c in result["chunks"]:
            snippet = c["text"] if len(c["text"]) < 100 else c["text"][:97] + "..."
            print(f"  [chunk {c['rank']}] page {c['page']}: {snippet}")
        conf = result["confidence"]
        conf_s = f"{conf:.4f}" if isinstance(conf, float) else repr(conf)
        print(f"A: {result['answer']!r}  (conf {conf_s})")
        if "viz_paths" in result:
            print(f"step overlays: {', '.join(result['viz_paths'])}")

    if args.question:
        show(args.question)
        return
    print("Type a question (empty line to exit).")
    while True:
        try:
            q = input("> ").strip()
        except EOFError:
            break
        if not q:
            break
        show(q)


if __name__ == "__main__":
    main()
