"""Qwen2.5-VL on the port's normal path, at tiny widths on the CPU: a tower
whose windows matter (112-px crops of 14-px patches, 56-px windows, full
attention at layers 1 and 3) and a causal LM with M-RoPE's sections scaled
to its head (hd 16: sections 2, 3, 3 of its 8 frequencies).

Held here: windows as batch rows equal the masked form (f32, to 1e-6 of the
largest value: one fused attention against another); the tower in bf16
within 4e-2 of its f32 output's largest value (bf16 keeps 8 bits: ~4e-3 a
rounding, over 4 layers, a merger and a residual stream); the device resize's
taps bit for bit the host resize's weights, and its pixels equal to the
host's `_resize_bilinear` within f32 rounding (1e-4 of a 0-255 pixel: the
same taps summed in another order); the M-RoPE positions of the
prompt assembly equal to a hand-written `get_rope_index` case exactly (and
to Hugging Face's where `transformers` imports); M-RoPE over equal indices
bit for bit the 1-D tables; prefill plus cached decode equal to the plain
reference's full forward (`perfbench/reference/qwen25_vl.py`, f32) in
logits to 1e-4; `build_engine(..., use_visual=True)` through `evaluate`
held to that reference by the benchmark's check; and the engine's spans and
counters: they fire with the tracer on, are a no-op off, and change no
synchronize and no answer."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from rag_docvqa_tpu_torch import profiling
from rag_docvqa_tpu_torch.data.tokenizer import HashTokenizer
from rag_docvqa_tpu_torch.engine import rag_qwen
from rag_docvqa_tpu_torch.models import causal_lm as clm
from rag_docvqa_tpu_torch.models import qwen25_vision as q25
from rag_docvqa_tpu_torch.ops.patches import _resize_bilinear, _resize_weight_mat
from rag_docvqa_tpu_torch.ops.resize import resize_crops, taps

torch.set_num_threads(2)

TOWER = dict(hidden_size=32, intermediate_size=64, num_heads=4, depth=4, patch_size=14, temporal_patch_size=2,
             spatial_merge_size=2, window_size=56, out_hidden_size=64, fullatt_block_indexes=(1, 3), image_size=112)
LM = dict(vocab_size=512, d_model=64, num_layers=2, num_heads=4, num_kv_heads=2, d_ff=128, tie_word_embeddings=False,
          mrope_section=(2, 3, 3))


def _tower(seed=0, dtype=torch.float32):
    """Tiny tower weights moved off their init (unit norms, zero biases)."""
    cfg = q25.Qwen25VisionConfig(**TOWER)
    p = q25.init_qwen25_vision_params(torch.Generator().manual_seed(seed), cfg)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for t in p.parameters():
            t.add_(0.05 * torch.randn(t.shape, generator=g))
    return cfg, p.to(dtype)


def _pixels(n=3, seed=2):
    return torch.rand(n, 112, 112, 3, generator=torch.Generator().manual_seed(seed)) * 2 - 1


def test_windows_as_batch_rows_equal_the_masked_form(monkeypatch):
    cfg, p = _tower()
    grid = q25._grid(8, 8, cfg, torch.device("cpu"))
    assert grid.windows == 4 and grid.mask is None  # 4 windows of 4 x 4 patches a crop
    q, k, v = (torch.randn(2, 64, 4, 8, generator=torch.Generator().manual_seed(i)) for i in range(3))
    win = torch.from_numpy(np.repeat(q25._window_index(8, 8, cfg)[1], 4))
    mask = win[:, None] == win[None, :]
    rows, masked = q25._attend(q, k, v, grid.windows, None), q25._attend(q, k, v, 0, mask)
    torch.testing.assert_close(rows, masked, rtol=0, atol=1e-6)
    assert not torch.allclose(rows, q25._attend(q, k, v, 0, None), atol=1e-3)  # the windows matter
    px = _pixels()
    want = q25.encode_image(p, cfg, px)
    monkeypatch.setattr(q25, "_grid", lambda h, w, c, d: dataclasses.replace(grid, windows=0, mask=mask))
    got = q25.encode_image(p, cfg, px)
    torch.testing.assert_close(want, got, rtol=0, atol=1e-6 * float(got.abs().max()))


def test_tower_in_bf16_within_its_tolerance_of_f32():
    cfg, p = _tower()
    px = _pixels()
    want = q25.encode_image(p, cfg, px)
    got = q25.encode_image(p.to(torch.bfloat16), cfg, px)
    assert got.dtype == torch.bfloat16 and got.shape == (3, 16, 64)
    err = float((got.float() - want).abs().max() / want.abs().max())
    assert 0 < err < 4e-2


@pytest.mark.parametrize("shape", [(112, 112), (40, 300), (260, 90), (1325, 1024), (7, 5), (112, 60)])
def test_device_resize_equals_the_host_resize(shape):
    rng = np.random.RandomState(sum(shape))
    crops = [rng.randint(0, 256, shape + (3,)).astype(np.uint8), rng.randint(0, 256, (33, 51, 3)).astype(np.uint8)]
    got = resize_crops(crops, 112, 112, "cpu")
    assert got.shape == (2, 112, 112, 3) and got.dtype == torch.float32
    for g, c in zip(got, crops):
        np.testing.assert_allclose(g.numpy(), _resize_bilinear(c, 112, 112), rtol=0, atol=1e-4)
    assert resize_crops([], 112, 112, "cpu").shape == (0, 112, 112, 3)


@pytest.mark.parametrize("n_in", [1, 2, 7, 55, 111, 112, 113, 397, 448, 998, 1325, 2000])
@pytest.mark.parametrize("n_out", [1, 112, 448])
def test_resize_taps_are_the_host_resize_s(n_in, n_out):
    """The taps worked out from each output's support, laid out densely, are
    the host resize's (out, in) weights bit for bit, zeros where it has
    zeros."""
    idx, w = taps(n_in, n_out)
    dense = np.zeros((n_out, n_in), np.float32)
    np.add.at(dense, (np.repeat(np.arange(n_out)[:, None], idx.shape[1], 1), idx), w)
    np.testing.assert_array_equal(dense, _resize_weight_mat(n_in, n_out))


def _engine(mrope=True):
    cfg, vparams = _tower()
    lm_cfg = clm.CausalLMConfig(**dict(LM, mrope_section=LM["mrope_section"] if mrope else ()))
    params = clm.init_causal_lm_params(torch.Generator().manual_seed(3), lm_cfg)
    eng = rag_qwen.RAGQwenEngine(rag_qwen.QwenRAGConfig(chunk_num=3, max_prompt_tokens=160, max_new_tokens=4,
                                                        use_visual=True, max_crops=2),
                                 lm_cfg, params, HashTokenizer(512), vision_cfg=cfg, vision_params=vparams)
    return eng


def _assembled(eng, total=None):
    crops = torch.randn(2, 2, 16, 64)
    valid = np.array([[True, True], [True, False]])
    return eng._assemble_prompts(["what is it", "who"], [["alpha beta", "gamma"], ["delta"]], crops, valid,
                                 total_len=total)


def test_mrope_positions_are_get_rope_index_s():
    """Row 0: text, two 4 x 4 images, the close; row 1: one image. Written
    out by hand: text counts on by one on all axes; an image token of cell
    (r, c) is (s, s + r, s + c), s the index it would have had as text; the
    text after it resumes at s + 4."""
    eng = _engine()
    ids, mask, vemb, vmask, lens, pos = _assembled(eng)
    for b in range(2):
        n = int(lens[b])
        spans = np.flatnonzero(np.diff(np.concatenate([[0], vmask[b, :n].astype(int), [0]])))
        starts, ends = spans[0::2], spans[1::2]
        assert len(starts) == (2 if b == 0 else 1) and all(e - s == 16 for s, e in zip(starts, ends))
        want = np.zeros((3, n), np.int64)
        i, nxt = 0, 0
        while i < n:
            if vmask[b, i]:
                for j in range(16):
                    want[:, i + j] = (nxt, nxt + j // 4, nxt + j % 4)
                nxt, i = nxt + 4, i + 16
            else:
                want[:, i] = nxt
                nxt, i = nxt + 1, i + 1
        np.testing.assert_array_equal(pos[:, b, :n], want)
        assert (pos[:, b, n:] == 1).all()  # padding, as HF fills it


def test_mrope_positions_match_hugging_face():
    pytest.importorskip("transformers", reason="Hugging Face's get_rope_index needs transformers")
    from transformers.models.qwen2_5_vl.modeling_qwen2_5_vl import Qwen2_5_VLModel

    eng = _engine()
    ids, mask, vemb, vmask, lens, pos = _assembled(eng)
    tok = eng.tokenizer
    config = types.SimpleNamespace(image_token_id=eng.image_pad_id, video_token_id=-5,
                                   vision_start_token_id=tok.encode(rag_qwen.CHATML_VISION_OPEN)[-1],
                                   vision_config=types.SimpleNamespace(spatial_merge_size=2, tokens_per_second=2))
    grids = torch.tensor([[1, 8, 8]] * int(vmask.sum() // 16))
    want, _ = Qwen2_5_VLModel.get_rope_index(types.SimpleNamespace(config=config), torch.from_numpy(ids).long(),
                                             grids, None, None, torch.from_numpy(mask).long())
    np.testing.assert_array_equal(pos, want.numpy())


def test_mrope_on_equal_indices_is_the_1d_rope():
    cfg = clm.CausalLMConfig(**LM)
    t = torch.arange(37)
    for a, b in zip(clm.mrope_frequencies(cfg, t[None].expand(3, -1)), clm.rope_frequencies(cfg, t)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="mrope_section"):
        clm.mrope_frequencies(dataclasses.replace(cfg, mrope_section=(2, 2, 2)), t[None].expand(3, -1))


def test_prefill_and_cached_decode_equal_the_reference_forward():
    """A ragged batch of two prompts with image spans and M-RoPE positions:
    the prefill's last logits and each cached decode step's, at rotary index
    max + 1 + t, against the plain reference's teacher-forced full forward
    (f32); `generate` serves the reference's argmax."""
    from perfbench.reference.qwen25_vl import QwenVL

    cfg = clm.CausalLMConfig(**LM)
    params = clm.init_causal_lm_params(torch.Generator().manual_seed(5), cfg)
    c = dict(d_model=64, num_layers=2, num_heads=4, num_kv_heads=2, mrope_section=list(LM["mrope_section"]),
             vision=dict(TOWER, rope_theta=10000.0))
    ref = QwenVL({k: v.detach() for k, v in params.named_parameters()}, c, torch.device("cpu"))
    eng = _engine()
    eng.params, eng.lm_cfg = params, cfg
    ids, mask, vemb, vmask, lens, pos = _assembled(eng)
    ids_t, mask_t, pos_t, vm = (torch.from_numpy(a) for a in (ids, mask, pos, vmask))
    steps = 4
    tokens, _ = clm.generate(params, cfg, ids_t, mask_t, steps, visual_embeds=vemb, visual_mask=vm, positions=pos_t)
    logits0, cache = clm.prefill(params, cfg, ids_t, mask_t, ids.shape[1] + steps, vemb, vm, pos_t)
    step_logits = [logits0]
    k_pos = torch.arange(ids.shape[1] + steps)[None]
    nxt = torch.from_numpy(pos.max(axis=(0,), where=mask[None], initial=-1).max(1) + 1)
    for t in range(steps - 1):
        slot = ids.shape[1] + t
        attn = (k_pos < mask_t.sum(1, keepdim=True)) | ((k_pos >= ids.shape[1]) & (k_pos <= slot))
        lg, cache = clm.decode_step(params, cfg, cache, tokens[:, t], slot, attn, rope_pos=nxt + t)
        step_logits.append(lg)
    for b in range(2):
        n = int(lens[b])
        seq = ids[b, :n].tolist() + tokens[b, :steps - 1].tolist()
        p = np.concatenate([pos[:, b, :n], np.broadcast_to(int(nxt[b]) + np.arange(steps - 1), (3, steps - 1))], 1)
        at = np.flatnonzero(vmask[b, :n])
        want = ref.logits(seq, p, vemb[b, at], at.tolist(), list(range(n - 1, n - 1 + steps)))
        got = torch.stack([lg[b] for lg in step_logits])
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))
        assert torch.equal(want.argmax(-1), tokens[b].long())


def test_build_engine_visual_through_evaluate_is_correct():
    """The benchmark's Qwen2.5-VL cell cut to a tiny size: `build_engine`
    with `use_visual` from a tree carrying the tower, `evaluate` over a
    document stream with page images, the check against the plain
    reference (crops, positions, prompts, pages, served tokens)."""
    from perfbench import harness
    from perfbench.tests.tiny_qwen25_vl import tiny

    r = harness.run(tiny(), 2**31 + 31, 0.05, False, device="cpu", log=lambda *a: None)
    assert r["correct"], r["checks"]
    assert r["checks"]["crop_err"]["value"] > 0 and r["checks"]["position_mismatch"]["value"] == 0


VISION_SPANS = {"engine.retrieve", "engine.crops", "engine.assemble", "engine.prefill", "engine.decode",
                "engine.answers", "vision.tower", "vision.window_layer", "vision.full_layer", "decode.step"}


def test_spans_and_counters_fire_on_and_change_nothing(monkeypatch):
    from rag_docvqa_tpu_torch.data.contract import Caps
    from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
    from rag_docvqa_tpu_torch.data.synthetic import make_corpus
    from rag_docvqa_tpu_torch.ops.chunking import ChunkSpec

    eng = _engine()
    syncs = [0]
    for module in (rag_qwen, clm):
        original = module._sync

        def counted(device, original=original):
            syncs[0] += 1
            original(device)

        monkeypatch.setattr(module, "_sync", counted)
    docs = make_corpus(2, n_pages=2, words_per_page=30, seed=21)
    rng = np.random.RandomState(0)
    for d in docs:
        d.images = [rng.randint(0, 255, (150, 120, 3)).astype(np.uint8) for _ in d.words]
    batch, aux = DocVQAIngestor(HashTokenizer(512), ChunkSpec(chunk_size=10, overlap=2),
                                Caps(max_pages=2, max_chunks=12, max_slots=128)).ingest(docs)
    off = eng.inference(batch, aux)
    n_off = syncs[0]
    assert profiling.read() == profiling.Trace([], [])
    profiling.reset()
    profiling.enable()
    try:
        on = eng.inference(batch, aux)
        trace = profiling.read()
    finally:
        profiling.disable()
        profiling.reset()
    assert on["pred_answers"] == off["pred_answers"] and on["confidences"] == off["confidences"]
    assert syncs[0] - n_off == n_off == 5  # retrieve, crops, assemble, prefill, decode
    names = [s.name for s in trace.spans]
    assert VISION_SPANS <= set(names)
    assert names.count("vision.full_layer") == 2 and names.count("vision.window_layer") == 2
    assert names.count("decode.step") == 3
    tower = {s.id for s in trace.spans if s.name == "vision.tower"}
    crops = {s.id for s in trace.spans if s.name == "engine.crops"}
    assert all(s.parent in tower for s in trace.spans if s.name.startswith("vision.") and s.name != "vision.tower")
    assert all(s.parent in crops for s in trace.spans if s.name == "vision.tower")
    dev_batch = eng._on_device(batch)
    ret, texts, _ = eng._retrieve(dev_batch, aux)
    ids, mask, vemb, vmask, lens, pos = eng._assemble_prompts(aux["questions"], texts,
                                                              *eng._encode_crops(dev_batch, aux, ret))
    n_crops = profiling.total(trace.counts, "vision.crops")
    assert n_crops == 4 and profiling.total(trace.counts, "vision.tokens") == 16 * n_crops
    assert profiling.total(trace.counts, "prefill.tokens_valid") == int(mask.sum())
    assert profiling.total(trace.counts, "prefill.image_tokens") == int(vmask.sum()) == 16 * n_crops
    assert profiling.total(trace.counts, "prefill.positions") == mask.size
