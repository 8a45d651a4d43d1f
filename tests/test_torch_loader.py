"""Port parity, checkpoint and tokenizer loading from local files:
`models/loader.py`, `models/convert.py`, `data/tokenizer.py` and the CLIs'
`--hf-weights` against the JAX package.

Hugging Face models and tokenizers are built in memory from a config (no
download) and saved under tmp_path: a T5 as model.safetensors in f32 and in
bf16, as a sharded index and as pytorch_model.bin. The port's reader (its
own safetensors parser) must give the JAX loader's arrays exactly; the
converted trees must equal JAX's leaf for leaf, but for the Hi-VT5 page
head, which the port loads into `page_head` where JAX writes `ret_head`
(ROADMAP Queue 3, F7). The VT5 `--hf-weights` evaluation must give the root
`eval.py`'s summary (metrics within 1e-6)."""

import json

import jax
import numpy as np
import pytest
import torch

from rag_docvqa_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from rag_docvqa_tpu.data.tokenizer import HFTokenizer as JHFTokenizer
from rag_docvqa_tpu.models import hivt5 as j_hivt5
from rag_docvqa_tpu.models import loader as j_loader
from rag_docvqa_tpu.models import t5 as j_t5
from rag_docvqa_tpu.models import vit as j_vit
from rag_docvqa_tpu.models import vt5 as j_vt5
from rag_docvqa_tpu.models.embeddings import SpatialConfig as JSpatialConfig
from rag_docvqa_tpu_torch import config as p_config
from rag_docvqa_tpu_torch import params as p_params
from rag_docvqa_tpu_torch.data.tokenizer import ByteTokenizer, HashTokenizer, HFTokenizer
from rag_docvqa_tpu_torch.models import convert as p_convert
from rag_docvqa_tpu_torch.models import hivt5 as p_hivt5
from rag_docvqa_tpu_torch.models import loader as p_loader
from rag_docvqa_tpu_torch.models import t5 as p_t5
from rag_docvqa_tpu_torch.models import vit as p_vit
from rag_docvqa_tpu_torch.models import vt5 as p_vt5
from rag_docvqa_tpu_torch.models.embeddings import SpatialConfig

transformers = pytest.importorskip("transformers")
torch.set_num_threads(2)

T5_KW = dict(vocab_size=128, d_model=32, d_kv=8, num_heads=4, d_ff=64, num_encoder_layers=2, num_decoder_layers=2,
             dropout_rate=0.0)
HI_KW = dict(page_tokens=4, max_doc_pages=4, page_seq_len=48)


@pytest.fixture(scope="module")
def hf_t5():
    torch.manual_seed(0)
    return transformers.T5ForConditionalGeneration(transformers.T5Config(
        vocab_size=128, d_model=32, d_kv=8, num_heads=4, d_ff=64, num_layers=2, num_decoder_layers=2,
        dropout_rate=0.0, feed_forward_proj="relu", tie_word_embeddings=True, decoder_start_token_id=0)).eval()


def _save(form, d, model):
    from safetensors.torch import save_file

    d.mkdir()
    sd = {k: v.clone().contiguous() for k, v in model.state_dict().items()}
    if form == "f32":
        model.save_pretrained(d)
    elif form == "bf16":
        save_file({k: v.bfloat16() for k, v in sd.items()}, d / "model.safetensors")
    elif form == "sharded":
        keys = sorted(sd)
        names = ("model-00001-of-00002.safetensors", "model-00002-of-00002.safetensors")
        parts = (keys[:len(keys) // 2], keys[len(keys) // 2:])
        for name, part in zip(names, parts):
            save_file({k: sd[k] for k in part}, d / name)
        weight_map = {k: name for name, part in zip(names, parts) for k in part}
        (d / "model.safetensors.index.json").write_text(json.dumps({"weight_map": weight_map}))
    else:
        model.save_pretrained(d, safe_serialization=False)
        assert (d / "pytorch_model.bin").exists()
    return sd


def _same_tree(got, want):
    gl, wl = jax.tree_util.tree_leaves_with_path(got), jax.tree_util.tree_leaves_with_path(want)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for (path, w), (_, g) in zip(wl, gl):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("form", ["f32", "bf16", "sharded", "bin"])
def test_read_state_dict_matches_jax(form, tmp_path, hf_t5):
    d = tmp_path / form
    sd = _save(form, d, hf_t5)
    got, want = p_loader.read_state_dict(str(d)), j_loader.read_state_dict(str(d))
    assert set(got) == set(want) and "shared.weight" in got
    for k in want:
        assert got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k], np.float32), err_msg=k)
    ref = sd["shared.weight"].bfloat16().float() if form == "bf16" else sd["shared.weight"]
    np.testing.assert_array_equal(got["shared.weight"], ref.numpy())
    # the converted T5 trees are equal too
    _same_tree(p_convert.convert_t5_state_dict(got, p_t5.T5Config(**T5_KW)),
               j_loader.convert_vt5_checkpoint(want, j_vt5.VT5Config(t5=j_t5.T5Config(**T5_KW)))["t5"])


def test_torch_state_dict_to_numpy_matches_jax(hf_t5):
    """A module's state dict as the JAX helper gives it; a mapping of tensors
    with bf16 floats as f32 and its integers kept."""
    from rag_docvqa_tpu.models.convert import torch_state_dict_to_numpy as j_to_numpy

    got, want = p_convert.torch_state_dict_to_numpy(hf_t5.state_dict()), j_to_numpy(hf_t5)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    w = torch.randn(3, 5, generator=torch.Generator().manual_seed(0))
    got = p_convert.torch_state_dict_to_numpy({"w": w.bfloat16(), "ids": torch.arange(4)})
    assert got["w"].dtype == np.float32 and got["ids"].dtype == np.int64
    np.testing.assert_array_equal(got["w"], w.bfloat16().float().numpy())
    np.testing.assert_array_equal(got["ids"], np.arange(4))


def test_safetensors_reader_dtypes(tmp_path):
    """F16, F64 and BF16 into f32; the integer and bool types as they are;
    the header's metadata skipped."""
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, generator=g)
    tensors = {"f16": x.half(), "f64": x.double(), "bf16": x.bfloat16(), "i64": torch.arange(6).reshape(2, 3),
               "i32": torch.arange(4, dtype=torch.int32), "i8": torch.tensor([-128, 0, 127], dtype=torch.int8),
               "u8": torch.tensor([0, 255], dtype=torch.uint8), "b": torch.tensor([True, False])}
    save_file(tensors, tmp_path / "m.safetensors", metadata={"format": "pt"})
    got = p_loader.read_safetensors(str(tmp_path / "m.safetensors"))
    assert set(got) == set(tensors)
    for k, t in tensors.items():
        want = t.float().numpy() if t.is_floating_point() else t.numpy()
        assert got[k].dtype == want.dtype and got[k].shape == want.shape, k
        np.testing.assert_array_equal(got[k], want, err_msg=k)


def _vt5_state_dict(hf_t5, d_model=32, extra=()):
    rng = np.random.RandomState(1)
    sd = {f"language_backbone.{k}": v.numpy() for k, v in hf_t5.state_dict().items()}
    sd.update({
        "spatial_embedding.x_position_embeddings.weight": rng.randn(1024, d_model).astype(np.float32),
        "spatial_embedding.y_position_embeddings.weight": rng.randn(1024, d_model).astype(np.float32),
        "spatial_embedding.LayerNorm.weight": rng.rand(d_model).astype(np.float32) + 0.5,
        "spatial_embedding.LayerNorm.bias": rng.randn(d_model).astype(np.float32),
        "spatial_embedding.spatial_emb_matcher.layers.0.weight": rng.randn(d_model, d_model).astype(np.float32),
        "spatial_embedding.spatial_emb_matcher.layers.0.bias": rng.randn(d_model).astype(np.float32),
    })
    sd.update(dict(extra))
    return sd


def _write(sd, d):
    from safetensors.numpy import save_file

    d.mkdir()
    save_file({k: np.ascontiguousarray(v) for k, v in sd.items()}, str(d / "model.safetensors"))
    return str(d)


def test_vt5_checkpoint_matches_jax(tmp_path, hf_t5):
    """The reference VT5 module layout, with the visual branch, converts to
    JAX's tree; loaded over random VT5Params it replaces what the checkpoint
    holds and keeps the rest."""
    hf_vit = transformers.ViTModel(transformers.ViTConfig(
        hidden_size=16, num_hidden_layers=1, num_attention_heads=2, intermediate_size=32, image_size=16,
        patch_size=8), add_pooling_layer=False)
    vis = {f"visual_embedding.image_model.{k}": v.detach().numpy() for k, v in hf_vit.state_dict().items()}
    rng = np.random.RandomState(2)
    vis["visual_embedding.visual_emb_matcher.layers.0.weight"] = rng.randn(32, 16).astype(np.float32)
    vis["visual_embedding.visual_emb_matcher.layers.0.bias"] = rng.randn(32).astype(np.float32)
    sd = _vt5_state_dict(hf_t5, extra=vis.items())
    vit_kw = dict(hidden_size=16, num_layers=1, num_heads=2, mlp_dim=32, patch_size=8, image_size=16)
    jcfg = j_vt5.VT5Config(t5=j_t5.T5Config(**T5_KW), spatial=JSpatialConfig(hidden_size=32),
                           vit=j_vit.ViTConfig(**vit_kw), use_visual=True)
    pcfg = p_vt5.VT5Config(t5=p_t5.T5Config(**T5_KW), spatial=SpatialConfig(hidden_size=32),
                           vit=p_vit.ViTConfig(**vit_kw), use_visual=True)
    got, want = p_loader.convert_vt5_checkpoint(sd, pcfg), j_loader.convert_vt5_checkpoint(sd, jcfg)
    assert set(got) == {"t5", "spatial", "visual"}
    _same_tree(got, want)
    d = _write(sd, tmp_path / "vt5")
    _same_tree(p_loader.load_vt5_params(d, pcfg), j_loader.load_vt5_params(d, jcfg))
    init = p_vt5.init_vt5_params(torch.Generator().manual_seed(3), pcfg)
    init_tree = p_params.to_jax(init)
    loaded = p_loader.load_vt5_params(d, pcfg, init)
    assert isinstance(loaded, p_vt5.VT5Params)
    _same_tree(p_params.to_jax(loaded), j_loader._merge(init_tree, want))
    # bf16 parameters stay bf16
    assert p_loader.load_vt5_params(d, pcfg, init.to(torch.bfloat16)).t5.shared.dtype == torch.bfloat16


def _hivt5_state_dict(hf_t5, rng_seed=4):
    rng = np.random.RandomState(rng_seed)
    P, K, d = HI_KW["max_doc_pages"], HI_KW["page_tokens"], 32
    return _vt5_state_dict(hf_t5, extra={
        "retrieval_module.page_retrieval.weight": rng.randn(P, P * K * d).astype(np.float32) * 0.02,
        "retrieval_module.page_retrieval.bias": rng.randn(P).astype(np.float32),
    }.items())


def test_hivt5_checkpoint_page_head_reaches_the_page_logits(tmp_path, hf_t5):
    """F7: the JAX loader writes the converted page head to "ret_head", which
    `page_retrieval_logits` never reads, so the JAX tree keeps its random
    `page_head`; the port loads it into `page_head`, and the page logits are
    the checkpoint head's. Everything else equals JAX's tree."""
    sd = _hivt5_state_dict(hf_t5)
    d = _write(sd, tmp_path / "hivt5")
    jcfg = j_hivt5.HiVT5Config(t5=j_t5.T5Config(**T5_KW), spatial=JSpatialConfig(hidden_size=32), **HI_KW)
    pcfg = p_hivt5.HiVT5Config(t5=p_t5.T5Config(**T5_KW), spatial=SpatialConfig(hidden_size=32), **HI_KW)
    got, want = p_loader.load_hivt5_params(d, pcfg), j_loader.load_hivt5_params(d, jcfg)
    assert set(want) == {"t5", "spatial", "ret_head"} and set(got) == {"t5", "spatial", "page_head"}
    _same_tree(got["page_head"], want["ret_head"])
    _same_tree({k: v for k, v in got.items() if k != "page_head"}, {k: v for k, v in want.items() if k != "ret_head"})

    jinit = jax.tree.map(np.asarray, j_hivt5.init_hivt5_params(jax.random.PRNGKey(0), jcfg))
    jmerged = j_loader.load_hivt5_params(d, jcfg, jinit)
    np.testing.assert_array_equal(np.asarray(jmerged["page_head"]["kernel"]), jinit["page_head"]["kernel"])
    assert not np.allclose(np.asarray(jmerged["page_head"]["kernel"]), sd["retrieval_module.page_retrieval.weight"].T)

    port = p_loader.load_params_for("hivt5", d, pcfg, p_params.hivt5_from_jax(jinit))
    assert isinstance(port, p_hivt5.HiVT5Params)
    np.testing.assert_array_equal(port.page_head.weight.numpy(), sd["retrieval_module.page_retrieval.weight"])
    np.testing.assert_array_equal(port.page_emb.numpy(), jinit["page_emb"])  # not in the checkpoint: kept
    emb = torch.randn((2, 16, 32), generator=torch.Generator().manual_seed(5))
    want_logits = emb.reshape(2, -1).numpy() @ sd["retrieval_module.page_retrieval.weight"].T \
        + sd["retrieval_module.page_retrieval.bias"]
    np.testing.assert_allclose(p_hivt5.page_retrieval_logits(port, pcfg, emb).numpy(), want_logits, rtol=1e-5,
                               atol=1e-6)


# --------------------------------------------------------------------------- #
# key coverage, as tests/test_converter_key_coverage.py
# --------------------------------------------------------------------------- #
class RecordingSD(dict):
    def __init__(self, base):
        super().__init__(base)
        self.accessed = set()

    def __getitem__(self, k):
        self.accessed.add(k)
        return super().__getitem__(k)


def _shapes(tree):
    return {jax.tree_util.keystr(p): np.shape(v) for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _fits(converted, init):
    """Every converted leaf exists in the init tree with the same shape."""
    have = _shapes(init)
    for path, shape in _shapes(converted).items():
        assert have.get(path) == shape, (path, shape, have.get(path))


def test_t5_base_keys():
    """The port's T5 converter consumes every key of the t5-base template (12
    + 12 layers, tiny widths) but the tied duplicates, and its tree fits the
    port's T5 parameters."""
    hf = transformers.T5ForConditionalGeneration(transformers.T5Config(
        vocab_size=64, d_model=16, d_kv=4, num_heads=4, d_ff=32, num_layers=12, num_decoder_layers=12,
        feed_forward_proj="relu", tie_word_embeddings=True))
    cfg = p_t5.T5Config(vocab_size=64, d_model=16, d_kv=4, num_heads=4, d_ff=32)
    sd = RecordingSD({k: v.numpy() for k, v in hf.state_dict().items()})
    out = p_convert.convert_t5_state_dict(sd, cfg)
    left = set(sd) - sd.accessed - {"encoder.embed_tokens.weight", "decoder.embed_tokens.weight", "lm_head.weight"}
    assert not left, sorted(left)[:10]
    _fits(out, p_params.t5_to_jax(p_t5.init_t5_params(torch.Generator().manual_seed(0), cfg)))
    _same_tree(out, j_loader.convert_vt5_checkpoint(dict(sd), j_vt5.VT5Config(t5=j_t5.T5Config(
        vocab_size=64, d_model=16, d_kv=4, num_heads=4, d_ff=32)))["t5"])


def test_reference_vt5_module_keys():
    """The reference VT5 layout at t5-base depth and a 12-layer ViT: every
    module lands in the tree, which fits the port's VT5 parameters."""
    hf = transformers.T5ForConditionalGeneration(transformers.T5Config(
        vocab_size=64, d_model=16, d_kv=4, num_heads=4, d_ff=32, num_layers=12, num_decoder_layers=12,
        feed_forward_proj="relu", tie_word_embeddings=True))
    hf_vit = transformers.ViTModel(transformers.ViTConfig(
        hidden_size=32, num_hidden_layers=12, num_attention_heads=4, intermediate_size=64, image_size=32,
        patch_size=16), add_pooling_layer=False)
    rng = np.random.RandomState(0)
    sd = {f"language_backbone.{k}": v.numpy() for k, v in hf.state_dict().items()}
    sd.update({
        "spatial_embedding.x_position_embeddings.weight": rng.randn(1024, 16).astype(np.float32),
        "spatial_embedding.y_position_embeddings.weight": rng.randn(1024, 16).astype(np.float32),
        "spatial_embedding.LayerNorm.weight": np.ones(16, np.float32),
        "spatial_embedding.LayerNorm.bias": np.zeros(16, np.float32),
        "spatial_embedding.spatial_emb_matcher.layers.0.weight": rng.randn(16, 16).astype(np.float32),
        "spatial_embedding.spatial_emb_matcher.layers.0.bias": np.zeros(16, np.float32),
        "visual_embedding.visual_emb_matcher.layers.0.weight": rng.randn(16, 32).astype(np.float32),
        "visual_embedding.visual_emb_matcher.layers.0.bias": np.zeros(16, np.float32),
    })
    sd.update({f"visual_embedding.image_model.{k}": v.detach().numpy() for k, v in hf_vit.state_dict().items()})
    vit_kw = dict(hidden_size=32, num_layers=12, num_heads=4, mlp_dim=64, image_size=32, patch_size=16)
    cfg = p_vt5.VT5Config(t5=p_t5.T5Config(vocab_size=64, d_model=16, d_kv=4, num_heads=4, d_ff=32),
                          spatial=SpatialConfig(hidden_size=16), vit=p_vit.ViTConfig(**vit_kw), use_visual=True)
    out = p_loader.convert_vt5_checkpoint(sd, cfg)
    assert set(out) == {"t5", "spatial", "visual"}
    np.testing.assert_array_equal(out["spatial"]["x_emb"], sd["spatial_embedding.x_position_embeddings.weight"])
    np.testing.assert_array_equal(out["spatial"]["matcher"]["kernel"],
                                  sd["spatial_embedding.spatial_emb_matcher.layers.0.weight"].T)
    np.testing.assert_array_equal(out["visual"]["matcher"]["kernel"],
                                  sd["visual_embedding.visual_emb_matcher.layers.0.weight"].T)
    np.testing.assert_array_equal(out["t5"]["shared"], sd["language_backbone.shared.weight"])
    _fits(out, p_params.to_jax(p_vt5.init_vt5_params(torch.Generator().manual_seed(0), cfg)))


# --------------------------------------------------------------------------- #
# tokenizers
# --------------------------------------------------------------------------- #
def test_byte_tokenizer_matches_jax():
    j, p = JByteTokenizer(), ByteTokenizer()
    assert p.vocab_size == j.vocab_size == 259
    for text in ("what is the total ?", "  naïve   café 42 ", "", "日本 語", "a"):
        assert p.encode(text) == j.encode(text), text
        assert p.decode(p.encode(text)) == j.decode(j.encode(text)) == " ".join(text.split())
        for w in text.split():
            assert p.encode_word(w) == j.encode_word(w)
    assert p.decode([0, 1, 2, 300, 3 + ord("x")]) == j.decode([0, 1, 2, 300, 3 + ord("x")]) == "x"
    assert isinstance(p_config.load_tokenizer("byte"), ByteTokenizer)


@pytest.fixture(scope="module")
def hf_tokenizer_dir(tmp_path_factory):
    """A word-level tokenizer made in memory with `tokenizers`, saved as a
    Hugging Face tokenizer directory."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    words = ["<pad>", "</s>", "<unk>", "what", "is", "the", "total", "?", "val42", "date", "of", "invoice"]
    tk = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)}, unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.Whitespace()
    fast = transformers.PreTrainedTokenizerFast(tokenizer_object=tk, pad_token="<pad>", eos_token="</s>",
                                                unk_token="<unk>")
    d = tmp_path_factory.mktemp("hf_tok")
    fast.save_pretrained(str(d))
    return str(d)


def test_hf_tokenizer_matches_jax(hf_tokenizer_dir):
    j, p = JHFTokenizer(hf_tokenizer_dir), p_config.load_tokenizer(hf_tokenizer_dir)
    assert isinstance(p, HFTokenizer)
    assert (p.vocab_size, p.pad_id, p.eos_id, p.unk_id) == (j.vocab_size, j.pad_id, j.eos_id, j.unk_id) == (12, 0, 1, 2)
    for text in ("what is the total ?", "the date of invoice is val42", "unknown words here"):
        assert p.encode(text) == j.encode(text), text
        for w in text.split():
            assert p.encode_word(w) == j.encode_word(w), w
        assert p.decode(p.encode(text)) == j.decode(j.encode(text))
    assert p.encode("what is") == [3, 4] and p.decode([3, 4, 1, 0]) == j.decode([3, 4, 1, 0])


def test_hf_tokenizer_names_the_missing_package(monkeypatch, hf_tokenizer_dir):
    """Where `transformers` is not installed (the card's machine), building an
    HFTokenizer raises an ImportError naming it; nothing falls back."""
    import sys

    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        HFTokenizer(hf_tokenizer_dir)
    with pytest.raises(ImportError, match="transformers"):
        p_config.load_tokenizer(hf_tokenizer_dir)
    assert isinstance(p_config.load_tokenizer("hash:64"), HashTokenizer)


# --------------------------------------------------------------------------- #
# the port's own checkpoints, the reranker's weights, the CLIs' --hf-weights
# --------------------------------------------------------------------------- #
def test_port_checkpoint_through_load_params_for(tmp_path):
    """A directory `training/checkpoint.py` wrote reads back through
    `load_params_for`: the best step, and the latest where no step has
    metrics."""
    from rag_docvqa_tpu_torch.training.checkpoint import CheckpointManager
    from rag_docvqa_tpu_torch.training.train_step import TrainState

    cfg = p_hivt5.HiVT5Config(t5=p_t5.T5Config(**T5_KW), spatial=SpatialConfig(hidden_size=32), **HI_KW)
    made = [p_hivt5.init_hivt5_params(torch.Generator().manual_seed(s), cfg) for s in range(3)]
    best = CheckpointManager(str(tmp_path / "best"))
    for step, (p, acc) in enumerate(zip(made, (0.2, 0.9, 0.5)), start=1):
        best.save(step, TrainState(params=p, opt_state={}, step=step), metrics={"accuracy": acc})
    latest = CheckpointManager(str(tmp_path / "latest"))
    for step, p in enumerate(made, start=1):
        latest.save(step, TrainState(params=p, opt_state={}, step=step))
    like = lambda: p_hivt5.init_hivt5_params(torch.Generator().manual_seed(9), cfg)
    for d, want in (("best", made[1]), ("latest", made[2])):
        got = p_loader.load_params_for("hivt5", str(tmp_path / d), cfg, like())
        for (name, a), (_, b) in zip(got.state_dict().items(), want.state_dict().items()):
            assert torch.equal(a, b), (d, name)
    # the CLIs' `--ckpt` takes the same route
    from rag_docvqa_tpu_torch.train import init_params

    got = init_params({"seed": 9, "ckpt": str(tmp_path / "best")}, cfg, "cpu", kind="hivt5")
    for (name, a), (_, b) in zip(got.state_dict().items(), made[1].state_dict().items()):
        assert torch.equal(a, b), ("init_params", name)
    with pytest.raises(FileNotFoundError):
        p_loader.load_checkpoint_params(str(tmp_path / "missing"), like())
    # the qwen kind reads a Hugging Face directory now (tests/test_torch_causal_lm.py); a missing one says so
    with pytest.raises(FileNotFoundError, match="checkpoint path not found"):
        p_loader.load_params_for("qwen", str(tmp_path / "none"), cfg)


def test_reranker_from_a_local_weight_directory(tmp_path):
    """`reranker_weights` naming a local XLM-R cross-encoder directory: its
    weights, converted as the JAX converter converts them, in place of the
    random ones."""
    from rag_docvqa_tpu.models.bert import BertConfig as JBertConfig
    from rag_docvqa_tpu.models.bert import convert_bert_state_dict as j_convert_bert

    torch.manual_seed(0)
    hf = transformers.XLMRobertaForSequenceClassification(transformers.XLMRobertaConfig(
        vocab_size=96, hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=48,
        max_position_embeddings=80, num_labels=1))
    d = tmp_path / "reranker"
    hf.save_pretrained(d)
    c = dict(reranker_weights=str(d), reranker_d_model=32, reranker_num_layers=2, reranker_num_heads=4,
             reranker_d_ff=48)
    rr = p_config.build_reranker(c, HashTokenizer(96), device="cpu")
    sd = j_loader.read_state_dict(str(d))
    jcfg = JBertConfig(vocab_size=96, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=48, num_labels=1)
    _same_tree(p_params.bert_to_jax(rr.params), j_convert_bert(sd, jcfg, prefix="roberta."))


def test_eval_cli_hf_weights_matches_root_eval(tmp_path, capsys, hf_t5):
    """`--hf-weights` on a VT5 checkpoint (language_backbone + spatial
    modules, the T5 config.json beside it; a bf16-exact encoder rel-pos
    table): the port's eval CLI gives the root `eval.py`'s summary. Both
    take the checkpoint's widths and a hash tokenizer at its vocabulary."""
    import eval as root_eval
    from rag_docvqa_tpu_torch import eval as p_eval

    sd = _vt5_state_dict(hf_t5)
    k = "language_backbone.encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"
    sd[k] = torch.from_numpy(sd[k]).bfloat16().float().numpy()
    d = _write(sd, tmp_path / "vt5")
    hf_t5.config.to_json_file(str(tmp_path / "vt5" / "config.json"))
    args = ["-m", "configs/VT5_tiny.yml", "-d", "configs/Synthetic.yml", "--hf-weights", d, "n_val_docs=4",
            "page_retrieval=maxconf"]
    want = root_eval.main(args + ["--platform", "cpu"])
    got = p_eval.main(args + ["--device", "cpu"])
    capsys.readouterr()
    for key in ("accuracy", "anls", "retrieval_precision", "chunk_score", "n_samples", "page_retrieval"):
        if isinstance(want[0][key], float):
            np.testing.assert_allclose(got[0][key], want[0][key], rtol=1e-6, err_msg=key)
        else:
            assert got[0][key] == want[0][key], key
