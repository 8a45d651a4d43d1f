"""Port parity, the corpus index as a whole: `parallel/index.py` and the
`precompute` CLI of the port against the JAX package, on the CPU.

The JAX `ShardedIndex` runs on the 8 virtual CPU devices of conftest.py
(shard_map, all-gather and merge really execute); the port runs the same
index as 8 row ranges of one tensor. Quantized and bf16 indexes are built
once by the JAX package and carried over with `params.index_from_numpy`, so
both packages query one and the same stored index and a quantizer's last bit
cannot show up as a query difference. Tolerances: indices equal; float
values 1e-5 (two CPU matmuls in another order); quantized values 1e-6
relative (each package normalizes the f32 query itself)."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_docvqa_tpu.parallel import ShardedIndex as JShardedIndex
from rag_docvqa_tpu.parallel import create_mesh
from rag_docvqa_tpu.parallel.index import single_device_query as j_single_device_query
from rag_docvqa_tpu_torch import params as p_params
from rag_docvqa_tpu_torch import precompute as p_precompute
from rag_docvqa_tpu_torch.ops import topk as p_topk
from rag_docvqa_tpu_torch.parallel import ShardedIndex, single_device_query

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOAT_TOL = 1e-5
QUANT_RTOL = 1e-6


@pytest.fixture(scope="module")
def mesh():
    return create_mesh((8, 1), ("data", "model"))


def _data(n, d, b, seed, dups=()):
    rng = np.random.RandomState(seed)
    emb = rng.randn(n, d).astype(np.float32)
    for src, dst in dups:
        emb[dst] = emb[src]
    q = rng.randn(b, d).astype(np.float32)
    if dups:
        q[0] = emb[dups[0][0]]
    return emb, q


def _carry(jidx: JShardedIndex, dtype: str, n_shards: int = 8, **kw) -> ShardedIndex:
    """A built JAX index -> the port's, through numpy."""
    emb = jidx.embeddings.astype(jnp.float32) if dtype == "bf16" else jidx.embeddings
    return p_params.index_from_numpy(
        np.asarray(emb), None if jidx.scales is None else np.asarray(jidx.scales), n_valid=jidx.n_valid,
        dtype=dtype, n_shards=n_shards, tile_n=jidx.tile_n, host_rows=jidx.host_rows,
        refine_kprime=jidx.refine_kprime, **kw)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(got, want, atol=FLOAT_TOL, rtol=0.0):
    (gv, gi, gok), (wv, wi, wok) = map(lambda t: tuple(map(_np, t)), (got, want))
    np.testing.assert_array_equal(gok, wok)
    np.testing.assert_array_equal(gi[wok], wi[wok])
    np.testing.assert_allclose(gv, wv, rtol=rtol, atol=atol)


# rows 3, 130 and 700 lie in different shards of an 8-way split of 1024
DUPS = ((3, 7), (3, 130), (3, 700))
SIZES = {"n1000_d64_b4_k5": (1000, 64, 4, 5), "n777_d32_b2_k16": (777, 32, 2, 16)}
FLOAT_MODES = {
    # name: (dtype, JAX use_pallas, kernel)
    "f32_flat": ("f32", False, "merge"),
    "f32_merge": ("f32", True, "merge"),
    "f32_twophase": ("f32", True, "twophase"),
    "bf16_merge": ("bf16", True, "merge"),
}


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("mode", FLOAT_MODES)
def test_sharded_float_index_matches_jax(mesh, mode, size):
    dtype, use_kernel, kernel = FLOAT_MODES[mode]
    n, d, b, k = SIZES[size]
    emb, q = _data(n, d, b, seed=n, dups=DUPS)
    jidx = dataclasses.replace(JShardedIndex.build(jnp.asarray(emb), mesh, tile_n=64, use_pallas=use_kernel,
                                                   dtype=dtype), kernel=kernel)
    want = jidx.query(jnp.asarray(q), k)
    got = _carry(jidx, dtype, use_kernel=use_kernel, kernel=kernel).query(q, k)
    _same(got, want)
    assert got[1].dtype == torch.int32
    if dtype == "f32":
        # the port's own build of the same rows, and the unsharded reference
        own = ShardedIndex.build(emb, n_shards=8, tile_n=64, use_kernel=use_kernel, kernel=kernel)
        assert own.embeddings.shape == tuple(jidx.embeddings.shape) and own.n_valid == jidx.n_valid
        np.testing.assert_allclose(own.embeddings.numpy(), np.asarray(jidx.embeddings), rtol=0, atol=1e-6)
        _same(own.query(q, k), want)
        _same(single_device_query(torch.from_numpy(emb), torch.from_numpy(q), k), want)
        _same(single_device_query(torch.from_numpy(emb), torch.from_numpy(q), k),
              j_single_device_query(jnp.asarray(emb), jnp.asarray(q), k))


QUANT_MODES = {
    # name: (dtype, refine, refine_kprime)
    "int8": ("int8", False, 48),
    "int4": ("int4", False, 48),
    "int4_refine": ("int4", True, 48),
    "int8_refine": ("int8", True, 24),
    "int4_refine_kprime_caps_at_shard": ("int4", True, 4096),
}


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("mode", QUANT_MODES)
def test_sharded_quantized_index_matches_jax(mesh, mode, size):
    dtype, refine, kprime = QUANT_MODES[mode]
    n, d, b, k = SIZES[size]
    emb, q = _data(n, d, b, seed=n + 1, dups=DUPS)
    jidx = JShardedIndex.build(jnp.asarray(emb), mesh, tile_n=64, dtype=dtype, refine=refine, refine_kprime=kprime)
    want = jidx.query(jnp.asarray(q), k)
    pidx = _carry(jidx, dtype)
    assert pidx.packed == (dtype == "int4") and pidx.embeddings.dtype == torch.int8
    got = pidx.query(q, k)
    if refine:  # numpy (vals, idx, valid) from the host rescore in both
        assert all(isinstance(a, np.ndarray) for a in got)
        _same(got, want, atol=1e-6)
    else:
        _same(got, want, atol=0.0, rtol=QUANT_RTOL)
    # the port's own quantizer gives an index of the same layout that
    # retrieves (nearly) the same rows
    own = ShardedIndex.build(emb, n_shards=8, tile_n=64, dtype=dtype, refine=refine, refine_kprime=kprime)
    assert own.embeddings.shape == tuple(jidx.embeddings.shape) and own.scales.shape == tuple(jidx.scales.shape)
    np.testing.assert_allclose(own.scales.numpy(), np.asarray(jidx.scales), rtol=1e-6, atol=0)
    oi, wi = _np(own.query(q, k)[1]), _np(want[1])
    overlap = np.mean([len(set(oi[r]) & set(wi[r])) / k for r in range(b)])
    assert overlap >= 0.9, overlap


@pytest.mark.parametrize("kernel", ["merge", "twophase"])
def test_bf16_index_query_matches_jax_xla(kernel):
    """A bf16 ShardedIndex (the rows whose kernels score on the tensor cores
    with three-term queries) queried through K4's or K5's route on the CPU
    gives the JAX `cosine_topk_xla` answer on the same bf16 rows."""
    from rag_docvqa_tpu.ops import topk as j_topk

    emb, q = _data(2048, 64, 20, seed=9, dups=DUPS)
    idx = ShardedIndex.build(emb, n_shards=4, tile_n=128, dtype="bf16", kernel=kernel)
    assert idx.embeddings.dtype == torch.bfloat16
    rows = idx.embeddings.float().numpy()
    mask = np.arange(rows.shape[0]) < idx.n_valid
    want = j_topk.cosine_topk_xla(jnp.asarray(rows), jnp.asarray(q), 10, index_mask=jnp.asarray(mask))
    _same(idx.query(q, 10), want)


def test_small_index_fewer_rows_than_k(mesh):
    emb, q = _data(3, 16, 2, seed=0)
    for dtype in ("f32", "bf16", "int8", "int4"):
        jidx = JShardedIndex.build(jnp.asarray(emb), mesh, tile_n=128, use_pallas=False, dtype=dtype)
        want = jidx.query(jnp.asarray(q), 8)
        for pidx in (_carry(jidx, dtype, use_kernel=False),
                     ShardedIndex.build(emb, n_shards=8, tile_n=128, use_kernel=False, dtype=dtype)):
            vals, idx, valid = pidx.query(q, 8)
            assert valid.tolist() == [[True] * 3 + [False] * 5] * 2 == np.asarray(want[2]).tolist()
            assert set(idx[0, :3].tolist()) == {0, 1, 2}
            # slots without a row keep the raw sentinel, unscaled
            assert (vals[:, 3:] == -1e30).all() and (np.asarray(want[0])[:, 3:] == np.float32(-1e30)).all()


SHARD_MODES = {
    "f32_flat": dict(dtype="f32", use_kernel=False),
    "f32_merge": dict(dtype="f32", kernel="merge"),
    "f32_twophase": dict(dtype="f32", kernel="twophase"),
    "f32_auto": dict(dtype="f32", kernel="auto"),
    "bf16_merge": dict(dtype="bf16"),
    "int8": dict(dtype="int8"),
    "int4": dict(dtype="int4"),
    "int4_refine": dict(dtype="int4", refine=True),
}


@pytest.mark.parametrize("mode", SHARD_MODES)
def test_shard_count_does_not_change_the_result(mode):
    """n_shards 1, 4 and 8 over the same rows: identical indices, values and
    validity, ties across shard boundaries included (one padding each: all
    three pad 1000 rows to 1024)."""
    emb, q = _data(1000, 64, 6, seed=3, dups=DUPS)
    results = [tuple(map(_np, ShardedIndex.build(emb, n_shards=s, tile_n=128, **SHARD_MODES[mode]).query(q, 10)))
               for s in (1, 4, 8)]
    for other in results[1:]:
        for a, b in zip(results[0], other):
            np.testing.assert_array_equal(a, b)
    # the duplicated rows tie; the lowest index comes first
    first = results[0][1][0].tolist()
    present = [i for i in (3, 7, 130, 700) if i in first]
    assert present == sorted(present) and len(present) >= 2


def test_index_layout_and_resident_bytes():
    emb, _ = _data(1000, 64, 1, seed=4)
    sizes = {dt: ShardedIndex.build(emb, n_shards=4, tile_n=128, dtype=dt) for dt in ("f32", "bf16", "int8", "int4")}
    assert sizes["f32"].embeddings.shape == (1024, 64) and sizes["int4"].embeddings.shape == (1024, 32)
    assert sizes["f32"].resident_bytes == 1024 * 64 * 4
    assert sizes["bf16"].resident_bytes == 1024 * 64 * 2
    assert sizes["int8"].resident_bytes == 1024 * 64 + 1024 * 4
    assert sizes["int4"].resident_bytes == 1024 * 32 + 1024 * 4
    assert [list(r)[1:] for r in ShardedIndex.build(emb, n_shards=4, tile_n=128)._shards()] == \
        [[slice(0, 256), 256], [slice(256, 512), 256], [slice(512, 768), 256], [slice(768, 1024), 232]]
    # a logical shard may hold no valid row at all
    short = ShardedIndex.build(emb[:100], n_shards=4, tile_n=64)
    assert [v for _, _, v in short._shards()] == [64, 36, 0, 0]


def test_index_from_numpy_and_build_refuse_bad_arguments():
    emb, q = _data(64, 16, 1, seed=5)
    with pytest.raises(ValueError, match="unknown index dtype"):
        ShardedIndex.build(emb, dtype="fp8")
    with pytest.raises(ValueError, match="unknown index dtype"):
        p_params.index_from_numpy(emb, n_valid=64, dtype="fp8")
    with pytest.raises(ValueError, match="int8 rows and their scales"):
        p_params.index_from_numpy(emb, n_valid=64, dtype="int8")
    with pytest.raises(ValueError, match="unknown per-shard kernel"):
        ShardedIndex.build(emb, tile_n=64, kernel="other").query(q, 3)
    # CPU tensors never reach a kernel: "auto" is the flat version here
    padded, n_valid = p_topk.pad_index(torch.from_numpy(emb), 64)
    assert n_valid == 64 and padded.shape == (64, 16)


# --------------------------------------------------------------------------- #
# the CLI
# --------------------------------------------------------------------------- #
MODEL, DATASET = "configs/VT5_tiny.yml", "configs/Synthetic.yml"
QUESTION = "what is the total amount due?"


def _ranks(text: str):
    rows = [json.loads(l) for l in text.strip().splitlines() if l.startswith("{") and '"rank"' in l]
    assert [r["rank"] for r in rows] == list(range(len(rows)))
    return rows


def _same_ranks(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "score"} == {k: v for k, v in w.items() if k != "score"}
        assert abs(g["score"] - w["score"]) <= 1.5e-4  # both print 4 decimals


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    """Each CLI's `index` run on the synthetic corpus, in this process: the
    JAX one with its own random weights, the port's with those weights
    carried over, so one table embeds chunks and questions in both."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import precompute as j_precompute

    from rag_docvqa_tpu.config import build_vt5_config as j_build_vt5_config
    from rag_docvqa_tpu.config import load_config as j_load_config
    from rag_docvqa_tpu.data import load_tokenizer as j_load_tokenizer
    from rag_docvqa_tpu.models import vt5 as j_vt5
    from rag_docvqa_tpu_torch.models import vt5 as p_vt5

    cwd = os.getcwd()
    os.chdir(REPO)
    mp = pytest.MonkeyPatch()
    try:
        config = j_load_config(model=MODEL, dataset=DATASET)
        jcfg = j_build_vt5_config(config, j_load_tokenizer(config.get("tokenizer")).vocab_size)
        tree = jax.tree.map(np.asarray, j_vt5.init_vt5_params(jax.random.PRNGKey(config["seed"]), jcfg))
        mp.setattr(p_vt5, "init_vt5_params", lambda g, cfg: p_params.from_jax(tree, device=g.device))
        tmp = tmp_path_factory.mktemp("index")
        j_npz, p_npz = str(tmp / "jax.npz"), str(tmp / "port.npz")
        j_precompute.main(["index", "-m", MODEL, "-d", DATASET, "--out", j_npz, "--platform", "cpu"])
        p_precompute.main(["index", "-m", MODEL, "-d", DATASET, "--out", p_npz, "--device", "cpu"])
        yield j_precompute, j_npz, p_npz
    finally:
        mp.undo()
        os.chdir(cwd)


def test_cli_index_files_agree(cli_files, capsys):
    _, j_npz, p_npz = cli_files
    j, p = np.load(j_npz, allow_pickle=True), np.load(p_npz, allow_pickle=True)
    assert sorted(j.files) == sorted(p.files) == ["embeddings", "meta"]
    assert json.loads(str(p["meta"])) == json.loads(str(j["meta"]))
    assert p["embeddings"].dtype == j["embeddings"].dtype == np.float32
    np.testing.assert_allclose(p["embeddings"], j["embeddings"], rtol=0, atol=1e-6)


CLI_DTYPES = {"f32": ["--index-dtype", "f32"], "bf16": ["--index-dtype", "bf16"], "int8": ["--index-dtype", "int8"],
              "int4": ["--index-dtype", "int4"], "int4_refine": ["--index-dtype", "int4", "--refine"],
              "f32_refine_is_ignored": ["--index-dtype", "f32", "--refine"]}


@pytest.mark.parametrize("mode", CLI_DTYPES)
def test_cli_query_reads_either_file(cli_files, capsys, mode):
    """`query` of both CLIs on both files: four runs, one answer."""
    j_precompute, j_npz, p_npz = cli_files
    capsys.readouterr()
    out = {}
    for npz in (j_npz, p_npz):
        j_precompute.main(["query", "--index", npz, "-m", MODEL, "-q", QUESTION, "--k", "5", "--platform", "cpu",
                           *CLI_DTYPES[mode]])
        out["jax", npz] = _ranks(capsys.readouterr().out)
        p_precompute.main(["query", "--index", npz, "-m", MODEL, "-q", QUESTION, "--k", "5", "--device", "cpu",
                           *CLI_DTYPES[mode]])
        out["port", npz] = _ranks(capsys.readouterr().out)
    assert len(out["jax", j_npz]) == 5
    assert set(out["jax", j_npz][0]) == {"rank", "score", "question_id", "doc_idx", "page", "text"}
    for key in (("port", p_npz), ("port", j_npz), ("jax", p_npz)):
        _same_ranks(out[key], out["jax", j_npz])


def test_cli_f32_ranks_are_the_unsharded_reference(cli_files, capsys):
    _, _, p_npz = cli_files
    from rag_docvqa_tpu_torch.config import load_config, load_tokenizer
    from rag_docvqa_tpu_torch.models import vt5 as p_vt5
    from rag_docvqa_tpu_torch.models.embedder import vt5_table_embed

    capsys.readouterr()
    p_precompute.main(["query", "--index", p_npz, "-m", MODEL, "-q", QUESTION, "--k", "7", "--device", "cpu"])
    rows = _ranks(capsys.readouterr().out)
    data = np.load(p_npz, allow_pickle=True)
    meta = json.loads(str(data["meta"]))
    tok = load_tokenizer(load_config(model=MODEL).get("tokenizer"))
    ids = tok.encode(QUESTION)[:64]
    shared = p_vt5.init_vt5_params(torch.Generator(), None).t5.shared  # the fixture's carried weights
    q = vt5_table_embed(shared, torch.tensor([ids]), torch.ones((1, len(ids)), dtype=torch.bool))
    _, idx, _ = single_device_query(torch.from_numpy(data["embeddings"]), q, 7)
    assert [{k: v for k, v in r.items() if k not in ("rank", "score")} for r in rows] == \
        [meta[int(i)] for i in idx[0]]


@pytest.mark.parametrize("cmd", ["index", "query"])
def test_cli_needs_a_gpu_unless_asked_for_the_cpu(tmp_path, cmd):
    """The default device is cuda; without one and without `--device cpu`
    the CLI exits non-zero and names the flag."""
    out = str(tmp_path / "x.npz")
    args = (["index", "-m", MODEL, "-d", DATASET, "--out", out] if cmd == "index"
            else ["query", "--index", out, "-m", MODEL, "-q", QUESTION])
    np.savez(out, embeddings=np.zeros((4, 32), np.float32), meta=json.dumps([{}] * 4))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-m", "rag_docvqa_tpu_torch.precompute", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode != 0 and "--device cpu" in proc.stderr
    assert '"rank"' not in proc.stdout and '"n_chunks"' not in proc.stdout


def test_train_cli_needs_a_gpu_unless_asked_for_the_cpu():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-m", "rag_docvqa_tpu_torch.train", "-m", MODEL, "-d", DATASET,
                           "--no-eval-start"], cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode != 0 and "--device cpu" in proc.stderr and "epoch=" not in proc.stdout


def test_cli_has_no_layouts_command(tmp_path):
    """The name is kept from when the `layouts` command waited for the
    layout detectors. It exists now (tests/test_torch_precompute_layouts.py
    holds it against the root CLI): a detector name the root CLI refuses is
    refused, and without a card the default device raises, naming
    `--device cpu`, instead of writing a file on the CPU."""
    with pytest.raises(SystemExit):
        p_precompute.main(["layouts", "-m", MODEL, "-d", DATASET, "--detector", "RCNN", "--out", "x"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            p_precompute.main(["layouts", "-m", MODEL, "-d", DATASET, "--out", str(tmp_path / "x.npz")])
        assert not (tmp_path / "x.npz").exists()
