"""Port parity, the noise-robustness experiment (`python -m
rag_docvqa_tpu_torch.noise_experiment --device cpu`) against the root
`noise_experiment.py --platform cpu` on configs/VT5_tiny.yml +
configs/Synthetic.yml, with the root CLI's own seeded weights (its encoder
rel-pos table rounded to bf16, which the port's encoder takes) carried over
with `params.from_jax`: the printed lines and the saved JSON equal (every
mean and standard deviation within 1e-6, relative; the keys and noise levels
exactly)."""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rag_docvqa_tpu.models import vt5 as j_vt5
from rag_docvqa_tpu_torch import params as p_params
from rag_docvqa_tpu_torch.models import vt5 as p_vt5

torch.set_num_threads(2)


def _same(got, want, where="result"):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            _same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12, err_msg=where)
    else:
        assert got == want, where


def test_noise_experiment_matches_root(tmp_path, monkeypatch, capsys):
    import noise_experiment as root_noise
    from rag_docvqa_tpu_torch import noise_experiment as p_noise

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
    args = ["-m", "configs/VT5_tiny.yml", "-d", "configs/Synthetic.yml", "n_val_docs=6", "--noise-pages", "0", "2",
            "--seeds", "0", "1"]
    want = root_noise.main(args + ["--platform", "cpu", "--save-path", str(tmp_path / "jax.json")])
    jlines = capsys.readouterr().out.strip().splitlines()
    got = p_noise.main(args + ["--device", "cpu", "--save-path", str(tmp_path / "port.json")])
    plines = capsys.readouterr().out.strip().splitlines()
    assert len(plines) == len(jlines) == 2
    for p, j in zip(plines, jlines):
        _same(json.loads(p), json.loads(j))
    _same(got, want)
    _same(json.loads((tmp_path / "port.json").read_text()), json.loads((tmp_path / "jax.json").read_text()))
    assert set(got) == {0, 2} and set(got[2]["by_seed_pages"]) == {"3"}
