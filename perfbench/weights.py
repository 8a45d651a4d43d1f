"""Seeded weights, made on the device in the type they are served in.

One `torch.randn` call on a generator of the device fills a flat buffer with
every random leaf; each leaf is a view of it, scaled in place by its
standard deviation. Norm weights are ones and biases zeros. The deviations
are T5's published initialisation (Mesh TensorFlow's, as Hugging Face's
`T5PreTrainedModel._init_weights` has it: q (d_model * d_kv)^-1/2, the other
projections fan_in^-1/2, the shared table 1, the relative-position table
d_model^-1/2), the spatial tables 0.02, a Hi-VT5 page embedding 1 and its
page head 0.02.

The names and shapes are those of the program's parameter tree, so the same
dict fills that tree and feeds the plain reference.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch

ONES = {"ln0", "ln1", "ln2", "final_ln", "ln_w"}
ZEROS = {"ln_b", "matcher_b", "bias"}
EMBED_STD = 0.05


def leaf_init(name: str, shape: Tuple[int, ...], d_model: int, d_kv: int):
    """("ones",), ("zeros",) or ("normal", std) for the leaf `name`."""
    last = name.rsplit(".", 1)[-1]
    if last in ONES:
        return ("ones",)
    if last in ZEROS:
        return ("zeros",)
    if last in ("shared", "page_emb"):
        return ("normal", EMBED_STD)
    if last in ("x_emb", "y_emb") or name.endswith("page_head.weight"):
        return ("normal", 0.02)
    if last == "rel_bias":
        return ("normal", d_model ** -0.5)
    if len(shape) == 2 and last == "q":
        return ("normal", (shape[1] * d_kv) ** -0.5)
    if name == "spatial.matcher_w":
        return ("normal", EMBED_STD * shape[1] ** -0.5)
    if len(shape) == 2 and last in ("k", "v", "o", "wi", "wo", "matcher_w"):
        return ("normal", shape[1] ** -0.5)
    raise ValueError(f"no initialisation rule for the leaf {name!r} {tuple(shape)}")


def make_weights(leaves: Iterable[Tuple[str, Tuple[int, ...]]], seed: int, device, d_model: int, d_kv: int,
                 dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """{name: tensor} for every (name, shape) in `leaves`, from `seed`."""
    leaves = [(n, tuple(s), leaf_init(n, s, d_model, d_kv)) for n, s in leaves]
    total = sum(torch.Size(s).numel() for _, s, init in leaves if init[0] == "normal")
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=g, device=device, dtype=dtype)
    out, at = {}, 0
    for name, shape, init in leaves:
        if init[0] == "normal":
            n = torch.Size(shape).numel()
            out[name] = flat[at:at + n].view(shape).mul_(init[1])
            at += n
        else:
            out[name] = (torch.ones if init[0] == "ones" else torch.zeros)(shape, dtype=dtype, device=device)
    return out


def load_into(module: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Every parameter of the program's `module` becomes its tensor of
    `weights`: the names and shapes must match one to one."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"weights and parameters differ: {sorted(set(params) ^ set(weights))[:8]}")
    for name, p in params.items():
        if tuple(p.shape) != tuple(weights[name].shape):
            raise ValueError(f"{name}: shape {tuple(p.shape)} against {tuple(weights[name].shape)}")
        p.data = weights[name]
