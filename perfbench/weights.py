"""Seeded weights, made on the device in the type they are served in.

Each family gives the rule of its leaves, `leaf_init(name, shape, c)`: ones,
zeros, or a normal draw with a standard deviation. `make_weights` fills the
normal leaves from one generator of the device, in their order, in pieces
of at most `PIECE` elements: each piece is one flat buffer of whole leaves
(a leaf larger than a piece has a buffer of its own, drawn a piece at a
time), and each leaf is a view of its buffer, scaled in place. A tree whose
normal leaves fit in one piece is one `torch.randn` call's bits, as the two
T5 trees are.

`t5_leaf_init` is the T5 families' rule: norm weights ones and biases zeros;
T5's published initialisation (Mesh TensorFlow's, as Hugging Face's
`T5PreTrainedModel._init_weights` has it: q (d_model * d_kv)^-1/2, the other
projections fan_in^-1/2, the shared table 1, the relative-position table
d_model^-1/2), the spatial tables 0.02, a Hi-VT5 page embedding 1 and its
page head 0.02.

The names and shapes are those of the program's parameter tree, so the same
dict fills that tree and feeds the plain reference. A family may build that
tree on the `meta` device, which holds no memory: `load_into` then puts each
seeded tensor in its leaf's place.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Tuple

import torch

ONES = {"ln0", "ln1", "ln2", "final_ln", "ln_w"}
ZEROS = {"ln_b", "matcher_b", "bias"}
EMBED_STD = 0.05
PIECE = 1 << 30  # elements a draw: one torch.randn call stays under 2**31


def t5_leaf_init(name: str, shape: Tuple[int, ...], c: Dict):
    """("ones",), ("zeros",) or ("normal", std) for the leaf `name` of a T5
    family's tree, `c` the configuration's engine dict."""
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
        return ("normal", c["d_model"] ** -0.5)
    if len(shape) == 2 and last == "q":
        return ("normal", (shape[1] * c["d_kv"]) ** -0.5)
    if name == "spatial.matcher_w":
        return ("normal", EMBED_STD * shape[1] ** -0.5)
    if len(shape) == 2 and last in ("k", "v", "o", "wi", "wo", "matcher_w"):
        return ("normal", shape[1] ** -0.5)
    raise ValueError(f"no initialisation rule for the leaf {name!r} {tuple(shape)}")


def make_weights(leaves: Iterable[Tuple[str, Tuple[int, ...]]], seed: int, device,
                 init: Callable[[str, Tuple[int, ...]], tuple], dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """{name: tensor} for every (name, shape) in `leaves`, from `seed`;
    `init(name, shape)` is the leaf's rule."""
    leaves = [(n, tuple(s), init(n, tuple(s))) for n, s in leaves]
    pieces, size = [[]], 0
    for name, shape, rule in leaves:
        if rule[0] == "normal":
            n = torch.Size(shape).numel()
            if pieces[-1] and size + n > PIECE:
                pieces.append([])
                size = 0
            pieces[-1].append((name, shape, n, rule[1]))
            size += n
    g = torch.Generator(device=device).manual_seed(int(seed))
    drawn = {}
    for piece in pieces:
        flat = torch.empty(sum(n for _, _, n, _ in piece), device=device, dtype=dtype)
        for at in range(0, flat.numel(), PIECE):
            flat[at:at + PIECE].normal_(generator=g)
        at = 0
        for name, shape, n, std in piece:
            drawn[name] = flat[at:at + n].view(shape).mul_(std)
            at += n
    return {name: drawn[name] if rule[0] == "normal"
            else (torch.ones if rule[0] == "ones" else torch.zeros)(shape, dtype=dtype, device=device)
            for name, shape, rule in leaves}


def load_into(module: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Every parameter of the program's `module` becomes its tensor of
    `weights`: the names and shapes must match one to one. A parameter on
    the `meta` device is replaced, in its module, by a parameter that holds
    the tensor; any other takes the tensor as its data."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"weights and parameters differ: {sorted(set(params) ^ set(weights))[:8]}")
    for name, p in params.items():
        if tuple(p.shape) != tuple(weights[name].shape):
            raise ValueError(f"{name}: shape {tuple(p.shape)} against {tuple(weights[name].shape)}")
        if p.is_meta:
            owner, _, leaf = name.rpartition(".")
            setattr(module.get_submodule(owner), leaf, torch.nn.Parameter(weights[name], p.requires_grad))
        else:
            p.data = weights[name]
