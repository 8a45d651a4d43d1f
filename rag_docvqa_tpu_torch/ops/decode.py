"""Fixed-length greedy decoding with the confidence product.

Counterpart of `rag_docvqa_tpu/ops/decode.py` (`greedy_decode`). The
semantics are those of `_decode_loop`: greedy argmax, pad emitted after a
sequence's EOS, and the confidence is the product over steps of the max of
an f32 softmax, with finished sequences and the last step contributing 1.

A Python loop over steps replaces `lax.scan`. It never syncs with the host:
the step index, the last token, the done flags, the confidence and the
emitted tokens (a (B, T) buffer written at the step) stay on the device,
and the decoder's rel-pos bias for every step is built once before the
loop. The JAX package's split dispatch (`greedy_decode_split`) works
around XLA relayouting an in-program cache; eager PyTorch has no such
program boundary, so the port has one function for it.

On CUDA tensors with autograd off, one step is captured once per shape
as a CUDA graph and replayed `max_new_tokens` times, one launch a step in
place of the step's ~800 small ones. The graphs are cached by the key of
`_graph_key` (shapes, dtypes, device, config, inference mode and the
parameters' addresses), the `_GRAPH_ENTRIES` most recently used kept. An
entry holds the state the graph reads and writes at fixed addresses; a call
computes the cross K/V and the bias eagerly into it, resets the rest,
replays, and returns copies. Everywhere else (the CPU, autograd on, a
caller that is itself capturing a graph, parameters made for the call) the
same step runs eagerly. Both
forms count themselves (`decode.graph_captures`, `decode.graph_replays`,
`decode.eager_steps`), and a replay adds the captured step's launches to
`kernels.LAUNCHES`, so the launch counts read as the eager path's.

`greedy_decode_sharded` is the decode of the JAX dry run's split-dispatch
case under the `(data, model)` layout (`parallel/mesh.py`): the encoder rows
are this rank's share of the data axis, the parameters this rank's slices
as `training/train_step.py::vt5_param_spec` splits them; the split leaves
are gathered whole over the model axis, the rank decodes its rows (K3 where
the config asks for it), and the tokens and confidences are all-gathered in
rank order, so every rank returns the replicated decode's ids.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from rag_docvqa_tpu_torch import kernels
from rag_docvqa_tpu_torch.models import t5 as t5_mod
from rag_docvqa_tpu_torch.parallel.mesh import Mesh, gathered_params
from rag_docvqa_tpu_torch.profiling import count, span

_GRAPH_ENTRIES = 4  # captured step graphs kept; the least recently used goes first
_WARMUP_STEPS = 2  # eager steps on a side stream before a capture
_graphs: "OrderedDict[tuple, _Graph]" = OrderedDict()
_graphs_lock = threading.Lock()  # one caller at a time through the graphs and their state


@dataclass
class _Decoding:
    """A greedy decode's state on the device, updated in place by `_step`."""

    cache: "t5_mod.DecodeCache"
    bias: torch.Tensor  # (1, H, T, T) decoder self bias, row t for step t
    mask: torch.Tensor  # (B, Te) bool encoder mask
    token: torch.Tensor  # (B,) int64, the token fed to the next step
    done: torch.Tensor  # (B,) bool, EOS emitted
    conf: torch.Tensor  # (B,) f32 confidence product
    tokens: torch.Tensor  # (B, T) int64 emitted tokens
    step: torch.Tensor  # () int64 step index

    @classmethod
    def start(cls, params, cfg, encoder_hidden, encoder_mask, max_new_tokens: int) -> "_Decoding":
        B, dev = encoder_hidden.shape[0], encoder_hidden.device
        return cls(
            t5_mod.init_decode_cache(params, cfg, encoder_hidden, max_new_tokens),
            t5_mod.decoder_self_bias(params, cfg, max_new_tokens),
            encoder_mask.clone(),
            torch.full((B,), cfg.decoder_start_token_id, dtype=torch.int64, device=dev),
            torch.zeros((B,), dtype=torch.bool, device=dev),
            torch.ones((B,), dtype=torch.float32, device=dev),
            torch.zeros((B, max_new_tokens), dtype=torch.int64, device=dev),
            torch.zeros((), dtype=torch.int64, device=dev),
        )

    def reset(self, cfg) -> None:
        self.token.fill_(cfg.decoder_start_token_id)
        self.done.zero_()
        self.conf.fill_(1.0)
        self.step.zero_()

    def restart(self, params, cfg, encoder_hidden, encoder_mask) -> None:
        """The state of `start` for new inputs of the same shapes, in place."""
        t5_mod.init_decode_cache(params, cfg, encoder_hidden, self.tokens.shape[1], out=self.cache)
        self.bias.copy_(t5_mod.decoder_self_bias(params, cfg, self.tokens.shape[1]))
        self.mask.copy_(encoder_mask)
        self.reset(cfg)


def _step(params, cfg, s: _Decoding) -> None:
    """One greedy step of `s`, in place. The step is `t5_mod.decode_step`,
    looked up at each call. The confidence takes each row's max probability
    until its EOS; a finished row and the last step contribute exactly 1."""
    at = s.step.view(1)
    logits, s.cache = t5_mod.decode_step(params, cfg, s.cache, s.token, s.step, s.mask,
                                         self_bias=s.bias.index_select(2, at)[:, :, 0, :])
    with span("decode.head"):
        next_tok = logits.argmax(dim=-1)  # first max, as jnp.argmax
        emitted = torch.where(s.done, cfg.pad_id, next_tok)
        max_prob = torch.softmax(logits.float(), dim=-1).amax(dim=-1)
        s.conf.mul_(torch.where(s.done | (s.step == s.tokens.shape[1] - 1), 1.0, max_prob))
        s.done.logical_or_(emitted == cfg.eos_id)
        s.token.copy_(emitted)
        s.tokens.index_copy_(1, at, emitted[:, None])
        s.step.add_(1)


@dataclass
class _Graph:
    """A captured step and the state it reads and writes."""

    replay: Callable[[], None]
    state: _Decoding
    launches: List[Dict[str, int]]  # the step's kernels.LAUNCHES and FORM_LAUNCHES
    params: List[torch.Tensor]  # the parameters it reads by address, kept alive


def _capture(run_step: Callable[[], None], reset: Callable[[], None]):
    """(replay, launches): `run_step` captured as a CUDA graph after
    `_WARMUP_STEPS` eager steps on a side stream, each after `reset()`, and
    the step's kernel launches by counter. Capture mode "thread_local": other
    threads (the ingest's copies to the card) go on while this one captures.
    The warm-up and the capture leave the launch counters as they were."""
    counters = (kernels.LAUNCHES, kernels.FORM_LAUNCHES)
    before = [dict(c) for c in counters]
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(_WARMUP_STEPS):
                reset()
                run_step()
        torch.cuda.current_stream().wait_stream(side)
        warm = [dict(c) for c in counters]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            run_step()
        return graph.replay, [{k: n - w[k] for k, n in c.items() if n != w[k]} for c, w in zip(counters, warm)]
    finally:
        for c, b in zip(counters, before):
            c.update(b)


def _graph_key(params, cfg, encoder_hidden, encoder_mask, max_new_tokens: int) -> tuple:
    B, Te, _ = encoder_hidden.shape
    return (B, Te, max_new_tokens, encoder_hidden.dtype, encoder_mask.dtype, encoder_hidden.device, cfg,
            torch.is_inference_mode_enabled(), tuple(p.data_ptr() for p in params.parameters()))


def _graph_for(params, cfg, encoder_hidden, encoder_mask, max_new_tokens: int) -> _Graph:
    """The cached graph of these inputs' key, captured on a miss."""
    key = _graph_key(params, cfg, encoder_hidden, encoder_mask, max_new_tokens)
    entry = _graphs.get(key)
    if entry is not None:
        _graphs.move_to_end(key)
        return entry
    state = _Decoding.start(params, cfg, encoder_hidden, encoder_mask, max_new_tokens)
    replay, launches = _capture(lambda: _step(params, cfg, state), lambda: state.reset(cfg))
    count("decode.graph_captures", 1)
    entry = _graphs[key] = _Graph(replay, state, launches, [p.detach() for p in params.parameters()])
    while len(_graphs) > _GRAPH_ENTRIES:
        _graphs.popitem(last=False)
    return entry


def _replayable(params, encoder_hidden: torch.Tensor) -> bool:
    """Whether the decode takes the graph path: CUDA tensors, autograd off,
    no graph being captured by the caller, and no parameter made for this
    call: one with a `grad_fn`, such as a training step's bf16 cast of its
    masters, sits at a new address every call, so its graph would never be
    replayed by a later one."""
    return (encoder_hidden.is_cuda and not torch.is_grad_enabled() and not torch.cuda.is_current_stream_capturing()
            and all(p.grad_fn is None for p in params.parameters()))


def _replayed(params, cfg, encoder_hidden, encoder_mask, max_new_tokens: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`greedy_decode` through the cached graph: its state refilled from the
    inputs, one replay a step, copies of the tokens and confidences out."""
    with _graphs_lock:
        g = _graph_for(params, cfg, encoder_hidden, encoder_mask, max_new_tokens)
        g.state.restart(params, cfg, encoder_hidden, encoder_mask)
        for _ in range(max_new_tokens):
            with span("decode.step"):
                g.replay()
        count("decode.graph_replays", max_new_tokens)
        for counter, launched in zip((kernels.LAUNCHES, kernels.FORM_LAUNCHES), g.launches):
            for name, n in launched.items():
                counter[name] += n * max_new_tokens
        return g.state.tokens.clone(), g.state.conf.clone()


def greedy_decode(
    params: "t5_mod.T5Params",
    cfg: "t5_mod.T5Config",
    encoder_hidden: torch.Tensor,  # (B, Te, D)
    encoder_mask: torch.Tensor,  # (B, Te) bool
    max_new_tokens: int = 100,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (tokens (B, T) int64 padded after EOS, confidence (B,) f32)."""
    if _replayable(params, encoder_hidden):
        return _replayed(params, cfg, encoder_hidden, encoder_mask, max_new_tokens)
    s = _Decoding.start(params, cfg, encoder_hidden, encoder_mask, max_new_tokens)
    for _ in range(max_new_tokens):
        with span("decode.step"):
            _step(params, cfg, s)
    count("decode.eager_steps", max_new_tokens)
    return s.tokens, s.conf


@torch.no_grad()
def greedy_decode_sharded(
    params: "t5_mod.T5Params",  # this rank's slices, split as `spec` says
    cfg: "t5_mod.T5Config",
    encoder_hidden: torch.Tensor,  # (B / data, Te, D): this rank's rows
    encoder_mask: torch.Tensor,  # (B / data, Te) bool
    max_new_tokens: int,
    *,
    mesh: Mesh,
    spec: Dict[str, Optional[int]],  # parameter name -> model-axis dimension or None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`greedy_decode` of the whole batch: (tokens (B, T), confidence (B,)),
    the same on every rank."""
    whole = gathered_params(params, spec, mesh)
    tokens, conf = greedy_decode(whole, cfg, encoder_hidden, encoder_mask, max_new_tokens)
    return torch.cat(mesh.all_gather(tokens, "data")), torch.cat(mesh.all_gather(conf, "data"))
