"""The VT5 training loop.

Counterpart of `rag_docvqa_tpu/training/trainer.py` (`TrainLoopConfig`,
`Trainer.fit`) on one device: per epoch a seeded shuffle, fixed-size batches
(the ragged tail batch is dropped), ingest and the copy to the device on a
background thread, the train step (loss, clip, AdamW, linear schedule),
logging every `log_every` steps, then evaluation and the best-checkpoint
bookkeeping. bf16 compute defaults to on for a CUDA device and off for
the CPU, as the JAX default does for a TPU and the CPU. With `use_nac` the
step adds the not-answerable classifier's BCE (its labels: the batch's
"not-answerable" answer types), "nac" trains beside the configured roots
(initialised from `seed` + 1 where the parameters carry none), and the
evaluation engine blanks answers at `nac_threshold`. With `hivt5_cfg` the
loop trains Hi-VT5 (`make_hivt5_train_step`: LM and page cross-entropy), its
`page_emb` and `page_head` beside the configured roots, and evaluates
through `HiVT5Engine`; the not-answerable term is VT5's only, as in JAX.
Remat is not ported yet and raises (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from rag_docvqa_tpu_torch.metrics import Evaluator
from rag_docvqa_tpu_torch.data.contract import RawDocument, to_device
from rag_docvqa_tpu_torch.data.ingest import DocVQAIngestor
from rag_docvqa_tpu_torch.data.prefetch import map_prefetch
from rag_docvqa_tpu_torch.engine.evaluate import evaluate
from rag_docvqa_tpu_torch.engine.hivt5_engine import HiVT5Engine
from rag_docvqa_tpu_torch.engine.rag_vt5 import RAGConfig, RAGVT5Engine
from rag_docvqa_tpu_torch.models import vt5 as vt5m
from rag_docvqa_tpu_torch.models.nac import NACConfig, init_nac_params
from rag_docvqa_tpu_torch.training.checkpoint import CheckpointManager
from rag_docvqa_tpu_torch.training.optimizer import build_optimizer, trainable_mask
from rag_docvqa_tpu_torch.training.train_step import TrainState, make_hivt5_train_step, make_train_step


@dataclass
class TrainLoopConfig:
    epochs: int = 10
    batch_size: int = 8
    lr: float = 2e-4
    warmup_steps: int = 1000
    clip_norm: float = 3.0
    weight_decay: float = 0.01
    answer_max_len: int = 32
    trainable: Sequence[str] = ("t5", "spatial")  # the reference trains the generator only
    save_dir: Optional[str] = None
    eval_start: bool = True
    eval_batch_size: int = 8
    seed: int = 42
    log_every: int = 10
    train_metrics_every: int = 0  # train-batch accuracy/ANLS every N batches (0 = off)
    use_nac: bool = False  # the not-answerable classifier's BCE term
    nac_loss_weight: float = 1.0
    nac_pos_weight: float = 1.0
    nac_threshold: float = 0.5  # the evaluation engine's blanking threshold
    remat: Any = False  # not ported: raises
    bf16_compute: Optional[bool] = None  # None: on for CUDA, off for the CPU
    prefetch_depth: int = 2


class Trainer:
    def __init__(self, vt5_cfg: Optional[vt5m.VT5Config], rag_cfg: RAGConfig, params, tokenizer,
                 ingestor: DocVQAIngestor, loop_cfg: Optional[TrainLoopConfig] = None, logger=None,
                 hivt5_cfg=None):
        """`params` a VT5Params, or with `hivt5_cfg` (a HiVT5Config; then
        `vt5_cfg` may be None) a HiVT5Params."""
        self.vt5_cfg = vt5_cfg
        self.hivt5_cfg = hivt5_cfg
        self.rag_cfg = rag_cfg
        self.tokenizer = tokenizer
        self.ingestor = ingestor
        self.cfg = loop_cfg or TrainLoopConfig()
        self.logger = logger
        self.evaluator = Evaluator()
        self.params = params
        self.device = params.t5.shared.device
        self.opt = None
        self.state = None
        self.step_fn = None
        self.ckpt = CheckpointManager(self.cfg.save_dir) if self.cfg.save_dir else None

    def _ensure_optimizer(self, total_steps: int) -> None:
        """Built once the schedule's horizon is known: the linear decay runs
        to the true number of steps."""
        if self.opt is not None:
            return
        c = self.cfg
        trainable = tuple(c.trainable)
        if self.hivt5_cfg is not None:
            trainable = trainable + tuple(k for k in ("page_emb", "page_head") if k not in trainable)
        elif c.use_nac:
            if self.params.nac is None:
                g = torch.Generator(device=self.device).manual_seed(c.seed + 1)
                self.params.nac = init_nac_params(g, NACConfig(emb_dim=self.vt5_cfg.t5.d_model))
            if "nac" not in trainable:
                trainable = trainable + ("nac",)
        self.opt = build_optimizer(lr=c.lr, warmup_steps=c.warmup_steps,
                                   total_steps=max(total_steps, c.warmup_steps + 1), clip_norm=c.clip_norm,
                                   weight_decay=c.weight_decay, mask=trainable_mask(self.params, trainable))
        self.state = TrainState.create(self.params, self.opt)
        bf16 = c.bf16_compute if c.bf16_compute is not None else self.device.type == "cuda"
        if self.hivt5_cfg is not None:
            self.step_fn = make_hivt5_train_step(self.hivt5_cfg, self.opt, remat=c.remat, bf16_compute=bf16)
            return
        self.step_fn = make_train_step(self.vt5_cfg, self.rag_cfg, self.opt, bf16_compute=bf16,
                                       use_nac=c.use_nac, nac_loss_weight=c.nac_loss_weight,
                                       nac_pos_weight=c.nac_pos_weight, remat=c.remat)

    def engine(self):
        if self.hivt5_cfg is not None:
            return HiVT5Engine(self.hivt5_cfg, self.params, self.tokenizer, max_new_tokens=self.cfg.answer_max_len)
        nac = (self.params.nac, self.cfg.nac_threshold) if self.cfg.use_nac and self.params.nac is not None else None
        return RAGVT5Engine(self.rag_cfg, self.vt5_cfg, self.params, self.tokenizer, nac=nac)

    def _evaluate(self, docs: Sequence[RawDocument]) -> Dict[str, Any]:
        return evaluate(self.engine(), docs, self.ingestor, self.evaluator, batch_size=self.cfg.eval_batch_size,
                        prefetch_depth=self.cfg.prefetch_depth)

    def fit(self, train_docs: Sequence[RawDocument], val_docs: Sequence[RawDocument]) -> Dict[str, Any]:
        cfg = self.cfg
        rng = random.Random(cfg.seed)
        history: List[Dict[str, Any]] = []
        best = {"accuracy": -1.0, "epoch": -1}
        steps_per_epoch = max(len(train_docs) // cfg.batch_size, 1)
        self._ensure_optimizer(steps_per_epoch * cfg.epochs)

        if cfg.eval_start and len(val_docs):
            m = self._evaluate(val_docs)
            self._log({"epoch": -1, **{k: m[k] for k in ("accuracy", "anls", "retrieval_precision")}})
            best = {"accuracy": m["accuracy"], "epoch": -1}

        order = list(range(len(train_docs)))
        for epoch in range(cfg.epochs):
            rng.shuffle(order)
            t0 = time.time()
            losses = []

            def _ingest_one(start):
                idx = order[start : start + cfg.batch_size]
                if len(idx) < cfg.batch_size:
                    return None  # fixed shapes: drop the ragged tail batch
                docs = [train_docs[i] for i in idx]
                batch, aux = self.ingestor.ingest(docs)
                labels = self.ingestor.answer_labels(aux["answers"], max_len=cfg.answer_max_len,
                                                     seed=rng.randrange(1 << 30))
                return docs, to_device(batch, self.device), torch.from_numpy(labels).to(self.device), aux

            for item in map_prefetch(_ingest_one, range(0, len(order), cfg.batch_size), depth=cfg.prefetch_depth):
                if item is None:
                    continue
                docs, batch, labels, aux = item
                step_args = [self.state, batch, labels]
                if cfg.use_nac and self.hivt5_cfg is None:  # the not-answerable ground truth
                    step_args.append(torch.tensor([t == "not-answerable" for t in aux["answer_types"]],
                                                  dtype=torch.float32, device=self.device))
                self.state, metrics = self.step_fn(*step_args)
                losses.append(float(metrics["loss"]))
                if len(losses) % cfg.log_every == 0:
                    logd = {"epoch": epoch, "step": self.state.step, "loss": losses[-1],
                            "grad_norm": float(metrics["grad_norm"])}
                    logd.update({k: float(metrics[k]) for k in ("nac_loss", "nac_accuracy", "lm_loss", "ret_loss")
                                 if k in metrics})
                    self._log(logd)
                if cfg.train_metrics_every and len(losses) % cfg.train_metrics_every == 0:
                    out = self.engine().inference(batch, aux)
                    m = self.evaluator.get_metrics(aux["answers"], out["pred_answers"], aux.get("answer_types"))
                    self._log({
                        "epoch": epoch, "step": self.state.step,
                        "train_batch_accuracy": float(np.mean(m["accuracy"])),
                        "train_batch_anls": float(np.mean(m["anls"])),
                        "train_batch_ret_prec": float(np.mean(self.evaluator.get_retrieval_metric(
                            [d.answer_page_idx for d in docs], out["pred_answer_pages"]))),
                    })

            epoch_metrics: Dict[str, Any] = {
                "epoch": epoch,
                "train_loss": float(np.mean(losses)) if losses else 0.0,
                "epoch_time": time.time() - t0,
            }
            if len(val_docs):
                m = self._evaluate(val_docs)
                epoch_metrics.update({k: m[k] for k in ("accuracy", "anls", "retrieval_precision", "chunk_score")})
                if self.evaluator.update_global_metrics(m["accuracy"], m["anls"], epoch):
                    best = {"accuracy": m["accuracy"], "epoch": epoch}
                if self.ckpt:
                    self.ckpt.save(self.state.step, self.state, metrics={"accuracy": m["accuracy"], "anls": m["anls"]})
            elif self.ckpt:
                self.ckpt.save(self.state.step, self.state)
            self._log(epoch_metrics)
            history.append(epoch_metrics)
        return {"best": best, "history": history}

    def _log(self, metrics: Dict[str, Any]) -> None:
        if self.logger is not None:
            self.logger.log(metrics)
        else:
            print(" ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in metrics.items()))
