"""Multi-task CTR models — the port of `deeprec_tpu/models/multitask.py`:
SimpleMultiTask, ESMM, MMoE, PLE and DBMTL. Each `forward` returns {task:
logits [B]} and `label_tasks` names the tasks; the Trainer sums one BCE per
task over `batch["label_<task>"]`.

All share a Criteo-style front: `num_cat` pooled tables and `num_dense`
numerics (log1p(max(x, 0))) concatenated. Parameter trees are the JAX
trees: experts are `nn.ModuleList`s and per-task gates and towers
`nn.ModuleDict`s keyed by task name, so `nn.jax_leaf_names` flattens them
in the JAX order (dict keys sorted: PLE's experts go ctr, cvr, shared).
The gate mixes are plain f32 products; the MLPs and gates round their
operands to bf16 (`nn.dense_apply`). Weights come from `seed`; parity tests
carry the JAX weights across.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from deeprec_tpu_torch import nn as dnn
from deeprec_tpu_torch.config import EmbeddingVariableOption
from deeprec_tpu_torch.models.criteo import CriteoModel


class _MTBase(CriteoModel):
    """The shared front; `tasks` (where a model has it) are `label_tasks`."""

    def __init__(self, emb_dim: int, capacity: int, num_cat: int, num_dense: int,
                 ev: EmbeddingVariableOption):
        super().__init__(emb_dim, capacity, ev, num_cat, num_dense)

    @property
    def label_tasks(self):
        return tuple(self.tasks)

    def _width(self) -> int:
        return self.num_cat * self.emb_dim + self.num_dense

    def _concat(self, inputs) -> torch.Tensor:
        return torch.cat(self._embs(inputs) + [self._numerics(inputs)], dim=-1)


def _prob_logit(p: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """The logit of a probability, clipped to [eps, 1 - eps] (whose
    gradient is 0 outside the range, as jnp.clip's)."""
    p = torch.clamp(p, eps, 1.0 - eps)
    return torch.log(p) - torch.log1p(-p)


def _mix(gate: torch.Tensor, experts: torch.Tensor) -> torch.Tensor:
    """Gate-weighted sum of experts [B, E, H] by gate [B, E], in f32."""
    return torch.einsum("be,beh->bh", gate, experts)


class SimpleMultiTask(_MTBase):
    """A shared bottom MLP and one tower per task
    (modelzoo/simple_multitask): {"bottom", "towers": {task: MLP}}."""

    def __init__(self, emb_dim: int = 8, capacity: int = 1 << 14, num_cat: int = 8,
                 num_dense: int = 4, bottom: Sequence[int] = (128,),
                 tower: Sequence[int] = (32,), tasks: Sequence[str] = ("ctr", "cvr"),
                 ev: EmbeddingVariableOption = EmbeddingVariableOption(),
                 seed: int = 0):
        super().__init__(emb_dim, capacity, num_cat, num_dense, ev)
        g = torch.Generator().manual_seed(seed)
        self.tasks = tuple(tasks)
        self.bottom = dnn.MLP(self._width(), bottom, g)
        self.towers = nn.ModuleDict(
            {t: dnn.MLP(bottom[-1], [*tower, 1], g) for t in self.tasks})

    def forward(self, inputs) -> Dict[str, torch.Tensor]:
        h = self.bottom(self._concat(inputs), final_activation=torch.relu)
        return {t: self.towers[t](h)[:, 0] for t in self.tasks}


class ESMM(_MTBase):
    """Entire-space multi-task model (modelzoo/esmm): pCTR and pCVR towers
    on the shared embeddings, supervised as ctr and ctcvr = pCTR * pCVR
    over the whole exposure space: {"ctr": MLP, "cvr": MLP}."""

    label_tasks = ("ctr", "ctcvr")

    def __init__(self, emb_dim: int = 8, capacity: int = 1 << 14, num_cat: int = 8,
                 num_dense: int = 4, tower: Sequence[int] = (64, 32),
                 ev: EmbeddingVariableOption = EmbeddingVariableOption(),
                 seed: int = 0):
        super().__init__(emb_dim, capacity, num_cat, num_dense, ev)
        g = torch.Generator().manual_seed(seed)
        self.ctr = dnn.MLP(self._width(), [*tower, 1], g)
        self.cvr = dnn.MLP(self._width(), [*tower, 1], g)

    def forward(self, inputs) -> Dict[str, torch.Tensor]:
        x = self._concat(inputs)
        ctr_logit = self.ctr(x)[:, 0]
        pctcvr = torch.sigmoid(ctr_logit) * torch.sigmoid(self.cvr(x)[:, 0])
        return {"ctr": ctr_logit, "ctcvr": _prob_logit(pctcvr)}


class MMoE(_MTBase):
    """Multi-gate mixture of experts (modelzoo/mmoe): shared experts, one
    softmax gate per task: {"experts": [MLP], "gates": {task: Dense},
    "towers": {task: MLP}}."""

    def __init__(self, emb_dim: int = 8, capacity: int = 1 << 14, num_cat: int = 8,
                 num_dense: int = 4, num_experts: int = 4,
                 expert: Sequence[int] = (64,), tower: Sequence[int] = (32,),
                 tasks: Sequence[str] = ("ctr", "cvr"),
                 ev: EmbeddingVariableOption = EmbeddingVariableOption(),
                 seed: int = 0):
        super().__init__(emb_dim, capacity, num_cat, num_dense, ev)
        g = torch.Generator().manual_seed(seed)
        self.tasks = tuple(tasks)
        W = self._width()
        self.experts = nn.ModuleList(
            dnn.MLP(W, expert, g) for _ in range(num_experts))
        self.gates = nn.ModuleDict(
            {t: dnn.Dense(W, num_experts, g) for t in self.tasks})
        self.towers = nn.ModuleDict(
            {t: dnn.MLP(expert[-1], [*tower, 1], g) for t in self.tasks})

    def forward(self, inputs) -> Dict[str, torch.Tensor]:
        x = self._concat(inputs)
        experts = torch.stack(
            [e(x, final_activation=torch.relu) for e in self.experts], dim=1)
        out = {}
        for t in self.tasks:
            g = torch.softmax(dnn.dense_apply(self.gates[t], x), dim=-1)
            out[t] = self.towers[t](_mix(g, experts))[:, 0]
        return out


class PLE(_MTBase):
    """Progressive layered extraction (modelzoo/ple): one CGC layer of
    shared and per-task experts, a gate per task over the shared and its
    own, then task towers: {"experts": {"shared": [MLP], task: [MLP]},
    "gates": {task: Dense}, "towers": {task: MLP}}."""

    def __init__(self, emb_dim: int = 8, capacity: int = 1 << 14, num_cat: int = 8,
                 num_dense: int = 4, shared_experts: int = 2, task_experts: int = 2,
                 expert: Sequence[int] = (64,), tower: Sequence[int] = (32,),
                 tasks: Sequence[str] = ("ctr", "cvr"),
                 ev: EmbeddingVariableOption = EmbeddingVariableOption(),
                 seed: int = 0):
        super().__init__(emb_dim, capacity, num_cat, num_dense, ev)
        g = torch.Generator().manual_seed(seed)
        self.tasks = tuple(tasks)
        W = self._width()
        self.experts = nn.ModuleDict({
            k: nn.ModuleList(dnn.MLP(W, expert, g) for _ in range(n))
            for k, n in [("shared", shared_experts)]
            + [(t, task_experts) for t in self.tasks]})
        self.gates = nn.ModuleDict(
            {t: dnn.Dense(W, shared_experts + task_experts, g)
             for t in self.tasks})
        self.towers = nn.ModuleDict(
            {t: dnn.MLP(expert[-1], [*tower, 1], g) for t in self.tasks})

    def forward(self, inputs) -> Dict[str, torch.Tensor]:
        x = self._concat(inputs)
        shared = [e(x, final_activation=torch.relu) for e in self.experts["shared"]]
        out = {}
        for t in self.tasks:
            own = [e(x, final_activation=torch.relu) for e in self.experts[t]]
            g = torch.softmax(dnn.dense_apply(self.gates[t], x), dim=-1)
            out[t] = self.towers[t](_mix(g, torch.stack(shared + own, dim=1)))[:, 0]
        return out


class DBMTL(_MTBase):
    """Deep Bayesian multi-task (modelzoo/dbmtl): a shared bottom, task
    towers and an explicit ctr -> cvr link on the hidden features:
    {"bottom", "ctr", "cvr", "link"}."""

    label_tasks = ("ctr", "cvr")

    def __init__(self, emb_dim: int = 8, capacity: int = 1 << 14, num_cat: int = 8,
                 num_dense: int = 4, bottom: Sequence[int] = (128,),
                 tower: Sequence[int] = (32,),
                 ev: EmbeddingVariableOption = EmbeddingVariableOption(),
                 seed: int = 0):
        super().__init__(emb_dim, capacity, num_cat, num_dense, ev)
        g = torch.Generator().manual_seed(seed)
        H = bottom[-1]
        self.bottom = dnn.MLP(self._width(), bottom, g)
        self.ctr = dnn.MLP(H, [*tower, 1], g)
        self.cvr = dnn.MLP(H + tower[-1], [*tower, 1], g)
        self.link = dnn.MLP(H, tower, g)

    def forward(self, inputs) -> Dict[str, torch.Tensor]:
        h = self.bottom(self._concat(inputs), final_activation=torch.relu)
        ctr_hidden = self.link(h, final_activation=torch.relu)
        return {"ctr": self.ctr(h)[:, 0],
                "cvr": self.cvr(torch.cat([h, ctr_hidden], dim=-1))[:, 0]}
