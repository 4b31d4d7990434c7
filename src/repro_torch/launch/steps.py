"""Step functions run by the dry-run and on the card.

Counterpart of ``repro.launch.steps``:

  make_train_step       — one FIRM client-local update (PPO x M -> MGDA ->
                          Adam)
  make_prefill_step     — sequence forward + KV/state harvest, last logits
  make_serve_step       — one decode token against the cache
  make_federated_round  — MULTI-POD: clients stacked on a leading pod
                          axis, K local steps per client, then FedAvg of
                          the trainables: one all-reduce over the pod
                          group, the round's only cross-pod collective
                          (the paper's O(Cd)).

The steps take plain tensors or DTensors.  On DTensors (the dry-run's
``meta`` shards on a fake mesh) every operation runs under DTensor's
sharding rules, less the few that ``launch.rules.StepRules`` lays out
itself (the serve step's write into a sequence-sharded cache and the
softmax over its slots among them), and plain tensors made inside the
step (masks, positions) count as replicated (``implicit_replication``).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import FIRMConfig, ModelConfig
from repro_torch.core import fedavg as fedavg_lib
from repro_torch.launch import rules, sharding as sh
from repro_torch.models import transformer
from repro_torch.rlhf import local as local_lib
from repro_torch.rlhf.ppo import PPOBatch


def _small_metrics(m: dict) -> dict:
    """Keep only O(M) metric outputs (drop any big tensors)."""
    keep = ("losses", "lam", "lam_star", "gram", "kl", "grad_norm",
            "td_err", "ratio_mean")
    return {k: m[k] for k in keep if k in m}


def _rules(*trees, decode: bool = False):
    """``rules.StepRules`` where an input is a DTensor; nothing for plain
    tensors, which need none of its layouts (and would pay its Python at
    every call)."""
    if any(isinstance(t, DTensor) for tree in trees
           for t in sh.tree_leaves(tree)):
        return rules.StepRules(decode=decode)
    return contextlib.nullcontext()


def make_train_step(cfg: ModelConfig, fc: FIRMConfig):
    def train_step(state, frozen, batch: PPOBatch, aux=None):
        with implicit_replication(), _rules(state, frozen, batch, aux):
            new_state, metrics = local_lib.firm_local_step(
                cfg, fc, state, frozen, batch, aux)
        return new_state, _small_metrics(metrics)
    return train_step


def _cache_layout(tokens):
    """For DTensor ``tokens``: the fresh cache with its batch dim sharded
    as the tokens' batch is and the rest replicated, the layout the
    forward's K/V come out in.  (``cache_shardings``' decode layout shards
    the slots, into which DTensor cannot write a window's ring.)"""
    if not isinstance(tokens, DTensor):
        return None
    mesh = tokens.device_mesh
    names = tuple(n for n, p in zip(mesh.mesh_dim_names, tokens.placements)
                  if p.is_shard(0))
    entry = (names if len(names) > 1 else names[0]) if names else None

    def one(path, t):
        spec = [None] * t.ndim
        if t.ndim > 1:                          # 'pos' is a scalar
            spec[1 if "slots" in path else 0] = entry
        return sh.Sharding(mesh, tuple(spec))

    def lay_out(cache):
        return sh.place(cache, sh.tree_map_with_path(one, cache))
    return lay_out


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, tokens, aux=None):
        with implicit_replication(), _rules(params, tokens, aux):
            logits, cache = transformer.prefill(
                cfg, params, tokens, aux,
                lay_out=_cache_layout(tokens))
            return logits[:, -1], cache
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, cache, token):
        with implicit_replication(), _rules(params, cache, token,
                                            decode=True):
            return transformer.decode_step(cfg, params, cache, token)
    return serve_step


# ------------------------------------------------------------ the pod axis
class _Pods:
    """Where a pod-stacked tree's pods live.

    DTensors on a mesh with a 'pod' dim: each rank holds n_pods / |pod|
    pods, run as DTensors over the submesh of the other dims, and the pod
    group is the mesh's 'pod' group.  Plain tensors: this process holds
    n_pods / world pods, and the pod group is the default group (world 1
    on one card).
    """

    def __init__(self, stacked, n_pods: int):
        leaf = sh.tree_leaves(stacked)[0]
        if isinstance(leaf, DTensor):
            mesh = leaf.device_mesh
            names = mesh.mesh_dim_names
            if not names or names[0] != "pod":
                raise ValueError("a pod-stacked DTensor needs a mesh whose "
                                 f"first dim is 'pod', got {names}")
            self.mesh, self.sub = mesh, mesh[names[1:]]
            self.group = mesh.get_group("pod")
            self.local = leaf.to_local().shape[0]
        else:
            if not dist.is_initialized():
                raise RuntimeError(
                    "the federated round's FedAvg needs a process group "
                    "(mesh.make_host_mesh() starts a world-1 group)")
            self.mesh = self.sub = None
            self.group = dist.group.WORLD
            self.local = leaf.shape[0]
        if self.local * dist.get_world_size(self.group) != n_pods:
            raise ValueError(
                f"{n_pods} pods do not split as {self.local} a rank over "
                f"{dist.get_world_size(self.group)} ranks of the pod group")

    def pod(self, x, i: int):
        """Pod i of this rank: a plain tensor, or a DTensor on the submesh."""
        if self.mesh is None:
            return x[i]
        if not isinstance(x, DTensor):
            raise TypeError("a pod-stacked tree mixes DTensors and tensors")
        pl = x.placements
        if not isinstance(pl[0], Shard) or pl[0].dim != 0:
            raise ValueError(f"the pod axis must be Shard(0), got {pl[0]}")
        rest = tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p
                     for p in pl[1:])
        return _from_local(x.to_local()[i], self.sub, rest,
                           tuple(x.shape[1:]))

    def shared(self, x):
        """A tree shared by every pod (replicated over 'pod') on the
        submesh."""
        if self.mesh is None or not isinstance(x, DTensor):
            return x
        return _from_local(x.to_local(), self.sub, tuple(x.placements[1:]),
                           tuple(x.shape))

    def stack(self, per_pod):
        """This rank's pods (same-placed leaves) stacked on a leading pod
        axis: a plain tensor, or a DTensor on the whole mesh."""
        if self.mesh is None:
            return torch.stack(per_pod)
        x = per_pod[0]
        pl = (Shard(0),) + tuple(Shard(p.dim + 1) if isinstance(p, Shard)
                                 else p for p in x.placements)
        shape = (self.local * dist.get_world_size(self.group),) + tuple(
            x.shape)
        return _from_local(torch.stack([p.to_local() for p in per_pod]),
                           self.mesh, pl, shape)


def _from_local(local, mesh, placements, shape):
    stride = [math.prod(shape[d + 1:]) for d in range(len(shape))]
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def _fedavg(trees: list, pods: _Pods, n_pods: int):
    """The mean of every pod's tree, all pods: this rank's sum, then
    ``core.fedavg.fedavg_collective`` over the pod group (one all-reduce
    a leaf) with the count of every pod; a DTensor leaf hands its shard
    and is rewrapped as it was laid out."""
    def total(*leaves):
        out = leaves[0]
        for t in leaves[1:]:
            out = out + t
        return out
    summed = sh.tree_map(total, *trees)
    mean = fedavg_lib.fedavg_collective(
        sh.tree_map(lambda t: t.to_local() if isinstance(t, DTensor) else t,
                    summed), pods.group, count=n_pods)
    return sh.tree_map(
        lambda m, t: _from_local(m, t.device_mesh, t.placements,
                                 tuple(t.shape))
        if isinstance(t, DTensor) else m, mean, summed)


def make_federated_round(cfg: ModelConfig, fc: FIRMConfig, n_pods: int):
    """stacked_state: ClientState with a leading (n_pods,) axis on every
    leaf; batches: PPOBatch with leading (n_pods, K) axes; frozen shared.
    Returns (stacked new states, whose trainables are FedAvg's mean,
    metrics stacked (n_pods, K)).
    """
    def client_k_steps(state, batches, aux_seq, frozen):
        metrics = []
        for k in range(batches.tokens.shape[0]):
            b = PPOBatch(*(t[k] for t in batches))
            a = None if aux_seq is None else sh.tree_map(lambda t: t[k],
                                                         aux_seq)
            state, m = local_lib.firm_local_step(cfg, fc, state, frozen, b, a)
            metrics.append(_small_metrics(m))
        return state, sh.tree_map(lambda *ms: torch.stack(ms), *metrics)

    def federated_round(stacked_state, frozen, stacked_batches, aux=None):
        # aux (modality stubs) is stacked (pods, K, ...) like the batches
        pods = _Pods(stacked_state, n_pods)
        with implicit_replication(), _rules(stacked_state, frozen,
                                            stacked_batches, aux):
            frozen = sh.tree_map(pods.shared, frozen)
            outs = []
            for i in range(pods.local):
                def take(t, i=i):
                    return pods.pod(t, i)
                outs.append(client_k_steps(
                    sh.tree_map(take, stacked_state),
                    sh.tree_map(take, stacked_batches),
                    None if aux is None else sh.tree_map(take, aux), frozen))
            states = [s for s, _ in outs]
            # FedAvg: the ONLY cross-pod collective of the round (O(Cd))
            avg = _fedavg([s.trainable for s in states], pods, n_pods)
            states = [s._replace(trainable=avg) for s in states]
            new = sh.tree_map(lambda *xs: pods.stack(list(xs)), *states)
            metrics = sh.tree_map(lambda *xs: pods.stack(list(xs)),
                                  *[m for _, m in outs])
        return new, metrics

    return federated_round


def step_and_args(cfg: ModelConfig, shape_kind: str, fc: FIRMConfig,
                  spec: dict):
    """(fn, ordered args) for the entry point implied by the shape kind."""
    if shape_kind == "train":
        return (make_train_step(cfg, fc),
                (spec["state"], spec["frozen"], spec["batch"], spec["aux"]))
    if shape_kind == "prefill":
        return (make_prefill_step(cfg),
                (spec["params"], spec["tokens"], spec["aux"]))
    return (make_serve_step(cfg),
            (spec["params"], spec["cache"], spec["token"]))
