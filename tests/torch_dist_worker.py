"""The ranks of the 4-rank gloo group that tests/test_torch_dist.py starts:
every multi-rank computation of the port that the tests hold to the JAX
package, run once per rank, each rank's results saved with ``torch.save``.

Imports no JAX: each rank is a fresh process that loads only torch and the
port. The parent computes the JAX side on one device and passes the inputs
(the JAX initial params and the batches, as numpy) in ``spec``.
"""

import os

import torch
import torch.distributed as dist

from repro_torch.compat import params_to_numpy, params_to_torch
from repro_torch.core import dist as port_dist
from repro_torch.core.dist import DistCtx
from repro_torch.core.loss import (
    contrastive_loss,
    sharded_bank_extra_columns,
    sharded_bank_extra_rows,
)
from repro_torch.core.memory_bank import BankState
from repro_torch.core.methods import build_step_program, init_state
from repro_torch.core.types import ContrastiveConfig, DualEncoder, RetrievalBatch
from repro_torch.optim import chain, clip_by_global_norm, sgd

AXIS = ("pod", "data")


def torch_mlp_encoder(dim_rep: int = 8) -> DualEncoder:
    """The twin of helpers.make_mlp_encoder: tanh MLP towers over vectors."""

    def tower(tp, x):
        return torch.tanh(x @ tp["w1"] + tp["b1"]) @ tp["w2"] + tp["b2"]

    def init(generator, device):
        raise NotImplementedError("the tests carry the JAX params across")

    return DualEncoder(
        init=init,
        encode_query=lambda params, x: tower(params["query"], x),
        encode_passage=lambda params, x: tower(params["passage"], x),
        rep_dim=dim_rep,
    )


def local_rows(x, rank, world):
    """This rank's contiguous block of the global rows (JAX's P("data"))."""
    n = x.shape[0] // world
    return x[rank * n : (rank + 1) * n]


def _bank(b: BankState):
    return {key: getattr(b, key).numpy() for key in ("buf", "valid", "head", "age")}


def trajectory(case, params0, batches, rank, world):
    """One program case over the batches on this rank's rows: per-step
    metrics, the final params and this rank's banks."""
    cfg = ContrastiveConfig(dp_axis=AXIS, temperature=1.0, grad_clip_norm=2.0, **case)
    tx = chain(clip_by_global_norm(cfg.grad_clip_norm), sgd(0.05))
    enc = torch_mlp_encoder()
    state = init_state(None, enc, tx, cfg, params=params_to_torch(params0, "cpu"), device="cpu")
    update = build_step_program(enc, tx, cfg).update
    metrics = []
    for b in batches:
        batch = RetrievalBatch(*(None if x is None else torch.from_numpy(local_rows(x, rank, world))
                                 for x in b))
        state, m = update(state, batch)
        metrics.append({k: float(v) for k, v in m._asdict().items()})
    return {"metrics": metrics, "params": params_to_numpy(state.params),
            "bank_q": _bank(state.bank_q), "bank_p": _bank(state.bank_p),
            "step": int(state.step)}


def collectives_case(rank, world, x, c):
    """gather (value, gradient), psum_tree, bool gather and ring_rotate
    (value, gradient, a full circle) on this rank's slices."""
    ctx = DistCtx(AXIS)
    out = {"is_distributed": ctx.is_distributed, "count": ctx.device_count(),
           "index": ctx.shard_index(), "perm": ctx.ring_perm(1)}
    xr = torch.from_numpy(x[rank]).requires_grad_(True)
    y = ctx.gather(xr)
    (y * torch.from_numpy(c[rank])).sum().backward()
    out["gather"], out["gather_grad"] = y.detach().numpy(), xr.grad.numpy()
    tree = {"a": torch.from_numpy(x[rank]), "b": [torch.full((3,), float(rank + 1)),
                                                 torch.tensor(rank, dtype=torch.int64)]}
    summed = ctx.psum_tree(tree)
    out["psum_tree"] = {"a": summed["a"].numpy(), "b0": summed["b"][0].numpy(),
                        "b1": int(summed["b"][1])}
    out["gather_bool"] = ctx.gather(torch.tensor([rank % 2 == 0, True, rank == 3])).numpy()
    s = torch.tensor([float(rank)], requires_grad=True)
    r = ctx.ring_rotate(s, 1)
    (r * float(rank + 1)).sum().backward()
    out["rotate"], out["rotate_grad"] = r.detach().numpy(), s.grad.numpy()
    full = (torch.tensor([float(rank)]), torch.tensor([rank == 1]))
    for _ in range(world):
        full = ctx.ring_rotate(full, 1)
    out["full_circle"] = (full[0].numpy(), full[1].numpy())
    port_dist.reset_collectives()
    ctx.gather(torch.zeros(2))
    ctx.psum(torch.zeros(()))
    ctx.ring_rotate(torch.zeros(2))
    out["collectives"] = dict(port_dist.collectives)
    return out


def loss_case(rank, world, spec, comm, backend):
    """contrastive_loss over sharded dual banks whose passage shard needs a
    gradient: this rank's loss share and its gradients w.r.t. its queries,
    positives, hard negatives and passage-bank shard."""
    ctx = DistCtx(AXIS)
    q, pp, ph = (torch.from_numpy(local_rows(spec[k], rank, world)).requires_grad_(True)
                 for k in ("q", "pp", "ph"))
    bq = BankState(*(torch.from_numpy(local_rows(spec["bank_q"][k], rank, world)) if k != "head"
                     else torch.zeros((), dtype=torch.int32) for k in BankState._fields))
    bp = BankState(*(torch.from_numpy(local_rows(spec["bank_p"][k], rank, world)) if k != "head"
                     else torch.zeros((), dtype=torch.int32) for k in BankState._fields))
    bp = bp._replace(buf=bp.buf.clone().requires_grad_(True))
    loss, aux = contrastive_loss(
        q, pp, ph, extra_cols=sharded_bank_extra_columns(bp, ctx, comm),
        extra_rows=sharded_bank_extra_rows(bq, bp, ctx), temperature=spec["temperature"],
        ctx=ctx, backend=backend,
    )
    loss.backward()
    return {"loss_dev": float(loss), "loss": float(aux.loss), "accuracy": float(aux.accuracy),
            "n_negatives": float(aux.n_negatives), "dq": q.grad.numpy(), "dpp": pp.grad.numpy(),
            "dph": ph.grad.numpy(), "dbank_p": bp.buf.grad.numpy()}


def run(rank, world, out_dir, spec):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(out_dir, "store"), world),
                            rank=rank, world_size=world)
    try:
        result = {"collectives": collectives_case(rank, world, spec["x"], spec["c"])}
        for name, case in spec["programs"].items():
            result[name] = trajectory(case, spec["params0"], spec["batches"], rank, world)
        for comm in ("all_gather", "ring"):
            for backend in ("dense", "fused"):
                result[f"loss/{comm}/{backend}"] = loss_case(rank, world, spec["loss"], comm,
                                                             backend)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(out_dir, spec, world):
    """Start ``world`` ranks on a FileStore under ``out_dir``; each saves
    ``rank<r>.pt`` there. Returns the ranks' results, in rank order."""
    torch.multiprocessing.spawn(run, args=(world, str(out_dir), spec), nprocs=world, join=True)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]

