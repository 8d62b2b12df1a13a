"""Training, back to back: `Trainer.train_step` on batches of source and
driving frames from pinned host memory, with one step in flight (the host
enqueues step i + 1 while the card runs step i, and waits for step i
before it goes on), as a training loop that reads its losses late does.

Set-up builds the one `Trainer` the window uses and drives it through its
first `check_steps` steps on the window's own call and feed (rows that all
differ), which also warm up every shape; what the check compares is read
from those steps: each step's loss, the first gradient as Adam received it
(twice its first moment after one step, beta1 = 0.5) and the weights'
change after the last of them, each by leaf.

Traffic keys: dtype, frame_size, batch, bank (batches made ahead, used in
turn), motion, check_steps, trace_calls.
"""
from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

from portbench import arith, inputs
from portbench.harness import COMPUTE_DTYPES
from portbench.compare import training_gaps
from portbench.reference import train as reference_train
from portbench.reference.lowp import lower_precision
from portbench.weights import make_weights


def generators(seed: int):
    """The CPU generators of the equivariance transforms and the dropout
    masks, seeded from the run's seed; the program and the reference each
    get a pair in the same state."""
    return (torch.Generator().manual_seed((int(seed) * 7919 + 11) % (2 ** 63)),
            torch.Generator().manual_seed((int(seed) * 7919 + 12) % (2 ** 63)))


def trained_names(model) -> list:
    """The leaves Adam trains: the encoder's, the decoder's, the dense motion's."""
    return [n for n, _ in model.named_parameters()
            if n.split(".")[0] in reference_train.MAIN_SUBTREES]


def leaf_norms(tensors) -> torch.Tensor:
    return torch.stack([t.detach().float().norm() for t in tensors]).cpu()


class Entry:
    def __init__(self, ctx):
        self.ctx = ctx
        self.batch = ctx.traffic["batch"]
        self.dropout_p = ctx.config.get("dropout_p")

    def _host_batch(self, i: int, rows=None):
        b = i % len(self.sources)
        return self.sources[b][:rows], self.drivers[b][:rows]

    def setup(self) -> None:
        from mrfa_tpu_torch.train.trainer import Trainer

        ctx, tr = self.ctx, self.ctx.traffic
        self.sources, self.drivers = inputs.training_pairs(
            tr["bank"], self.batch, tr["frame_size"], tr["motion"], ctx.seed, ctx.device)
        weights = make_weights(ctx.model_cfg, ctx.seed, ctx.device, ctx.config.get("init"))
        gen, dgen = generators(ctx.seed)
        self.trainer = Trainer(ctx.model_cfg, device=ctx.device, weights=weights, generator=gen,
                               dropout_generator=dgen, compute_dtype=COMPUTE_DTYPES[ctx.dtype])
        model = self.trainer.model
        names = trained_names(model)
        params = dict(model.named_parameters())
        self.i, self.pending, self.losses = 0, None, []
        for step in range(tr["check_steps"]):
            self.call()
            self.losses.append(self.terms["loss"])
            if step == 0:
                state = self.trainer.optimizer.state
                self.grad_norms = 2.0 * leaf_norms(
                    [state[params[n]]["exp_avg"] if params[n] in state
                     else torch.zeros(()) for n in names])
        self.change_norms = leaf_norms([params[n] - weights[n] for n in names])
        self.losses = [float(x) for x in self.losses]
        self.names = names
        del weights
        self.drain()

    def call(self) -> dict:
        with record_function("h2d"):
            source, driving = (x.to(self.ctx.device, non_blocking=True)
                               for x in self._host_batch(self.i))
        self.i += 1
        with record_function("train_step"):
            self.terms, _ = self.trainer.train_step(
                {"source": source, "driving": driving},
                dropout_flag=self.dropout_p is not None, dropout_p=self.dropout_p or 0.0)
        if self.ctx.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
            if self.pending is not None:
                self.pending.synchronize()
            self.pending = done
        return {"units": self.batch, "steps": 1}

    def drain(self) -> None:
        self.ctx.sync()
        self.pending = None

    def release(self) -> None:
        del self.trainer

    def reference(self, precision=None, rows=None):
        """The reference's readings over the same first steps: losses, the
        first clipped gradient's and the change's leaf norms; `precision` puts
        it in a lower one (the control), `rows` feeds it only the first rows
        of each batch (a planted fault)."""
        ctx = self.ctx
        weights = make_weights(ctx.model_cfg, ctx.seed, ctx.device, ctx.config.get("init"))
        gen, dgen = generators(ctx.seed)
        ref = reference_train.Trainer(ctx.model_cfg, weights, ctx.device, gen, dgen,
                                      self.dropout_p)
        params = dict(ref.model.named_parameters())
        scope = (lower_precision(ref.model, precision) if precision
                 else contextlib.nullcontext())
        losses = []
        with scope:
            for step in range(ctx.traffic["check_steps"]):
                source, driving = (x.to(ctx.device).float().permute(0, 3, 1, 2).contiguous()
                                   for x in self._host_batch(step, rows))
                if step == 0 and ctx.trace and ctx.flops_per_unit is None and precision is None:
                    out = []
                    flops = arith.count_flops(lambda: out.append(ref.step(source, driving)))
                    ctx.flops_per_unit = flops / self.batch
                    terms = out[0]
                else:
                    terms = ref.step(source, driving)
                losses.append(float(terms["loss"]))
                if step == 0:
                    grad_norms = leaf_norms([params[n].grad if params[n].grad is not None
                                             else torch.zeros(()) for n in self.names])
        change_norms = leaf_norms([params[n] - weights[n] for n in self.names])
        del ref, weights
        return losses, grad_norms, change_norms

    def check(self) -> dict:
        self.ref = self.reference()
        return training_gaps((self.losses, self.grad_norms, self.change_norms), self.ref)
