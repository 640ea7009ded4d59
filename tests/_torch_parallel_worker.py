"""Ranks of a data-parallel group for the port's n-rank == 1-rank tests.

``spawn(jobs, world)`` starts ``world`` processes with
``torch.multiprocessing`` (spawn; ``Ranks`` leaves them running in the
background until ``results()``) and runs every ``(task, kwargs)`` of
``jobs`` on each rank, in order: ``"cli"`` runs ``adapt_train.main`` with
the group flags (``--coordinator``), which join and leave a group of their
own; the other tasks then run as ``TASKS[task](dp, **kwargs)`` in one gloo
group joined through ``parallel.multihost.initialize``. A task that takes
``space`` lays the group out in row blocks of that many ranks
(``parallel.spatial.spatial_layout``, on every rank in job order). It
returns, per rank, the jobs' results in order, and raises if any rank
failed. One spawn serves a whole test module. The workers import torch and
the port only (no JAX), and run on two CPU threads each.
"""

import contextlib
import json
import os
import socket
import tempfile

import numpy as np
import torch


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(rank, world, ports, jobs, out_dir, device="cpu"):
    from mcseg_tpu_torch.parallel.multihost import initialize, shutdown

    torch.set_num_threads(2)
    results = [_cli(rank, world, ports[1 + i], **kw) if task == "cli" else None
               for i, (task, kw) in enumerate(jobs)]
    if any(task != "cli" for task, _ in jobs):
        dp = initialize(f"127.0.0.1:{ports[0]}", world, rank, device, backend="gloo")
        try:
            for i, (task, kw) in enumerate(jobs):
                if task != "cli":
                    results[i] = TASKS[task](dp, **kw)
        finally:
            shutdown()
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


class Ranks:
    """``world`` ranks running ``jobs`` in the background, their group on
    ``device`` (gloo; ``"cuda:0"``: ranks sharing the card); ``results()``
    waits for them."""

    def __init__(self, jobs, world=2, device="cpu"):
        self.world, self._out = world, tempfile.TemporaryDirectory()
        ports = tuple(free_port() for _ in range(len(jobs) + 1))
        self._ctx = torch.multiprocessing.spawn(
            _run, args=(world, ports, jobs, self._out.name, device), nprocs=world, join=False)

    def results(self):
        try:
            while not self._ctx.join():
                pass
            return [torch.load(os.path.join(self._out.name, f"rank{r}.pt"), weights_only=False)
                    for r in range(self.world)]
        finally:
            self._out.cleanup()


def spawn(jobs, world=2, device="cpu"):
    return Ranks(jobs, world, device).results()


def rows_of(dp, a):
    """This rank's rows of a global numpy batch (all of them without a
    group), as a torch tensor."""
    from mcseg_tpu_torch.parallel.mesh import batch_rows

    r = batch_rows(dp, a.shape[0])
    return torch.from_numpy(np.ascontiguousarray(a if r is None else a[r]))


def block_of(dp, a, dim):
    """This rank's data block of a global numpy batch, then its row block
    along ``dim`` (the whole batch without a group), as a torch tensor."""
    from mcseg_tpu_torch.parallel.mesh import batch_rows

    r = batch_rows(dp, a.shape[0])
    a = a if r is None else a[r]
    if dp is not None and dp.space > 1:
        rows = a.shape[dim] // dp.space
        a = np.take(a, np.arange(dp.space_rank * rows, (dp.space_rank + 1) * rows), axis=dim)
    return torch.from_numpy(np.ascontiguousarray(a))


def state_tensors(state):
    """Parameters, BN statistics and both optimizers' states of a train
    state, by name, as CPU float64/int64 tensors."""
    out = {f"{name}.{k}": v.detach().cpu().clone()
           for name, m in state.modules().items() for k, v in m.state_dict().items()}
    for opt_name in ("opt_g", "opt_f"):
        opt = getattr(state, opt_name)
        i = 0
        for group in opt.param_groups:
            for p in group["params"]:
                for k, v in sorted(opt.state.get(p, {}).items()):
                    if isinstance(v, torch.Tensor):
                        out[f"{opt_name}.{i}.{k}"] = v.detach().cpu().clone()
                i += 1
    return out


def logged(out_dir, keys):
    """[records, keys] of the run's training log."""
    with open(os.path.join(out_dir, "train_log.jsonl")) as f:
        return np.array([[r[k] for k in keys] for r in map(json.loads, f)])


def assert_states_close(got, want, what, rel=1e-9):
    """Every float tensor of ``got`` within ``rel`` of ``want``'s, relative
    to that tensor's largest magnitude; integer tensors equal."""
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, (what, k, g.dtype, w.dtype)
        if not w.is_floating_point():
            assert torch.equal(g, w), (what, k)
            continue
        err = float((g - w).abs().max() / max(float(w.abs().max()), 1e-300))
        assert err <= rel, f"{what} {k}: relative error {err:.3g}"


def without_batch_counts(tensors):
    """The tensors JAX keeps too: flax's BatchNorm counts no batches."""
    return {k: v for k, v in tensors.items() if not k.endswith("num_batches_tracked")}


# --- tasks --------------------------------------------------------------------

def _grad_rows(fn, *inputs):
    """(value, grads of the inputs) of ``fn(*leaves)`` on fresh leaves."""
    leaves = [x.clone().requires_grad_(True) for x in inputs]
    value = fn(*leaves)
    value.backward()
    return value.detach(), [x.grad for x in leaves]


def losses_task(dp, batch_norm, ce, bce, berhu, disc):
    """BatchNorm over the global batch and the losses on this rank's rows of
    the global inputs (``dp`` None: one process, all rows); values and this
    rank's input gradients."""
    from mcseg_tpu_torch.losses.discrepancy import get_prob_distance_criterion
    from mcseg_tpu_torch.losses.seg import balanced_bce_2d, berhu_loss, cross_entropy_2d
    from mcseg_tpu_torch.models.drn import BatchNorm2d, set_data_parallel
    from mcseg_tpu_torch.parallel.mesh import all_sum

    out = {}
    x, probe, weight, bias, rm, rv = batch_norm
    bn = BatchNorm2d(x.shape[1], eps=1e-5, momentum=0.1).to(torch.float64)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(rm))
        bn.running_var.copy_(torch.from_numpy(rv))
    set_data_parallel(bn, dp)
    xl = rows_of(dp, x).requires_grad_(True)
    y = bn(xl)
    loss = all_sum((y * rows_of(dp, probe)).sum(), dp)
    loss.backward()
    out["bn"] = {"y": y.detach(), "loss": loss.detach(), "dx": xl.grad,
                 "dweight": bn.weight.grad, "dbias": bn.bias.grad,
                 "running_mean": bn.running_mean.clone(), "running_var": bn.running_var.clone()}
    logits, labels = ce
    out["ce"] = _grad_rows(lambda z: cross_entropy_2d(z, rows_of(dp, labels), dp=dp),
                           rows_of(dp, logits))
    logits, targets, valid = bce
    out["bce"] = _grad_rows(lambda z: balanced_bce_2d(z, rows_of(dp, targets),
                                                      rows_of(dp, valid), dp=dp),
                            rows_of(dp, logits))
    pred, depth = berhu
    out["berhu"] = _grad_rows(lambda z: berhu_loss(z, rows_of(dp, depth), dp=dp),
                              rows_of(dp, pred))
    a, b = disc
    for name in ("diff", "symkl"):
        out[name] = _grad_rows(get_prob_distance_criterion(name, dp),
                               rows_of(dp, a), rows_of(dp, b))
    return out


def train_task(dp, cfg_dict, out_dir, kind, iterations, space=1, **train_kw):
    """``train_adapt`` or ``train_multitask`` of ``cfg_dict`` for
    ``iterations`` under ``dp`` (laid out in row blocks of ``space``),
    writing into ``out_dir/rank<r>``; the final state's tensors, its step,
    the files each rank wrote and its log."""
    import dataclasses

    from mcseg_tpu_torch.core.config import ExperimentConfig
    from mcseg_tpu_torch.parallel.spatial import spatial_layout
    from mcseg_tpu_torch.train.loops import train_adapt, train_multitask

    dp = spatial_layout(dp, space)
    cfg = ExperimentConfig.from_dict(cfg_dict)
    mine = os.path.join(out_dir, f"rank{dp.rank}")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, out_dir=mine))
    fn = train_adapt if kind == "adapt" else train_multitask
    state = fn(cfg, max_iterations=iterations, device="cpu", dp=dp, **train_kw)
    return {"tensors": state_tensors(state), "step": state.step,
            "wrote": sorted(os.listdir(mine)) if os.path.isdir(mine) else None}


def eval_task(dp, params, cfg_dict, max_samples):
    """``evaluate`` of ``params`` under ``dp`` on the first ``max_samples``
    val samples: the confusion matrix."""
    import dataclasses

    from mcseg_tpu_torch.core.config import ExperimentConfig
    from mcseg_tpu_torch.eval.tester import evaluate

    cfg = ExperimentConfig.from_dict(cfg_dict)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, max_samples=max_samples))
    _, hist, _ = evaluate(params, cfg, print_table=False, device="cpu", num_workers=0, dp=dp)
    return {"hist": hist}


@contextlib.contextmanager
def float64_commands():
    """The training commands in float64, the oracle dtype that ``--dtype``
    does not offer: ``args_to_config`` of ``cli._train_main`` wrapped to
    set the model's dtype."""
    import dataclasses

    from mcseg_tpu_torch.cli import _train_main

    plain = _train_main.args_to_config

    def to_float64(args, adapt):
        cfg = plain(args, adapt)
        return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dtype="float64"))

    _train_main.args_to_config = to_float64
    try:
        yield
    finally:
        _train_main.args_to_config = plain


def _cli(rank, world, port, argv, out_dir, float64=False):
    """One rank of ``adapt_train.main(argv)`` joined by ``--coordinator``,
    writing into ``out_dir/rank<r>`` (in float64 with ``float64``): its
    final state's tensors and the files it wrote."""
    from mcseg_tpu_torch.cli import adapt_train

    mine = os.path.join(out_dir, f"rank{rank}")
    with float64_commands() if float64 else contextlib.nullcontext():
        state = adapt_train.main(argv + ["--coordinator", f"127.0.0.1:{port}",
                                         "--num_processes", str(world), "--process_id",
                                         str(rank), "--out_dir", mine], device="cpu")
    return {"tensors": state_tensors(state), "step": state.step,
            "wrote": sorted(os.listdir(mine)) if os.path.isdir(mine) else None}


def _grads_of(fn, x, module=None, probe=None):
    """(output, d(sum(output * probe))/dx, the module's parameter grads) of
    ``fn(x)`` on a fresh leaf, on the CPU."""
    x = x.clone().requires_grad_(True)
    y = fn(x)
    (y * probe).sum().backward()
    grads = {k: p.grad.cpu() for k, p in module.named_parameters()} if module else {}
    return {"y": y.detach().cpu(), "dx": x.grad.cpu(), "grads": grads}


def halo_task(dp, space, convs, upsample):
    """The row-split ops on this rank's row block of global float64 inputs
    (the same on every rank, from numpy): ``convs`` is a list of (x, probe,
    weight, stride, dilation) for ``models.drn.Conv2d`` under the layout,
    ``upsample`` (x, probe, factor) for both modes of
    ``ops.upsample.upsample_logits``; each case's output, input gradient and
    weight gradient (this rank's share)."""
    from mcseg_tpu_torch.models.drn import Conv2d, set_data_parallel
    from mcseg_tpu_torch.ops.upsample import upsample_logits
    from mcseg_tpu_torch.parallel.spatial import spatial_layout

    dp = spatial_layout(dp, space)
    out = {"convs": [], "upsample": {}}
    for x, probe, weight, stride, dilation in convs:
        k = weight.shape[-1]
        conv = Conv2d(weight.shape[1], weight.shape[0], k, stride=stride,
                      padding=dilation * (k // 2), dilation=dilation, bias=False).double()
        with torch.no_grad():
            conv.weight.copy_(torch.from_numpy(weight))
        set_data_parallel(conv.to(dp.device), dp)
        out["convs"].append(_grads_of(conv, block_of(dp, x, 2).to(dp.device), conv,
                                      block_of(dp, probe, 2).to(dp.device)))
    x, probe, factor = upsample
    for mode in ("convt", "resize"):
        out["upsample"][mode] = _grads_of(
            lambda t: upsample_logits(t, factor, mode, dp), block_of(dp, x, 2).to(dp.device),
            probe=block_of(dp, probe, 2).to(dp.device))
    return out


def spatial_step_task(dp, space, params, model_cfg, train_cfg, xs, ys, xt):
    """One MCD step (``train.mcd.make_mcd_step``) under a layout of
    ``space`` row blocks, from ``params`` on this rank's blocks of the
    global NHWC inputs: the metrics and the state's parameters."""
    from mcseg_tpu_torch.core.config import ModelConfig, TrainConfig
    from mcseg_tpu_torch.parallel.spatial import spatial_layout
    from mcseg_tpu_torch.train.mcd import make_mcd_step
    from mcseg_tpu_torch.train.state import create_train_state

    dp = spatial_layout(dp, space)
    mcfg, tcfg = ModelConfig(**model_cfg), TrainConfig(**train_cfg)
    state = create_train_state(mcfg, tcfg, 0, "cpu", params=params)
    state.set_data_parallel(dp)
    step = make_mcd_step(tcfg, mcfg.uses_one_classifier, torch.float64, dp)
    nchw = lambda a: block_of(dp, a, 1).permute(0, 3, 1, 2)  # noqa: E731
    metrics = step(state, nchw(xs), block_of(dp, ys, 1), nchw(xt))
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "params": state.params()}


TASKS = {"losses": losses_task, "train": train_task, "eval": eval_task, "halo": halo_task,
         "spatial_step": spatial_step_task}
