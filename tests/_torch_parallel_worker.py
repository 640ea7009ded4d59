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
import math
import os
import socket
import tempfile

import numpy as np
import torch
import torch.nn.functional as F


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


def relative_errors(got, want):
    """Each tensor of ``got`` against ``want``'s, by name: a float tensor's
    largest difference relative to ``want``'s largest magnitude, an integer
    tensor's 0 when equal; inf for a name either lacks, or a shape or dtype
    that differs."""
    errs = {k: math.inf for k in set(got) ^ set(want)}
    for k, w in want.items():
        g = got.get(k)
        if g is None:
            continue
        if g.shape != w.shape or g.dtype != w.dtype:
            errs[k] = math.inf
        elif not w.is_floating_point():
            errs[k] = 0.0 if torch.equal(g, w) else math.inf
        else:
            errs[k] = float((g - w).abs().max() / max(float(w.abs().max()), 1e-300))
    return errs


def assert_states_close(got, want, what, rel=1e-9):
    """Every float tensor of ``got`` within ``rel`` of ``want``'s, relative
    to that tensor's largest magnitude; integer tensors equal; the same
    names, shapes and dtypes."""
    for k, err in sorted(relative_errors(got, want).items()):
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


@contextlib.contextmanager
def no_checkpoints():
    """The training loops without checkpoint files (``last`` and every
    epoch's): for runs whose states the test reads in memory, such as
    FCN8s's 2 GB float64 state, that would fill the disk for nothing."""
    from mcseg_tpu_torch.train import loops

    plain = loops.save_checkpoint, loops._EpochSaver.save_epoch
    loops.save_checkpoint = lambda *a, **kw: None
    loops._EpochSaver.save_epoch = lambda *a, **kw: None
    try:
        yield
    finally:
        loops.save_checkpoint, loops._EpochSaver.save_epoch = plain


def digest(tensors):
    """A SHA-256 of ``tensors`` (name -> tensor), names, dtypes and bytes:
    equal digests are bit-equal states."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(tensors):
        t = tensors[k]
        h.update(f"{k}:{t.dtype}:{tuple(t.shape)}".encode())
        h.update(t.numpy().tobytes())  # C order, whatever the strides
    return h.hexdigest()


def _cli(rank, world, port, argv, out_dir, float64=False, spatial=1, lean=False):
    """One rank of ``adapt_train.main(argv)`` joined by ``--coordinator``
    (``--spatial_devices spatial``), writing into ``out_dir/rank<r>`` (in
    float64 with ``float64``): its
    final state's tensors, their ``digest``, its step and the files it
    wrote. With ``lean`` (a large state) no checkpoint files are written
    and no tensors sent: rank 0 then runs ``argv`` again in one process
    (``one_step``) and sends its state's ``relative_errors`` against it."""
    from mcseg_tpu_torch.cli import adapt_train

    mine = os.path.join(out_dir, f"rank{rank}")
    with float64_commands() if float64 else contextlib.nullcontext(), \
            no_checkpoints() if lean else contextlib.nullcontext():
        state = adapt_train.main(argv + ["--spatial_devices", str(spatial), "--coordinator",
                                         f"127.0.0.1:{port}", "--num_processes", str(world),
                                         "--process_id", str(rank), "--out_dir", mine],
                                 device="cpu")
        tensors = state_tensors(state)
        out = {"tensors": None if lean else tensors, "digest": digest(tensors),
               "step": state.step, "float64": all(t.dtype == torch.float64 for t in
                                                   tensors.values() if t.is_floating_point()),
               "wrote": sorted(os.listdir(mine)) if os.path.isdir(mine) else None}
        del state
        if lean and rank == 0:
            one = adapt_train.main(argv + ["--out_dir", mine + "_one"], device="cpu")
            out.update(one_step=one.step, errors=relative_errors(tensors, state_tensors(one)))
    return out


def _grads_of(fn, x, module=None, probe=None):
    """(output, d(sum(output * probe))/dx, the module's parameter grads) of
    ``fn(x)`` on a fresh leaf, on the CPU."""
    x = x.clone().requires_grad_(True)
    y = fn(x)
    (y * probe).sum().backward()
    grads = {k: p.grad.cpu() for k, p in module.named_parameters()} if module else {}
    return {"y": y.detach().cpu(), "dx": x.grad.cpu(), "grads": grads}


def _upsample_spans(fn, x, probe):
    """``fn(x)``'s ``upsample`` spans under the profiler (CPU): each
    record's (backward, root), and the autograd nodes that the profiler saw
    inside the backward spans."""
    from torch.profiler import ProfilerActivity, profile

    from mcseg_tpu_torch.utils import profiler

    profiler.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiler.span("train.iteration"):
            _grads_of(fn, x, probe=probe)
    records = [(r["backward"], r["root"]) for r in profiler.span_records()
               if r["name"] == "upsample"]
    profiler.reset_spans()
    events = prof.events()
    marked = [e for e in events if e.name == "mcseg::upsample.backward"]
    nodes = sorted({e.name for e in events for m in marked
                    if e.name.rstrip("0123456789").endswith("Backward")
                    and m.time_range.start <= e.time_range.start
                    and e.time_range.end <= m.time_range.end})
    return {"records": records, "nodes": nodes}


def row_split_module(kind, params, **kw):
    """A float64 module of the row-split trunks in train mode, its
    parameters from the numpy dict ``params`` (None: torch's
    initialization): ``"ppm"`` (PSPNet's
    ``PyramidPooling``, ``kw`` its ``cin`` and ``reduce_ch``) or ``"fcn"``
    (``FCN8sClassifier``, ``kw`` its ``n_class`` and ``upsample``)."""
    from mcseg_tpu_torch.models.fcn_vgg import FCN8sClassifier
    from mcseg_tpu_torch.models.psp_net import PyramidPooling

    if kind == "ppm":
        m = PyramidPooling(kw["cin"], reduce_ch=kw["reduce_ch"])
    else:
        m = FCN8sClassifier(0, kw["n_class"], kw["upsample"])
    m = m.double().train()
    if params is not None:
        m.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    return m


def _module_grads(m, inputs, probe):
    """(output, input gradients, parameter gradients, BN running
    statistics) of ``m(*inputs)`` probed by ``probe``, on the CPU."""
    leaves = [x.clone().requires_grad_(True) for x in inputs]
    y = m(leaves[0] if len(leaves) == 1 else tuple(leaves))
    (y * probe).sum().backward()
    return {"y": y.detach().cpu(), "dx": [x.grad.cpu() for x in leaves],
            "grads": {k: p.grad.cpu() for k, p in m.named_parameters()},
            "buffers": {k: b.cpu().clone() for k, b in m.named_buffers()
                        if b.is_floating_point()}}


def halo_task(dp, space, convs, upsample, stem_pool=None, ceil_pool=None, modules=()):
    """The row-split ops on this rank's row block of global float64 inputs
    (the same on every rank, from numpy): ``convs`` is a list of (x, probe,
    weight, stride, dilation) for ``models.drn.Conv2d`` under the layout,
    ``upsample`` (x, probe, factor) for both modes of
    ``ops.upsample.upsample_logits``, ``stem_pool`` and ``ceil_pool`` an
    (x, probe) for PSPNet's stem pool and FCN8s's 2x2 ceil-mode pool, and
    ``modules`` a list of (kind, params, kw, inputs, probe, space) for
    ``row_split_module`` in a layout of ``space`` row blocks; each case's
    output, input gradient and parameter gradients (this rank's share)."""
    from mcseg_tpu_torch.models.drn import Conv2d, set_data_parallel
    from mcseg_tpu_torch.models.psp_net import stem_pool as psp_stem_pool
    from mcseg_tpu_torch.ops.upsample import upsample_logits
    from mcseg_tpu_torch.parallel.spatial import spatial_layout

    layouts = {s: spatial_layout(dp, s) for s in sorted({space} | {m[-1] for m in modules})}
    dp = layouts[space]
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
        out["upsample"][mode]["spans"] = _upsample_spans(
            lambda t: upsample_logits(t, factor, mode, dp), block_of(dp, x, 2).to(dp.device),
            block_of(dp, probe, 2).to(dp.device))
    pools = {"stem_pool": (stem_pool, lambda t: psp_stem_pool(t, dp)),
             "ceil_pool": (ceil_pool, lambda t: F.max_pool2d(t, 2, 2, ceil_mode=True))}
    for name, (case, fn) in pools.items():
        if case is not None:
            out[name] = _grads_of(fn, block_of(dp, case[0], 2), probe=block_of(dp, case[1], 2))
    out["modules"] = []
    for kind, params, kw, inputs, probe, s in modules:
        m = row_split_module(kind, params, **kw)
        set_data_parallel(m, layouts[s])
        out["modules"].append(_module_grads(m, [block_of(layouts[s], x, 2) for x in inputs],
                                            block_of(layouts[s], probe, 2)))
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
