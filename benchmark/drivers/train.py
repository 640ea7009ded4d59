"""The ``train`` kind: the program's MCD training iteration on batches
staged on the card.

Set-up builds one train state (``mcseg_tpu_torch.train.state.
create_train_state``) from weights the benchmark draws from the seed,
stages a pool of distinct (source, target) batch pairs of raw planes, and
drives the state through its first ``CHECK_ITERATIONS`` iterations with
the window's own call, ``mcseg_tpu_torch.train.loops.make_adapt_iteration``,
on pairs 0, 1, 2, ...: those iterations warm every shape up and are the
ones the reference follows. The window then enqueues iterations back to
back on the pool's pairs in turn, reading nothing and synchronizing
nowhere, until ``seconds`` have passed; it ends at the synchronize after
the last one. A traced run then profiles two stretches of ``TRACE_ITERATIONS``
more iterations each (``trace``).

What the check reads of the program: each check iteration's preprocessed
inputs as the MCD step receives them (a pass-through wrapper of the step
that ``make_adapt_iteration`` builds, installed while the iteration is
made; in the window it hands every call on unchanged), the losses the
iterations return, and at the step's ``A`` mark of the first iteration the
momentum buffers (the first gradient) and G's BatchNorm running statistics.

Crops and flips are both drawn by the program, a flip a coin per image, as
in its training.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List
from unittest import mock

import torch

from benchmark.lib import check, flops
from benchmark.lib.laps import Laps
from benchmark.lib.scenes import SCENE, SOURCE_SHIFT, TARGET_SHIFT, generator, scenes
from benchmark.lib.spec import SpecError, positive, share, validate
from benchmark.lib.trace import busy_seconds, reduce_profile
from benchmark.lib.weights import make_params
from benchmark.reference import float32_exact
from benchmark.reference.drn import UPSAMPLE, build_models
from benchmark.reference.mcd import MCD
from benchmark.reference.preprocess import canvas, draws, label_table, train_inputs

STAGES = ("preprocess", "A", "B", "C")
CHECK_ITERATIONS = 3  # the iterations the reference follows
TRACE_ITERATIONS = 3
# streams of the seed
WEIGHTS, SOURCE, TARGET = 1, 2, 3

TRAFFIC = {
    "kind": ("train",), "batch": positive(int), "pool": positive(int), "scene": SCENE,
    "train": {"num_k": positive(int), "lr": positive(float), "lr_power": float,
              "max_steps": positive(int), "momentum": share, "weight_decay": float,
              "crop_scale_min": positive(float)},
}


def check_traffic(config: Dict, traffic: Dict, name: str) -> None:
    """``traffic`` against the schema and against ``config``: the scene
    draws depth exactly where the model reads HHA, labels the label map
    knows, and the check iterations run on distinct pairs of the pool."""
    what = f"traffic/{name}.json"
    validate(traffic, TRAFFIC, what)
    sc, tr = traffic["scene"], traffic["train"]
    if sc["depth"] != (config["model"]["input_ch"] == 6):
        raise SpecError(f"{what}: key 'scene.depth' must be true exactly when the model "
                        "reads RGB+HHA (input_ch 6)")
    unknown = [c for c in sc["classes"] if str(c) not in config["label_map"]]
    if unknown:
        raise SpecError(f"{what}: key 'scene.classes': raw ids {unknown} are not in the "
                        "configuration's label map")
    if traffic["pool"] < CHECK_ITERATIONS:
        raise SpecError(f"{what}: key 'pool' must be at least {CHECK_ITERATIONS}, the check "
                        "iterations, so that each runs on a pair of its own")
    if tr["crop_scale_min"] > 1:
        raise SpecError(f"{what}: key 'train.crop_scale_min' must be at most 1")


def program_config(config: Dict, traffic: Dict, seed: int):
    """The program's configuration of the cell; ``seed`` seeds its crop and
    flip draws."""
    from mcseg_tpu_torch.core.config import (
        DataConfig, ExperimentConfig, ModelConfig, TrainConfig)

    model, prog, tr = config["model"], config["program"], traffic["train"]
    w, h = traffic["scene"]["width"], traffic["scene"]["height"]
    return ExperimentConfig(
        model=ModelConfig(net=prog["net"], input_ch=model["input_ch"],
                          n_class=model["n_class"], dtype=model["dtype"],
                          upsample=UPSAMPLE),
        data=DataConfig(src_dataset=prog["src_dataset"], tgt_dataset=prog["tgt_dataset"],
                        batch_size=traffic["batch"], train_img_shape=(w, h),
                        test_img_shape=(w, h), input_ch=model["input_ch"],
                        random_crop=True, crop_scale_min=tr["crop_scale_min"],
                        random_flip=True, hha_on_device=True),
        train=TrainConfig(opt="sgd", lr=tr["lr"], momentum=tr["momentum"],
                          weight_decay=tr["weight_decay"], num_k=tr["num_k"],
                          d_loss="diff", lr_schedule="poly", lr_power=tr["lr_power"],
                          max_steps=tr["max_steps"], seed=seed))


class Run:
    """One run of a training cell on ``device``. ``seed`` draws the weights,
    the batches and the crops and flips."""

    def __init__(self, config: Dict, traffic: Dict, seed: int, device="cuda"):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.model = config["model"]
        self.tr = traffic["train"]
        self.batch = traffic["batch"]
        self.hw = (traffic["scene"]["height"], traffic["scene"]["width"])
        self.cfg = program_config(config, traffic, seed)
        self.inputs = None  # the step's inputs, recorded in the check iterations

    # ---- set-up -------------------------------------------------------
    def make_pool(self) -> List:
        sc, n, dev = self.traffic["scene"], self.traffic["pool"], self.device
        return [(scenes(sc, self.batch, SOURCE_SHIFT, generator(self.seed, SOURCE, i,
                                                                   device=dev)),
                 scenes(sc, self.batch, TARGET_SHIFT, generator(self.seed, TARGET, i,
                                                                   device=dev),
                        labels=False))
                for i in range(n)]

    def _recording(self, make_step):
        """``make_step`` whose steps first record their inputs while
        ``self.inputs`` is a list."""
        def make(*args, **kwargs):
            step = make_step(*args, **kwargs)

            def recorded(state, xs, ys, xt, mark=None):
                if self.inputs is not None:
                    self.inputs.append((xs, ys, xt))
                return step(state, xs, ys, xt, mark)

            return recorded

        return make

    def setup(self, iterate_wrapper=None) -> None:
        from mcseg_tpu_torch.train import loops
        from mcseg_tpu_torch.train.state import create_train_state

        lap = Laps(self.device)
        self.params = make_params(self.model, generator(self.seed, WEIGHTS,
                                                        device=self.device))
        self.pool = self.make_pool()
        lap("weights_and_inputs")
        self.state = create_train_state(self.cfg.model, self.cfg.train, self.seed,
                                        self.device, params=self.params)
        lap("program_state")
        with mock.patch.object(loops, "make_mcd_step", self._recording(loops.make_mcd_step)):
            iterate = loops.make_adapt_iteration(self.cfg)
        self.iterate = iterate_wrapper(iterate) if iterate_wrapper else iterate
        self.first_grads: Dict[str, torch.Tensor] = {}
        self.prog_stats_a: Dict[str, torch.Tensor] = {}
        self.prog_losses, self.inputs = [], []
        for i in range(CHECK_ITERATIONS):
            src, tgt = self.pool[i % len(self.pool)]
            mark = self._after_a if i == 0 else None
            self.prog_losses.append(self.iterate(self.state, src, tgt, mark))
            if i == 0:
                self.prog_after1 = leaves(self.state.modules())
        self.prog_after = leaves(self.state.modules())
        self.prog_inputs, self.inputs = self.inputs, None
        lap("first_iterations")
        self.flops = flops.train_flops(self.model, self.tr["num_k"], self.batch, self.hw)
        self.setup_parts = lap.parts

    def _named(self):
        st = self.state
        for name, mod in st.modules().items():
            opt = st.opt_g if name == "G" else st.opt_f
            for k, p in mod.named_parameters():
                yield f"{name}.{k}", p, opt

    def _after_a(self, stage: str) -> None:
        """At the A mark of the first iteration: each parameter's gradient as
        its optimizer got it, from the momentum buffer it left, and G's
        BatchNorm running statistics after step A's one forward."""
        if stage != "A":
            return
        wd = self.tr["weight_decay"]
        for name, p, opt in self._named():
            mod, key = name.split(".", 1)
            buf = opt.state[p]["momentum_buffer"]
            self.first_grads[name] = buf - wd * self.params[mod][key]
        self.prog_stats_a = {k: v for k, v in leaves({"G": self.state.g}).items()
                             if k.endswith(("running_mean", "running_var"))}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _peak(self) -> int:
        cuda = self.device.type == "cuda"
        return torch.cuda.max_memory_allocated(self.device) if cuda else 0

    # ---- the window ---------------------------------------------------
    def window(self, seconds: float) -> Dict:
        self._sync()
        self.setup_peak = self._peak()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        losses, n, k0 = [], 0, CHECK_ITERATIONS
        gc.collect()
        gc.disable()
        try:
            t0 = time.perf_counter()
            while True:
                src, tgt = self.pool[(k0 + n) % len(self.pool)]
                m = self.iterate(self.state, src, tgt)
                losses += [m["loss_source"], m["loss_b"], m["loss_dis"]]
                n += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            self._sync()
            window_s = time.perf_counter() - t0
        finally:
            gc.enable()
        self.next = k0 + n
        bad = int((~torch.isfinite(torch.stack(losses))).view(n, 3).any(1).sum())
        return {"iterations": n, "window_s": window_s, "failed": bad,
                "images": 2 * self.batch * n, "flops": self.flops["total"] * n,
                "window_peak_bytes": self._peak()}

    def trace(self) -> Dict:
        """Two stretches of ``TRACE_ITERATIONS`` iterations each: the first
        profiles the device alone (its busy time and idle share) with a
        CUDA event at each of the program's stage marks, the second the
        host's operations too (the device's operations, the upsample's
        kernels, the idle gaps' labels)."""
        from torch.profiler import ProfilerActivity, profile

        k = TRACE_ITERATIONS
        marks: List[List] = []

        def mark(stage):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks[-1].append(ev)

        def stretch(activities, first, with_marks):
            self._sync()
            gc.collect()
            gc.disable()  # as in the window
            try:
                with profile(activities=activities) as prof:
                    t0 = time.perf_counter()
                    for i in range(k):
                        if with_marks:
                            marks.append([torch.cuda.Event(enable_timing=True)])
                            marks[-1][0].record()
                        src, tgt = self.pool[(first + i) % len(self.pool)]
                        self.iterate(self.state, src, tgt, mark if with_marks else None)
                    self._sync()
                    wall = time.perf_counter() - t0
            finally:
                gc.enable()
            return prof, wall

        device, wall = stretch([ProfilerActivity.CUDA], self.next, True)
        busy_s = busy_seconds(device.events())
        del device
        both, both_wall = stretch([ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                  self.next + k, False)
        out = reduce_profile(both, both_wall)
        out["host_traced"] = {"busy_s": out["busy_s"], "window_s": out["window_s"]}
        out["busy_s"], out["window_s"] = busy_s, wall
        # marks[i]: the iteration's start, then one event per stage's end
        out["stage_ms"] = {s: sum(ev[j].elapsed_time(ev[j + 1]) for ev in marks) / k
                           for j, s in enumerate(STAGES)}
        out["iterations"] = k
        out["images"] = 2 * self.batch * k
        return out

    # ---- the check ----------------------------------------------------
    def free(self) -> None:
        """Drop the program's state (what the check needs was kept)."""
        self.prog_losses = [{k: float(v) for k, v in m.items() if k != "lr"}
                            for m in self.prog_losses]
        del self.state, self.iterate
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, alter=None, rows=None) -> Dict:
        """The reference's first ``CHECK_ITERATIONS`` from the same weights,
        raw planes and draws (float32, or float64 where the configuration
        states float64), as ``numbers`` takes a side: its inputs,
        losses, first gradients, BatchNorm statistics after step A and leaves
        after the first and the last iteration. ``alter(modules)``, called
        on (G, F1, F2) once the weights are in, changes how they compute (a
        control, such as ``set_precision`` with ``reference/quant.py FP8``,
        or a planted fault); ``rows`` keeps only the first rows of each
        batch (a fault)."""
        dtype = torch.float64 if self.model["dtype"] == "float64" else torch.float32
        g, f1, f2 = (m.to(self.device, dtype) for m in build_models(self.model))
        for name, mod in zip(("G", "F1", "F2"), (g, f1, f2)):
            mod.load_state_dict(self.params[name])
        if alter is not None:
            alter((g, f1, f2))
        mcd = MCD(g, f1, f2, self.tr)
        table = label_table(self.config["label_map"], self.device)
        pre = canvas(self.hw, self.tr["crop_scale_min"])
        losses, inputs = [], []
        with float32_exact():
            for i in range(CHECK_ITERATIONS):
                src, tgt = self.pool[i % len(self.pool)]
                (ts, ls, fs), (tt, lt, ft) = draws(self.seed, i, self.batch, self.hw, pre)
                xs, ys = train_inputs(src, self.model["input_ch"], table, self.hw, pre,
                                      ts, ls, fs)
                xt, _ = train_inputs(tgt, self.model["input_ch"], table, self.hw, pre,
                                     tt, lt, ft)
                xs, xt = xs.to(dtype), xt.to(dtype)
                if rows is not None:
                    xs, ys, xt = xs[:rows], ys[:rows], xt[:rows]
                inputs.append((xs, ys, xt))
                losses.append({k: float(v) for k, v in mcd.iteration(xs, ys, xt).items()})
                if i == 0:
                    after1 = leaves(mcd.mods)
        return {"inputs": inputs, "losses": losses, "grads": mcd.first_grads,
                "stats_a": mcd.stats_a, "after1": after1, "after": leaves(mcd.mods)}

    def program_side(self) -> Dict:
        """The program's readings, as ``numbers`` takes a side."""
        return {"inputs": self.prog_inputs, "losses": self.prog_losses,
                "grads": self.first_grads, "stats_a": self.prog_stats_a,
                "after1": self.prog_after1, "after": self.prog_after}

    def numbers(self, prog: Dict, ref: Dict) -> Dict:
        """The check's numbers of one side (``program_side``, or a control's
        or a fault's ``reference``) against the reference's ``ref``; which
        of them decide ``correct`` is the cell's limits file's to say."""
        p0 = {f"{n}.{k}": v for n, sd in self.params.items() for k, v in sd.items()
              if v.is_floating_point()}
        moving = check.moving_leaves(ref["grads"])
        stats = [k for k in ref["after"] if k.endswith(("running_mean", "running_var"))]

        def change(leaves_, keys):
            return {k: leaves_[k] - p0[k] for k in keys}

        out = check.input_numbers(prog["inputs"], ref["inputs"], self.model["input_ch"])
        out["loss_gap"] = check.loss_gap(prog["losses"], ref["losses"])
        out["loss_a_gap"] = check.loss_gap([m["loss_source"] for m in prog["losses"][:1]],
                                           [m["loss_source"] for m in ref["losses"][:1]])
        out.update(check.summary("grad_gap", check.leaf_gaps(
            prog["grads"], ref["grads"], ref["grads"])))
        out.update(check.summary("grad_diff", check.leaf_diffs(
            prog["grads"], ref["grads"], ref["grads"])))
        out.update(check.summary("stats_a_diff", check.leaf_diffs(
            change(prog["stats_a"], stats), change(ref["stats_a"], stats), stats)))
        for name, after in (("update1_gap", "after1"), ("update_gap", "after")):
            out.update(check.summary(name, check.leaf_gaps(
                change(prog[after], moving + stats), change(ref[after], moving + stats),
                moving + stats)))
        out["_left_out"] = sorted(set(ref["grads"]) - set(moving))
        out["_losses"] = {"program": prog["losses"], "reference": ref["losses"]}
        return out

    def check(self) -> Dict:
        return self.numbers(self.program_side(), self.reference())


def leaves(modules: Dict[str, torch.nn.Module]) -> Dict[str, torch.Tensor]:
    """Copies of every floating-point leaf of ``modules`` (parameters and
    BatchNorm's running statistics), by ``<module>.<key>``."""
    return {f"{n}.{k}": v.detach().clone() for n, m in modules.items()
            for k, v in m.state_dict().items() if v.is_floating_point()}
