"""The ``serve`` kind: one closed-loop client of the program's serving entry.

Set-up draws the weights from the seed, sets the trunk's BatchNorm running
statistics to those of a reference forward over the first request (a
served model has trained statistics, and eval-mode BatchNorm with the
initial ones would let the activations grow through the trunk), builds
``mcseg_tpu_torch.eval.serving.make_serve_fn`` on them and draws a pool of
distinct requests of raw planes into host memory (numpy). ``warmup``
requests warm every shape up. In the window one client sends a request,
waits for its class map in host memory (a copy of the program's answer,
which stays on the card), and sends the next, the pool's requests in
turn, until ``seconds`` have passed. A request's latency runs from the
call with the numpy planes to the class map in host memory. A sample of
the window's answers, drawn from the seed by reservoir sampling, is kept
for the check.
"""

from __future__ import annotations

import gc
import random
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.lib import check, flops
from benchmark.lib.laps import Laps
from benchmark.lib.scenes import SCENE, TARGET_SHIFT, generator, scenes
from benchmark.lib.spec import SpecError, positive, validate
from benchmark.lib.trace import busy_seconds, reduce_profile
from benchmark.lib.weights import make_params
from benchmark.reference import float32_exact
from benchmark.reference.drn import UPSAMPLE, build_models, set_precision
from benchmark.reference.preprocess import serve_inputs

WEIGHTS, REQUESTS, SAMPLE = 1, 4, 5  # streams of the seed
WARMUP_REQUESTS = 2  # each warms every shape up
SAMPLED_ANSWERS = 8  # of the window's, for the check
TRACE_REQUESTS = 40

TRAFFIC = {"kind": ("serve",), "batch": positive(int), "pool": positive(int), "scene": SCENE}


def check_traffic(config: Dict, traffic: Dict, name: str) -> None:
    """``traffic`` against the schema and against ``config``: the scene
    draws depth exactly where the model reads HHA."""
    what = f"traffic/{name}.json"
    validate(traffic, TRAFFIC, what)
    if traffic["scene"]["depth"] != (config["model"]["input_ch"] == 6):
        raise SpecError(f"{what}: key 'scene.depth' must be true exactly when the model "
                        "reads RGB+HHA (input_ch 6)")


def program_config(config: Dict, traffic: Dict):
    from mcseg_tpu_torch.core.config import DataConfig, ExperimentConfig, ModelConfig

    model, prog = config["model"], config["program"]
    w, h = traffic["scene"]["width"], traffic["scene"]["height"]
    return ExperimentConfig(
        model=ModelConfig(net=prog["net"], input_ch=model["input_ch"],
                          n_class=model["n_class"], dtype=model["dtype"],
                          upsample=UPSAMPLE),
        data=DataConfig(src_dataset=prog["src_dataset"], tgt_dataset=prog["tgt_dataset"],
                        batch_size=traffic["batch"], train_img_shape=(w, h),
                        test_img_shape=(w, h), input_ch=model["input_ch"],
                        hha_on_device=True))


class Run:
    """One run of a serving cell on ``device``."""

    def __init__(self, config: Dict, traffic: Dict, seed: int, device="cuda"):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.model = config["model"]
        self.batch = traffic["batch"]
        self.hw = (traffic["scene"]["height"], traffic["scene"]["width"])
        self.cfg = program_config(config, traffic)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _peak(self) -> int:
        cuda = self.device.type == "cuda"
        return torch.cuda.max_memory_allocated(self.device) if cuda else 0

    def _reference_models(self, precision=None):
        mods = [m.to(self.device, self._ref_dtype()) for m in build_models(self.model)]
        for name, mod in zip(("G", "F1", "F2"), mods):
            mod.load_state_dict(self.params[name])
        if precision is not None:
            set_precision(mods, **precision)
        return mods

    def _ref_dtype(self):
        return torch.float64 if self.model["dtype"] == "float64" else torch.float32

    def _calibrate(self, request: Dict[str, torch.Tensor]) -> None:
        """The trunk's running statistics := one reference forward's batch
        statistics."""
        g, _, _ = self._reference_models()
        for m in g.modules():
            if hasattr(m, "momentum"):
                m.momentum = 1.0
        with float32_exact(), torch.no_grad():
            g.train()(serve_inputs(request, self.model["input_ch"]).to(self._ref_dtype()))
        self.params["G"] = {k: v.detach().to(torch.float32) if v.is_floating_point() else
                            v.detach().clone() for k, v in g.state_dict().items()}

    def setup(self, serve_wrapper=None) -> None:
        from mcseg_tpu_torch.eval.serving import make_serve_fn

        lap = Laps(self.device)
        self.params = make_params(self.model, generator(self.seed, WEIGHTS,
                                                        device=self.device))
        pool = [scenes(self.traffic["scene"], self.batch, TARGET_SHIFT,
                       generator(self.seed, REQUESTS, i, device=self.device), labels=False)
                for i in range(self.traffic["pool"])]
        self._calibrate(pool[0])
        self.pool = [{k: v.cpu().numpy() for k, v in req.items()} for req in pool]
        del pool
        lap("weights_and_inputs")
        serve = make_serve_fn(self.cfg, self.params, self.device)
        self.serve = serve_wrapper(serve) if serve_wrapper else serve
        lap("program_state")
        for i in range(WARMUP_REQUESTS):
            self.request(i)
        lap("first_requests")
        self.flops = flops.serve_flops(self.model, self.batch, self.hw)
        self.setup_parts = lap.parts

    def request(self, i: int) -> np.ndarray:
        """Request ``i`` of the pool's cycle: its class map in host memory."""
        return self.serve(self.pool[i % len(self.pool)]).cpu().numpy()

    def window(self, seconds: float) -> Dict:
        self._sync()
        self.setup_peak = self._peak()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        rng = random.Random(self.seed * 1_000_003 + SAMPLE)
        k = SAMPLED_ANSWERS
        self.answers: List = []
        lat, n = [], 0
        gc.collect()
        gc.disable()
        try:
            t0 = time.perf_counter()
            while True:
                t = time.perf_counter()
                pred = self.request(n)
                lat.append(time.perf_counter() - t)
                if n < k:
                    self.answers.append((n, pred))
                elif (j := rng.randrange(n + 1)) < k:
                    self.answers[j] = (n, pred)
                n += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            window_s = time.perf_counter() - t0
        finally:
            gc.enable()
        self.next = n
        return {"requests": n, "window_s": window_s, "latencies_s": lat, "failed": 0,
                "images": self.batch * n, "flops": self.flops * n,
                "window_peak_bytes": self._peak()}

    def trace(self) -> Dict:
        """Two stretches of ``TRACE_REQUESTS`` requests each: the first
        profiles the device alone (its busy time and idle share), the
        second the host's operations too (the device's operations, the
        upsample's kernels, the idle gaps' labels)."""
        from torch.profiler import ProfilerActivity, profile

        k = TRACE_REQUESTS

        def stretch(activities, first):
            self._sync()
            gc.collect()
            gc.disable()  # as in the window
            try:
                with profile(activities=activities) as prof:
                    t0 = time.perf_counter()
                    for i in range(k):
                        self.request(first + i)
                    wall = time.perf_counter() - t0
            finally:
                gc.enable()
            return prof, wall

        device, wall = stretch([ProfilerActivity.CUDA], self.next)
        busy_s = busy_seconds(device.events())
        del device
        both, both_wall = stretch([ProfilerActivity.CPU, ProfilerActivity.CUDA], self.next + k)
        out = reduce_profile(both, both_wall)
        out["host_traced"] = {"busy_s": out["busy_s"], "window_s": out["window_s"]}
        out["busy_s"], out["window_s"] = busy_s, wall
        out["requests"] = k
        out["images"] = self.batch * k
        return out

    def free(self) -> None:
        del self.serve
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_logits(self, i: int, mods) -> torch.Tensor:
        """The reference's logits [B, C, H, W] of pool request ``i`` through
        ``mods`` (``_reference_models``): the average of both heads over
        the trunk, eval mode, float32."""
        g, f1, f2 = (m.eval() for m in mods)
        req = {k: torch.as_tensor(v, device=self.device)
               for k, v in self.pool[i % len(self.pool)].items()}
        with float32_exact(), torch.no_grad():
            feat = g(serve_inputs(req, self.model["input_ch"]).to(self._ref_dtype()))
            return 0.5 * (f1(feat) + f2(feat))

    def numbers(self, answers, mods, served=None) -> Dict:
        """``logit_gap``, ``tile_gap`` and ``class_mismatch`` of ``answers`` [(request, class map)] against the
        reference's logits through ``mods``, each the largest over the
        answers; ``served(i)``, where given, makes the class map of request
        ``i`` in place of the answer (a control)."""
        names = ("logit_gap", "tile_gap", "class_mismatch")
        out = {name: 0.0 for name in names}
        for n, pred in answers:
            logits = self.reference_logits(n, mods)
            pred = served(n) if served else torch.as_tensor(pred, device=self.device)
            for name in names:
                out[name] = max(out[name], getattr(check, name)(logits, pred))
            del logits
        out["_answers"] = [n for n, _ in answers]
        return out

    def check(self) -> Dict:
        return self.numbers(self.answers, self._reference_models())
