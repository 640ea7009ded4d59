"""Seconds of each part of a set-up, each ended by a synchronize."""

import time

import torch


class Laps:
    def __init__(self, device: torch.device):
        self.device, self.parts, self.t = device, {}, time.perf_counter()

    def __call__(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.parts[name] = now - self.t
        self.t = now
