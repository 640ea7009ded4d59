"""The benchmark's plain reference: models, preprocess, losses, optimizer
and the MCD iteration in plain PyTorch and NumPy. It imports nothing of the
program under test."""

import contextlib

import torch


@contextlib.contextmanager
def float32_exact():
    """TF32 off for the block (float32 products stay float32), restored
    after: the switches are process-wide and the program keeps its own."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
