"""Data parallelism over ``torch.distributed``: one process per card, NCCL
between cards, gloo on the CPU (``multihost``); the context, batch rows,
autograd-aware reductions and gradient all-reduce (``mesh``); BatchNorm
over the global batch (``sync_bn``)."""
