"""PyTorch/CUDA port of the multichannel segmentation system.

A second package beside the JAX one (``mcseg_tpu``), with the same public
layouts: raw NHWC planes in, ``[B, H, W]`` integer predictions out. Inside,
the trunk runs NCHW in ``channels_last`` memory. The hand-written CUDA
kernels live in ``csrc/`` and are compiled with ``nvcc`` at first use
(``mcseg_tpu_torch.utils.cuda_build``).

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; they raise when CUDA is asked for and absent.
"""
