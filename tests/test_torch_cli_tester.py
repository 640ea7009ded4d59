"""The port's test commands against the JAX package's on one checkpoint.

A JAX ``create_train_state`` checkpoint (drn_d_14, input_ch 4, 40
classes, float64, no training: the JAX MCD step compiles for minutes on
the CPU) is scored by ``mcseg_tpu.cli.adapt_test.main`` and
``source_test.main``; the same weights, carried into a port checkpoint by
``params_from_jax``, are scored by the port's mains. 5 val samples of
``synthetic_shifted`` at 32x24 in batches of 3, so the ignore-padded tail
batch is scored too.

Bound: the mIoU within 1e-6. Both sides compute the trunk and heads in
float64 from the same float32 preprocessed input (which agrees to float32
rounding), so their predictions agree pixel for pixel unless two logits
tie within ~1e-7.
"""

import jax
import numpy as np

from _torch_parity import x64
from mcseg_tpu.cli import adapt_test as jax_adapt_test
from mcseg_tpu.cli import source_test as jax_source_test
from mcseg_tpu.core.config import DataConfig as JaxDataConfig
from mcseg_tpu.core.config import ExperimentConfig as JaxExperimentConfig
from mcseg_tpu.core.config import ModelConfig as JaxModelConfig
from mcseg_tpu.train.state import create_train_state as jax_create_train_state
from mcseg_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from mcseg_tpu_torch.cli import adapt_test, source_test
from mcseg_tpu_torch.core.config import ExperimentConfig
from mcseg_tpu_torch.train.state import create_train_state
from mcseg_tpu_torch.utils.checkpoint import save_checkpoint
from mcseg_tpu_torch.utils.jax_weights import params_from_jax
from _torch_threads import torch_threads  # noqa: F401  (autouse: the worker's cores)


def test_test_commands_match_the_jax_commands(tmp_path):
    jcfg = JaxExperimentConfig(
        model=JaxModelConfig(net="drn_d_14", input_ch=4, n_class=40, dtype="float64"),
        data=JaxDataConfig(src_dataset="synthetic", tgt_dataset="synthetic_shifted",
                           batch_size=3, train_img_shape=(32, 24), test_img_shape=(32, 24),
                           input_ch=4, max_samples=5, num_workers=1))
    jax_prefix, port_prefix = str(tmp_path / "jax" / "init"), str(tmp_path / "port" / "init")
    with x64():
        state, _, _ = jax_create_train_state(jcfg.model, jcfg.train, jax.random.key(3),
                                             img_shape=(24, 32))
        jax_save_checkpoint(jax_prefix, state, jcfg)
        want_adapt = jax_adapt_test.main([jax_prefix])
        want_source = jax_source_test.main([jax_prefix])
    params = params_from_jax(jax.tree.map(np.asarray, state.params),
                             jax.tree.map(np.asarray, state.batch_stats))
    cfg = ExperimentConfig.from_dict(jcfg.to_dict())
    save_checkpoint(port_prefix, create_train_state(cfg.model, cfg.train, device="cpu",
                                                    params=params), cfg)
    got_adapt = adapt_test.main([port_prefix], device="cpu")
    got_source = source_test.main([port_prefix], device="cpu")
    assert abs(got_adapt - want_adapt) < 1e-6, (got_adapt, want_adapt)
    assert abs(got_source - want_source) < 1e-6, (got_source, want_source)
    assert got_adapt != got_source  # F1 alone is another head than the average
