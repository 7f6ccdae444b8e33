"""Data-parallel ticks of the critic models on 2 ``gloo`` ranks against the
JAX package's single-device step on the global batch, on the CPU (the
JAX package's DP tolerances, ``tests/test_torch_parallel.py``):

* WGAN-CLS with GAN-INT: the gradient penalty's second derivative through
  the conv and join kernels' Functions on each rank's rows, and the
  interpolated captions rolled over the global batch (rank 1's first row
  pairs with rank 0's last);
* C-PGGAN during a fade: the minibatch stddev over each stream's global
  batch, gathered differentiably, so that the penalty's second derivative
  crosses the ranks too.
"""

import dataclasses

from tests.helpers import tiny_config
from tests.test_torch_parallel import check_against_jax, dp_run
from tests.test_torch_pggan import _jax_ticks, pg_config
from tests.test_torch_wgan import jax_draws, jax_ticks


def test_wgancls_gan_int_dp_ticks_match_jax_single_device(tmp_path):
    jcfg = tiny_config("wgancls", n_critic=2, g_steps=1, beta1=0.0,
                       generator_lr=1e-4, discriminator_lr=1e-4,
                       use_interpolation=True)
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, coeff=dataclasses.replace(jcfg.train.coeff,
                                              drift_epsilon=1e-3)))
    ticks = jax_ticks(jcfg, n_ticks=2, batch_size=6)
    outs = dp_run(ticks, tmp_path, 2, dict(data=2, model=1, slices=1),
                  jax_draws)
    assert {"gp", "g_interp", "w_dist"} <= outs[0]["metrics"][0].keys()
    check_against_jax(ticks, outs)


def test_pggan_dp_tick_matches_jax_single_device(tmp_path):
    """Stage 2 of 3 at step 5 (α = 0.5), batch 4 over 2 ranks: each
    stream's stddev is over all 4 examples, as JAX's."""
    jcfg = pg_config(stage=2, n_critic=2, g_steps=1, beta1=0.0,
                     generator_lr=1e-4, discriminator_lr=1e-4,
                     use_interpolation=True)
    ticks = _jax_ticks(jcfg, step0=5)
    outs = dp_run(ticks, tmp_path, 2, dict(data=2, model=1, slices=1),
                  jax_draws)
    assert {"gp", "kl"} <= outs[0]["metrics"][0].keys()
    check_against_jax(ticks, outs)

