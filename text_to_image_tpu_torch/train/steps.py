"""The training tick of every model (counterpart of
``text_to_image_tpu/train/steps.py``):

1. ``n_critic`` matching-aware D updates, each on its own data slice, over
   the real, fake and wrong streams (three streams in one D pass, each with
   its own BN statistics).  WGAN-CLS and C-PGGAN (``bundle.is_wgan``) train
   a critic: the Wasserstein loss with the gradient penalty at x̂ = fake +
   ε·(real − fake), each update with its own ε, and the drift term;
2. ``g_steps`` G updates on the last slice, all with one z (StackGAN and
   C-PGGAN add ``coeff.kl``·KL of their conditioning augmentation to the G
   loss, metric ``kl``);
3. Adam with the config's betas and the staircase LR decay on each net;
   a leaf the tick does not reach (the deeper C-PGGAN stages) takes a zero
   gradient, so every leaf's moments decay and its count advances with
   the rest, as optax does;
4. the optional generator EMA with the fade-aware ramp, counted from the
   bundle's ``ema_anchor``.

Under a profiler the tick records its spans (``utils/profiling``):
``train.tick`` holding ``train.noise`` (the noise drawn on the host and
copied to the device: the copies, counted on ``train.host_waits``, may
wait for the card; wait spans), ``train.d_step`` (its
``.forward`` with ``train.gp``, its ``.backward``, ``train.adam``),
``train.g_step`` (``.forward``, ``.backward``, ``train.adam``) and
``train.ema``; the resident tier's draw is ``data.draw``.

The bundle's hooks: ``step_aux(step)`` is merged into ``aux`` for the
tick (C-PGGAN's fade-in α) and ``prep_images`` runs on the f32 images
before the compute-dtype cast (C-PGGAN's downsample), as the JAX step does.

The JAX package compiles the tick into one XLA program; here it runs
eagerly, and every convolution, join and BN epilogue on the card is a
hand-written kernel (``ops/kernels``).

Semantics kept from the JAX step: the D step's generator runs train-mode
BN without gradient and its new G state is thrown away; the G step's D
call is one stream in train mode and its new D state is thrown away; only
the G steps update the G state.  Stage-II's frozen Stage-I generator
rides in ``aux`` (``stage1_g_params`` / ``stage1_g_state``): no gradient
reaches it, and it is in neither optimizer nor the EMA.  The noise of step
``s`` (z, the conditioning-augmentation ε and the GP's ε) comes from keys
``fold_in(fold_in(seed, s), 0 | 1)``, drawn on the CPU and moved to the
device, so a tick gives the same numbers on every device; a caller may pass
its own instead (``noise=``), as the tests do with the JAX step's draws.

Data parallelism (``env``, a ``parallel/mesh.MeshEnv`` with a batch group of
D = slice·data ranks): the JAX contract holds, N ranks on a global batch B
give the one-device result on B up to reduction-order rounding.  Each rank
gets its B/D rows of the batch, draws the global noise from (seed, step)
and keeps its rows of it, and runs the tick under
``collectives.batch_sync``, where the train-mode BN, C-PGGAN's minibatch
stddev and GAN-INT's pairing see the global batch.  No DDP wrapper: the
tick calls ``torch.autograd.grad`` itself, the GP with ``create_graph``.
The factor: rank r backprops its local mean loss L_r, and the global loss
is L = (1/D)·Σ_r L_r (equal shards).  L_r reaches the other ranks' rows
only through the collectives, whose backward all-reduces (sums) the
cotangents, so rank r's gradient is ∂(Σ_r' L_r')/∂θ along its own rows'
paths; summed over the ranks that is ∂(Σ_r L_r)/∂θ = D·∂L/∂θ.  So after
every ``_grads`` one flat all-reduce SUM over the batch group, ÷ D, gives
∂L/∂θ on every rank, and the replicated Adam and EMA stay replicated.  The
metrics are averaged over the group, so every rank holds the global ones.
Without a batch group nothing of this runs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from text_to_image_tpu_torch.config import Config
from text_to_image_tpu_torch.models import losses as LL
from text_to_image_tpu_torch.models import stackgan
from text_to_image_tpu_torch.models.registry import get_model, tree_to
from text_to_image_tpu_torch.ops import layers as L
from text_to_image_tpu_torch.parallel import collectives, mesh, tensor
from text_to_image_tpu_torch.parallel.mesh import MeshEnv
from text_to_image_tpu_torch.train import optim
from text_to_image_tpu_torch.train.checkpoint import unflatten
from text_to_image_tpu_torch.train.optim import flatten
from text_to_image_tpu_torch.train.state import TrainState
from text_to_image_tpu_torch.utils import prng, profiling


def _leaf_params(tree: Dict) -> Dict:
    return {k: _leaf_params(v) if isinstance(v, dict)
            else v.detach().clone().requires_grad_(True)
            for k, v in tree.items()}


def _detached(tree: Dict) -> Dict:
    return {k: _detached(v) if isinstance(v, dict) else v.detach()
            for k, v in tree.items()}


def _grads(loss: torch.Tensor, leaves, sync: Optional[collectives.Sync] = None
           ) -> Tuple[torch.Tensor, ...]:
    """d loss / d leaf for every leaf; zeros where the loss does not reach
    the leaf (the C-PGGAN layers deeper than the stage).  Over a batch
    group, the mean over its ranks (one flat all-reduce)."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = tuple(torch.zeros_like(p) if g is None else g
                  for p, g in zip(leaves, grads))
    if sync is None:
        return grads
    flat = collectives.all_reduce_sum(
        torch.cat([g.reshape(-1) for g in grads]), sync).div_(sync.size)
    return tuple(f.view_as(g) for f, g in
                 zip(flat.split([g.numel() for g in grads]), grads))


def batch_sync_of(env: Optional[MeshEnv]) -> Optional[collectives.Sync]:
    """The batch group of `env` as the tick's collectives take it; None
    without a process group."""
    if env is None or env.batch_group is None:
        return None
    return collectives.Sync(env.batch_group, env.shards, env.shard_index)


def model_sync_of(env: Optional[MeshEnv]) -> Optional[collectives.Sync]:
    """The model group of `env` as ``parallel/tensor.py`` takes it; None
    unless model > 1 in a process group."""
    if env is None or env.model_group is None:
        return None
    return collectives.Sync(env.model_group, env.model_size, env.coords[2])


def shard_state(ts: TrainState, env: Optional[MeshEnv]) -> TrainState:
    """`ts` with the ``w`` of every ``stem`` and ``embed`` linear cut to
    this rank's column block over the model group
    (`tensor.shard_columns`, the JAX dry run's placement), each Adam's
    moments and the generator EMA cut alike (both are elementwise), the
    update counts kept; `ts` itself without a model group."""
    sync = model_sync_of(env)
    if sync is None:
        return ts
    out = {}
    for net in ("g", "d"):
        params = tensor.shard_columns(getattr(ts, f"{net}_params"), sync)
        old = getattr(ts, f"{net}_opt")
        opt = optim.Adam(params, old.schedule,
                         *old.opt.param_groups[0]["betas"])
        if old.count:
            opt.load(old.count, *(dict(flatten(tensor.shard_columns(
                unflatten(m, old.leaves[0].device), sync)))
                for m in old.moments()))
        out.update({f"{net}_params": params, f"{net}_opt": opt})
    aux = dict(ts.aux)
    if "ema_g_params" in aux:
        aux["ema_g_params"] = tensor.shard_columns(aux["ema_g_params"], sync)
    return dataclasses.replace(ts, aux=aux, **out)


def shard_noise(cfg: Config, env: Optional[MeshEnv],
                noise: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """This rank's rows of `draw_noise`'s global noise: the batch is axis 1
    of the stacked entries (one per D update) and axis 0 of the others; the
    CA ε's is the bundle's ``eps_batch_axis``."""
    if env is None or env.batch_group is None:
        return noise
    eps_axis = get_model(cfg).eps_batch_axis
    axes = {"d": 1, "g": 0, "g2": 0, "gp_eps": 1, "d_eps": 1 + eps_axis,
            "g_eps": eps_axis, "g2_eps": eps_axis}
    return {k: mesh.shard_batch(env, v, axes[k]) for k, v in noise.items()}


def _clone(tree: Dict) -> Dict:
    return {k: _clone(v) if isinstance(v, dict) else v.detach().clone()
            for k, v in tree.items()}


def stage1_aux(cfg: Config, key: int, device="cuda",
               stage1: Optional[Tuple[Dict, Dict]] = None) -> Dict:
    """The ``aux`` entries of Stage-II's frozen Stage-I generator:
    `stage1` (params, state), for example from `convert.load_npz`, or one
    drawn from `key` at image_size/4 when None, so that dry runs need no
    earlier training run (the JAX package does the same)."""
    if stage1 is None:
        stage1 = stackgan.stage1_generator_init(
            prng.fold_in(key, 2), cfg.gan, cfg.data.image_size // 4)
    params, state = (_detached(tree_to(t, device)) for t in stage1)
    return {"stage1_g_params": params, "stage1_g_state": state}


def init_train_state(key: int, cfg: Config, steps_per_epoch: int = 1000,
                     device="cuda",
                     stage1: Optional[Tuple[Dict, Dict]] = None) -> TrainState:
    """Both networks drawn from `key` (f32, on `device`), fresh Adam states
    with the G decay period ``lr_decay_epoch·steps_per_epoch·g_steps`` and
    the D period ``…·n_critic``, step 0, ``aux['ema_g_params']`` (a copy
    of G) when ``train.ema_decay > 0`` and, for ``stackgan_stage2``, the
    frozen Stage-I generator beside it (`stage1_aux`)."""
    bundle = get_model(cfg)
    gp, gs, dp, ds = bundle.init(key, device)
    aux = stage1_aux(cfg, key, device, stage1) if bundle.needs_stage1 else {}
    return make_train_state(cfg, steps_per_epoch, gp, gs, dp, ds, aux=aux)


def make_train_state(cfg: Config, steps_per_epoch: int, g_params: Dict,
                     g_state: Dict, d_params: Dict, d_state: Dict,
                     step: int = 0, aux: Optional[Dict] = None) -> TrainState:
    """A TrainState around given trees: the params become f32 leaf tensors
    that require grad, the optimizers are fresh."""
    tcfg = cfg.train
    gp, dp = _leaf_params(g_params), _leaf_params(d_params)
    aux = dict(aux or {})
    if tcfg.ema_decay > 0 and "ema_g_params" not in aux:
        aux["ema_g_params"] = _clone(gp)
    return TrainState(
        g_params=gp, g_state=_clone(g_state), d_params=dp,
        d_state=_clone(d_state),
        g_opt=optim.generator_optimizer(gp, tcfg,
                                        steps_per_epoch * tcfg.g_steps),
        d_opt=optim.discriminator_optimizer(dp, tcfg,
                                            steps_per_epoch * tcfg.n_critic),
        step=step, aux=aux)


def draw_noise(cfg: Config, step: int, batch: int) -> Dict[str, torch.Tensor]:
    """The tick's noise on the CPU: z as ``d`` [n_critic, B, z] (one per D
    update), ``g`` [B, z] (shared by the G updates) and, with GAN-INT,
    ``g2`` [B, z] for the interpolated-caption term; for a model with
    conditioning augmentation also its ε under ``d_eps`` [n_critic, …],
    ``g_eps`` and ``g2_eps``, each of the bundle's ``eps_shape(B)``; for a
    critic the GP's ε ∈ U[0, 1) as ``gp_eps`` [n_critic, B, 1, 1, 1]."""
    key = prng.fold_in(cfg.seed, step)
    dkey, gkey = prng.fold_in(key, 0), prng.fold_in(key, 1)
    bundle = get_model(cfg)
    eps_shape = bundle.eps_shape(batch)

    def normal(k, shape=(batch, cfg.gan.z_dim)):
        return torch.randn(*shape, generator=prng.generator(k))

    d_keys = [prng.fold_in(dkey, k) for k in range(cfg.train.n_critic)]
    noise = {"d": torch.stack([normal(k) for k in d_keys]), "g": normal(gkey)}
    if cfg.train.use_interpolation:
        noise["g2"] = normal(prng.fold_in(gkey, 1))
    if eps_shape is not None:
        noise["d_eps"] = torch.stack([normal(prng.fold_in(k, 2), eps_shape)
                                      for k in d_keys])
        noise["g_eps"] = normal(prng.fold_in(gkey, 2), eps_shape)
        if cfg.train.use_interpolation:
            noise["g2_eps"] = normal(prng.fold_in(gkey, 3), eps_shape)
    if bundle.is_wgan:
        noise["gp_eps"] = torch.stack([prng.uniform_eps(prng.fold_in(k, 3),
                                                        batch)
                                       for k in d_keys])
    return noise


def make_train_step(cfg: Config, steps_per_epoch: int = 1000, device="cuda",
                    env: Optional[MeshEnv] = None):
    """Returns ``step(ts, batch, noise=None) -> (ts, metrics)``.

    `batch` holds real/wrong [K,B,H,W,3] (uint8, or float in [-1, 1]) and
    emb [K,B,E] with K = n_critic, as numpy arrays or tensors; `noise` is
    `draw_noise`'s dict, drawn from (seed, step) when None.  `ts` is updated
    in place and returned; metrics are 0-dim device tensors.  With a batch
    group in `env`, `batch` is this rank's B/D rows and `noise` is the
    global batch's, of which the tick keeps this rank's rows."""
    bundle = get_model(cfg)
    sync, msync = batch_sync_of(env), model_sync_of(env)
    policy = L.Policy.from_str(cfg.dtype)
    tcfg = cfg.train
    co = tcfg.coeff

    def images(x) -> torch.Tensor:
        """f32 images in [-1, 1] after the bundle's prep; the networks
        cast them."""
        x = torch.as_tensor(x).to(device, non_blocking=True)
        x = x.float() / 127.5 - 1.0 if x.dtype == torch.uint8 else x.float()
        return bundle.prep_images(x) if bundle.prep_images else x

    def d_step(ts: TrainState, aux, real, wrong, emb, z, eps, gp_eps
               ) -> Dict:
        with profiling.span("train.d_step.forward"):
            with torch.no_grad():
                fake, _, _ = bundle.gen_apply(ts.g_params, ts.g_state, aux,
                                              z, emb, eps, True, policy)
            xs = torch.stack([policy.cast(v) for v in (real, fake, wrong)])
            logits, new_state = bundle.disc_streams(
                ts.d_params, ts.d_state, aux, xs, emb.expand(3, *emb.shape),
                True, policy)
            if bundle.is_wgan:
                def critic_on_images(x):
                    return bundle.disc_apply(ts.d_params, ts.d_state, aux, x,
                                             emb, True, policy)[0]
                with profiling.span("train.gp"):
                    gp = LL.gradient_penalty(critic_on_images, real, fake,
                                             gp_eps)
                ld = LL.wgan_cls_d_loss(logits[0], logits[1], logits[2], gp,
                                        co.mismatch_alpha, co.gp_lambda,
                                        co.drift_epsilon)
            else:
                ld = LL.gan_cls_d_loss(logits[0], logits[1], logits[2],
                                       co.real_label_smooth)
        with profiling.span("train.d_step.backward"):
            grads = _grads(ld["d_loss"], ts.d_opt.leaves, sync)
        with profiling.span("train.adam"):
            ts.d_opt.update(grads)
        ts.d_state = _detached(new_state)
        return {k: v.detach() for k, v in ld.items()}

    def g_step(ts: TrainState, aux, emb, z, eps, z2, eps2) -> Dict:
        with profiling.span("train.g_step.forward"):
            lg, new_state = g_forward(ts, aux, emb, z, eps, z2, eps2)
        with profiling.span("train.g_step.backward"):
            grads = _grads(lg["g_loss"], ts.g_opt.leaves, sync)
        with profiling.span("train.adam"):
            ts.g_opt.update(grads)
        ts.g_state = _detached(new_state)
        return lg

    def g_forward(ts: TrainState, aux, emb, z, eps, z2, eps2):
        """The G step's losses and G's new BN state."""
        d_params = _detached(ts.d_params)
        fake, new_state, gen_aux = bundle.gen_apply(
            ts.g_params, ts.g_state, aux, z, emb, eps, True, policy)
        fake_logit, _ = bundle.disc_apply(d_params, ts.d_state, aux, fake,
                                          emb, True, policy)
        interp_logit = None
        if tcfg.use_interpolation:
            emb_int = LL.interpolate_embeddings(emb, co.interp_beta)
            fake_int, _, _ = bundle.gen_apply(ts.g_params, ts.g_state, aux,
                                              z2, emb_int, eps2, True, policy)
            interp_logit, _ = bundle.disc_apply(d_params, ts.d_state, aux,
                                                fake_int, emb_int, True,
                                                policy)
        if bundle.is_wgan:
            lg = LL.wgan_cls_g_loss(fake_logit)
            if interp_logit is not None:
                g_int = -interp_logit.float().mean()
                lg = {**lg, "g_interp": g_int,
                      "g_loss": lg["g_loss"] + co.interp_weight * g_int}
        else:
            lg = LL.gan_cls_g_loss(fake_logit, interp_logit,
                                   co.interp_weight)
        if bundle.has_ca:
            kl = LL.ca_kl_loss(gen_aux["mu"], gen_aux["logvar"])
            lg = {**lg, "kl": kl, "g_loss": lg["g_loss"] + co.kl * kl}
        return lg, new_state

    @torch.no_grad()
    def ema(ts: TrainState) -> None:
        decay = tcfg.ema_decay
        if tcfg.ema_rampup > 0:
            # fade-aware ramp from the bundle's anchor (C-PGGAN: the end of
            # this stage's fade; 0 for the others)
            t = float(max(ts.step - bundle.ema_anchor, 0))
            decay = min(decay, (1.0 + t) / (tcfg.ema_rampup + t))
        ema_leaves = [e for _, e in flatten(ts.aux["ema_g_params"])]
        live = [p for _, p in flatten(ts.g_params)]
        torch._foreach_lerp_(ema_leaves, live, 1.0 - decay)

    def step(ts: TrainState, batch, noise: Optional[Dict] = None
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with collectives.batch_sync(sync), tensor.model_sync(msync), \
                profiling.span("train.tick", step=ts.step):
            return tick(ts, batch, noise)

    def tick(ts: TrainState, batch, noise: Optional[Dict]
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        embs = torch.as_tensor(batch["emb"]).to(device, non_blocking=True)

        def on_device(name):
            """The noise `name` on the device: a copy from pageable host
            memory, which CUDA may make wait for the card (a host wait)."""
            if name not in noise:      # no GAN-INT term / no CA in this model
                return None
            profiling.count("train.host_waits")
            return torch.as_tensor(noise[name]).to(device, non_blocking=True)

        aux = ts.aux
        if bundle.step_aux is not None:
            # 0-dim CPU tensors: they enter the card's kernels as scalars
            aux = {**aux, **bundle.step_aux(ts.step)}
        # the noise's host path: where the card has drained, it waits here
        with profiling.span("train.noise", wait=True):
            if noise is None:
                shards = 1 if sync is None else sync.size
                noise = draw_noise(cfg, ts.step, embs.shape[1] * shards)
            noise = shard_noise(cfg, env, noise)
            zs, eps_d, gp_eps = (on_device(k)
                                 for k in ("d", "d_eps", "gp_eps"))
        for k in range(tcfg.n_critic):
            with profiling.span("train.d_step"):
                d_metrics = d_step(ts, aux, images(batch["real"][k]),
                                   images(batch["wrong"][k]), embs[k], zs[k],
                                   None if eps_d is None else eps_d[k],
                                   None if gp_eps is None else gp_eps[k])
        with profiling.span("train.noise", wait=True):
            g_noise = [on_device(k) for k in ("g", "g_eps", "g2", "g2_eps")]
        for _ in range(tcfg.g_steps):
            with profiling.span("train.g_step"):
                g_metrics = g_step(ts, aux, embs[-1], *g_noise)
        if tcfg.ema_decay > 0:
            with profiling.span("train.ema"):
                ema(ts)
        ts.step += 1
        metrics = {k: v.detach() for k, v in {**d_metrics,
                                              **g_metrics}.items()}
        if sync is not None:
            names = sorted(metrics)
            mean = collectives.all_reduce_sum(
                torch.stack([metrics[k].float() for k in names]), sync)
            metrics = dict(zip(names, mean.div_(sync.size)))
        return ts, metrics

    return step


def make_resident_step(cfg: Config, steps_per_epoch: int = 1000,
                       device="cuda", env: Optional[MeshEnv] = None):
    """Returns ``step(ts, data) -> (ts, metrics)`` for the device-resident
    tier (counterpart of the JAX ``make_resident_step``): the tick's
    [n_critic, B, …] batch is drawn and gathered on the data's device from
    ``data/device.batch_key(seed, ts.step)`` (`data` is a
    ``data/device.DeviceData``), then goes through `make_train_step`'s tick.
    The batch depends on (seed, step) alone, so a restored run replays it.
    ``step.batch_at(data, step)`` and ``step.tick(ts, batch)`` are the two
    halves.  With a batch group in `env` each rank gathers its rows of the
    global batch, or (``data/device.ShardedDeviceData``) draws them from
    its shard."""
    from text_to_image_tpu_torch.data import device as DD

    tick = make_train_step(cfg, steps_per_epoch, device, env)
    dcfg, tcfg = cfg.data, cfg.train
    rows = (None if batch_sync_of(env) is None
            else env.rows(tcfg.batch_size))

    def batch_at(data, step: int) -> Dict[str, torch.Tensor]:
        key = DD.batch_key(cfg.seed, step)
        args = (tcfg.n_critic, tcfg.batch_size, dcfg.image_size,
                dcfg.caption_window, dcfg.random_crop, dcfg.random_flip)
        if isinstance(data, DD.ShardedDeviceData):
            return DD.sample_stacked_sharded(data, key, *args, step=step)
        return DD.sample_stacked(data, key, *args, rows=rows, step=step)

    def step(ts: TrainState, data) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        return tick(ts, batch_at(data, ts.step))

    step.batch_at = batch_at
    step.tick = tick
    return step
