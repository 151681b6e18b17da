"""Stage-1 NeRF trainer: train step, EMA, lr schedule, grid refresh, eval, checkpoints.

Port of the ``-O`` path of ``palettenerf_tpu/train/trainer.py``:

- Adam(b1=0.9, b2=0.99, eps=1e-15). The lr of the k-th update (k = 0, 1, ...) is
  ``lr * 0.1**min(k/iters, 1)``: optax evaluates its schedule on the count of
  updates already made, so the first update uses ``lr`` itself (:138-141).
- EMA of the parameters with decay 0.95 after every update.
- Loss: MSE against the gt composited on a random per-ray background (RGBA data; with
  the background net, ``bg_radius > 0``, or ``--no_bg`` the straight RGB), plus
  ``lambda_sparse * rgb_norm`` (:172-205); with ``--patch_size > 1 --lambda_lpips`` the
  random-feature LPIPS of the batch's pixel patches (``metrics.rlpips_distance``,
  :194-204, its conv stack made once per trainer on its device). With ``--color_space
  linear`` the gt goes to linear space in every step and every eval (:177-178,
  :546-547); renders stay linear.
- Density-grid refresh: full below ``grid_update_warmup``, then the rotating 1/4 slab
  ``global_step // update_extra_interval`` (:378-384); never-seen cells are marked at the
  start of training (:442-446).
- Training runs on device-resident images with pixels sampled and rays generated on
  the device (``train_one_epoch_fast`` and its ``scan_steps``, :281-372, as a Python
  loop): the epoch's order is cut into runs of ``update_extra_interval`` steps, the last
  one shorter when that does not divide the image count, and the grid is refreshed at the
  start of every run (:352-356), so the refreshes restart at each epoch's first step.
  Where the JAX trainer takes its host-sampled epoch (``supports_fast_path`` false,
  :322-330), with ``--error_map``, ``--random_size`` or ``--patch_size``, the batches come
  from ``train_ds.iter_epoch()`` on the host, the grid is refreshed before every step
  whose ``global_step`` is a multiple of ``update_extra_interval`` (:466), and the error
  map is updated after each step (:462-490).
- ``-O2`` (``--fast_grad --stochastic_trilerp --grad_levels 8``) and ``--gridtype
  hash_xadd`` act in the encoder (``ops/hashgrid_fast.py``); each step draws its encode
  randomness (``models.nerf.encode_rand_for``) after the background and the jitter.
- The interactive hooks (:611-747): ``train_gui`` bursts on collated host batches,
  ``test_gui`` frames at a downscale, ``set_render_option`` for the GUI sliders,
  ``save_view``, and ``save_mesh`` (density lattice on the device, marching tetrahedra
  on the host).
- Ray data-parallel training (``--n_devices > 1``, :90-99): one process per rank
  (``palettenerf_torch.parallel``), each with the whole replicated state. A rank trains on
  its shard of every batch (``parallel.RayShard``; every draw of the step is made for
  the whole batch and sliced, so the generators stay in step and the rays are those of
  one process), scales its loss by 1/n_devices and counts the terms that read only
  parameters on rank 0, so that the summed gradients (``RayGroup.reduce_grads``, one
  all-reduce per step) are the whole batch's, and reports the whole batch's loss. The
  grid refresh, the EMA and Adam then run alike on every rank; the error map's update
  takes the rows of every rank; refused scatter rows and dropped samples are summed over
  the ranks. An eval frame is rendered a whole chunk per rank (chunk k on rank k mod
  n_devices: the compaction rounds pick their rays per chunk, so the frame equals the
  single-process frame); each rank writes its chunks into a zero frame and an all-reduce
  sums the frames. Rank 0 alone logs and writes
  checkpoints, images and meshes.
- The opt-in render options (:111-136), all off by default: ``--train_compact_frac`` /
  ``--eval_compact_frac`` (the network runs on the march-valid samples only, in a static
  budget; the eval renders' dropped samples are summed over a frame and logged once),
  ``--eval_fine_grid`` (a finer bitfield baked lazily from the EMA field at the first
  eval render, ``_eval_bitfield``, dropped whenever the weights or the grid change) and
  ``--march_groups`` (the hierarchical march; -1 resolves to 0, :656-670).

All randomness comes from one ``torch.Generator`` on the trainer's device, seeded
with ``opt.seed``, through the trainer's draw source (``draws.Draws``; ``train`` takes
another in its place); the host samplers of ``iter_epoch`` use the dataset's own NumPy
generator. ``--rand_pose`` (CLIP guidance, no weights in the repository) raises
(``check_ported``).
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Optional

import numpy as np
import torch

from .. import parallel, resolve_device
from ..config import Config
from ..data.png import write_png
from ..data.rays import gen_rays, gen_rays_torch
from ..models.mlp import param_leaves
from ..models.nerf import NeRFSpec, init_nerf, nerf_density
from ..ops.hashgrid_fast import EncodeRand
from ..ops.occupancy import (GridState, bake_fine_bitfield, init_grid_state,
                             mark_untrained_grid, unpackbits, update_density_grid)
from ..ops.scatter import check_refused
from ..render.nerf_renderer import (RenderSettings, render_nerf_eval, render_nerf_train,
                                    train_rows)
from ..utils import profiling
from ..utils.color import srgb_to_linear
from . import checkpoint as ckpt_lib
from .draws import Draws
from .metrics import PSNRMeter, make_rlpips_kernels, rlpips_distance

_DENSITY_CHUNK = 1 << 18  # grid points per density query during a refresh


def check_ported(opt: Config) -> None:
    """Raise for the option whose code path is not ported: ``rand_pose`` (CLIP guidance
    needs CLIP weights, which the repository does not hold)."""
    if opt.rand_pose >= 0:
        raise NotImplementedError("not ported to palettenerf_torch: rand_pose")


def _copy_params(params, device):
    """A detached copy of a parameter dict on ``device``: tensors, and lists of layers
    that are tensors or ``{"w", "b"}`` dicts of tensors."""
    def one(t):
        if isinstance(t, dict):
            return {k: one(v) for k, v in t.items()}
        return t.detach().to(device, copy=True)

    return {k: ([one(w) for w in v] if isinstance(v, list) else one(v))
            for k, v in params.items()}


def spec_cascade(spec: NeRFSpec) -> int:
    return 1 + max(0, math.ceil(math.log2(spec.bound)))


def gt_to_color_space(opt: Config, img: torch.Tensor) -> torch.Tensor:
    """Images [..., C] with their rgb in ``opt.color_space``: with "linear" the first three
    channels go through ``srgb_to_linear``, alpha stays."""
    if opt.color_space != "linear":
        return img
    return torch.cat([srgb_to_linear(img[..., :3]), img[..., 3:]], -1)


def eval_gt(opt: Config, img: np.ndarray) -> np.ndarray:
    """The ground truth of an eval image [H, W, C] (host): RGBA composited on white, in
    ``opt.color_space`` (JAX trainer.py:541-547)."""
    gt = img[..., :3]
    if img.shape[-1] == 4:
        gt = img[..., :3] * img[..., 3:] + 1.0 * (1 - img[..., 3:])
    if opt.color_space == "linear":
        gt = srgb_to_linear(torch.from_numpy(np.ascontiguousarray(gt))).numpy()
    return gt


class Trainer:
    """Stage-1 NeRF trainer; ``opt`` is a Config. Runs on ``device`` (CUDA by default)."""

    def __init__(
        self,
        name: str,
        opt: Config,
        spec: NeRFSpec,
        params=None,
        workspace: str = "workspace",
        use_checkpoint: str = "latest",
        ema_decay: Optional[float] = 0.95,
        eval_interval: int = 50,
        max_keep_ckpt: int = 2,
        mute: bool = False,
        device="cuda",
        metrics=None,
    ):
        check_ported(opt)
        self.name = name
        self.opt = opt
        self.spec = spec
        # the rank of a --n_devices run (its own device), or None in one process
        self.dp = parallel.group_for(opt.n_devices)
        if self.dp is not None:
            parallel.check_batch(opt.num_rays, opt.n_devices, opt.patch_size, opt.random_size)
        self.device = self.dp.device if self.dp is not None else resolve_device(device)
        self.is_main = self.dp is None or self.dp.is_main
        # --random_size batches come as (pixel, jittered pixel) halves (data/rays.py)
        self._paired = opt.random_size > 0 and opt.patch_size <= 1
        self.workspace = workspace
        self.ema_decay = ema_decay
        self.eval_interval = eval_interval
        self.max_keep_ckpt = max_keep_ckpt
        self.mute = mute
        self.metrics = metrics if metrics is not None else [PSNRMeter()]

        self.epoch = 0
        self.global_step = 0
        self.stats = {"loss": [], "valid_loss": [], "results": [], "best_result": None}
        self.grid_frozen = False  # PaletteTrainer: True (its grid is stage 1's)

        os.makedirs(workspace, exist_ok=True)
        self.ckpt_path = os.path.join(workspace, "checkpoints")
        self.best_path = os.path.join(self.ckpt_path, f"{name}.ckpt")
        self.log_path = os.path.join(workspace, f"log_{name}.txt")

        self.generator = torch.Generator(device=self.device).manual_seed(opt.seed)
        self.draws = Draws(self.generator)  # the draw source of every step and refresh
        self._set_params(params if params is not None else self._init_params())

        cascade = spec_cascade(spec)
        self.grid_state = init_grid_state(cascade, opt.grid_size, self.device)
        self.train_settings = RenderSettings(
            bound=spec.bound, cascade=cascade, grid_size=opt.grid_size,
            dt_gamma=opt.dt_gamma, max_steps=opt.max_steps,
            num_samples=opt.train_samples_per_ray, t_thresh=opt.t_thresh_train,
            min_near=opt.min_near, bg_radius=spec.bg_radius,
            march_groups=self._march_groups(), compact_frac=opt.train_compact_frac,
        )
        s_inf = opt.infer_samples_per_ray
        self.eval_settings = RenderSettings(
            bound=spec.bound, cascade=cascade, grid_size=opt.grid_size,
            dt_gamma=opt.dt_gamma, max_steps=opt.max_steps,
            num_samples=s_inf, t_thresh=opt.t_thresh_infer, min_near=opt.min_near,
            bg_radius=spec.bg_radius, compaction_rounds=self._compaction_rounds(s_inf),
            march_groups=self._march_groups(),
            compact_frac=opt.eval_compact_frac, fine_grid_size=int(opt.eval_fine_grid),
        )
        self._fine_bitfield = None   # the lazily baked --eval_fine_grid bitfield
        self._overflow = None        # train renders' dropped samples, summed on the device
        self.last_compact_overflow = None  # the last eval frame's, with --eval_compact_frac
        self._dev_src = None
        # the conv stack of the patch loss, made once (JAX :213-216)
        self._rlpips_kernels = (make_rlpips_kernels(device=self.device)
                                if opt.patch_size > 1 and opt.lambda_lpips > 0 else None)

        n_params = sum(p.numel() for p in param_leaves(self.params))
        self.log(f"[INFO] Trainer: {name} | {workspace} | {n_params} params | {self.device}")
        if use_checkpoint == "scratch":
            self.log("[INFO] Training from scratch ...")
        elif use_checkpoint in ("latest", "latest_model"):
            self.load_checkpoint(model_only=use_checkpoint == "latest_model")
        elif use_checkpoint == "best":
            self.load_checkpoint(self.best_path if os.path.exists(self.best_path) else None)
        else:
            self.load_checkpoint(use_checkpoint)

    # ------------------------------------------------------------------ helpers

    def _init_params(self):
        return init_nerf(self.spec, self.generator, self.device)

    def _trainable(self, params):
        """The tensors of ``params`` that the optimizer and the EMA move, in a fixed order."""
        return param_leaves(params)

    def _set_params(self, params, ema_params=None):
        """Adopt ``params`` (copied to the device; EMA = a copy unless given) and start a
        fresh optimizer on them: Adam's moments and the lr schedule's count restart."""
        self.params = _copy_params(params, self.device)
        for p in self._trainable(self.params):
            p.requires_grad_(True)
        self.ema_params = _copy_params(self.params if ema_params is None else ema_params,
                                       self.device)
        self.optimizer = self._optimizer(self._trainable(self.params))
        self.opt_step = 0  # optimizer updates made (the lr schedule's count)
        self._fine_bitfield = None  # the weights changed: rebake on the next eval

    def _optimizer(self, leaves) -> torch.optim.Optimizer:
        return torch.optim.Adam(leaves, lr=self.opt.lr, betas=(0.9, 0.99), eps=1e-15)

    def _march_groups(self) -> int:
        """Group slots of the hierarchical march: ``--march_groups``, where -1 (the
        default) resolves to 0 for every sample count. Strictly opt-in, as in JAX
        (:656-670): when more groups pass the coarse test than there are slots, samples
        the flat march keeps are dropped, and a default-on run diverged there."""
        return max(0, self.opt.march_groups)

    def _compaction_rounds(self, s_inf: int) -> tuple:
        """All rays march s/4 samples, the top 1/4 by transmittance s/4 more, the
        top 1/16 the last s/2 (nerf/renderer.py:336-386 as a static schedule)."""
        if self.opt.eval_compaction and s_inf % 4 == 0 and s_inf >= 16:
            return ((1, s_inf // 4), (4, s_inf // 4), (16, s_inf // 2))
        return ()

    def eval_params(self):
        return self.ema_params if self.ema_decay is not None else self.params

    def log(self, *args):
        if not self.is_main:
            return
        msg = " ".join(str(a) for a in args)
        if not self.mute:
            print(msg, flush=True)
        with open(self.log_path, "a") as f:
            f.write(msg + "\n")

    # ------------------------------------------------------------------ training

    def _batch_shard(self, n: int) -> Optional[parallel.RayShard]:
        """This rank's rays of a batch of ``n`` rays; None in one process."""
        if self.dp is None:
            return None
        return self.dp.shard(n, self._paired, max(1, self.opt.patch_size) ** 2)

    def _step_shard(self, n_local: int) -> Optional[parallel.RayShard]:
        """The shard of the batch whose ``n_local`` rays this rank's step was given."""
        return None if self.dp is None else self._batch_shard(n_local * self.dp.world)

    @staticmethod
    def _take(t, shard: Optional[parallel.RayShard]):
        """This rank's rows of a whole-batch ``t`` (rows per ray: ``t``'s length over the
        batch's); ``t`` itself in one process."""
        return t if shard is None or t is None else shard.take(t)

    def _encode_rand(self, n_rays: int, enc_u=None, enc_lvls=None,
                     shard: Optional[parallel.RayShard] = None,
                     draws: Optional[Draws] = None) -> Optional[EncodeRand]:
        """The step's encode draws: ``enc_u`` [train_rows, L] / ``enc_lvls`` [K] as given,
        or (both None) from ``draws`` (the trainer's), ``u`` then ``lvls``; None when the
        spec's profile uses none. ``train_rows`` is n_rays * S, or the compact budget with
        ``--train_compact_frac`` (JAX :178-186). On a rank (``shard``), ``n_rays`` is the
        whole batch's and ``u`` is cut to the rank's rows: its rays' slots, or with the
        compact budget (budget / n_devices per rank, where JAX has one budget for the
        batch: ROADMAP C15) the rank's block of the budget's rows."""
        if enc_u is not None or enc_lvls is not None:
            rand = EncodeRand(u=enc_u, lvls=enc_lvls)
        else:
            rand = (draws or self.draws).encode(self.spec,
                                                train_rows(self.train_settings, n_rays))
        if shard is None or rand is None or rand.u is None:
            return rand
        if self.train_settings.compact_frac > 0:
            m = train_rows(self.train_settings, shard.size)
            rows = (torch.arange(m, device=rand.u.device) + self.dp.rank * m) % rand.u.shape[0]
            return EncodeRand(u=rand.u[rows], lvls=rand.lvls)
        return EncodeRand(u=shard.take(rand.u), lvls=rand.lvls)

    def _add_overflow(self, out: dict) -> None:
        """Sum the train render's ``compact_overflow`` on the device (read once per epoch
        with the losses)."""
        if "compact_overflow" in out:
            self._overflow = out["compact_overflow"] + (
                0 if self._overflow is None else self._overflow)

    def train_step(self, rays_o, rays_d, images, bg=None, noise=None, enc_u=None,
                   enc_lvls=None, draws: Optional[Draws] = None):
        """One optimizer step on a ray batch; returns (loss, per_ray), detached.

        ``bg`` [N, 3] (background for RGBA gt), ``noise`` [N] (march jitter) and, under
        ``-O2``, the encode draws ``enc_u`` / ``enc_lvls`` are taken from ``draws`` (the
        trainer's draw source when None), in this order, when None. With the patch loss
        the batch is ``patch_size``^2-ray patches in ``data/rays.py``'s order.

        On a rank of a ``--n_devices`` run the rays, ``images`` and ``per_ray`` are the
        rank's shard of the batch, while the draws (given or drawn) are the whole
        batch's, and the loss is the whole batch's.
        """
        opt, dev = self.opt, self.device
        draws = draws or self.draws
        shard = self._step_shard(rays_o.shape[0])
        n = rays_o.shape[0] if shard is None else shard.n
        profiling.count("train.ray_count", rays_o.shape[0])
        with profiling.span("train.forward"):
            images = gt_to_color_space(opt, images)
            c = images.shape[-1]
            if c == 4 and self.spec.bg_radius <= 0 and not opt.no_bg:
                if bg is None:
                    bg = draws.background(n)
                bg = self._take(bg, shard)
                gt = images[..., :3] * images[..., 3:] + bg * (1.0 - images[..., 3:])
            else:
                bg = torch.ones((3,), dtype=torch.float32, device=dev)
                gt = images[..., :3]
            if noise is None:
                noise = draws.jitter(n)
            noise = self._take(noise, shard)
            rand = self._encode_rand(n, enc_u, enc_lvls, shard, draws)

            out = render_nerf_train(self.params, self.spec, self.grid_state.bitfield,
                                    rays_o, rays_d, self.train_settings,
                                    bg_color=bg, rays_gt=gt, noise=noise, rand=rand)
            self._add_overflow(out)
            per_ray = ((out["image"] - gt) ** 2).mean(-1) + out["rgb_norm"] * opt.lambda_sparse
            loss = per_ray.mean()
            if self._rlpips_kernels is not None:
                ps = opt.patch_size
                loss = loss + opt.lambda_lpips * rlpips_distance(
                    self._rlpips_kernels, out["image"].reshape(-1, ps, ps, 3),
                    gt.reshape(-1, ps, ps, 3))

        return self._update(loss), per_ray.detach()

    def _update(self, loss: torch.Tensor, zero_grad_for=(),
                param_loss: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Backward, one Adam step at the schedule's lr, EMA; returns the step's loss,
        ``loss + param_loss``, detached (``_backward`` says what the arguments are)."""
        total = self._backward(loss, zero_grad_for, param_loss)
        with profiling.span("train.optim"):
            self._set_lr(self._scheduled_lr())
            self._step_optimizer()
            self.opt_step += 1
        return total

    def _backward(self, loss: torch.Tensor, zero_grad_for=(),
                  param_loss: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The gradients of a step; returns its loss, ``loss + param_loss``, detached.
        ``loss`` holds the terms of the batch (means over its rays), ``param_loss``
        (optional) those that read only parameters. A tensor of ``zero_grad_for`` that got
        no gradient is given a zero one, so that its Adam step count runs on as optax's
        single count does.

        On a rank, ``loss`` is the rank's shard's: it is scaled by 1/n_devices and
        ``param_loss`` counted on rank 0 alone, so the gradients summed over the ranks
        are the whole batch's; the returned loss is summed with them."""
        self.optimizer.zero_grad(set_to_none=True)
        if self.dp is None:
            total = loss if param_loss is None else loss + param_loss
        else:
            loss = loss / self.dp.world
            total = loss if param_loss is None or not self.dp.is_main else loss + param_loss
        with profiling.span("train.backward"):
            total.backward()
        for p in zero_grad_for:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.dp is not None:
            total = self.dp.reduce_grads(self._trainable(self.params), loss.detach()[None])[0]
            if param_loss is not None:
                total = total + param_loss.detach()
        return total.detach()

    def _scheduled_lr(self) -> float:
        """The lr of the next update: ``lr * 0.1**min(k / iters, 1)`` at update k."""
        return self.opt.lr * 0.1 ** min(self.opt_step / self.opt.iters, 1.0)

    def _set_lr(self, lr: float) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    def _step_optimizer(self) -> None:
        """Adam's step on the gradients, then the EMA of the parameters."""
        self.optimizer.step()
        if self.ema_decay is not None:
            with torch.no_grad():
                ema, cur = self._trainable(self.ema_params), self._trainable(self.params)
                torch._foreach_mul_(ema, self.ema_decay)
                torch._foreach_add_(ema, cur, alpha=1.0 - self.ema_decay)

    _field_density = staticmethod(nerf_density)

    def _density(self, params, pts: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return torch.cat([self._field_density(params, self.spec, c)["sigma"]
                              for c in pts.split(_DENSITY_CHUNK)])

    def refresh_grid(self, draws: Optional[Draws] = None):
        """Full refresh during warmup, then the rotating 1/4 slab ``global_step //
        update_extra_interval`` (nerf/renderer.py:479-537; JAX :378-384). The jitter comes
        from ``draws`` (the trainer's draw source when None)."""
        opt = self.opt
        kw = dict(bound=self.spec.bound, density_thresh=opt.density_thresh,
                  grid_size=opt.grid_size)
        cells = opt.grid_size ** 3
        if self.global_step >= opt.grid_update_warmup:
            kw.update(partial_fraction=4,
                      slab_index=self.global_step // opt.update_extra_interval)
            cells //= 4
        with profiling.span("train.refresh", unit=self.global_step):
            noise = (draws or self.draws).refresh_noise(
                (self.grid_state.density_grid.shape[0], cells, 3))
            self.grid_state = update_density_grid(
                self.grid_state, lambda p: self._density(self.params, p), noise=noise, **kw)

    def train(self, train_ds, valid_ds=None, max_epochs: int = 1,
              draws: Optional[Draws] = None):
        """Train to ``max_epochs``; ``draws`` replaces the trainer's draw source for these
        epochs (``draws.Draws`` says what it draws)."""
        self.grid_state = mark_untrained_grid(
            self.grid_state, torch.as_tensor(train_ds.poses), train_ds.intrinsics,
            self.spec.bound, self.opt.min_near, self.opt.filter_close_point,
            self.opt.grid_size)
        for _ in range(max_epochs - self.epoch):
            self.epoch += 1
            self.train_one_epoch(train_ds, draws)
            self._fine_bitfield = None  # the weights and the grid changed
            self.save_checkpoint(best=False)
            if valid_ds is not None and self.epoch % self.eval_interval == 0:
                self.evaluate_one_epoch(valid_ds)
                self.save_checkpoint(best=True)
        return self.stats

    def host_sampled(self) -> bool:
        """Whether epochs take host-collated batches: the JAX trainers' epoch without
        ``supports_fast_path`` (error map, paired pixels, patches)."""
        opt = self.opt
        return bool(opt.error_map or opt.random_size > 0 or opt.patch_size > 1)

    def train_one_epoch(self, train_ds, draws: Optional[Draws] = None):
        """One step per training image, in a random order: device-sampled pixels on
        device-resident images, or the host-sampled epoch (``host_sampled``). ``draws``
        replaces the trainer's draw source."""
        with profiling.span("train.epoch", unit=self.epoch):
            return self._train_one_epoch(train_ds, draws)

    def _train_one_epoch(self, train_ds, draws: Optional[Draws]) -> float:
        t0 = time.time()
        self._overflow = None
        draws = draws or self.draws
        if self.host_sampled():
            losses = self._host_epoch(train_ds, draws)
        else:
            losses = self._device_epoch(train_ds, draws)
        with profiling.span("train.read"):
            avg = float(torch.stack(losses).mean())
            self._check_refused()  # the host has just waited for the device
            profiling.flush()      # the device counters, read while it waits for nothing
        self.stats["loss"].append(avg)
        self.stats.setdefault("epoch_seconds", []).append(time.time() - t0)
        note = self._epoch_note()
        if self._overflow is not None:
            dropped = int(self._overflow if self.dp is None
                          else self.dp.all_reduce_(self._overflow.clone()))
            self.stats.setdefault("compact_overflow", []).append(dropped)
            note += f", compact overflow {dropped}"
        self.log(f"[epoch {self.epoch}] loss={avg:.6f} ({len(losses)} steps, "
                 f"{time.time() - t0:.1f}s, step={self.global_step}{note})")
        return avg

    def _epoch_note(self) -> str:
        return ""

    def _check_refused(self) -> None:
        """Raise for rows the scatter kernel refused since the last check, on any rank."""
        if self.dp is None:
            return check_refused()
        return check_refused(reduce=lambda n: int(self.dp.all_reduce_(
            torch.tensor([n], dtype=torch.int64, device=self.device))))

    def _upload(self, train_ds):
        """Move the training images and poses to the device once per dataset."""
        if self._dev_src is not train_ds:
            imgs = torch.as_tensor(train_ds.images)
            self._dev_images = imgs.reshape(imgs.shape[0], -1, imgs.shape[-1]).to(self.device)
            self._dev_poses = torch.as_tensor(train_ds.poses).to(self.device)
            self._dev_src = train_ds

    def _device_epoch(self, train_ds, draws: Draws) -> list:
        """Pixels sampled and rays generated on the device, the grid refreshed at the
        start of every run of ``update_extra_interval`` steps of the epoch (JAX
        ``train_one_epoch_fast``, :352-356); returns the step losses."""
        self._upload(train_ds)
        B = self._dev_poses.shape[0]
        H, W = train_ds.H, train_ds.W
        intr = [float(v) for v in train_ds.intrinsics]
        order = draws.order(B)
        losses = []
        for i, idx in enumerate(order):
            with profiling.span("train.step", unit=self.global_step):
                if i % self.opt.update_extra_interval == 0:
                    self.refresh_grid(draws)
                with profiling.span("train.rays"):
                    inds = draws.pixels(self.opt.num_rays, H * W)
                    inds = self._take(inds, self._batch_shard(self.opt.num_rays))
                    pix = self._dev_images[idx][inds]
                    rays_o, rays_d = gen_rays_torch(self._dev_poses[idx], intr, H, W, inds)
                loss, _ = self.train_step(rays_o, rays_d, pix, draws=draws)
                losses.append(loss)
                self.global_step += 1
        return losses

    def _host_epoch(self, train_ds, draws: Draws) -> list:
        """Batches collated on the host by ``train_ds.iter_epoch()`` (its error-map and
        paired-pixel samplers), one upload each, the grid refreshed before every step
        whose ``global_step`` is a multiple of ``update_extra_interval`` (JAX :466); the
        error map takes each step's per-ray loss (trainer.py:462-490). Returns the step
        losses."""
        losses = []
        for data in train_ds.iter_epoch():
            with profiling.span("train.step", unit=self.global_step):
                if not self.grid_frozen and self.global_step % self.opt.update_extra_interval == 0:
                    self.refresh_grid(draws)
                loss, per_ray = self._batch_step(data, draws=draws)
                losses.append(loss)
                self.global_step += 1
                if "inds_coarse" in data:
                    if self.dp is not None:  # every rank updates its map from every rank's rows
                        per_ray = self.dp.gather_rows(
                            per_ray, self._batch_shard(len(data["inds_coarse"])))
                    train_ds.update_error_map(data["index"], data["inds_coarse"],
                                              per_ray.cpu().numpy())
        return losses

    # ------------------------------------------------------------------ eval

    def _eval_bitfield(self):
        """The bitfield of eval renders: the train grid's, or with ``--eval_fine_grid``
        the pair (train, fine), the fine one baked from the EMA field at first use after
        each change of the weights or the grid (JAX :405-427)."""
        fine = self.eval_settings.fine_grid_size
        if fine <= 0:
            return self.grid_state.bitfield
        if self._fine_bitfield is None:
            params = self.eval_params()
            t0 = time.time()
            self._fine_bitfield = bake_fine_bitfield(
                self.grid_state, lambda p: self._density(params, p), bound=self.spec.bound,
                density_thresh=self.opt.density_thresh, fine_size=fine,
                grid_size=self.opt.grid_size)
            occ = int(unpackbits(self._fine_bitfield).sum())
            self.fine_bake_stats = {"seconds": time.time() - t0, "occupied": occ}
            self.log(f"[INFO] baked {fine}^3 eval bitfield in {time.time() - t0:.1f}s "
                     f"({occ} occupied cells)")
        return (self.grid_state.bitfield, self._fine_bitfield)

    def render_image(self, rays_o, rays_d, bg_color=None, chunk: int = 16384):
        """Full-frame eval render in ray chunks -> dict of numpy arrays. Every chunk counts
        as ``chunk`` rays: JAX pads the short last one with copies of its last ray (:496-527),
        and the eval rounds and compact budgets are the padded chunk's; the port counts the
        copies without rendering them (``render_nerf_eval``'s ``pad_to``). With
        ``--eval_compact_frac`` the samples the budget dropped (the copies' included, as
        JAX counts them) are summed over the frame on the device and read once, after
        every chunk; a frame that dropped any is logged (JAX :518-524), and the count is
        kept in ``last_compact_overflow``."""
        with profiling.span("eval.frame"):
            return self._render_image(rays_o, rays_d, bg_color, chunk)

    def _render_image(self, rays_o, rays_d, bg_color, chunk: int) -> dict:
        rays_o = torch.as_tensor(rays_o, dtype=torch.float32)
        rays_d = torch.as_tensor(rays_d, dtype=torch.float32)
        bg = None if bg_color is None else torch.as_tensor(
            bg_color, dtype=torch.float32, device=self.device)
        params = self.eval_params()
        bitfield = self._eval_bitfield()

        def render(start):
            with profiling.span("eval.chunk"):
                return self._render_chunk(params, bitfield,
                                          rays_o[start:start + chunk].to(self.device),
                                          rays_d[start:start + chunk].to(self.device), bg,
                                          pad_to=chunk)

        starts = range(0, rays_o.shape[0], chunk)
        if self.dp is not None:  # whole chunks, chunk k on rank k mod n_devices
            starts = starts[self.dp.rank::self.dp.world]
        profiling.count("eval.chunks", len(starts))
        outs = [render(start) for start in starts]
        if self.dp is not None:
            # a rank without a chunk of its own (a frame of fewer chunks than ranks)
            # renders the first one for the outputs' layout, and writes nothing of it
            layout = outs[0] if outs else render(0)
            outs = [self._gather_chunks(layout, starts, outs, rays_o.shape[0])]
        with profiling.span("eval.gather"):
            dropped = [o.pop("compact_overflow") for o in outs if "compact_overflow" in o]
            frame = {k: torch.cat([o[k] for o in outs]).cpu().numpy() for k in outs[0]}
            profiling.flush()  # the device counters, read while the device waits for nothing
        if dropped:
            self.last_compact_overflow = int(torch.stack(dropped).sum())
            if self.last_compact_overflow > 0:
                self.log(f"[WARN] compact budget overflow: {self.last_compact_overflow} "
                         "valid samples dropped this frame — raise eval_compact_frac")
        return frame

    def _gather_chunks(self, layout: dict, starts, outs: list, n: int) -> dict:
        """The whole frame's outputs on every rank, from every rank's chunks (``outs``, at
        rows ``starts``): each rank writes its chunks at their rows of a zero frame on its
        device, and an all-reduce sums the frames (exact: each row is zero on every rank
        but one). The dropped-sample counts are summed."""
        full = {}
        for k, v in layout.items():
            if k == "compact_overflow":
                acc = torch.zeros_like(v)
                for o in outs:
                    acc += o[k]
            else:
                acc = v.new_zeros((n, *v.shape[1:]))
                for start, o in zip(starts, outs):
                    acc[start:start + o[k].shape[0]] = o[k]
            full[k] = self.dp.all_reduce_(acc)
        return full

    def _render_chunk(self, params, bitfield, rays_o, rays_d, bg, pad_to=None):
        return render_nerf_eval(params, self.spec, bitfield, rays_o, rays_d,
                                self.eval_settings, bg, pad_to)

    def eval_step_full(self, data, bg_color=None):
        out = self.render_image(data["rays_o"], data["rays_d"], bg_color)
        H, W = data["H"], data["W"]
        return {k: v.reshape(H, W, *v.shape[1:]) for k, v in out.items()}

    def evaluate_one_epoch(self, valid_ds, save_images: bool = True) -> float:
        for m in self.metrics:
            m.clear()
        total_loss, n = 0.0, 0
        for i, data in enumerate(valid_ds.iter_epoch()):
            pred = self.eval_step_full(data)["image"]
            img = data.get("images")
            if img is not None:
                gt = eval_gt(self.opt, img)
                total_loss += float(((pred - gt) ** 2).mean())
                n += 1
                for m in self.metrics:
                    if not m.basis_metric:
                        m.update(pred[None], gt[None])
            if save_images:
                self._save_image(os.path.join(
                    self.workspace, "validation",
                    f"{self.name}_ep{self.epoch:04d}_{i:04d}.png"), pred)
        result = self.metrics[0].measure() if n else 0.0
        self.stats["valid_loss"].append(total_loss / max(n, 1))
        self.stats["results"].append(result)
        if self.stats["best_result"] is None or result > self.stats["best_result"]:
            self.stats["best_result"] = result
        self.log(f"[eval epoch {self.epoch}] loss={total_loss / max(n, 1):.6f} | "
                 + " | ".join(m.report() for m in self.metrics))
        return result

    def test(self, test_ds, save_path: Optional[str] = None):
        """Render the test split to pngs (no mp4: the port uses no video encoder).
        ``main_nerf`` follows it with ``save_mesh``."""
        save_path = save_path or os.path.join(self.workspace, "results")
        t0 = time.time()
        n = 0
        for i, data in enumerate(test_ds.iter_epoch()):
            out = self.eval_step_full(data)
            self._save_image(os.path.join(
                save_path, f"{self.name}_ep{self.epoch:04d}_{i:04d}_rgb.png"), out["image"])
            n += 1
        dt = time.time() - t0
        self.log(f"[test] {n} frames, total {dt:.2f}s, avg {dt / max(n, 1):.3f}s/frame")

    def _load_optimizer(self, state: dict) -> None:
        """Adam's saved moments and step counts into this trainer's optimizer, which keeps
        its own lr and ``capturable`` (a checkpoint written on the card may be read on the
        CPU and the other way round); the step counts go where, and in the dtype, that
        setting keeps them (``capturable``: beside the parameter, in f64)."""
        own = [{k: g[k] for k in ("lr", "capturable")} for g in self.optimizer.param_groups]
        self.optimizer.load_state_dict(state)
        for group, kept in zip(self.optimizer.param_groups, own):
            group.update(kept)
            for p in group["params"]:
                st = self.optimizer.state.get(p, {})
                if "step" in st:
                    st["step"] = (st["step"].to(p.device, torch.float64) if kept["capturable"]
                                  else st["step"].to("cpu", torch.float32))

    # ------------------------------------------------------------------ GUI hooks

    def train_gui(self, train_ds, step: int = 16) -> dict:
        """One interactive burst of ``step`` optimizer steps on collated batches of
        ``train_ds`` (reference nerf/utils.py:745-800). Returns dict(loss, lr, time)."""
        t0 = time.time()
        losses = []
        it = train_ds.iter_epoch()
        for _ in range(step):
            try:
                data = next(it)
            except StopIteration:
                it = train_ds.iter_epoch()
                data = next(it)
            if not self.grid_frozen and self.global_step % self.opt.update_extra_interval == 0:
                self.refresh_grid()
            losses.append(self._batch_step(data)[0])
            self.global_step += 1
        loss = float(torch.stack(losses).mean())
        self._check_refused()  # the host has just waited for the device
        lr = float(self.opt.lr * 0.1 ** min(self.global_step / self.opt.iters, 1.0))
        return {"loss": loss, "lr": lr, "time": time.time() - t0}

    def _batch(self, data: dict, key: str, dtype=np.float32) -> torch.Tensor:
        """A per-ray array of a collated batch on the device: this rank's rows of it."""
        a = np.asarray(data[key], dtype)
        return torch.as_tensor(self._take(a, self._batch_shard(len(data["rays_o"]))),
                               device=self.device)

    def _batch_step(self, data: dict, **given):
        """One optimizer step from a collated batch; returns (loss, per_ray), detached.
        ``given`` (``bg``, ``noise``, ``enc_u``, ``enc_lvls``) replace the draw source's
        draws, and may name the source (``draws``)."""
        return self.train_step(self._batch(data, "rays_o"), self._batch(data, "rays_d"),
                               self._batch(data, "images"), **given)

    def _gui_train_step(self, data: dict, **given) -> torch.Tensor:
        """The GUI's training step (``_batch_step``); returns the loss, detached."""
        return self._batch_step(data, **given)[0]

    def test_gui(self, pose, intrinsics, W: int, H: int, downscale: float = 1.0,
                 bg_color=None) -> dict:
        """One interactive frame at ``downscale`` of W x H (reference nerf/utils.py:
        803-858): host numpy arrays shaped [rH, rW, ...]."""
        rW, rH = int(W * downscale), int(H * downscale)
        intr = np.asarray(intrinsics, np.float64) * downscale
        ro, rd = gen_rays(np.asarray(pose, np.float32), intr, rH, rW, None)
        out = self.render_image(ro, rd, bg_color)
        return {k: v.reshape(rH, rW, *v.shape[1:]) for k, v in out.items()}

    def set_render_option(self, **kw):
        """Live render-settings update from the GUI sliders (``dt_gamma``, ``num_samples``,
        ...): both settings take the values (JAX :684-700); a new ``num_samples`` without
        ``march_groups`` re-provisions the group slots of both, and the eval compaction
        schedule follows it."""
        tkw = {k: v for k, v in kw.items() if k != "compaction_rounds"}
        if "num_samples" in kw and "march_groups" not in kw:
            tkw["march_groups"] = kw["march_groups"] = self._march_groups()
        self.train_settings = dataclasses.replace(self.train_settings, **tkw)
        if "num_samples" in kw and "compaction_rounds" not in kw:
            kw["compaction_rounds"] = self._compaction_rounds(kw["num_samples"])
        self.eval_settings = dataclasses.replace(self.eval_settings, **kw)

    def save_view(self, pose, intrinsics, W: int, H: int, name: Optional[str] = None) -> str:
        """Render and save the current GUI viewpoint ('render view' button,
        palette/gui.py:387-399). Returns the path."""
        out = self.test_gui(pose, intrinsics, W, H)
        path = os.path.join(self.workspace, "results",
                            f"{name or self.name}_view_{int(time.time())}.png")
        self._save_image(path, out["image"])
        self.log(f"[GUI] saved view {path}")
        return path

    def density_lattice(self, resolution: int) -> np.ndarray:
        """Density (``sigma``, EMA weights) on the ``resolution``^3 lattice of
        linspace(-bound, bound) in x, y, z (ij order), queried on the device: [R, R, R]."""
        b = self.spec.bound
        lin = torch.from_numpy(np.linspace(-b, b, resolution, dtype=np.float32)).to(self.device)
        grid = torch.stack(torch.meshgrid(lin, lin, lin, indexing="ij"), -1).reshape(-1, 3)
        sigma = self._density(self.eval_params(), grid)
        return sigma.reshape((resolution,) * 3).cpu().numpy()

    def save_mesh(self, resolution: int = 256, threshold: float = 10.0,
                  save_path: Optional[str] = None) -> str:
        """Marching-tetrahedra mesh of the density field as a binary PLY (nerf/utils.py:
        633-653, 187-217). ``self.mesh_stats`` keeps the seconds of the lattice (device
        queries and the move to the host) and of the host's marching tetrahedra."""
        from ..utils.mcubes import marching_tetrahedra, write_ply

        if not self.is_main:
            return None
        save_path = save_path or os.path.join(
            self.workspace, "meshes", f"{self.name}_{self.epoch}.ply")
        os.makedirs(os.path.dirname(save_path), exist_ok=True)
        t0 = time.perf_counter()
        field = self.density_lattice(resolution)
        t1 = time.perf_counter()
        verts, faces = marching_tetrahedra(field, threshold)
        b = self.spec.bound
        verts = verts / (resolution - 1) * (2 * b) - b
        write_ply(save_path, verts, faces)
        self.mesh_stats = {"lattice_s": t1 - t0, "host_s": time.perf_counter() - t1,
                           "vertices": len(verts), "faces": len(faces)}
        self.log(f"[save_mesh] {len(verts)} verts, {len(faces)} faces -> {save_path}")
        return save_path

    def _save_image(self, path: str, img01: np.ndarray):
        if not self.is_main:
            return  # rank 0 writes the images of a --n_devices run
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_png(path, (np.clip(img01, 0, 1) * 255).astype(np.uint8))

    # ------------------------------------------------------------------ checkpoints

    def save_checkpoint(self, best: bool = False) -> Optional[str]:
        if not self.is_main:
            return None  # rank 0 writes the checkpoints of a --n_devices run
        payload = {"epoch": self.epoch, "global_step": self.global_step, "stats": self.stats}
        if best:
            # the best checkpoint holds the EMA weights only (nerf/utils.py:1134-1136)
            payload["params"] = _copy_params(self.eval_params(), "cpu")
        else:
            payload.update(
                params=_copy_params(self.params, "cpu"),
                ema_params=_copy_params(self.ema_params, "cpu"),
                grid_state={k: v.cpu() for k, v in self.grid_state._asdict().items()},
                optimizer=self.optimizer.state_dict(),
                opt_step=self.opt_step,
                generator=self.generator.get_state(),
            )
        return ckpt_lib.save_checkpoint(self.ckpt_path, self.name, self.epoch, payload,
                                        self.max_keep_ckpt, best=best)

    def load_checkpoint(self, path: Optional[str] = None, model_only: bool = False):
        if path is None:
            path = ckpt_lib.latest_checkpoint(self.ckpt_path, self.name)
            if path is None:
                self.log("[INFO] no checkpoint found, starting fresh")
                return
        data = ckpt_lib.load_checkpoint(path)
        self._set_params(data["params"], data.get("ema_params"))
        if model_only:
            self.log(f"[INFO] loaded model from {path}")
            return
        self.epoch = data.get("epoch", 0)
        self.global_step = data.get("global_step", 0)
        self.stats = data.get("stats", self.stats)
        if "grid_state" in data:
            self.grid_state = GridState(**{k: v.to(self.device)
                                           for k, v in data["grid_state"].items()})
        if "optimizer" in data:
            self._load_optimizer(data["optimizer"])
            self.opt_step = data.get("opt_step", self.global_step)
        if "generator" in data:
            self.generator.set_state(data["generator"])
        self.log(f"[INFO] loaded checkpoint {path} (epoch {self.epoch}, "
                 f"step {self.global_step})")
