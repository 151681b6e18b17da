"""PaletteNeRF trainer (stage 3) and the palette extraction that feeds it (stage 2).

Port of ``palettenerf_tpu/train/palette_trainer.py`` (reference ``PaletteTrainer``,
``palette/utils.py:296-1331``):

- warm start of the sigma / color nets and the density grid from the stage-1 NeRF
  checkpoint by parameter name (:429-432, :1306-1330); the density grid stays frozen
  during palette training (:644-646).
- loss (:486-571): MSE(image) + MSE(direct_rgb) [+ MSE(clip_feat)]
  + lambda_sparsity * omega_sparsity + lambda_offsets * |offsets|^2
  + lambda_view_dep * |view_dep|^2 + lambda_smooth * smooth
  + lambda_palette * |basis_color - origin|^2 + lambda_weight * MSE(basis_acc, gt weights)
  [+ lambda_patchsmooth * ``patch_smooth_term`` on the paired pixels of ``--random_size``
  batches, once the smooth loss is on].
- epoch schedules (:651-674): lambda_weight decays linearly to 0 by
  ``lweight_decay_epoch``; the basis colors are unfrozen and lambda_palette switched on
  after ``max_freeze_palette_epoch``; the smooth loss starts after
  ``smooth_loss_start_epoch``. A resumed run re-derives them from its epoch.
- epochs as the stage-1 trainer's: device-sampled pixels, or with ``--random_size`` /
  ``--error_map`` / ``--patch_size`` host-collated batches with the error map's update
  (:433-460); patches have no loss term of their own in this stage, as in JAX.
- the ground truth as the stage-1 trainer takes it: the straight RGB of RGBA images with
  the background net (which the warm start copies from stage 1 and this stage trains),
  in linear space with ``--color_space linear`` (:138-140, :479-480, :623-624).
- ``--n_devices > 1`` as in the stage-1 trainer (``palettenerf_torch.parallel``): a
  paired ``--random_size`` batch gives each rank the same block of both halves, so
  ``patch_smooth_term`` pairs ray i with ray i + N/2 within the rank; the
  ``lambda_palette`` term reads only parameters and is counted on rank 0; each rank
  renders the extraction's views, and rank 0 alone runs the host extraction and writes
  its files.
- the opt-in render options as in the stage-1 trainer; the ``--eval_fine_grid`` bake
  queries the palette field's density (:304), which this stage never moves, so it is
  dropped only when the parameters are replaced (:336, :653).
- ``extract_palette`` (:1135-1200): render all training views with the stage-1 NeRF,
  keep foreground pixels (weights_sum > 0.5), intensity-normalize the ground-truth colors
  ((rgb + 0.05) / |.|), run the RGBXY extraction -> palette.npz / hist_weights.npz.

What moves and what does not. ``encoder`` and ``sigma_net`` get no gradient in this stage
(the renderer detaches sigma, the model the geo feature), ``basis_color_origin`` and
``hist_weights`` are frozen: none of them is in the optimizer or the EMA update, so they
keep their values bit for bit. ``basis_color`` is in the optimizer from the start and is
stepped with a zero gradient while frozen: ``torch.optim.Adam`` counts steps per tensor,
optax once for all, and the bias correction after the unfreeze must see the same count.
Rebuilding the parameters (``initialize_palette``, ``load_nerf_checkpoint``) restarts
Adam's moments and the lr schedule's count, as re-initializing the optax state does.

On the card a step's device work (render, loss terms, backward with its scatter kernels,
the zero gradient of a frozen ``basis_color``, Adam and the EMA) is captured into one CUDA
graph and replayed (``step_graph.StepGraphs``), one graph per kind of step: the key is
what the step's control flow reads (the ray batch's shapes, the smooth and patch-smooth
terms, ``freeze_basis_color``, ``pred_clip``, whether ``hist_weights`` is present and
``lambda_palette`` non-zero, whether the recorder counts, the render settings). A key's
first step runs eagerly, its warm-up. New parameters or a new optimizer drop the graphs;
the occupancy grid is frozen on this stage, so the bitfield a graph reads stays the
trainer's. The draws stay eager, in their order; the lr, ``lambda_weight``,
``lambda_palette`` and the EMA's decay are device scalars, and Adam is ``capturable``, on
the eager steps too, so both do the same arithmetic. Steps stay eager on the CPU, on a
rank of a ``--n_devices`` run and with ``--train_compact_frac`` (its overflow is summed
across steps).
"""

from __future__ import annotations

import os
import time
import zipfile
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..data.rays import gen_rays_torch
from ..models.mlp import param_leaves
from ..models.palette import (FROZEN, PaletteSpec, get_palette_weight_with_hist, init_palette,
                              initialize_palette, palette_density)
from ..ops.hashgrid_fast import EncodeRand
from ..ops.occupancy import GridState
from ..render.palette_renderer import (RegionEdit, StylizerParams, render_palette_eval,
                                       render_palette_train)
from ..utils import profiling
from . import checkpoint as ckpt_lib
from .draws import Draws
from .step_graph import DeviceScalars, StepGraphs
from .trainer import Trainer, eval_gt, gt_to_color_space


def patch_smooth_term(out: dict, inds: torch.Tensor, width: int,
                      sigma_color: float) -> torch.Tensor:
    """Paired-pixel omega smoothness (palette/utils.py:494-516; JAX palette_trainer.py:
    106-120). The ``random_size`` sampler gives the batch as (pixel, jittered pixel)
    halves; the composited palette weights of a pair are pulled together, weighted by
    their image-space distance and diffuse-colour similarity (no gradient through the
    weight)."""
    half = inds.shape[0] // 2
    ij = torch.stack([torch.div(inds, width, rounding_mode="floor"), inds % width],
                     -1).to(torch.float32)
    diffuse, omega = out["diffuse_rgb"], out["basis_acc"]
    xyz_w = ((ij[:half] - ij[half:]) ** 2).sum(-1, keepdim=True) / 100.0
    rgb_w = ((diffuse[:half] - diffuse[half:]) ** 2).sum(-1, keepdim=True) / sigma_color
    sw = torch.exp(-(xyz_w + rgb_w)).detach()
    return (((omega[:half] - omega[half:]) ** 2).sum(-1, keepdim=True) * sw).mean()


class PaletteTrainer(Trainer):
    """``opt`` is a Config, ``spec`` a PaletteSpec. Runs on ``device`` (CUDA by default)."""

    _field_density = staticmethod(palette_density)

    def __init__(
        self,
        name: str,
        opt: Config,
        spec: PaletteSpec,
        params=None,
        workspace: str = "workspace",
        metrics=None,
        use_checkpoint: str = "latest",
        nerf_path: Optional[str] = None,
        ema_decay: Optional[float] = 0.95,
        eval_interval: int = 50,
        max_keep_ckpt: int = 2,
        mute: bool = False,
        device="cuda",
    ):
        self.palette_spec = spec
        self.freeze_basis_color = opt.use_initialization_from_rgbxy
        self.require_smooth_loss = False
        self.lambda_palette = 0.0
        self.lambda_weight = opt.lambda_weight
        self.edit: Optional[RegionEdit] = None
        self.stylizer: Optional[StylizerParams] = None
        self.offsets_weight = 1.0
        self.view_dep_weight = 1.0
        # leaves that this stage never moves (see the module docstring)
        self._fixed = FROZEN + ("encoder", "sigma_net") + (
            () if spec.pred_clip else ("encoder_clip",))
        self._graphs = StepGraphs()
        self._scalars = None  # DeviceScalars on the card

        super().__init__(
            name, opt, spec, params=params, workspace=workspace, metrics=metrics,
            use_checkpoint=use_checkpoint, ema_decay=ema_decay, eval_interval=eval_interval,
            max_keep_ckpt=max_keep_ckpt, mute=mute, device=device,
        )
        self.grid_frozen = True  # stage 1's grid, never refreshed (palette/utils.py:644-646)
        self._rlpips_kernels = None  # patches take no LPIPS term in this stage
        # warm-start from stage 1 only on fresh runs: resuming a palette checkpoint must
        # not stomp the palette-trained color head with stage-1 weights
        if nerf_path is not None and self.global_step == 0:
            self.load_nerf_checkpoint(nerf_path)

    def _init_params(self):
        return init_palette(self.palette_spec, self.generator, self.device)

    def _trainable(self, params):
        return param_leaves(params, skip=self._fixed)

    def _optimizer(self, leaves) -> torch.optim.Optimizer:
        """Adam as the stage-1 trainer's; on the card ``capturable``, its lr a device
        scalar, and its state made here with the step counts in f64 (``capturable`` Adam
        computes ``1 - beta2**t`` in the counts' dtype: in f32 it is 1e-6 off at t = 1, and
        every update with it). New parameters or a new optimizer drop the captured steps."""
        self._graphs.clear()
        if self.device.type != "cuda":
            return super()._optimizer(leaves)
        if self._scalars is None:
            self._scalars = DeviceScalars(self.device, ("lr", "lambda_weight", "lambda_palette",
                                                        "ema_decay", "ema_rest"))
        adam = torch.optim.Adam(leaves, lr=self._scalars["lr"], betas=(0.9, 0.99), eps=1e-15,
                                capturable=True)
        for p in leaves:
            adam.state[p] = {"step": torch.zeros((), dtype=torch.float64, device=p.device),
                             "exp_avg": torch.zeros_like(p), "exp_avg_sq": torch.zeros_like(p)}
        return adam

    def _set_lr(self, lr: float) -> None:
        if self._scalars is None:
            return super()._set_lr(lr)
        self._scalars.set(lr=lr)

    def _step_optimizer(self) -> None:
        if self._scalars is None or self.ema_decay is None:
            return super()._step_optimizer()
        self.optimizer.step()
        with torch.no_grad():
            ema, cur = self._trainable(self.ema_params), self._trainable(self.params)
            torch._foreach_mul_(ema, self._scalars["ema_decay"])
            torch._foreach_add_(ema, torch._foreach_mul(cur, self._scalars["ema_rest"]))

    def _weight(self, name: str):
        """Loss weight ``name`` as the step reads it: its device scalar on the card."""
        return getattr(self, name) if self._scalars is None else self._scalars[name]

    def _captures(self) -> bool:
        """Whether steps are captured (see the module docstring)."""
        return (self.device.type == "cuda" and self.dp is None
                and self.train_settings.compact_frac <= 0)

    def set_edit(self, edit: Optional[RegionEdit] = None,
                 stylizer: Optional[StylizerParams] = None,
                 offsets_weight: float = 1.0, view_dep_weight: float = 1.0):
        """Headless editing API: set the render-time edit state of the eval renders."""
        self.edit = edit
        self.stylizer = stylizer
        self.offsets_weight = offsets_weight
        self.view_dep_weight = view_dep_weight

    # ------------------------------------------------------------------ training

    def initialize_palette(self, color_list=None, hist_weights=None):
        self._set_params(initialize_palette(self.params, self.palette_spec, color_list,
                                            hist_weights))

    def train_step(self, rays_o, rays_d, images, gt_feat=None, bg=None, noise=None,
                   jit_u=None, enc_u=None, enc_lvls=None, inds=None, width=None,
                   draws: Optional[Draws] = None):
        """One optimizer step on a ray batch; returns (loss, per_ray), detached (copies).

        ``bg`` [N, 3] (background for RGBA gt), ``noise`` [N] (march jitter), ``jit_u``
        [N*S, 3] (smooth-loss jitter) and, under ``-O2``, the encode draws ``enc_u`` /
        ``enc_lvls`` are taken from ``draws`` (the trainer's draw source when None), in
        this order, when None.
        ``gt_feat`` [N, clip_dim] is needed with ``pred_clip``; the batch's pixel indices
        ``inds`` [N] and image ``width`` with the patch-smooth term. On a rank of a
        ``--n_devices`` run, as ``Trainer.train_step``: the rays, images, ``gt_feat`` and
        ``inds`` are the rank's shard, the draws the whole batch's.

        A captured step (module docstring) replays its graph: ``train.forward`` then
        covers the draws and the copies into the graph's inputs, ``train.backward`` the
        graph's launch (its capture, the first time) and ``train.optim`` the copies of its
        outputs.
        """
        opt, spec = self.opt, self.palette_spec
        draws = draws or self.draws
        shard = self._step_shard(rays_o.shape[0])
        n = rays_o.shape[0] if shard is None else shard.n
        profiling.count("train.ray_count", rays_o.shape[0])
        with profiling.span("train.forward"):
            smooth = self.require_smooth_loss
            patch = smooth and opt.random_size > 0 and opt.lambda_patchsmooth > 0
            if patch and (inds is None or width is None):
                raise ValueError("the patch-smooth term needs the batch's pixel indices and width")
            if images.shape[-1] == 4 and spec.bg_radius <= 0:
                if bg is None:
                    bg = draws.background(n)
                bg = self._take(bg, shard)
            else:
                bg = None
            if noise is None:
                noise = draws.jitter(n)
            noise = self._take(noise, shard)
            if smooth and jit_u is None:
                jit_u = draws.smooth_jitter(n * self.train_settings.num_samples)
            rand = self._encode_rand(n, enc_u, enc_lvls, shard, draws) or EncodeRand()
            batch = {"rays_o": rays_o, "rays_d": rays_d, "images": images, "bg": bg,
                     "noise": noise, "jit_u": self._take(jit_u, shard) if smooth else None,
                     "gt_feat": gt_feat if spec.pred_clip else None,
                     "inds": inds if patch else None, "enc_u": rand.u, "enc_lvls": rand.lvls}
            if self._scalars is not None:
                self._scalars.set(lambda_weight=self.lambda_weight,
                                  lambda_palette=self.lambda_palette,
                                  ema_decay=self.ema_decay or 0.0,
                                  ema_rest=1.0 - (self.ema_decay or 0.0))
            graph = None
            if self._captures():
                key = (tuple((k, None if v is None else (tuple(v.shape), v.dtype))
                             for k, v in batch.items()),
                       smooth, patch, width if patch else None, self.freeze_basis_color,
                       spec.pred_clip, "hist_weights" in self.params, bool(self.lambda_palette),
                       profiling.counting(), self.ema_decay is None, self.train_settings)
                graph = self._graphs.get(
                    key, lambda b: self._captured_step(b, smooth, patch, width))
            if graph is None:
                loss, per_ray, param_loss = self._step_terms(batch, smooth, patch, width)
            else:
                self._set_lr(self._scheduled_lr())
                graph.load(batch)
        if graph is None:
            profiling.count("train.graph.replays", 0)
            loss = self._update(loss, zero_grad_for=(self.params["basis_color"],),
                                param_loss=param_loss)
            return loss, per_ray.detach()
        with profiling.span("train.backward"):
            graph.launch()
        with profiling.span("train.optim"):
            self.opt_step += 1
            loss, per_ray = graph.results()
        return loss, per_ray

    def _step_terms(self, b: dict, smooth: bool, patch: bool, width) -> tuple:
        """The render and loss terms of a step on its inputs ``b`` (``train_step``'s
        batch): (the batch's terms, per_ray, the parameters' term or None)."""
        opt, spec, p = self.opt, self.palette_spec, self.params
        images = gt_to_color_space(opt, b["images"])
        bg = b["bg"]
        if bg is not None:
            gt = images[..., :3] * images[..., 3:] + bg * (1.0 - images[..., 3:])
        else:
            bg = torch.ones((3,), dtype=torch.float32, device=self.device)
            gt = images[..., :3]
        rand = None
        if b["enc_u"] is not None or b["enc_lvls"] is not None:
            rand = EncodeRand(u=b["enc_u"], lvls=b["enc_lvls"])
        out = render_palette_train(p, spec, self.grid_state.bitfield, b["rays_o"], b["rays_d"],
                                   self.train_settings, bg_color=bg,
                                   freeze_basis_color=self.freeze_basis_color,
                                   require_smooth_loss=smooth, noise=b["noise"],
                                   jit_u=b["jit_u"], rand=rand)
        self._add_overflow(out)
        per_ray = ((out["image"] - gt) ** 2).mean(-1)
        loss = per_ray.mean()
        loss = loss + ((out["direct_rgb"] - gt) ** 2).mean()
        if spec.pred_clip:
            loss = loss + ((out["clip_feat"] - b["gt_feat"]) ** 2).mean()
        loss = loss + opt.lambda_sparsity * out["omega_sparsity"].mean()
        loss = loss + opt.lambda_offsets * out["offsets_norm"].mean()
        loss = loss + opt.lambda_view_dep * out["view_dep_norm"].mean()
        if smooth and opt.lambda_smooth > 0:
            loss = loss + opt.lambda_smooth * out["smooth_norm"].mean()
        if patch:
            loss = loss + opt.lambda_patchsmooth * patch_smooth_term(out, b["inds"], width,
                                                                     opt.sigma_color)
        if "hist_weights" in p:
            gt_w = get_palette_weight_with_hist(gt, p["hist_weights"]).detach()
            loss = loss + self._weight("lambda_weight") * ((gt_w - out["basis_acc"]) ** 2).mean()
        param_loss = None  # the term of the parameters alone: once per step, not per rank
        if self.lambda_palette:
            param_loss = self._weight("lambda_palette") * (
                (p["basis_color"] - p["basis_color_origin"]) ** 2).sum(-1).mean()
        return loss, per_ray, param_loss

    def _captured_step(self, b: dict, smooth: bool, patch: bool, width) -> tuple:
        """What a step's graph holds: loss terms, backward, Adam and EMA; returns (loss,
        per_ray), the graph's outputs."""
        loss, per_ray, param_loss = self._step_terms(b, smooth, patch, width)
        loss = self._backward(loss, (self.params["basis_color"],), param_loss)
        self._step_optimizer()
        return loss, per_ray.detach()

    def _batch_step(self, data: dict, **given):
        """The palette-loss step from a collated batch (the host-sampled epoch and
        ``train_gui``); ``given`` (``bg``, ``noise``, ``jit_u``, ``enc_u``, ``enc_lvls``)
        replace the draw source's draws, and may name the source (``draws``). Without LSeg
        features in the batch, ``pred_clip`` is held to zeros, as in the JAX trainer."""
        images = self._batch(data, "images")
        gt_feat = None
        if self.palette_spec.pred_clip:
            gt_feat = (self._batch(data, "feat_images") if "feat_images" in data else
                       torch.zeros((images.shape[0], self.palette_spec.clip_dim),
                                   device=self.device))
        inds = None if "inds" not in data else self._batch(data, "inds", np.int64)
        return self.train_step(self._batch(data, "rays_o"), self._batch(data, "rays_d"),
                               images, gt_feat=gt_feat, inds=inds, width=data.get("W"),
                               **given)

    def _apply_schedule(self):
        """The schedule flags the epoch count implies (palette/utils.py:651-674)."""
        opt = self.opt
        if self.epoch >= opt.max_freeze_palette_epoch or not opt.use_initialization_from_rgbxy:
            self.freeze_basis_color = False
            self.lambda_palette = opt.lambda_palette
        if self.epoch >= opt.smooth_loss_start_epoch:
            self.require_smooth_loss = True

    def train(self, train_ds, valid_ds=None, max_epochs: int = 1,
              draws: Optional[Draws] = None):
        """Train to ``max_epochs``; ``draws`` replaces the trainer's draw source. The
        density grid is inherited frozen from the NeRF checkpoint: no refresh and no
        mark_untrained (palette/utils.py:644-646)."""
        opt = self.opt
        ckpt_every = opt.ckpt_interval if opt.ckpt_interval > 0 else 1
        self._apply_schedule()  # resume: what the end-of-epoch updates below had left
        for _ in range(max_epochs - self.epoch):
            self.epoch += 1
            self.lambda_weight = opt.lambda_weight * max(
                0.0, 1.0 - self.epoch / opt.lweight_decay_epoch)
            self.train_one_epoch(train_ds, draws)
            if self.epoch % ckpt_every == 0 or self.epoch == max_epochs:
                self.save_checkpoint(best=False)
            if valid_ds is not None and self.epoch % self.eval_interval == 0:
                self.evaluate_one_epoch(valid_ds)
                self.save_checkpoint(best=True)
            self._apply_schedule()
        return self.stats

    def _epoch_note(self) -> str:
        return (f", lw={self.lambda_weight:.4f}, lp={self.lambda_palette:.4f}, "
                f"freeze={self.freeze_basis_color}, smooth={self.require_smooth_loss}")

    def _upload(self, train_ds):
        """The stage-1 upload, plus the LSeg features with ``pred_clip``."""
        if self._dev_src is not train_ds:
            feats = getattr(train_ds, "feat_images", None)
            self._dev_feats = None if feats is None else torch.as_tensor(feats).reshape(
                feats.shape[0], -1, feats.shape[-1]).to(self.device)
        super()._upload(train_ds)

    def _device_epoch(self, train_ds, draws: Draws) -> list:
        """Pixels sampled and rays generated on the device (no grid refresh: the grid is
        stage 1's); returns the step losses."""
        self._upload(train_ds)
        if self.palette_spec.pred_clip and self._dev_feats is None:
            raise ValueError("pred_clip training needs the dataset's lseg_feature arrays")
        B = self._dev_poses.shape[0]
        H, W = train_ds.H, train_ds.W
        intr = [float(v) for v in train_ds.intrinsics]
        losses = []
        for idx in draws.order(B):
            with profiling.span("train.step", unit=self.global_step):
                with profiling.span("train.rays"):
                    inds = draws.pixels(self.opt.num_rays, H * W)
                    inds = self._take(inds, self._batch_shard(self.opt.num_rays))
                    pix = self._dev_images[idx][inds]
                    gt_feat = None if self._dev_feats is None else self._dev_feats[idx][inds]
                    rays_o, rays_d = gen_rays_torch(self._dev_poses[idx], intr, H, W, inds)
                loss, _ = self.train_step(rays_o, rays_d, pix, gt_feat=gt_feat, draws=draws)
                losses.append(loss)
                self.global_step += 1
        return losses

    # ------------------------------------------------------------------ eval / test

    def _render_chunk(self, params, bitfield, rays_o, rays_d, bg, pad_to=None):
        return render_palette_eval(
            params, self.palette_spec, bitfield, rays_o, rays_d,
            self.eval_settings, bg, edit=self.edit, stylizer=self.stylizer,
            offsets_weight=self.offsets_weight, view_dep_weight=self.view_dep_weight,
            pad_to=pad_to)

    def evaluate_one_epoch(self, valid_ds, save_images: bool = True) -> float:
        for m in self.metrics:
            m.clear()
        total_loss, n = 0.0, 0
        for i, data in enumerate(valid_ds.iter_epoch()):
            out = self.eval_step_full(data)
            pred = out["image"]
            img = data.get("images")
            if img is not None:
                gt = eval_gt(self.opt, img)
                total_loss += float(((pred - gt) ** 2).mean())
                n += 1
                for m in self.metrics:
                    if getattr(m, "basis_metric", False):
                        m.update(out["basis_acc"], out["weights_sum"])
                    else:
                        m.update(pred[None], gt[None])
            if save_images:
                base = os.path.join(self.workspace, "validation",
                                    f"{self.name}_ep{self.epoch:04d}_{i:04d}")
                self._save_image(base + ".png", pred)
                self._save_palette_maps(base, out)
        result = self.metrics[0].measure() if n else 0.0
        self.stats["valid_loss"].append(total_loss / max(n, 1))
        self.stats["results"].append(result)
        if self.stats["best_result"] is None or result > self.stats["best_result"]:
            self.stats["best_result"] = result
        self.log(f"[eval epoch {self.epoch}] loss={total_loss / max(n, 1):.6f} | "
                 + " | ".join(m.report() for m in self.metrics))
        return result

    def _save_palette_maps(self, base: str, out: dict):
        """Per-basis decomposition maps + PCA clip features (palette/utils.py:833-909)."""
        P = self.palette_spec.num_basis
        H, W = out["image"].shape[:2]
        if "basis_rgb" in out:
            basis_rgb = out["basis_rgb"].reshape(H, W, P, 3)
            for p in range(P):
                self._save_image(base + f"_basis{p:02d}_rgb.png", basis_rgb[..., p, :])
                self._save_image(base + f"_basis{p:02d}_acc.png",
                                 np.repeat(out["basis_acc"][..., p:p + 1], 3, -1))
        if "clip_feat" in out and self.palette_spec.pred_clip:
            cf = out["clip_feat"].reshape(-1, out["clip_feat"].shape[-1])
            cf = cf - cf.mean(0)
            u, s, _ = np.linalg.svd(cf, full_matrices=False)
            proj = (u[:, :3] * s[:3]).reshape(H, W, 3)
            proj = (proj - proj.min()) / (np.ptp(proj) + 1e-8)
            self._save_image(base + "_clip_pca.png", proj)

    def test(self, test_ds, save_path: Optional[str] = None, name: Optional[str] = None):
        """Test renders to pngs, with the per-basis decomposition (palette/utils.py:
        1050-1078). Returns the uint8 rgb frames. Video writing is not ported."""
        save_path = save_path or os.path.join(self.workspace, "results")
        name = name or f"{self.name}_ep{self.epoch:04d}"
        P = self.palette_spec.num_basis
        frames = []
        t0 = time.time()
        for i, data in enumerate(test_ds.iter_epoch()):
            out = self.eval_step_full(data)
            frames.append((np.clip(out["image"], 0, 1) * 255).astype(np.uint8))
            self._save_image(os.path.join(save_path, f"{name}_{i:04d}_rgb.png"), out["image"])
            H, W = out["image"].shape[:2]
            basis_rgb = out["basis_rgb"].reshape(H, W, P, 3)
            for p in range(P):
                self._save_image(os.path.join(save_path, f"{name}_{i:04d}_basis{p:02d}.png"),
                                 basis_rgb[..., p, :])
        dt = time.time() - t0
        self.log(f"[test] {len(frames)} frames, total {dt:.2f}s, "
                 f"avg {dt / max(len(frames), 1):.3f}s/frame")
        return frames

    # ------------------------------------------------------------------ extraction

    def extract_palette(self, nerf_trainer, loader, normalize_input: bool = False,
                        save_path: Optional[str] = None, via_sweep: bool = False,
                        sweep_resolution: int = 384, u_res: int = 448):
        """Stage 2: render all training views with the stage-1 NeRF and run the RGBXY
        extraction (palette/utils.py:1135-1200). ``nerf_trainer`` provides the renderer;
        the ground-truth pixels come from the loader.

        ``via_sweep`` renders the views with the shear-warp sweep over a bake of the NeRF
        instead of the per-ray network path. The extraction only takes the renders'
        foreground mask (weights_sum > 0.5) and the depth-reconstructed xyz, both tolerant
        of the bake's resolution; the colors come from the dataset either way. The
        extraction statistics depend on the image resolution, so compare palettes at one
        ``downscale``. A camera inside the volume's slab along its sweep axis cannot be
        factorized: that view goes through the per-ray path.

        Returns (palette_rgb [P, 3], hist_weights [32, 32, 32, P]); ``self.extract_stats``
        holds the counts of foreground samples and of per-ray fallback views, and
        ``self.extract_timer`` (a ``PhaseTimer``) the seconds of the bake, the sweep
        renders, the device-to-host moves, the host's rays and gathers and the host
        extraction; ``self.extract_inputs`` keeps the colors and xyzs the host extraction
        took. On a rank of a ``--n_devices`` run every rank renders, and
        rank 0 alone extracts, writes and returns; the others return None.
        """
        from ..extraction.extract import palette_extraction
        from ..utils.profiling import PhaseTimer

        save_path = save_path or self.workspace
        os.makedirs(save_path, exist_ok=True)
        timer = self.extract_timer = PhaseTimer()
        sv = None
        if via_sweep:
            from ..render.baking import bake_nerf, mask_with_bitfield
            from ..render.sweep import build_sweep_volume, plan_sweep, render_sweep

            t0 = time.time()
            with timer.phase("bake", sync_on=nerf_trainer.grid_state.bitfield):
                baked = bake_nerf(nerf_trainer.eval_params(), nerf_trainer.spec,
                                  resolution=sweep_resolution)
                gs = nerf_trainer.grid_state
                baked = mask_with_bitfield(baked, {
                    "bitfield": gs.bitfield.cpu().numpy(),
                    "density_grid": gs.density_grid.cpu().numpy()})
                sv = build_sweep_volume(baked)
                del baked
            self.log(f"[extract_palette] sweep volume baked in {time.time() - t0:.1f}s "
                     f"(R={sweep_resolution})")
        all_norm, all_xyz = [], []
        n_fallback = 0
        views = loader.iter_epoch()
        while True:
            with timer.phase("host rays"):  # the loader's collate: the view's rays
                data = next(views, None)
            if data is None:
                break
            H, W = data["H"], data["W"]
            use_sweep = False
            if sv is not None:
                pose = loader.poses[data["index"]]
                plan = plan_sweep(np.asarray(pose), loader.intrinsics, H, W, sv.bound, u_res)
                use_sweep = abs(float(plan.o_p[0])) > sv.bound * 1.02
            if use_sweep:
                with timer.phase("sweep render", sync_on=sv.vols):
                    out = render_sweep(sv, pose, loader.intrinsics, H, W, u_res=u_res,
                                       min_near=self.opt.min_near,
                                       t_thresh=self.opt.t_thresh_infer)
                with timer.phase("device to host"):  # one move per view
                    w, depth_o = torch.stack([out["weights_sum"].reshape(-1),
                                              out["depth_origin"].reshape(-1)]).cpu().numpy()
            else:
                n_fallback += 1 if sv is not None else 0
                with timer.phase("per-ray render"):  # its chunks' moves to the host included
                    out = nerf_trainer.eval_step_full(data)
                w = out["weights_sum"].reshape(-1)
                depth_o = out.get("depth_origin", out["depth"]).reshape(-1)
            with timer.phase("host gather"):
                gt = eval_gt(self.opt, data["images"]).reshape(-1, 3)
                valid = w > 0.5
                norm = gt[valid] + np.float32(0.05)
                all_norm.append(norm / np.linalg.norm(norm, axis=-1, keepdims=True))
                all_xyz.append(data["rays_o"].reshape(-1, 3)[valid]
                               + data["rays_d"].reshape(-1, 3)[valid] * depth_o[valid, None])
        if not self.is_main:
            return None  # rank 0 extracts and writes
        colors = np.concatenate(all_norm, 0)
        xyzs = np.concatenate(all_xyz, 0)
        if sv is not None and n_fallback:
            self.log(f"[extract_palette] {n_fallback} inside-volume views used "
                     "the per-ray path")
        self.log(f"[extract_palette] {len(colors)} foreground samples")
        self.extract_stats = {"foreground_samples": len(colors), "fallback_views": n_fallback}
        self.extract_inputs = {"colors": colors, "xyzs": xyzs}
        with timer.phase("host extraction"):
            result = palette_extraction(
                self.extract_inputs, save_path,
                normalize_input=normalize_input, error_thres=self.opt.error_thres,
            )
        self.log("[extract_palette] time by phase:\n" + timer.report())
        return result

    # ------------------------------------------------------------------ warm start

    def load_nerf_checkpoint(self, nerf_path: str):
        """Non-strict load of the stage-1 weights and density grid (palette/utils.py:
        1306-1330) from the newest ``ngp`` checkpoint under ``nerf_path``: the port's own
        (``torch.save``) or a pickle of the JAX package."""
        ckpt_dir = os.path.join(nerf_path, "checkpoints")
        path = ckpt_lib.latest_checkpoint(ckpt_dir, "ngp")
        if path is None:
            raise FileNotFoundError(f"no NeRF checkpoint under {ckpt_dir}")
        if zipfile.is_zipfile(path):
            data = ckpt_lib.load_checkpoint(path)
            source, gs = data["params"], data.get("grid_state")
        else:
            data = ckpt_lib.load_reference_checkpoint(path)
            source, gs = ckpt_lib.params_from_jax(data["params"]), data.get("grid_state")
        merged, missing, loaded = ckpt_lib.merge_params_non_strict(self.params, source)
        self._set_params(merged)
        self.log(f"[INFO] warm-started {len(loaded)} tensors from NeRF ckpt {path}; "
                 f"palette-only tensors: {len(missing)}")
        if gs is not None:
            self.grid_state = GridState(**{
                k: (v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))).to(self.device)
                for k, v in gs.items()})
            self.log("[INFO] inherited frozen density grid from NeRF ckpt")
