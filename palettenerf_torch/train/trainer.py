"""Stage-1 NeRF trainer: train step, EMA, lr schedule, grid refresh, eval, checkpoints.

Port of the ``-O`` path of ``palettenerf_tpu/train/trainer.py``:

- Adam(b1=0.9, b2=0.99, eps=1e-15). The lr of the k-th update (k = 0, 1, ...) is
  ``lr * 0.1**min(k/iters, 1)``: optax evaluates its schedule on the count of
  updates already made, so the first update uses ``lr`` itself (:138-141).
- EMA of the parameters with decay 0.95 after every update.
- Loss: MSE against the gt composited on a random per-ray background (RGBA data),
  plus ``lambda_sparse * rgb_norm`` (:186-205; ``patch_size == 1`` only).
- Density-grid refresh every ``update_extra_interval`` steps: full below
  ``grid_update_warmup``, then a rotating 1/4 slab (:378-384); never-seen cells are
  marked at the start of training (:442-446).
- Training runs on device-resident images with pixels sampled and rays generated on
  the device (the counterpart of ``scan_steps`` :281-320, as a Python loop).

All randomness comes from one ``torch.Generator`` on the trainer's device, seeded
with ``opt.seed``. Options of the JAX trainer that are not ported yet raise.
"""

from __future__ import annotations

import math
import os
import time
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..config import Config
from ..data.png import write_png
from ..data.rays import gen_rays_torch
from ..models.nerf import NeRFSpec, init_nerf, nerf_density, param_list
from ..ops.occupancy import (GridState, init_grid_state, mark_untrained_grid,
                             update_density_grid)
from ..ops.scatter import check_refused
from ..render.nerf_renderer import RenderSettings, render_nerf_eval, render_nerf_train
from . import checkpoint as ckpt_lib
from .metrics import PSNRMeter

_DENSITY_CHUNK = 1 << 18  # grid points per density query during a refresh


def check_ported(opt: Config) -> None:
    """Raise for options whose code paths are not ported yet."""
    unported = {
        "O2": opt.O2, "fast_grad": opt.fast_grad,
        "stochastic_trilerp": opt.stochastic_trilerp, "grad_levels": opt.grad_levels,
        "gridtype=hash_xadd": opt.gridtype == "hash_xadd",
        "march_groups": opt.march_groups > 0, "eval_fine_grid": opt.eval_fine_grid,
        "eval_compact_frac": opt.eval_compact_frac,
        "train_compact_frac": opt.train_compact_frac,
        "bg_radius > 0": opt.bg_radius > 0, "error_map": opt.error_map,
        "patch_size > 1": opt.patch_size > 1, "random_size": opt.random_size,
        "color_space=linear": opt.color_space == "linear",
        "n_devices > 1": opt.n_devices > 1, "rand_pose": opt.rand_pose >= 0,
        "gui": opt.gui,
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(f"not ported to palettenerf_torch yet: {', '.join(bad)}")


def _copy_params(params, device, requires_grad: bool = False):
    """A copy of a parameter dict (tensors and lists of tensors) on ``device``."""
    def one(t):
        return t.detach().to(device, copy=True).requires_grad_(requires_grad)

    return {k: ([one(w) for w in v] if isinstance(v, list) else one(v))
            for k, v in params.items()}


def spec_cascade(spec: NeRFSpec) -> int:
    return 1 + max(0, math.ceil(math.log2(spec.bound)))


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
    ):
        check_ported(opt)
        self.name = name
        self.opt = opt
        self.spec = spec
        self.device = resolve_device(device)
        self.workspace = workspace
        self.ema_decay = ema_decay
        self.eval_interval = eval_interval
        self.max_keep_ckpt = max_keep_ckpt
        self.mute = mute
        self.metrics = [PSNRMeter()]

        self.epoch = 0
        self.global_step = 0
        self.opt_step = 0  # optimizer updates made (the lr schedule's count)
        self.stats = {"loss": [], "valid_loss": [], "results": [], "best_result": None}

        os.makedirs(workspace, exist_ok=True)
        self.ckpt_path = os.path.join(workspace, "checkpoints")
        self.best_path = os.path.join(self.ckpt_path, f"{name}.ckpt")
        self.log_path = os.path.join(workspace, f"log_{name}.txt")

        self.generator = torch.Generator(device=self.device).manual_seed(opt.seed)
        if params is None:
            params = init_nerf(spec, self.generator, self.device)
        self.params = _copy_params(params, self.device, requires_grad=True)
        self.ema_params = _copy_params(self.params, self.device)

        cascade = spec_cascade(spec)
        self.grid_state = init_grid_state(cascade, opt.grid_size, self.device)
        self.train_settings = RenderSettings(
            bound=spec.bound, cascade=cascade, grid_size=opt.grid_size,
            dt_gamma=opt.dt_gamma, max_steps=opt.max_steps,
            num_samples=opt.train_samples_per_ray, t_thresh=opt.t_thresh_train,
            min_near=opt.min_near,
        )
        s_inf = opt.infer_samples_per_ray
        self.eval_settings = RenderSettings(
            bound=spec.bound, cascade=cascade, grid_size=opt.grid_size,
            dt_gamma=opt.dt_gamma, max_steps=opt.max_steps,
            num_samples=s_inf, t_thresh=opt.t_thresh_infer, min_near=opt.min_near,
            compaction_rounds=self._compaction_rounds(s_inf),
        )
        self.optimizer = torch.optim.Adam(param_list(self.params), lr=opt.lr,
                                          betas=(0.9, 0.99), eps=1e-15)
        self._dev_src = None

        n_params = sum(p.numel() for p in param_list(self.params))
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

    def _compaction_rounds(self, s_inf: int) -> tuple:
        """All rays march s/4 samples, the top 1/4 by transmittance s/4 more, the
        top 1/16 the last s/2 (nerf/renderer.py:336-386 as a static schedule)."""
        if self.opt.eval_compaction and s_inf % 4 == 0 and s_inf >= 16:
            return ((1, s_inf // 4), (4, s_inf // 4), (16, s_inf // 2))
        return ()

    def eval_params(self):
        return self.ema_params if self.ema_decay is not None else self.params

    def log(self, *args):
        msg = " ".join(str(a) for a in args)
        if not self.mute:
            print(msg, flush=True)
        with open(self.log_path, "a") as f:
            f.write(msg + "\n")

    # ------------------------------------------------------------------ training

    def train_step(self, rays_o, rays_d, images, bg=None, noise=None):
        """One optimizer step on a ray batch; returns (loss, per_ray), detached.

        ``bg`` [N, 3] (background for RGBA gt) and ``noise`` [N] (march jitter) are
        drawn from the trainer's generator when None.
        """
        opt, n, dev = self.opt, rays_o.shape[0], self.device
        c = images.shape[-1]
        if c == 4 and self.spec.bg_radius <= 0 and not opt.no_bg:
            if bg is None:
                bg = torch.rand((n, 3), generator=self.generator, device=dev)
            gt = images[..., :3] * images[..., 3:] + bg * (1.0 - images[..., 3:])
        else:
            bg = torch.ones((3,), dtype=torch.float32, device=dev)
            gt = images[..., :3]
        if noise is None:
            noise = torch.rand((n,), generator=self.generator, device=dev)

        out = render_nerf_train(self.params, self.spec, self.grid_state.bitfield,
                                rays_o, rays_d, self.train_settings,
                                bg_color=bg, rays_gt=gt, noise=noise)
        per_ray = ((out["image"] - gt) ** 2).mean(-1) + out["rgb_norm"] * opt.lambda_sparse
        loss = per_ray.mean()

        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        lr = opt.lr * 0.1 ** min(self.opt_step / opt.iters, 1.0)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.opt_step += 1
        if self.ema_decay is not None:
            with torch.no_grad():
                ema, cur = param_list(self.ema_params), param_list(self.params)
                torch._foreach_mul_(ema, self.ema_decay)
                torch._foreach_add_(ema, cur, alpha=1.0 - self.ema_decay)
        return loss.detach(), per_ray.detach()

    def _density(self, params, pts: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return torch.cat([nerf_density(params, self.spec, c)["sigma"]
                              for c in pts.split(_DENSITY_CHUNK)])

    def refresh_grid(self):
        """Full refresh during warmup, rotating 1/4 slab after (nerf/renderer.py:479-537)."""
        opt = self.opt
        kw = dict(bound=self.spec.bound, density_thresh=opt.density_thresh,
                  grid_size=opt.grid_size, generator=self.generator)
        if self.global_step >= opt.grid_update_warmup:
            kw.update(partial_fraction=4,
                      slab_index=self.global_step // opt.update_extra_interval)
        self.grid_state = update_density_grid(
            self.grid_state, lambda p: self._density(self.params, p), **kw)

    def train(self, train_ds, valid_ds=None, max_epochs: int = 1):
        self.grid_state = mark_untrained_grid(
            self.grid_state, torch.as_tensor(train_ds.poses), train_ds.intrinsics,
            self.spec.bound, self.opt.min_near, self.opt.filter_close_point,
            self.opt.grid_size)
        for _ in range(max_epochs - self.epoch):
            self.epoch += 1
            self.train_one_epoch(train_ds)
            self.save_checkpoint(best=False)
            if valid_ds is not None and self.epoch % self.eval_interval == 0:
                self.evaluate_one_epoch(valid_ds)
                self.save_checkpoint(best=True)
        return self.stats

    def train_one_epoch(self, train_ds):
        """One step per training image, in a random order, on device-resident images."""
        t0 = time.time()
        if self._dev_src is not train_ds:
            imgs = torch.as_tensor(train_ds.images)
            self._dev_images = imgs.reshape(imgs.shape[0], -1, imgs.shape[-1]).to(self.device)
            self._dev_poses = torch.as_tensor(train_ds.poses).to(self.device)
            self._dev_src = train_ds
        B = self._dev_poses.shape[0]
        H, W = train_ds.H, train_ds.W
        intr = [float(v) for v in train_ds.intrinsics]
        order = torch.randperm(B, generator=self.generator, device=self.device).tolist()
        losses = []
        for idx in order:
            if self.global_step % self.opt.update_extra_interval == 0:
                self.refresh_grid()
            inds = torch.randint(0, H * W, (self.opt.num_rays,), generator=self.generator,
                                 device=self.device)
            pix = self._dev_images[idx][inds]
            rays_o, rays_d = gen_rays_torch(self._dev_poses[idx], intr, H, W, inds)
            loss, _ = self.train_step(rays_o, rays_d, pix)
            losses.append(loss)
            self.global_step += 1
        avg = float(torch.stack(losses).mean())
        check_refused()  # the host has just waited for the device: rows the kernel refused
        self.stats["loss"].append(avg)
        self.log(f"[epoch {self.epoch}] loss={avg:.6f} "
                 f"({B} steps, {time.time() - t0:.1f}s, step={self.global_step})")
        return avg

    # ------------------------------------------------------------------ eval

    def render_image(self, rays_o, rays_d, bg_color=None, chunk: int = 16384):
        """Full-frame eval render in ray chunks -> dict of numpy arrays."""
        rays_o = torch.as_tensor(rays_o, dtype=torch.float32)
        rays_d = torch.as_tensor(rays_d, dtype=torch.float32)
        bg = None if bg_color is None else torch.as_tensor(
            bg_color, dtype=torch.float32, device=self.device)
        params = self.eval_params()
        outs = []
        for start in range(0, rays_o.shape[0], chunk):
            out = render_nerf_eval(params, self.spec, self.grid_state.bitfield,
                                   rays_o[start:start + chunk].to(self.device),
                                   rays_d[start:start + chunk].to(self.device),
                                   self.eval_settings, bg)
            outs.append(out)
        return {k: torch.cat([o[k] for o in outs]).cpu().numpy() for k in outs[0]}

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
                gt = img[..., :3]
                if img.shape[-1] == 4:
                    gt = img[..., :3] * img[..., 3:] + 1.0 * (1 - img[..., 3:])
                total_loss += float(((pred - gt) ** 2).mean())
                n += 1
                for m in self.metrics:
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
        """Render the test split to pngs (videos and mesh export are not ported yet)."""
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

    @staticmethod
    def _save_image(path: str, img01: np.ndarray):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_png(path, (np.clip(img01, 0, 1) * 255).astype(np.uint8))

    # ------------------------------------------------------------------ checkpoints

    def save_checkpoint(self, best: bool = False) -> str:
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
        with torch.no_grad():
            for dst, src in zip(param_list(self.params), param_list(data["params"])):
                dst.copy_(src)
            ema_src = data.get("ema_params", data["params"])
            for dst, src in zip(param_list(self.ema_params), param_list(ema_src)):
                dst.copy_(src)
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
            self.optimizer.load_state_dict(data["optimizer"])
            self.opt_step = data.get("opt_step", self.global_step)
        if "generator" in data:
            self.generator.set_state(data["generator"])
        self.log(f"[INFO] loaded checkpoint {path} (epoch {self.epoch}, "
                 f"step {self.global_step})")
