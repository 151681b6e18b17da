"""Headless palette-editing API: everything the reference GUI can do, programmatically.

Port of ``palettenerf_tpu/gui/headless.py``. The reference PaletteGUI (palette/gui.py)
drives palette color edits with live HSV deltas, spatial / semantic region masks from
point picks, the offsets / view-dep weight dials, photorealistic style transfer (a
Stylizer fit on point -> color correspondences) and test renders. These live in this
session API; the DearPyGui front-end in ``dpg_gui.py`` calls the same methods.

Frames are rendered on the trainer's device and returned as host NumPy arrays, as
``render_image`` returns them; the pacing and accumulation of ``render_dynamic`` run in
float32 NumPy.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..data.rays import gen_rays
from ..render.palette_renderer import (StylizerParams, apply_stylizer, init_stylizer,
                                       make_region_edit, region_edit_delta_hsv,
                                       stylizer_arap_loss)
from .camera import OrbitCamera


class EditingSession:
    """Interactive editing over a trained PaletteTrainer.

    Typical flow (mirrors the GUI interactions, palette/gui.py:216-223, 475-558):

        sess = EditingSession(trainer, W=800, H=800)
        frame = sess.render()                                 # dict with image etc.
        pick = sess.pick(x, y)                                # -> xyz + clip_feat
        sess.set_region(mean_xyz=pick["xyz"], std_xyz=0.05)
        sess.recolor(basis=2, new_rgb=[0.9, 0.2, 0.2])
        frame = sess.render()
    """

    def __init__(self, trainer, W: int = 800, H: int = 800, radius: float = 2.0,
                 fovy: float = 60.0):
        self.trainer = trainer
        self.cam = OrbitCamera(W, H, r=radius, fovy=fovy)
        # the raw trained colors (not the EMA copy, not clipped), as the reference GUI
        self.palette = trainer.params["basis_color"].detach().cpu().numpy()
        self.edited_palette = self.palette.copy()
        self.num_basis = self.palette.shape[0]
        self.clip_dim = trainer.palette_spec.clip_dim
        self._edit = make_region_edit(self.num_basis, self.clip_dim)
        self._stylizer: Optional[StylizerParams] = None
        self._style_enabled = True
        self._weights = (1.0, 1.0)  # offsets_weight, view_dep_weight
        self._last_frame = None
        # dynamic-resolution + spp-accumulation state (render_dynamic)
        self._downscale = 1.0
        self.min_downscale = 0.25
        self._acc_pose = None
        self._acc_image = None
        self._spp = 0
        # style correspondences: list of (ray_o, ray_d, target_rgb)
        self._corr = []
        self._push()

    # ---------------- edit state ----------------

    def recolor(self, basis: int, new_rgb):
        """Change one palette color; recoloring happens in HSV-delta space
        (palette/renderer.py:105-119)."""
        self.edited_palette[basis] = np.asarray(new_rgb, np.float32)
        dh = region_edit_delta_hsv(self.palette, self.edited_palette).numpy()
        self._edit = self._edit._replace(delta_hsv=dh)
        self._push()

    def reset_colors(self):
        self.edited_palette = self.palette.copy()
        self._edit = make_region_edit(self.num_basis, self.clip_dim,
                                      weight_mode=self._edit.weight_mode)
        self._push()

    def set_region(self, mean_xyz=None, std_xyz: float = 1.0,
                   mean_clip=None, std_clip: float = 1.0, weight_mode: bool = False):
        """Restrict edits spatially / semantically (RegionEdit, renderer.py:127-136)."""
        e = make_region_edit(self.num_basis, self.clip_dim, mean_xyz, std_xyz,
                             mean_clip, std_clip, weight_mode)
        self._edit = e._replace(delta_hsv=self._edit.delta_hsv)
        self._push()

    def set_weights(self, offsets_weight: float = 1.0, view_dep_weight: float = 1.0):
        """Scalar dials on offsets / view-dependent color (renderer.py:484, 494)."""
        self._weights = (offsets_weight, view_dep_weight)
        self._push()

    def set_stylizer(self, stylizer: Optional[StylizerParams]):
        self._stylizer = stylizer
        self._push()

    def use_style(self, enabled: bool):
        """Toggle the fitted stylizer without discarding it (style on/off checkbox)."""
        self._style_enabled = bool(enabled)
        self._push()

    def _push(self):
        self.trainer.set_edit(
            edit=self._edit,
            stylizer=self._stylizer if self._style_enabled else None,
            offsets_weight=self._weights[0], view_dep_weight=self._weights[1],
        )

    # ---------------- rendering / picking ----------------

    def render(self, pose: Optional[np.ndarray] = None, chunk: int = 16384) -> dict:
        pose = self.cam.pose if pose is None else pose
        H, W = self.cam.H, self.cam.W
        ro, rd = gen_rays(pose, self.cam.intrinsics, H, W, None)
        out = self.trainer.render_image(ro, rd, chunk=chunk)
        out = {k: v.reshape(H, W, *v.shape[1:]) for k, v in out.items()}
        # xyz buffer for point picking (palette/utils.py:952)
        out["xyz"] = ro.reshape(H, W, 3) + rd.reshape(H, W, 3) * out["depth_origin"][..., None]
        self._last_frame = out
        return out

    def pick(self, x: int, y: int) -> dict:
        """Right-click point picking: world xyz + clip feature at pixel (x, y)
        (palette/gui.py:216-223, 724-744)."""
        if self._last_frame is None:
            self.render()
        f = self._last_frame
        return {
            "xyz": np.asarray(f["xyz"][y, x]),
            "clip_feat": np.asarray(f["clip_feat"][y, x]) if "clip_feat" in f else None,
            "rgb": np.asarray(f["image"][y, x]),
        }

    # ------------- interactive frame pacing (nerf/gui.py:90-141, 240-268) -------------

    def render_dynamic(self, pose: Optional[np.ndarray] = None,
                       target_ms: float = 100.0) -> dict:
        """Adaptive-resolution frame: renders at the current downscale and adjusts it so
        that the frame time tracks ``target_ms`` (nerf/gui.py:90-112). While the camera
        is still, frames accumulate into a running mean (spp accumulation,
        nerf/gui.py:240-268)."""
        pose = self.cam.pose if pose is None else np.asarray(pose)
        t0 = time.perf_counter()
        out = self.trainer.test_gui(pose, self.cam.intrinsics, self.cam.W, self.cam.H,
                                    downscale=self._downscale)
        dt_ms = (time.perf_counter() - t0) * 1e3

        img = np.asarray(out["image"], np.float32)
        moved = self._acc_pose is None or not np.allclose(pose, self._acc_pose)
        if moved:
            self._acc_image, self._spp, self._acc_pose = img, 1, pose.copy()
        elif img.shape == self._acc_image.shape:
            self._spp += 1
            self._acc_image += (img - self._acc_image) / self._spp
        else:  # downscale changed between frames: restart accumulation
            self._acc_image, self._spp = img, 1

        # multiplicative pacing toward the frame budget, clamped to the reference's range
        ratio = np.sqrt(target_ms / max(dt_ms, 1e-3))
        self._downscale = float(np.clip(self._downscale * np.clip(ratio, 0.7, 1.4),
                                        self.min_downscale, 1.0))
        out = dict(out)
        out["image"] = self._acc_image
        out["spp"] = self._spp
        out["frame_ms"] = dt_ms
        out["downscale"] = self._downscale
        return out

    # ------------- training / checkpoint / mesh controls (nerf/gui.py:240-370) -------

    def train_burst(self, train_ds, steps: int = 16) -> dict:
        """One interactive training burst (train-toggle backend)."""
        return self.trainer.train_gui(train_ds, step=steps)

    def save_checkpoint(self):
        self.trainer.save_checkpoint()

    def save_mesh(self, resolution: int = 256, threshold: float = 10.0):
        return self.trainer.save_mesh(resolution=resolution, threshold=threshold)

    def jump_to_pose(self, poses, index: int) -> np.ndarray:
        """Teleport the orbit camera to dataset pose ``index`` (the reference's test-pose
        jump, palette/gui.py:401-427). Returns the pose used."""
        pose = np.asarray(poses[index], np.float32)
        self.cam.set_pose(pose)
        return pose

    # ------------- style-transfer correspondence workflow (palette/gui.py:560-659) ---

    def add_correspondence(self, x: int, y: int, target_rgb) -> int:
        """Record a point -> target-color pair from the current frame (the style-image
        click workflow). Returns the correspondence count."""
        if self._last_frame is None:
            self.render()
        ro, rd = gen_rays(self.cam.pose, self.cam.intrinsics, self.cam.H, self.cam.W, None)
        i = y * self.cam.W + x
        self._corr.append((ro[i].copy(), rd[i].copy(), np.asarray(target_rgb, np.float32)))
        return len(self._corr)

    def clear_correspondences(self):
        self._corr = []

    def optimize_style(self, iters: int = 1000, lr: float = 1e-2) -> StylizerParams:
        """Fit the Stylizer to the recorded correspondences and enable it
        (palette/gui.py:153-194 inline solve)."""
        assert self._corr, "no correspondences recorded: add_correspondence first"
        ro, rd, tgt = (np.stack(c) for c in zip(*self._corr))
        sty = fit_stylizer(self.trainer, ro, rd, tgt, iters=iters, lr=lr)
        self.set_stylizer(sty)
        return sty


def stylizer_problem(trainer, rays_o: np.ndarray, rays_d: np.ndarray,
                     target_colors: np.ndarray, arap_weight: float = 1e-2):
    """The style-transfer loss as a function of ``StylizerParams`` (palette/gui.py:153-194
    + renderer.py:151-183): the per-sample palette quantities of the rays are computed
    once, without autograd (march without jitter, ``palette_forward`` with the EMA
    weights, clipped basis colors), then the stylized render is composited onto a white
    background against the targets, plus ``arap_weight`` times the ARAP penalty."""
    from ..models.palette import palette_forward
    from ..ops.composite import composite_channels, composite_weights
    from ..ops.march import march_rays
    from ..ops.rays import near_far_from_aabb
    from ..render.nerf_renderer import _aabb

    spec, st, dev = trainer.palette_spec, trainer.eval_settings, trainer.device
    params = trainer.eval_params()
    P, S = spec.num_basis, st.num_samples
    ro = torch.as_tensor(np.asarray(rays_o, np.float32), device=dev)
    rd = torch.as_tensor(np.asarray(rays_d, np.float32), device=dev)
    n = ro.shape[0]
    with torch.no_grad():
        nears, fars = near_far_from_aabb(ro, rd, _aabb(st, dev), st.min_near)
        # the flat march on the train grid, as JAX's fit_stylizer marches (headless.py:269)
        m = march_rays(ro, rd, nears, fars, trainer.grid_state.bitfield, st.bound,
                       st.cascade, st.grid_size, st.dt_gamma, st.max_steps, S)
        xyzs = m.xyzs.reshape(-1, 3)
        dirs = rd[:, None, :].expand_as(m.xyzs).reshape(-1, 3)
        sigma, _, omega, off_rad, view_dep, _ = palette_forward(params, spec, xyzs, dirs)
        M = xyzs.shape[0]
        offsets = off_rad[..., :-1].reshape(M, P, 3)
        radiance = off_rad[..., -1:].reshape(M, 1, 1)
        omega = omega.reshape(M, P, 1)
        basis_color = params["basis_color"].clamp(0.0, 1.0)[None]
        w, ws, _ = composite_weights((sigma * st.density_scale).reshape(n, S), m.dts, m.mask,
                                     st.t_thresh)
        target = torch.as_tensor(np.asarray(target_colors, np.float32), device=dev)

    def loss_fn(sty: StylizerParams) -> torch.Tensor:
        rgbs = apply_stylizer(sty, radiance, omega, basis_color, offsets, view_dep)
        img = composite_channels(w, rgbs.reshape(n, S, 3)) + (1.0 - ws)[:, None]
        return ((img - target) ** 2).mean() + arap_weight * stylizer_arap_loss(sty)

    return loss_fn


def fit_stylizer(
    trainer,
    rays_o: np.ndarray,
    rays_d: np.ndarray,
    target_colors: np.ndarray,
    iters: int = 1000,
    lr: float = 1e-2,
    arap_weight: float = 1e-2,
) -> StylizerParams:
    """Photorealistic style transfer solve: ``iters`` Adam steps (optax ``adam``'s
    defaults: betas (0.9, 0.999), eps 1e-8) on per-palette (dI, dP, ddelta) from the
    identity stylizer, so that the stylized render matches the user's point -> color
    correspondences. A loop of plain PyTorch steps on the trainer's device."""
    loss_fn = stylizer_problem(trainer, rays_o, rays_d, target_colors, arap_weight)
    leaves = [t.clone().requires_grad_(True)
              for t in init_stylizer(trainer.palette_spec.num_basis, device=trainer.device)]
    adam = torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    for _ in range(iters):
        adam.zero_grad(set_to_none=True)
        loss_fn(StylizerParams(*leaves)).backward()
        adam.step()
    return StylizerParams(*(t.detach() for t in leaves))
