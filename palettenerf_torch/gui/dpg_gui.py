"""DearPyGui front-ends (optional; require the ``dearpygui`` package).

Interactive viewers mirroring the reference GUIs with the FULL control surface:

- ``NeRFGUI`` (reference ``nerf/gui.py:55-480``): orbit camera, live render with
  dynamic resolution + spp accumulation, train start/stop toggle, checkpoint and
  marching-cubes buttons, dt_gamma / max-samples sliders, FPS/loss readouts.
- ``PaletteGUI`` (reference ``palette/gui.py``): everything above plus palette
  color pickers with live HSV deltas, weight-mode toggle, std_xyz/std_clip
  sliders, offsets/view-dep dials, right-click point picking, test-pose jump,
  style-image correspondence list + inline stylizer optimize + style on/off,
  and render-view/render-video buttons.

Port of ``palettenerf_tpu/gui/dpg_gui.py``. All editing logic lives in
``gui.headless.EditingSession``; this module is a thin widget layer over it. Without
the ``dearpygui`` package the GUIs raise an ``ImportError`` that points to
``EditingSession``, through which every capability stays scriptable (see
tests/test_torch_gui.py).
"""

from __future__ import annotations

import numpy as np

try:
    import dearpygui.dearpygui as dpg

    HAS_DPG = True
except ImportError:  # pragma: no cover
    dpg = None
    HAS_DPG = False


def _require_dpg():
    if not HAS_DPG:
        raise ImportError(
            "dearpygui is not installed in this environment. Use "
            "palettenerf_torch.gui.EditingSession for headless editing, or install "
            "dearpygui for the interactive viewer."
        )


class NeRFGUI:
    """Interactive NeRF viewer/trainer (reference nerf/gui.py:55-480)."""

    def __init__(self, opt, trainer, train_ds=None):
        _require_dpg()
        self.opt = opt
        self.trainer = trainer
        self.train_ds = train_ds
        self.W, self.H = opt.W, opt.H
        from .camera import OrbitCamera

        self.cam = OrbitCamera(opt.W, opt.H, r=opt.radius, fovy=opt.fovy)
        self.render_buffer = np.zeros((self.H, self.W, 3), np.float32)
        self.training = False
        self.dynamic_res = True
        self._downscale = 1.0
        self._spp = 0
        self._acc = None
        self._acc_pose = None
        self.target_ms = 100.0  # reference's ~100 ms/frame pacing target

    # -------- frame production (dynamic resolution + spp accumulation) --------

    def render_frame(self):
        import time

        pose = self.cam.pose
        t0 = time.perf_counter()
        out = self.trainer.test_gui(pose, self.cam.intrinsics, self.W, self.H,
                                    downscale=self._downscale if self.dynamic_res else 1.0)
        dt_ms = (time.perf_counter() - t0) * 1e3
        img = np.asarray(out["image"], np.float32)
        if img.shape[:2] != (self.H, self.W):  # upsample the downscaled frame
            ry = self.H // img.shape[0] + (self.H % img.shape[0] > 0)
            img = np.kron(img, np.ones((ry, ry, 1), np.float32))[: self.H, : self.W]

        moved = self._acc_pose is None or not np.allclose(pose, self._acc_pose)
        if moved or self._acc is None or self._acc.shape != img.shape:
            self._acc, self._spp, self._acc_pose = img, 1, pose.copy()
        else:
            self._spp += 1
            self._acc += (img - self._acc) / self._spp

        if self.dynamic_res and moved:
            ratio = np.sqrt(self.target_ms / max(dt_ms, 1e-3))
            self._downscale = float(np.clip(self._downscale * np.clip(ratio, 0.7, 1.4),
                                            0.25, 1.0))
        self.render_buffer = np.ascontiguousarray(self._acc)
        self._last_ms = dt_ms
        return self.render_buffer

    # -------- widget panels --------

    def _add_train_panel(self):
        def _toggle(sender, app_data):
            self.training = bool(app_data)

        dpg.add_checkbox(label="train", default_value=False, callback=_toggle)
        dpg.add_button(label="save ckpt", callback=lambda: self.trainer.save_checkpoint())
        dpg.add_button(label="save mesh", callback=lambda: self.trainer.save_mesh())
        dpg.add_text("", tag="_log_train")
        dpg.add_text("", tag="_log_fps")
        dpg.add_checkbox(label="dynamic res", default_value=True,
                         callback=lambda s, a: setattr(self, "dynamic_res", bool(a)))
        dpg.add_slider_float(
            label="dt_gamma", default_value=getattr(self.opt, "dt_gamma", 0.0),
            max_value=0.1, format="%.5f",
            callback=lambda s, a: self.trainer.set_render_option(dt_gamma=a))
        dpg.add_slider_int(
            label="max samples", default_value=getattr(self.opt, "infer_samples_per_ray", 256),
            min_value=16, max_value=1024,
            callback=lambda s, a: self.trainer.set_render_option(num_samples=int(a)))

    def _install_camera_handlers(self, pickers=False):
        def _drag(sender, app_data):
            self.cam.orbit(app_data[1], app_data[2])

        def _pan(sender, app_data):
            self.cam.pan(app_data[1], app_data[2])

        with dpg.handler_registry():
            dpg.add_mouse_drag_handler(button=dpg.mvMouseButton_Left, callback=_drag)
            dpg.add_mouse_drag_handler(button=dpg.mvMouseButton_Middle, callback=_pan)
            dpg.add_mouse_wheel_handler(callback=lambda s, a: self.cam.scale(a))
            if pickers:
                dpg.add_mouse_click_handler(button=dpg.mvMouseButton_Right,
                                            callback=self._on_pick)

    def _loop_body(self):
        if self.training and self.train_ds is not None:
            stats = self.trainer.train_gui(self.train_ds, step=16)
            dpg.set_value("_log_train",
                          f"loss {stats['loss']:.4f} lr {stats['lr']:.2e} "
                          f"{stats['time'] * 1e3:.0f} ms/16 steps")
        self.render_frame()
        dpg.set_value("_log_fps",
                      f"{self._last_ms:.0f} ms ({1e3 / max(self._last_ms, 1e-3):.1f} fps) "
                      f"x{self._downscale:.2f} spp {self._spp}")
        dpg.set_value("_texture", self.render_buffer)

    def render(self):
        dpg.create_context()
        with dpg.texture_registry(show=False):
            dpg.add_raw_texture(self.W, self.H, self.render_buffer,
                                format=dpg.mvFormat_Float_rgb, tag="_texture")
        with dpg.window(tag="_primary", width=self.W, height=self.H):
            dpg.add_image("_texture")
        with dpg.window(label="Control", width=300, pos=(self.W + 5, 0)):
            self._add_train_panel()
        self._install_camera_handlers()
        dpg.create_viewport(title="palettenerf-torch", width=self.W + 320, height=self.H)
        dpg.setup_dearpygui()
        dpg.show_viewport()
        dpg.set_primary_window("_primary", True)
        while dpg.is_dearpygui_running():
            self._loop_body()
            dpg.render_dearpygui_frame()
        dpg.destroy_context()


class PaletteGUI(NeRFGUI):
    """Palette editing viewer (reference palette/gui.py) over EditingSession."""

    def __init__(self, opt, trainer, train_loader=None, video_loader=None,
                 test_poses=None):
        super().__init__(opt, trainer, train_loader)
        from .headless import EditingSession

        self.video_loader = video_loader
        self.test_poses = test_poses
        self.session = EditingSession(trainer, W=opt.W, H=opt.H,
                                      radius=opt.radius, fovy=opt.fovy)
        self.session.cam = self.cam
        self._style_target = [1.0, 1.0, 1.0]

    def render_frame(self):
        out = self.session.render_dynamic(target_ms=self.target_ms
                                          if self.dynamic_res else 1e9)
        img = np.asarray(out["image"], np.float32)
        if img.shape[:2] != (self.H, self.W):
            ry = self.H // img.shape[0] + (self.H % img.shape[0] > 0)
            img = np.kron(img, np.ones((ry, ry, 1), np.float32))[: self.H, : self.W]
        self.render_buffer = np.ascontiguousarray(img)
        self._last_ms = out["frame_ms"]
        self._downscale = out["downscale"]
        self._spp = out["spp"]
        return self.render_buffer

    # -------- palette / edit panels (palette/gui.py:475-659) --------

    def _on_pick(self, sender, app_data):
        x, y = dpg.get_mouse_pos()
        p = self.session.pick(int(x), int(y))
        if dpg.get_value("_style_mode"):
            # style-image workflow: picked point -> current target color
            n = self.session.add_correspondence(int(x), int(y), self._style_target)
            dpg.set_value("_log_style", f"{n} correspondences")
        else:
            self.session.set_region(
                mean_xyz=p["xyz"], std_xyz=dpg.get_value("_std_xyz"),
                mean_clip=p["clip_feat"], std_clip=dpg.get_value("_std_clip"),
                weight_mode=dpg.get_value("_weight_mode"))

    def _add_palette_panel(self):
        for i, c in enumerate(self.session.palette):
            def _cb(sender, app_data, user_data=i):
                self.session.recolor(user_data, app_data[:3])

            dpg.add_color_edit(default_value=list((c * 255).astype(int)) + [255],
                               label=f"basis {i}", callback=_cb)
        dpg.add_button(label="reset colors", callback=lambda: self.session.reset_colors())
        dpg.add_checkbox(label="weight mode", tag="_weight_mode", default_value=False,
                         callback=lambda s, a: self.session.set_region(
                             std_xyz=dpg.get_value("_std_xyz"),
                             std_clip=dpg.get_value("_std_clip"), weight_mode=bool(a)))
        dpg.add_slider_float(label="std_xyz", tag="_std_xyz", default_value=1.0,
                             min_value=0.01, max_value=5.0,
                             callback=lambda s, a: self.session.set_region(std_xyz=a))
        dpg.add_slider_float(label="std_clip", tag="_std_clip", default_value=1.0,
                             min_value=0.01, max_value=5.0)
        dpg.add_slider_float(label="offsets w", default_value=1.0, max_value=2.0,
                             callback=lambda s, a: self.session.set_weights(
                                 offsets_weight=a))
        dpg.add_slider_float(label="view-dep w", default_value=1.0, max_value=2.0,
                             callback=lambda s, a: self.session.set_weights(
                                 view_dep_weight=a))

    def _add_style_panel(self):
        dpg.add_checkbox(label="style-pick mode", tag="_style_mode", default_value=False)
        dpg.add_color_edit(default_value=[255, 255, 255, 255], label="target color",
                           callback=lambda s, a: setattr(self, "_style_target",
                                                         list(a[:3])))
        dpg.add_button(label="optimize style",
                       callback=lambda: (self.session.optimize_style(),
                                         dpg.set_value("_log_style", "style fitted")))
        dpg.add_checkbox(label="use style", default_value=True,
                         callback=lambda s, a: self.session.use_style(bool(a)))
        dpg.add_button(label="clear corr",
                       callback=lambda: self.session.clear_correspondences())
        dpg.add_text("", tag="_log_style")

    def _add_output_panel(self):
        if self.test_poses is not None:
            dpg.add_slider_int(label="test pose", min_value=0,
                               max_value=len(self.test_poses) - 1,
                               callback=lambda s, a: self.session.jump_to_pose(
                                   self.test_poses, int(a)))
        dpg.add_button(label="render view",
                       callback=lambda: self.trainer.save_view(self.cam.pose,
                                                               self.cam.intrinsics,
                                                               self.W, self.H))
        if self.video_loader is not None:  # test renders as PNGs (no video encoder)
            dpg.add_button(label="render video",
                           callback=lambda: self.trainer.test(self.video_loader))

    def render(self):
        dpg.create_context()
        with dpg.texture_registry(show=False):
            dpg.add_raw_texture(self.W, self.H, self.render_buffer,
                                format=dpg.mvFormat_Float_rgb, tag="_texture")
        with dpg.window(tag="_primary", width=self.W, height=self.H):
            dpg.add_image("_texture")
        with dpg.window(label="Palette", width=300, pos=(self.W + 5, 0)):
            self._add_palette_panel()
            dpg.add_separator()
            self._add_style_panel()
            dpg.add_separator()
            self._add_output_panel()
            dpg.add_separator()
            self._add_train_panel()
        self._install_camera_handlers(pickers=True)
        dpg.create_viewport(title="palettenerf-torch editor",
                            width=self.W + 320, height=self.H)
        dpg.setup_dearpygui()
        dpg.show_viewport()
        dpg.set_primary_window("_primary", True)
        while dpg.is_dearpygui_running():
            self._loop_body()
            dpg.render_dearpygui_frame()
        dpg.destroy_context()
